"""3x3 stride-1 convolutions in float32, zero-padded one column in W and
``pad_h`` rows in H: V2VNet's fusion convs.

* :func:`conv3x3_plain` — ``F.conv2d``: the CPU path.
* :func:`conv3x3_f32x3` — the wrapper. CPU tensors go to the plain version.
  CUDA tensors go to the hand-written kernel (``csrc/conv3x3_f32x3.cu``),
  which runs the float32 product on the tensor cores in 3xTF32, in the
  forward and for the input gradient; the weight and bias gradients stay
  with ``aten.convolution_backward`` (cuDNN) in float32. On a CUDA tensor
  the wrapper launches the kernel or raises.

``pad_h`` 1 is a SAME conv. ``pad_h`` 0 is the halo form of an H-sharded
strip: ``h + 2`` rows in (the neighbours' boundary rows at the ends), ``h``
out. The input gradient of a stride-1 conv is the forward conv of the
output gradient with the weights flipped in both taps and transposed in
channels, padded ``2 - pad_h`` rows: 1 for SAME, 2 for the halo form.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from disconet_tpu_torch.utils import profiling


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor, bias=None, pad_h: int = 1) -> torch.Tensor:
    """x (N, Cin, H, W), weight (Cout, Cin, 3, 3) [+ bias (Cout)] ->
    (N, Cout, H + 2 pad_h - 2, W)."""
    _check(x, weight, bias, pad_h)
    return F.conv2d(x, weight, bias, padding=(pad_h, 1))


@functools.cache
def _launchers():
    """The kernel's two C entry points, resolved and typed once per process."""
    from disconet_tpu_torch import _build

    lib = _build.load("conv3x3_f32x3")
    prep = lib.conv3x3_f32x3_prep_weights
    prep.restype = ctypes.c_int
    prep.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 4 + [ctypes.c_int,
                                                                                            ctypes.c_void_p]
    launch = lib.conv3x3_f32x3_launch
    launch.restype = ctypes.c_int
    launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return prep, launch


def _check(x: torch.Tensor, weight: torch.Tensor, bias, pad_h: int):
    if x.dim() != 4 or weight.dim() != 4 or tuple(weight.shape[2:]) != (3, 3) or weight.shape[1] != x.shape[1]:
        raise ValueError(f"x (N, Cin, H, W) and weight (Cout, Cin, 3, 3) expected, got {tuple(x.shape)} "
                         f"and {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias {tuple(bias.shape)} does not match weight {tuple(weight.shape)}")
    if pad_h not in (0, 1, 2):
        raise ValueError(f"pad_h must be 0, 1 or 2, got {pad_h}")
    if x.shape[2] + 2 * pad_h < 3:
        raise ValueError(f"{x.shape[2]} rows with pad_h {pad_h} leave no output row")


def _check_kernel(x: torch.Tensor, weight: torch.Tensor, bias):
    """What the kernel takes beyond the shapes: float32, channels in
    multiples of 32, one device."""
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
    if x.shape[1] % 32 or weight.shape[0] % 32:
        raise ValueError(f"the kernel takes channels in multiples of 32, got {x.shape[1]} -> {weight.shape[0]}")


def _prepare(weight: torch.Tensor, transpose: bool) -> torch.Tensor:
    """The kernel's weights (2, 9, Cout, Cin): hi then lo, tap-major, input
    channels permuted as the kernel reads them; with ``transpose``, those of
    the input gradient (taps flipped, channels transposed)."""
    s_o, s_i, s_y, s_x = weight.stride()
    cout, cin = weight.shape[:2]
    if transpose:
        s_o, s_i, cout, cin = s_i, s_o, cin, cout
    out = torch.empty((2, 9, cout, cin), dtype=torch.float32, device=weight.device)
    err = _launchers()[0](weight.data_ptr(), out.data_ptr(), cout, cin, s_o, s_i, s_y, s_x, int(transpose),
                          torch.cuda.current_stream(weight.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_f32x3 weight preparation failed with CUDA error {err}")
    return out


def _launch(x: torch.Tensor, wsplit: torch.Tensor, bias, pad_h: int) -> torch.Tensor:
    """The kernel on x (N, Cin, H, W) and prepared weights (2, 9, Cout, Cin)
    -> (N, Cout, H + 2 pad_h - 2, W), a channels-last view."""
    n, cin, h, w = x.shape
    cout = wsplit.shape[2]
    xh = x.permute(0, 2, 3, 1).contiguous()
    if xh.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if bias is not None:
        bias = bias.contiguous()
    hout = h + 2 * pad_h - 2
    y = torch.empty((n, hout, w, cout), dtype=torch.float32, device=x.device)
    err = _launchers()[1](xh.data_ptr(), wsplit.data_ptr(), None if bias is None else bias.data_ptr(),
                          y.data_ptr(), n, h, w, cin, cout, pad_h,
                          torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_f32x3 kernel launch failed with error {err}")
    conv3x3_f32x3.launches += 1
    profiling.count("fusion/conv3x3_f32x3")
    return y.permute(0, 3, 1, 2)


class _Conv3x3F32x3(torch.autograd.Function):
    """The kernel forward and for the input gradient; cuDNN's float32 for
    the weight and bias gradients. Saves what ``F.conv2d`` saves."""

    @staticmethod
    def forward(ctx, x, weight, bias, pad_h):
        ctx.save_for_backward(x, weight)
        ctx.pad_h, ctx.has_bias = pad_h, bias is not None
        return _launch(x, _prepare(weight, transpose=False), bias, pad_h)

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        gx = gw = gb = None
        # autograd runs this on a thread whose current device is x's
        if ctx.needs_input_grad[0]:
            gx = _launch(gy, _prepare(weight, transpose=True), None, 2 - ctx.pad_h)
        want_b = ctx.has_bias and ctx.needs_input_grad[2]
        if ctx.needs_input_grad[1] or want_b:
            _, gw, gb = torch.ops.aten.convolution_backward(
                gy, x, weight, [weight.shape[0]] if ctx.has_bias else None, [1, 1], [ctx.pad_h, 1], [1, 1],
                False, [0, 0], 1, [False, ctx.needs_input_grad[1], want_b])
        return gx, gw, gb, None


def conv3x3_f32x3(x: torch.Tensor, weight: torch.Tensor, bias=None, pad_h: int = 1) -> torch.Tensor:
    """Wrapper: the 3xTF32 kernel for CUDA tensors, the plain version for CPU ones.

    x (N, Cin, H, W), weight (Cout, Cin, 3, 3) [+ bias (Cout)], float32 on
    the card -> (N, Cout, H + 2 pad_h - 2, W), channels-last in memory
    there. Differentiable in all three.
    """
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias, pad_h)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, weight, bias, pad_h)
    _check_kernel(x, weight, bias)
    with torch.cuda.device(x.device):
        return _Conv3x3F32x3.apply(x, weight, bias, pad_h)


conv3x3_f32x3.launches = 0
