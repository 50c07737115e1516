"""V2VNet's float32 3x3 convs (``ops/conv3x3.py``).

On the CPU: the wrapper is ``F.conv2d`` bit for bit, forward and all three
gradients, SAME and in the halo form; the autograd function's backward
(the input gradient as the forward conv of the flipped, transposed weights,
padded ``2 - pad_h`` rows) run with plain launches; the 3xTF32 arithmetic
emulated in float64 sits within float32's round-off of the exact conv, and a
single TF32 pass lies far outside it; V2VNet's fusion calls the wrapper 15
times a forward (3 rounds x 5 convs).

On the card (``gpu``; ``python -m pytest --noconftest
tests/test_torch_port_conv3x3.py -m gpu`` there, no JAX needed): the kernel
at the main path's shapes, forward and input gradient, against a float64
conv of the same inputs beside cuDNN's float32 on the same data; a planted
single-pass TF32 fault; two runs bit-identical; the launch counter in
V2VNet's ``predict`` and train step; V2VNet's K-step CUDA graph.
"""

from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from disconet_tpu_torch import build_model, example_batch, example_train_batch, make_anchors, predict, tiny_config
from disconet_tpu_torch.models import v2v_net
from disconet_tpu_torch.ops import conv3x3 as c3
from disconet_tpu_torch.ops.conv3x3 import conv3x3_f32x3
from disconet_tpu_torch.training import (
    batch_to_device,
    create_train_state,
    make_train_step,
    make_train_step_multi,
    stack_host_batches,
)
from disconet_tpu_torch.utils import profiling


def _inputs(pad_h, n=2, cin=32, cout=64, h=8, w=8, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    rows = h + 2 - 2 * pad_h  # the halo form takes h + 2 rows for h out
    x = torch.randn(n, cin, rows, w, generator=g, dtype=dtype)
    wt = torch.randn(cout, cin, 3, 3, generator=g, dtype=dtype) * (2.0 / (9 * cin)) ** 0.5
    b = torch.randn(cout, generator=g, dtype=dtype) * 0.1
    gy = torch.randn(n, cout, h, w, generator=g, dtype=dtype)
    return x, wt, b, gy


def _grads(fn, x, wt, b, gy):
    leaves = [t.clone().requires_grad_() for t in (x, wt, b)]
    y = fn(*leaves)
    y.backward(gy)
    return y.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("pad_h", [1, 0])
def test_wrapper_is_f_conv2d_on_the_cpu(pad_h):
    x, wt, b, gy = _inputs(pad_h)
    got, got_g = _grads(lambda a, c, d: conv3x3_f32x3(a, c, d, pad_h=pad_h), x, wt, b, gy)
    want, want_g = _grads(lambda a, c, d: F.conv2d(a, c, d, padding=(pad_h, 1)), x, wt, b, gy)
    assert got.shape == gy.shape and torch.equal(got, want)
    for name, g, h in zip(("x", "weight", "bias"), got_g, want_g):
        assert torch.equal(g, h), name


def _plain_prepare(weight, transpose):
    return weight.flip(2, 3).transpose(0, 1) if transpose else weight


def _plain_launch(x, weight, bias, pad_h):
    c3.conv3x3_f32x3.launches += 1
    return F.conv2d(x, weight, bias, padding=(pad_h, 1))


@pytest.mark.parametrize("pad_h", [1, 0])
def test_backward_launches_the_flipped_transposed_conv(pad_h):
    """The autograd function with plain launches in place of the kernel's:
    the input gradient (one launch, padded 2 - pad_h) equals autograd's of
    F.conv2d within float32 round-off (another sum order), the weight and
    bias gradients (aten.convolution_backward, as autograd) bit for bit."""
    x, wt, b, gy = _inputs(pad_h, seed=1)
    before = conv3x3_f32x3.launches
    with mock.patch.object(c3, "_prepare", _plain_prepare), mock.patch.object(c3, "_launch", _plain_launch):
        got, got_g = _grads(lambda a, c, d: c3._Conv3x3F32x3.apply(a, c, d, pad_h), x, wt, b, gy)
    assert conv3x3_f32x3.launches - before == 2  # forward and input gradient
    want, want_g = _grads(lambda a, c, d: F.conv2d(a, c, d, padding=(pad_h, 1)), x, wt, b, gy)
    assert torch.equal(got, want)
    assert got_g[0].shape == x.shape
    torch.testing.assert_close(got_g[0], want_g[0], rtol=1e-5, atol=1e-5)
    assert torch.equal(got_g[1], want_g[1]) and torch.equal(got_g[2], want_g[2])


def _rna_tf32(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: add half of the dropped 13 bits' unit to the magnitude, truncate."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _conv64(x, w):
    return F.conv2d(torch.from_numpy(x).double(), torch.from_numpy(w).double(), padding=1).numpy()


def test_3xtf32_arithmetic_keeps_float32_accuracy():
    """hi = rna_tf32(v), lo = rna_tf32(v - hi) and hi*hi + hi*lo + lo*hi,
    summed exactly (float64): off the exact conv of the float32 inputs by
    the split's own error, under 2^-22 of each product, which lands within
    the round-off of a float32 conv of the same inputs (limit 1x: read
    8.5e-8 against float32's 3.0e-7, of the largest output). A single TF32
    pass (hi*hi) is off by ~2^-11 of each product: at least 10x further
    than float32 (read 3.0e-4, 1000x)."""
    x, wt, _, _ = _inputs(1, n=2, cin=64, cout=32, h=16, w=16, seed=2)
    x, wt = x.numpy(), wt.numpy()
    exact = _conv64(x, wt)
    xh, wh = _rna_tf32(x), _rna_tf32(wt)
    xl, wl = _rna_tf32(x - xh), _rna_tf32(wt - wh)
    three = _conv64(xh, wh) + _conv64(xh, wl) + _conv64(xl, wh)
    one = _conv64(xh, wh)
    f32 = F.conv2d(torch.from_numpy(x), torch.from_numpy(wt), padding=1).double().numpy()

    def err(y):
        return np.abs(y - exact).max() / np.abs(exact).max()

    assert np.all(xh.view(np.uint32) & 0x1FFF == 0) and np.all(xl.view(np.uint32) & 0x1FFF == 0)
    assert err(three) <= err(f32), (err(three), err(f32))
    assert err(one) >= 10 * err(f32), (err(one), err(f32))


def test_v2vnet_fuses_through_the_wrapper():
    """Every conv of V2VNet's fusion goes through ``conv3x3_f32x3``: 3
    rounds x (the message conv's two halves + the ConvGRU's 3)."""
    cfg = tiny_config(32)
    model = build_model("v2v", cfg, device="cpu", seed=0)
    bev, trans, mask = example_batch(cfg, 1, 2, seed=0)
    calls = []

    def counting(*a, **k):
        calls.append(a[0].shape)
        return conv3x3_f32x3(*a, **k)

    with mock.patch.object(v2v_net, "conv3x3_f32x3", counting), torch.no_grad():
        model(torch.from_numpy(bev), torch.from_numpy(trans), torch.from_numpy(mask))
    assert len(calls) == 15


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Shapes on both paths; float32, channels in multiples of 32 and one
    device before a launch (the CPU path is F.conv2d in any dtype)."""
    x, wt, b, _ = _inputs(1)
    with pytest.raises(ValueError):
        conv3x3_f32x3(x, wt[..., :1, :1])
    with pytest.raises(ValueError):
        conv3x3_f32x3(x, wt, b, pad_h=3)
    assert conv3x3_f32x3(x.double(), wt.double()).dtype == torch.float64
    with pytest.raises(TypeError):
        c3._check_kernel(x.double(), wt.double(), None)
    with pytest.raises(ValueError):
        c3._check_kernel(x[:, :16], wt[:48, :16], None)


# ---------------------------------------------------------------------------
# on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the 3xTF32 kernel has no CPU mode")


# (images, rows out, width, Cin, Cout, pad_h): V2VNet's main path at
# --layer 3 (B 4 x A 6 agents, 32x32 cells, C 256): the message conv's
# sender half (every receiver-sender pair) and receiver half, the ConvGRU's
# 512 -> 256; the ConvGRU on a strip of a spatial mesh of 2 (the halo
# form); the message conv's receiver half at --layer 2 (64x64, C 128); the
# ConvGRU at --layer 1 (128x128, C 64) and --layer 0 (256x256, C 32), where
# the kernel's tile is 64 and 32 channels wide; and a Cout past a multiple
# of 128 (a last tile of 32 channels in 128)
CARD_SHAPES = [
    (144, 32, 32, 256, 256, 1),
    (24, 32, 32, 256, 256, 1),
    (24, 32, 32, 512, 256, 1),
    (24, 16, 32, 512, 256, 0),
    (24, 64, 64, 128, 128, 1),
    (24, 128, 128, 128, 64, 1),
    (24, 256, 256, 64, 32, 1),
    (4, 16, 16, 96, 160, 1),
]


def _tf32_round(t: torch.Tensor) -> torch.Tensor:
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _single_pass(x, weight, bias, pad_h, transpose):
    """The planted fault: the kernel fed TF32-rounded activations and no lo
    weights computes hi*hi alone, one TF32 pass."""
    wsplit = c3._prepare(weight, transpose)
    wsplit[1].zero_()
    return c3._launch(_tf32_round(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2), wsplit, bias, pad_h)


def _errors(got, ref):
    d = got.double() - ref
    return (d.abs().max() / ref.abs().max()).item(), (d.norm() / ref.norm()).item()


# The kernel's float32 must be as good as cuDNN's float32 (TF32 off) on the
# same data, in the largest and the RMS error against float64: limit 2x
# cuDNN's readings. The products are exact in 3xTF32 up to 2^-22 of each;
# the tensor cores sum without rounding to nearest, which is why the
# kernel adds each tap's partial in float32. A single TF32 pass is off by
# ~2^-11 of each product and must fail the limit.
@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_precision_on_the_card(shape, monkeypatch):
    _card()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    n, h, w, cin, cout, pad_h = shape
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = torch.randn(n, cin, h + 2 - 2 * pad_h, w, device="cuda", generator=g).contiguous(
        memory_format=torch.channels_last)
    wt = torch.randn(cout, cin, 3, 3, device="cuda", generator=g) * (2.0 / (9 * cin)) ** 0.5
    b = torch.randn(cout, device="cuda", generator=g) * 0.1
    gy = torch.randn(n, cout, h, w, device="cuda", generator=g).contiguous(memory_format=torch.channels_last)

    x64 = x.double().requires_grad_()
    ref = F.conv2d(x64, wt.double(), b.double(), padding=(pad_h, 1))
    ref.backward(gy.double())
    x32 = x.clone().requires_grad_()
    lib = F.conv2d(x32, wt, b, padding=(pad_h, 1))
    lib.backward(gy)
    xk = x.clone().requires_grad_()
    before = conv3x3_f32x3.launches
    got = conv3x3_f32x3(xk, wt, b, pad_h)
    got.backward(gy)
    assert conv3x3_f32x3.launches - before == 2
    again = conv3x3_f32x3(x, wt, b, pad_h)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "two runs differ"

    pairs = {"forward": (got, lib, ref.detach(), _single_pass(x, wt, b, pad_h, False)),
             "input gradient": (xk.grad, x32.grad, x64.grad, _single_pass(gy, wt, None, 2 - pad_h, True))}
    for what, (kernel, cudnn, exact, fault) in pairs.items():
        k, c, f = _errors(kernel, exact), _errors(cudnn, exact), _errors(fault, exact)
        assert k[0] <= 2 * c[0] and k[1] <= 2 * c[1], (what, k, c)
        assert f[0] > 2 * c[0] or f[1] > 2 * c[1], (what, f, c)


CFG = tiny_config(64, compute_dtype="float32", head_raw_dtype="float32")


@pytest.mark.gpu
def test_v2vnet_launches_on_the_card():
    """15 launches a ``predict`` (forward: 3 rounds x 5 convs), 30 a train
    step (and the input gradient of each), at --layer 2 (16x16 x 128); the
    program counter ``fusion/conv3x3_f32x3`` counts the same while
    recording."""
    _card()
    _, trans, mask = example_batch(CFG, 2, CFG.max_agents, seed=0)
    pts = np.random.default_rng(0).uniform([-8, -8, -3], [8, 8, 2], (2, CFG.max_agents, 4096, 3)).astype(np.float32)
    model = build_model("v2v", CFG, seed=1)
    before = conv3x3_f32x3.launches
    profiling.snapshot()
    with profiling.recording():
        predict(model, pts, trans, mask, make_anchors(CFG), CFG)
    assert conv3x3_f32x3.launches - before == 15
    assert profiling.snapshot()["counters"].get("fusion/conv3x3_f32x3") == 15
    step = make_train_step(model, CFG, create_train_state(model))
    batch = batch_to_device(example_train_batch(CFG, 2, CFG.max_agents, seed=0, boxes_per_frame=2))
    before = conv3x3_f32x3.launches
    metrics = step(batch)
    torch.cuda.synchronize()
    assert conv3x3_f32x3.launches - before == 30
    assert all(torch.isfinite(v).all() for v in metrics.values())


@pytest.mark.gpu
def test_v2vnet_graph_on_the_card():
    """V2VNet's K-step CUDA graph captures the kernel (30 launches a step,
    counted once, at capture) and replays it: step 1 within 1e-5 of a
    single step from the same weights (the K-step graph test's bound), the
    weights updated, and a second dispatch replays without a launch from
    Python."""
    _card()
    k = 3
    hosts = [example_train_batch(CFG, 2, CFG.max_agents, seed=s, boxes_per_frame=2) for s in range(k)]
    sd = build_model("v2v", CFG, device="cpu", seed=7).state_dict()
    models = [build_model("v2v", CFG, seed=0) for _ in range(2)]
    for m in models:
        m.load_state_dict(sd)
    single = make_train_step(models[0], CFG, create_train_state(models[0]))(batch_to_device(hosts[0]))
    multi = make_train_step_multi(models[1], CFG, create_train_state(models[1]))
    start = [p.detach().clone() for p in models[1].parameters()]
    before = conv3x3_f32x3.launches
    got = multi(batch_to_device(stack_host_batches(hosts)))
    torch.cuda.synchronize()
    captured = conv3x3_f32x3.launches - before
    assert captured % 30 == 0 and captured >= 30 * k, captured  # warm-up steps and the K captured
    for key, v in single.items():
        torch.testing.assert_close(got[key][0], v, rtol=1e-5, atol=1e-6, msg=key)
    assert any(not torch.equal(p, q) for p, q in zip(start, models[1].parameters()))
    before = conv3x3_f32x3.launches
    again = multi(batch_to_device(stack_host_batches(hosts)))
    torch.cuda.synchronize()
    assert conv3x3_f32x3.launches == before
    assert all(torch.isfinite(v).all() for v in again.values())
