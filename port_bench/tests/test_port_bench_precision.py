"""The control's plain products round as its convs do: exact in the
reference, e4m3 operands and an e5m2 incoming gradient where the
configuration states bfloat16, bfloat16 where it states float32."""

import pytest
import torch
import torch.nn.functional as F

from port_bench.reference.precision import Precision


def _operands(seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(3, 24, 40, generator=g)
    b = torch.randn(3, 40, 16, generator=g)
    return a, b


def test_the_reference_is_exact_float32():
    a, b = _operands()
    ref = Precision("reference")
    assert torch.equal(ref.matmul(a, b, stated="bfloat16"), a @ b)
    w, bias = b[0].T.contiguous(), torch.randn(16)
    assert torch.equal(ref.linear(a, w, bias), F.linear(a, w, bias))
    assert torch.equal(Precision("control_fusion").matmul(a, b, stated="bfloat16"), a @ b)


@pytest.mark.parametrize("mode,stated", [("control", "bfloat16"), ("control", "float32"),
                                         ("control_fusion", "float32")])
def test_the_control_matches_a_1x1_conv_on_the_same_operands(mode, stated):
    """(M, K) @ (K, N) as a 1x1 conv of K channels over M pixels to N; the
    same per-tensor scales, so the same rounded operands, forward and
    backward."""
    a, b = _operands(1)
    a, b = a[0].clone().requires_grad_(), b[0].clone().requires_grad_()
    prec = Precision(mode)
    y = prec.matmul(a, b, stated=stated)
    x = a.T[None, :, :, None]  # (1, K, M, 1)
    w = b.T[:, :, None, None]  # (N, K, 1, 1)
    yc = prec.conv(x, w, stated=stated)[0, :, :, 0].T
    torch.testing.assert_close(y, yc, rtol=1e-6, atol=1e-5)
    assert not torch.allclose(y, a.detach() @ b.detach(), rtol=1e-3, atol=1e-3)  # it does round
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    ga, gb = torch.autograd.grad(y, (a, b), g)
    gac, gbc = torch.autograd.grad(yc, (a, b), g)
    torch.testing.assert_close(ga, gac, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(gb, gbc, rtol=1e-6, atol=1e-5)
    lin = prec.linear(a, b.T, torch.ones(16), stated=stated)
    torch.testing.assert_close(lin, y + 1.0, rtol=1e-6, atol=1e-5)
