"""Device choice shared by the port's entry points, and the card's matmul
precision where a product must be computed as on the CPU."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    There is no quiet fallback: with no GPU, a caller that did not ask for the
    CPU gets an error, never a CPU run that looks like a GPU run.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


@contextlib.contextmanager
def exact_products(t: torch.Tensor):
    """For a CUDA ``t``, within the block: no TF32 in fp32 products and no
    reduced-precision reduction in bf16 ones (fp32 accumulators throughout,
    as on the CPU). The global flags are put back after."""
    if t.device.type != "cuda":
        yield
        return
    m = torch.backends.cuda.matmul
    prev = m.allow_tf32, m.allow_bf16_reduced_precision_reduction
    m.allow_tf32, m.allow_bf16_reduced_precision_reduction = False, False
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = prev
