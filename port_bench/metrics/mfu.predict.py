"""The whole predict call's share of the card's bf16 dense peak, in %:
the natural-layout model's operations of a call (present frames and pairs
only, ``core/model.py``) times the calls of the timed window, over the
window's wall time and 989 TFLOP/s."""

from port_bench.core.peaks import BF16_DENSE_FLOPS_PER_S


def read(r):
    if r.get("kind") != "predict" or not r.get("timed_calls"):
        return None
    return 100.0 * r["flops_per_call"] * r["timed_calls"] / r["timed_window_s"] / BF16_DENSE_FLOPS_PER_S
