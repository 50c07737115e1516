"""The whole training step's share of the card's bf16 dense peak, in %:
three times the student's natural-layout forward operations a step
(present frames and pairs only) times the steps of the timed window, over
the window's wall time and 989 TFLOP/s."""

from port_bench.core.peaks import BF16_DENSE_FLOPS_PER_S


def read(r):
    if r.get("kind") != "train" or not r.get("timed_steps"):
        return None
    return 100.0 * 3.0 * r["fwd_flops_per_step"] * r["timed_steps"] / r["timed_window_s"] / BF16_DENSE_FLOPS_PER_S
