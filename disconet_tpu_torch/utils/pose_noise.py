"""Pose-error robustness (the DiscoNet paper's noise study, arXiv:2111.00643).

The port's own copy of the JAX package's helper. The paper evaluates
collaboration under localization error by perturbing the inter-agent poses
with Gaussian translation/rotation noise at test time. This helper applies
that perturbation to the (B, A, A, 4, 4) relative-pose tensor:
every non-self edge T[i<-j] is composed with a small random planar transform;
self-poses stay exact (an agent knows its own frame).
"""

from __future__ import annotations

import numpy as np


def perturb_trans(
    trans: np.ndarray,
    std_t: float,
    std_r: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """Apply planar Gaussian pose noise to non-self relative poses.

    Args:
        trans: (..., A, A, 4, 4), trans[..., i, j] maps sender j -> receiver i.
        std_t: translation noise std in meters (per x/y axis).
        std_r: rotation noise std in radians.
    Returns:
        Perturbed copy (float32).
    """
    trans = np.asarray(trans, np.float32).copy()
    A = trans.shape[-3]
    lead = trans.shape[:-4]
    for idx in np.ndindex(*lead) if lead else [()]:
        for i in range(A):
            for j in range(A):
                if i == j:
                    continue
                th = rng.normal(0.0, std_r)
                c, s = np.cos(th), np.sin(th)
                E = np.eye(4, dtype=np.float32)
                E[0, 0], E[0, 1], E[1, 0], E[1, 1] = c, -s, s, c
                E[0, 3], E[1, 3] = rng.normal(0.0, std_t, 2)
                trans[idx + (i, j)] = E @ trans[idx + (i, j)]
    return trans
