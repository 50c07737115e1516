"""BEV figures of the port, the JAX package's ``utils/visualization.py``:
occupancy with gt (green) and detections (red), segmentation panels and
DiscoNet's edge-weight heat-maps. Host numpy and matplotlib; matplotlib is
imported only when a figure is drawn, and :func:`require_matplotlib` turns
its absence into an exit that names it.
"""

from __future__ import annotations

import numpy as np

from disconet_tpu_torch.config import Config
from disconet_tpu_torch.ops.boxes import box_corners_np


def require_matplotlib() -> None:
    """Exit with a message naming matplotlib where it does not import (the
    CLIs call this before any work when ``--visualization 1`` is set)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        raise SystemExit("--visualization 1 needs matplotlib, which is not installed here; "
                         "install it or run without --visualization") from None


def _plt():
    """Headless pyplot."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save(fig, path: str) -> None:
    """Write ``fig`` as a png and close it."""
    fig.savefig(path, dpi=100)
    _plt().close(fig)


def render_bev(cfg: Config, bev, gt_boxes=None, det_boxes=None, det_scores=None):
    """One agent's BEV: the occupancy (H, W, Z) seen from above, gt boxes in
    green, detections in red with their scores; metric axes."""
    plt = _plt()
    (x_lo, x_hi), (y_lo, y_hi), _ = cfg.area_extents
    occ = np.asarray(bev).max(axis=-1)  # (H, W)
    fig, ax = plt.subplots(figsize=(6, 6))
    # axis 0 is metric x, axis 1 metric y: imshow wants rows of y
    ax.imshow(occ.T, origin="lower", extent=(x_lo, x_hi, y_lo, y_hi), cmap="gray_r", alpha=0.8)

    def draw(boxes, color, scores=None):
        boxes = np.asarray(boxes).reshape(-1, 5)
        for i, c in enumerate(box_corners_np(boxes) if len(boxes) else []):
            poly = np.vstack([c, c[:1]])
            ax.plot(poly[:, 0], poly[:, 1], color=color, linewidth=1.2)
            if scores is not None:
                ax.text(c[0, 0], c[0, 1], f"{scores[i]:.2f}", color=color, fontsize=6)

    if gt_boxes is not None:
        draw(gt_boxes, "green")
    if det_boxes is not None:
        draw(det_boxes, "red", det_scores)
    ax.set_xlim(x_lo, x_hi)
    ax.set_ylim(y_lo, y_hi)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    fig.tight_layout()
    return fig


def render_seg(pred, label=None, num_classes: int = 8, class_names=None):
    """Predicted (and ground-truth) BEV classes (H, W), one categorical
    colour a class, with a legend where ``class_names`` are given."""
    plt = _plt()
    from matplotlib import colors as mcolors
    from matplotlib.patches import Patch

    cmap = plt.get_cmap("tab10", num_classes)
    norm = mcolors.BoundaryNorm(np.arange(num_classes + 1) - 0.5, num_classes)
    panels = [("prediction", np.asarray(pred))]
    if label is not None:
        panels.append(("ground truth", np.asarray(label)))
    fig, axes = plt.subplots(1, len(panels), figsize=(5 * len(panels), 5))
    for ax, (title, img) in zip(np.atleast_1d(axes), panels):
        ax.imshow(img.T, origin="lower", cmap=cmap, norm=norm, interpolation="nearest")
        ax.set_title(title)
        ax.set_xticks([])
        ax.set_yticks([])
    if class_names:
        fig.legend(handles=[Patch(color=cmap(c), label=n) for c, n in enumerate(class_names)],
                   loc="lower center", ncol=min(len(class_names), 4), fontsize=8)
    fig.tight_layout(rect=(0, 0.12 if class_names else 0, 1, 1))
    return fig


def render_edge_weights(weights, agent_mask, receiver: int):
    """DiscoNet's edge weights into one receiver: ``weights`` (A_send, h, w)
    (a receiver's row of ``DiscoNet.edge_weights``), one panel a present
    sender on a shared [0, 1] scale; the self-edge is marked."""
    plt = _plt()
    weights = np.asarray(weights)
    mask = np.asarray(agent_mask).astype(bool)
    senders = [j for j in range(weights.shape[0]) if mask[j]]
    fig, axes = plt.subplots(1, max(len(senders), 1), figsize=(3 * max(len(senders), 1), 3))
    axes = np.atleast_1d(axes)
    im = None
    for ax, j in zip(axes, senders):
        im = ax.imshow(weights[j].T, origin="lower", cmap="viridis", vmin=0.0, vmax=1.0)
        tag = " (self)" if j == receiver else ""
        ax.set_title(f"$W_{{{j}\\to{receiver}}}${tag}", fontsize=9)
        ax.set_xticks([])
        ax.set_yticks([])
    if im is not None:
        fig.colorbar(im, ax=list(axes), fraction=0.025)
    return fig
