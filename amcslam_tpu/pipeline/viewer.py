"""Visualization (rebuild of src/Viewer.cc + MapDrawer/FrameDrawer, SURVEY §2.11).

The reference renders with Pangolin; it is disabled in the AMV example
(bUseViewer=false, multicam_amv.cc:45). Here: a headless matplotlib renderer
producing the same artifacts — map points + keyframe frusta + covisibility
graph + trajectory (MapDrawer.cc:135,181,401) and a multi-camera keypoint
mosaic (FrameDrawer.cc:384) — to files or figure objects, suitable for
offline inspection of device runs.
"""

from __future__ import annotations

import numpy as np

from .map_store import Frame, Map


def draw_map(map_: Map, trajectory=None, path: str | None = None, show_covis=True):
    """Top-down (x-y) map plot: landmarks, keyframes, covisibility edges."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    if map_.map_points:
        X = np.stack([mp.position for mp in map_.map_points.values()])
        ax.scatter(X[:, 0], X[:, 1], s=1, c="k", alpha=0.3, label="map points")
    kfs = sorted(map_.keyframes.values(), key=lambda k: k.timestamp)
    if kfs:
        P = np.stack([k.Twb[:3, 3] for k in kfs])
        ax.plot(P[:, 0], P[:, 1], "b.-", ms=4, lw=1, label="keyframes")
        if show_covis:
            pos = {k.id: k.Twb[:3, 3] for k in kfs}
            for k in kfs:
                for nb, w in k.covisibility.items():
                    if nb in pos and nb > k.id:
                        a, b = pos[k.id], pos[nb]
                        ax.plot([a[0], b[0]], [a[1], b[1]], "g-", lw=0.3, alpha=0.4)
    if trajectory:
        T = np.stack([Twb[:3, 3] for _, Twb in trajectory])
        ax.plot(T[:, 0], T[:, 1], "r-", lw=0.8, label="trajectory")
    ax.set_aspect("equal")
    ax.legend(loc="best")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def draw_frame_mosaic(frame: Frame, images=None, path: str | None = None):
    """Multi-camera keypoint mosaic (FrameDrawer::DrawFrame analog)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    C = frame.n_cameras
    fig, axes = plt.subplots(1, C, figsize=(4 * C, 3))
    if C == 1:
        axes = [axes]
    for c in range(C):
        ax = axes[c]
        if images is not None and c < len(images) and images[c] is not None:
            ax.imshow(images[c], cmap="gray")
        kp = frame.keypoints[c]
        if len(kp):
            matched = np.array([
                frame.matches[frame.global_index(c, i)] >= 0 for i in range(len(kp))
            ])
            ax.scatter(kp[~matched, 0], kp[~matched, 1], s=4, c="r", marker="x")
            ax.scatter(kp[matched, 0], kp[matched, 1], s=6, c="g", marker="o")
        ax.set_title(f"cam {c}" + (" (stereo)" if c == C - 1 else ""))
        ax.invert_yaxis()
    if path:
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig
