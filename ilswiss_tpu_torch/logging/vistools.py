"""Plots and videos (counterpart: ilswiss_tpu/logging/vistools.py;
`plot_learning_curves`, `plot_histogram`, `save_video`).

The reference's visualization helpers (rlkit/core/vistools.py and
run_scripts/video.py's mp4 writer): learning curves read straight from
`progress.csv`, return histograms, and rollout videos through imageio.
numpy, matplotlib (the Agg backend) and imageio only, each imported where
it is used.
"""

from __future__ import annotations

import csv
import os
from typing import Iterable, Sequence

import numpy as np


def _load_progress(csv_path: str) -> dict:
    """The numeric columns of a progress.csv as float arrays."""
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    cols: dict = {}
    for row in rows:
        for k, v in row.items():
            try:
                cols.setdefault(k, []).append(float(v))
            except (TypeError, ValueError):
                pass
    return {k: np.asarray(v) for k, v in cols.items()}


def plot_learning_curves(csv_paths: Sequence[str], key: str,
                         labels: Sequence[str] | None = None,
                         x_key: str = "Epoch",
                         save_path: str = "curve.png",
                         title: str | None = None) -> str:
    """`key` against `x_key` (the row index where a file has no such
    column) from each progress.csv on one plot, labelled by `labels` or
    each file's directory; a file without `key` is left out (the
    reference's plot_returns_on_same_plot).  Returns `save_path`."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4.5))
    for i, path in enumerate(csv_paths):
        cols = _load_progress(path)
        if key not in cols:
            continue
        x = cols.get(x_key, np.arange(len(cols[key])))
        label = labels[i] if labels else os.path.basename(
            os.path.dirname(path))
        ax.plot(x[: len(cols[key])], cols[key], label=label)
    ax.set_xlabel(x_key)
    ax.set_ylabel(key)
    if title:
        ax.set_title(title)
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def plot_histogram(values: Iterable[float], save_path: str,
                   title: str = "") -> str:
    """A 40-bin histogram of `values` (the reference's plot_histogram).
    Returns `save_path`."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(np.asarray(list(values)), bins=40)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def save_video(frames: np.ndarray, save_path: str, fps: int = 30) -> str:
    """[T, H, W, C] frames, uint8 or floats in [0, 1] (clipped, scaled to
    uint8), one channel repeated to three, written by imageio; where no
    ffmpeg backend writes `save_path`, a gif beside it.  Returns the path
    written."""
    import imageio

    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    if frames.shape[-1] == 1:
        frames = np.repeat(frames, 3, axis=-1)
    try:
        imageio.mimwrite(save_path, list(frames), fps=fps)
    except (ValueError, OSError):
        save_path = os.path.splitext(save_path)[0] + ".gif"
        imageio.mimwrite(save_path, list(frames), fps=fps)
    return save_path
