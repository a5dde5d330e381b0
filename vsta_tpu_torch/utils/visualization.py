"""Visualisation and export: the port's own copy of
``vsta_tpu/utils/visualization.py``.

The heatmap ('hot' PNG) and the learning curves need matplotlib; where it
does not import, each call prints one line saying so, and
:func:`save_learning_curves` still writes its curves as
``learning_curves.json`` beside the PNG's path (it writes that file in
every case). Predictions are one JSON a frame, {"frame_idx", "boxes",
"scores"} at ``frame_{idx:06d}.json``.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where it does not import."""
    try:
        import matplotlib
    except ImportError as e:
        print(f"[vis] matplotlib unavailable ({e}); no PNG written")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_bev_heatmap(heatmap, save_path: str):
    """heatmap: array [B,H,W,1] / [H,W] etc. -> matplotlib 'hot' PNG."""
    plt = _pyplot()
    if plt is None:
        return
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    hm = np.asarray(heatmap)
    while hm.ndim > 2:
        hm = hm[0] if hm.shape[0] <= hm.shape[-1] else hm[..., 0]
    plt.figure(figsize=(4, 4))
    plt.imshow(hm, cmap="hot", interpolation="nearest")
    plt.colorbar()
    plt.tight_layout()
    plt.savefig(save_path)
    plt.close()


def save_predictions_json(
    boxes: np.ndarray,
    scores: np.ndarray,
    valid: np.ndarray,
    save_dir: str,
    frame_indices: Sequence[int],
    batch_mask: Optional[np.ndarray] = None,
    tracks: Optional[Sequence[list]] = None,
    clips: Optional[Sequence[int]] = None,
):
    """Write one JSON per frame from padded decoded arrays [B,K,...].

    ``tracks`` (per batch row) adds a "tracks" list of
    {"id","xy","velocity","score"} dicts; ``clips`` (per batch row) records
    the frame's temporal window in multi-clip mode.
    """
    os.makedirs(save_dir, exist_ok=True)
    for b, frame_idx in enumerate(frame_indices):
        if batch_mask is not None and not batch_mask[b]:
            continue
        keep = np.asarray(valid[b], bool)
        out = {
            "frame_idx": int(frame_idx),
            "boxes": np.asarray(boxes[b][keep], np.float64).tolist(),
            "scores": np.asarray(scores[b][keep], np.float64).tolist(),
        }
        if tracks is not None:
            out["tracks"] = tracks[b]
        if clips is not None:
            out["clip"] = int(clips[b])
        with open(os.path.join(save_dir, f"frame_{int(frame_idx):06d}.json"), "w") as f:
            json.dump(out, f)


def save_learning_curves(train_loss: List[float], val_f1: List[float], save_path: str):
    """The curves as a PNG at ``save_path`` (with matplotlib) and as
    ``learning_curves.json`` in its directory."""
    out_dir = os.path.dirname(save_path) or "."
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "learning_curves.json"), "w") as f:
        json.dump({"train_loss": [float(x) for x in train_loss], "val_f1": [float(x) for x in val_f1]}, f)
    plt = _pyplot()
    if plt is None:
        return
    plt.figure(figsize=(6, 4))
    plt.plot(train_loss, label="train_loss")
    if val_f1:
        plt.plot(val_f1, label="val_f1")
    plt.legend()
    plt.tight_layout()
    plt.savefig(save_path)
    plt.close()
