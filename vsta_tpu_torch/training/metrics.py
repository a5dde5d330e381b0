"""Detection metrics (host-side numpy over decoded, masked detections):
the port's own copy of ``vsta_tpu/training/metrics.py``.

Greedy centre-distance matching gives precision, recall, F1 and the mean
localisation error (MLE); MODA is 1 - (misses + false positives) / GT.
MODP is the distance-based point-detection variant,
``mean(1 - d / match_dist)`` over matched detections (d: BEV centre
distance in metres), not the IoU-based CLEAR MODP. Frames with no
prediction and no ground truth count in the totals but not in the
per-frame means; a summary over no frame is NaN, not a perfect score.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


def greedy_match(
    pred_centers: np.ndarray, gt_centers: np.ndarray, match_dist: float
) -> Tuple[int, int, int, List[float]]:
    """Reference-style greedy matching: iterate predictions in their given
    (score-descending) order; a prediction is TP iff its NEAREST unused GT
    is within match_dist (train.py:86-99). Returns (tp, fp, fn, dists)."""
    tp, fp = 0, 0
    dists: List[float] = []
    used = np.zeros(len(gt_centers), bool)
    for p in pred_centers:
        if len(gt_centers) == 0:
            fp += 1
            continue
        d = np.linalg.norm(gt_centers - p[None, :], axis=1)
        j = int(np.argmin(d))
        if d[j] <= match_dist and not used[j]:
            tp += 1
            used[j] = True
            dists.append(float(d[j]))
        else:
            fp += 1
    fn = int((~used).sum())
    return tp, fp, fn, dists


@dataclass
class DetectionMetrics:
    """Accumulates TP/FP/FN and localization errors across frames."""

    match_dist: float = 0.5
    tp: int = 0
    fp: int = 0
    fn: int = 0
    n_gt: int = 0
    n_frames: int = 0
    loc_errors: List[float] = field(default_factory=list)
    # per-frame (P, R, F1, MLE) for reference-compatible frame averaging
    frame_stats: List[Tuple[float, float, float, float]] = field(default_factory=list)

    def update(self, pred_centers: np.ndarray, gt_centers: np.ndarray):
        tp, fp, fn, dists = greedy_match(pred_centers, gt_centers, self.match_dist)
        self.tp += tp
        self.fp += fp
        self.fn += fn
        self.n_gt += len(gt_centers)
        self.n_frames += 1
        self.loc_errors.extend(dists)
        if len(pred_centers) == 0 and len(gt_centers) == 0:
            # degenerate frame: exclude from frame averages (ref counted it
            # as P=R=F1=1.0 - a documented bug we do not replicate)
            return
        p = tp / max(1, tp + fp)
        r = tp / max(1, tp + fn)
        f1 = 2 * p * r / max(1e-6, p + r)
        mle = float(np.mean(dists)) if dists else 0.0
        self.frame_stats.append((p, r, f1, mle))

    def update_batch(
        self,
        boxes: np.ndarray,
        scores: np.ndarray,
        valid: np.ndarray,
        gt_boxes: np.ndarray,
        gt_counts: np.ndarray,
        batch_mask: Optional[np.ndarray] = None,
    ):
        """Consume a decoded batch (padded arrays from ops.decode)."""
        B = boxes.shape[0]
        for b in range(B):
            if batch_mask is not None and not batch_mask[b]:
                continue
            pv = valid[b]
            self.update(boxes[b, pv, :2], gt_boxes[b, : gt_counts[b], :2])

    def summary(self) -> Dict[str, float]:
        if self.n_frames == 0:
            # no frames were ever scored (empty val split / all-masked
            # batches): report NaN, not a vacuous perfect score
            nan = float("nan")
            return {
                "precision": nan, "recall": nan, "f1": nan, "mle": nan,
                "moda": nan, "modp": nan, "tp": 0.0, "fp": 0.0, "fn": 0.0,
                "n_frames": 0.0,
            }
        tp, fp, fn = self.tp, self.fp, self.fn
        precision = tp / max(1, tp + fp)
        recall = tp / max(1, tp + fn)
        f1 = 2 * precision * recall / max(1e-6, precision + recall)
        mle = float(np.mean(self.loc_errors)) if self.loc_errors else 0.0
        # MODA: 1 - (misses + false positives) / total GT (CLEAR-MOT).
        moda = 1.0 - (fn + fp) / max(1, self.n_gt)
        # MODP (distance-based variant, NOT PASCAL-overlap): mean matched-
        # detection precision, 1 - d/match_dist per TP (module docstring).
        if self.loc_errors:
            modp = float(np.mean(1.0 - np.array(self.loc_errors) / self.match_dist))
        else:
            modp = 0.0
        out = {
            "precision": precision,
            "recall": recall,
            "f1": f1,
            "mle": mle,
            "moda": moda,
            "modp": modp,
            "tp": float(tp),
            "fp": float(fp),
            "fn": float(fn),
            "n_frames": float(self.n_frames),
        }
        # reference-compatible per-frame means (train.py:299-302)
        if self.frame_stats:
            arr = np.array(self.frame_stats)
            out["frame_precision"] = float(arr[:, 0].mean())
            out["frame_recall"] = float(arr[:, 1].mean())
            out["frame_f1"] = float(arr[:, 2].mean())
            out["frame_mle"] = float(arr[:, 3].mean())
        return out
