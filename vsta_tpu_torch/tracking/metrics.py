"""Multi-object tracking metrics: CLEAR-MOT (MOTA/MOTP, ID switches) and
IDF1, on ground-plane points. The port's own copy of
``vsta_tpu/tracking/metrics.py``.

The reference names tracking as Phase 3 but implements neither the
tracker nor its evaluation (README.md:65-71,
project/models/heads/detector.py:128-130). This completes the
evaluation side: standard CLEAR-MOT matching (carry over last frame's
assignment when still within the gate, Hungarian on the rest) and
global IDF1 (Hungarian over the gt-track x hyp-track overlap matrix).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


@dataclass
class MotAccumulator:
    """Accumulates CLEAR-MOT events over a sequence.

    update() takes per-frame ground truth (ids + xy) and hypotheses
    (ids + xy); matching gate is euclidean distance <= match_dist.
    """

    match_dist: float = 1.0
    n_gt: int = 0
    n_miss: int = 0
    n_fp: int = 0
    n_switch: int = 0
    n_match: int = 0
    dist_sum: float = 0.0
    _last: Dict[int, int] = field(default_factory=dict)  # gt id -> hyp id
    # for IDF1: co-occurrence counts and per-id totals
    _pair_counts: Dict[Tuple[int, int], int] = field(default_factory=dict)
    _gt_counts: Dict[int, int] = field(default_factory=dict)
    _hyp_counts: Dict[int, int] = field(default_factory=dict)

    def update(
        self,
        gt_ids: Sequence[int],
        gt_xy: np.ndarray,
        hyp_ids: Sequence[int],
        hyp_xy: np.ndarray,
    ):
        gt_ids = list(gt_ids)
        hyp_ids = list(hyp_ids)
        gt_xy = np.asarray(gt_xy, np.float64).reshape(len(gt_ids), 2)
        hyp_xy = np.asarray(hyp_xy, np.float64).reshape(len(hyp_ids), 2)
        self.n_gt += len(gt_ids)
        for g in gt_ids:
            self._gt_counts[g] = self._gt_counts.get(g, 0) + 1
        for h in hyp_ids:
            self._hyp_counts[h] = self._hyp_counts.get(h, 0) + 1

        matches: Dict[int, int] = {}
        used_h: set = set()
        if gt_ids and hyp_ids:
            d = np.linalg.norm(gt_xy[:, None] - hyp_xy[None, :], axis=-1)
            # 1. keep surviving matches from the previous frame
            for gi, g in enumerate(gt_ids):
                h_prev = self._last.get(g)
                if h_prev is not None and h_prev in hyp_ids:
                    hi = hyp_ids.index(h_prev)
                    if d[gi, hi] <= self.match_dist and hi not in used_h:
                        matches[gi] = hi
                        used_h.add(hi)
            # 2. Hungarian on the remainder
            free_g = [i for i in range(len(gt_ids)) if i not in matches]
            free_h = [j for j in range(len(hyp_ids)) if j not in used_h]
            if free_g and free_h:
                sub = d[np.ix_(free_g, free_h)]
                gated = np.where(sub <= self.match_dist, sub, 1e9)
                rows, cols = linear_sum_assignment(gated)
                for r, c in zip(rows, cols):
                    if gated[r, c] < 1e9:
                        matches[free_g[r]] = free_h[c]
                        used_h.add(free_h[c])

            for gi, hi in matches.items():
                g, h = gt_ids[gi], hyp_ids[hi]
                if g in self._last and self._last[g] != h:
                    self.n_switch += 1
                self._last[g] = h
                self.n_match += 1
                self.dist_sum += float(d[gi, hi])
                key = (g, h)
                self._pair_counts[key] = self._pair_counts.get(key, 0) + 1

        self.n_miss += len(gt_ids) - len(matches)
        self.n_fp += len(hyp_ids) - len(matches)
        # forget stale carry-over for gt absent this frame? CLEAR-MOT keeps
        # the last assignment until contradicted; we keep it (standard).

    def summary(self) -> Dict[str, float]:
        mota = 1.0 - (self.n_miss + self.n_fp + self.n_switch) / max(1, self.n_gt)
        motp = self.dist_sum / max(1, self.n_match)
        idf1 = self._idf1()
        return {
            "mota": mota,
            "motp": motp,
            "idf1": idf1,
            "id_switches": float(self.n_switch),
            "misses": float(self.n_miss),
            "false_positives": float(self.n_fp),
            "matches": float(self.n_match),
            "n_gt": float(self.n_gt),
        }

    def _idf1(self) -> float:
        """Global ID-measure: Hungarian over gt-id x hyp-id overlap counts."""
        gts = sorted(self._gt_counts)
        hyps = sorted(self._hyp_counts)
        if not gts or not hyps:
            return 0.0
        overlap = np.zeros((len(gts), len(hyps)))
        for (g, h), c in self._pair_counts.items():
            overlap[gts.index(g), hyps.index(h)] = c
        rows, cols = linear_sum_assignment(-overlap)
        idtp = overlap[rows, cols].sum()
        total_gt = sum(self._gt_counts.values())
        total_hyp = sum(self._hyp_counts.values())
        idp = idtp / max(1, total_hyp)
        idr = idtp / max(1, total_gt)
        return 2 * idp * idr / max(1e-9, idp + idr)


def evaluate_tracking(
    gt_sequence: Sequence[Tuple[Sequence[int], np.ndarray]],
    hyp_sequence: Sequence[Tuple[Sequence[int], np.ndarray]],
    match_dist: float = 1.0,
) -> Dict[str, float]:
    """Score a whole sequence: lists of (ids, xy[N,2]) per frame."""
    acc = MotAccumulator(match_dist=match_dist)
    for (g_ids, g_xy), (h_ids, h_xy) in zip(gt_sequence, hyp_sequence):
        acc.update(g_ids, g_xy, h_ids, h_xy)
    return acc.summary()
