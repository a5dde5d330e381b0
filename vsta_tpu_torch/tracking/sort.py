"""SORT-style online tracking over decoded BEV detections: the port's own
copy of ``vsta_tpu/tracking/sort.py`` (numpy and scipy, on the host).

Phase 3 of the reference's roadmap (README.md:65-71), which it never
implemented (project/models/heads/detector.py:128-130 is a print-only
placeholder). Standard SORT adapted to ground-plane points: per-track
constant-velocity Kalman filter, Hungarian assignment on center
distance with gating, max_age/min_hits lifecycle.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from .kalman import KalmanFilter2D


@dataclass
class Track:
    track_id: int
    kf: KalmanFilter2D
    hits: int = 1
    age: int = 0  # frames since last match
    frames: int = 1  # total frames alive
    score: float = 0.0
    history: List[np.ndarray] = field(default_factory=list)

    @property
    def xy(self) -> np.ndarray:
        return self.kf.xy

    @property
    def confirmed(self) -> bool:
        return self.hits >= 1  # patched by tracker min_hits at query time


class SortTracker:
    def __init__(self, max_age: int = 5, min_hits: int = 2, match_dist_m: float = 1.0):
        self.max_age = max_age
        self.min_hits = min_hits
        self.match_dist_m = match_dist_m
        self.tracks: List[Track] = []
        self._next_id = 1

    def reset(self):
        self.tracks = []
        self._next_id = 1

    def update(
        self, centers: np.ndarray, scores: Optional[np.ndarray] = None
    ) -> List[Dict]:
        """Advance one frame with detections [N, 2] (meters).

        Returns the confirmed tracks as dicts: {'id', 'xy', 'velocity',
        'score', 'hits'}.
        """
        centers = np.asarray(centers, np.float64).reshape(-1, 2)
        if scores is None:
            scores = np.ones(len(centers))

        # 1. predict all tracks forward
        predicted = np.array([t.kf.predict() for t in self.tracks]).reshape(-1, 2)

        # 2. associate via Hungarian on gated euclidean distance
        matches: List[Tuple[int, int]] = []
        unmatched_dets = set(range(len(centers)))
        unmatched_trks = set(range(len(self.tracks)))
        if len(centers) > 0 and len(self.tracks) > 0:
            cost = np.linalg.norm(
                predicted[:, None, :] - centers[None, :, :], axis=-1
            )  # [T, N]
            gated = np.where(cost <= self.match_dist_m, cost, 1e6)
            rows, cols = linear_sum_assignment(gated)
            for r, c in zip(rows, cols):
                if gated[r, c] < 1e6:
                    matches.append((r, c))
                    unmatched_dets.discard(c)
                    unmatched_trks.discard(r)

        # 3. update matched tracks
        for r, c in matches:
            t = self.tracks[r]
            t.kf.update(centers[c])
            t.hits += 1
            t.age = 0
            t.frames += 1
            t.score = float(scores[c])
            t.history.append(t.kf.xy)

        # 4. age unmatched tracks, drop the stale
        for r in unmatched_trks:
            self.tracks[r].age += 1
            self.tracks[r].frames += 1
        self.tracks = [t for t in self.tracks if t.age <= self.max_age]

        # 5. births
        for c in unmatched_dets:
            t = Track(self._next_id, KalmanFilter2D(centers[c]), score=float(scores[c]))
            t.history.append(t.kf.xy)
            self._next_id += 1
            self.tracks.append(t)

        # 6. report confirmed tracks with a fresh match
        out = []
        for t in self.tracks:
            if t.hits >= self.min_hits and t.age == 0:
                out.append(
                    {
                        "id": t.track_id,
                        "xy": t.xy,
                        "velocity": t.kf.velocity,
                        "score": t.score,
                        "hits": t.hits,
                    }
                )
        return out


def track_sequence(
    boxes_seq: List[np.ndarray],
    scores_seq: Optional[List[np.ndarray]] = None,
    *,
    max_age: int = 5,
    min_hits: int = 2,
    match_dist_m: float = 1.0,
) -> List[List[Dict]]:
    """Offline helper: run SORT over a whole decoded sequence."""
    tracker = SortTracker(max_age=max_age, min_hits=min_hits, match_dist_m=match_dist_m)
    out = []
    for i, boxes in enumerate(boxes_seq):
        centers = np.asarray(boxes).reshape(-1, boxes.shape[-1])[:, :2]
        scores = None if scores_seq is None else scores_seq[i]
        out.append(tracker.update(centers, scores))
    return out
