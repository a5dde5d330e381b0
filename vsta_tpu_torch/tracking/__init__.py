"""SORT tracking on the BEV ground plane, on the host: the port's own copy
of ``vsta_tpu/tracking``."""

from .kalman import KalmanFilter2D
from .metrics import MotAccumulator, evaluate_tracking
from .sort import SortTracker, Track, track_sequence

__all__ = [
    "KalmanFilter2D",
    "MotAccumulator",
    "evaluate_tracking",
    "SortTracker",
    "Track",
    "track_sequence",
]
