"""Constant-velocity Kalman filter on the BEV ground plane: the port's own
copy of ``vsta_tpu/tracking/kalman.py`` (numpy, on the host).

State [x, y, vx, vy] (meters, meters/frame); measurement [x, y].
Used by the SORT tracker (Phase 3 - the reference only declares
tracking in its roadmap, README.md:65-71; nothing was implemented)."""

from __future__ import annotations

import numpy as np


class KalmanFilter2D:
    def __init__(
        self,
        xy: np.ndarray,
        *,
        pos_std: float = 0.2,
        vel_std: float = 1.0,
        meas_std: float = 0.1,
        process_std: float = 0.15,
    ):
        self.x = np.array([xy[0], xy[1], 0.0, 0.0], np.float64)
        self.P = np.diag([pos_std**2, pos_std**2, vel_std**2, vel_std**2])
        self.F = np.eye(4)
        self.F[0, 2] = self.F[1, 3] = 1.0
        self.H = np.zeros((2, 4))
        self.H[0, 0] = self.H[1, 1] = 1.0
        self.R = np.eye(2) * meas_std**2
        q = process_std**2
        self.Q = np.diag([q / 4, q / 4, q, q])

    def predict(self) -> np.ndarray:
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + self.Q
        return self.x[:2].copy()

    def update(self, z: np.ndarray):
        z = np.asarray(z, np.float64)
        y = z - self.H @ self.x
        S = self.H @ self.P @ self.H.T + self.R
        K = self.P @ self.H.T @ np.linalg.inv(S)
        self.x = self.x + K @ y
        self.P = (np.eye(4) - K @ self.H) @ self.P

    @property
    def xy(self) -> np.ndarray:
        return self.x[:2].copy()

    @property
    def velocity(self) -> np.ndarray:
        return self.x[2:].copy()
