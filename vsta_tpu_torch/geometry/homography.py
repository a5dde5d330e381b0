"""Ground-plane homography math in float32, batched over leading dims.

For a pinhole camera with intrinsics K and world->camera extrinsics
[R|t], points on the ground plane z=0 map to the image by
``H_w2i = K @ [r1 r2 t]`` (r1, r2 the first two columns of R).
"""

from __future__ import annotations

import torch


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Rotation vector (3,), (3,1) or (1,3) -> 3x3 rotation matrix.

    Angles below 1e-8 return the identity.
    """
    rv = rvec.reshape(-1).to(torch.float32)
    theta = torch.linalg.norm(rv)
    k = rv / torch.where(theta < 1e-8, torch.ones_like(theta), theta)
    kx, ky, kz = k[0], k[1], k[2]
    zero = torch.zeros_like(kx)
    Kx = torch.stack(
        [
            torch.stack([zero, -kz, ky]),
            torch.stack([kz, zero, -kx]),
            torch.stack([-ky, kx, zero]),
        ]
    )
    eye = torch.eye(3, dtype=torch.float32, device=rv.device)
    R = eye + torch.sin(theta) * Kx + (1.0 - torch.cos(theta)) * (Kx @ Kx)
    return torch.where(theta < 1e-8, eye, R)


def compute_homography(K: torch.Tensor, Rt: torch.Tensor) -> torch.Tensor:
    """World ground plane (z=0) -> image homography ``K @ [r1 r2 t]``.

    K: (..., 3, 3); Rt: (..., 4, 4) or (..., 3, 4). Returns (..., 3, 3).
    """
    K3 = K[..., :3, :3].to(torch.float32)
    Rt = Rt.to(torch.float32)
    G = torch.cat([Rt[..., :3, 0:1], Rt[..., :3, 1:2], Rt[..., :3, 3:4]], dim=-1)
    return K3 @ G


def invert_homography(H: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse, with the pseudo-inverse where H is (near-)singular."""
    det = torch.linalg.det(H)
    ok = (torch.isfinite(det) & (det.abs() >= eps))[..., None, None]
    eye = torch.eye(3, dtype=H.dtype, device=H.device).expand_as(H)
    inv = torch.linalg.inv(torch.where(ok, H, eye))
    return torch.where(ok, inv, torch.linalg.pinv(H))


def project_points(H: torch.Tensor, pts: torch.Tensor, w_eps: float = 1e-6):
    """Apply a 3x3 homography to homogeneous points.

    H: (..., 3, 3); pts: (..., N, 3). Returns (uv (..., N, 2), w (..., N)):
    uv dehomogenised, with |w| < w_eps divided by 1 instead.
    """
    uvw = torch.einsum("...ij,...nj->...ni", H, pts)
    w = uvw[..., 2]
    w_safe = torch.where(w.abs() < w_eps, torch.ones_like(w), w)
    return uvw[..., :2] / w_safe[..., None], w
