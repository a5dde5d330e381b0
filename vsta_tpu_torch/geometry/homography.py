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


def small_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for a short inner dimension, (..., I, K) @ (..., K, J)
    broadcast over the leading dims, as elementwise products added in the
    order k = 0, 1, ...: every element's bits are the same whatever the
    batch. (On the card cuBLAS picks its kernel, and with it the rounding,
    by the batch count: a view mesh's ranks would warp their views through
    other coordinates than one device holding every view.)"""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def compute_homography(K: torch.Tensor, Rt: torch.Tensor) -> torch.Tensor:
    """World ground plane (z=0) -> image homography ``K @ [r1 r2 t]``.

    K: (..., 3, 3); Rt: (..., 4, 4) or (..., 3, 4). Returns (..., 3, 3).
    """
    K3 = K[..., :3, :3].to(torch.float32)
    Rt = Rt.to(torch.float32)
    G = torch.cat([Rt[..., :3, 0:1], Rt[..., :3, 1:2], Rt[..., :3, 3:4]], dim=-1)
    return small_matmul(K3, G)


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
    uvw = small_matmul(pts, H.transpose(-1, -2))
    w = uvw[..., 2]
    w_safe = torch.where(w.abs() < w_eps, torch.ones_like(w), w)
    return uvw[..., :2] / w_safe[..., None], w


def pixel_to_world(uv: torch.Tensor, K: torch.Tensor, Rt: torch.Tensor):
    """Back-project image pixels (..., N, 2) onto the ground plane.

    Returns ((..., N, 2) world xy, (..., N) valid): invalid where the
    homogeneous scale is not finite or |w| < 1e-8 (the horizon), whose xy
    is divided by 1 instead.
    """
    H_i2w = invert_homography(compute_homography(K, Rt))
    pts = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    xyw = torch.einsum("...ij,...nj->...ni", H_i2w, pts)
    w = xyw[..., 2]
    valid = torch.isfinite(w) & (w.abs() >= 1e-8)
    w_safe = torch.where(valid, w, torch.ones_like(w))
    return xyw[..., :2] / w_safe[..., None], valid


def geom_consistency_error(K: torch.Tensor, Rt: torch.Tensor, points_xy: torch.Tensor) -> torch.Tensor:
    """Round trip world -> image -> world of ground points: the mean
    distance in metres, over the points in front of the camera that come
    back finite. A calibration check (``python -m
    vsta_tpu_torch.check_dataset``).

    K: (..., 3, 3); Rt: (..., 4, 4); points_xy: (N, 2). Returns (...).
    """
    pts_h = torch.cat([points_xy, torch.ones_like(points_xy[..., :1])], dim=-1)
    uv, w_fwd = project_points(compute_homography(K, Rt), pts_h)
    xy_back, valid = pixel_to_world(uv, K, Rt)
    vf = (valid & (w_fwd > 1e-6)).to(points_xy.dtype)
    err = torch.linalg.norm(xy_back - points_xy, dim=-1)
    return (err * vf).sum(dim=-1) / torch.clamp(vf.sum(dim=-1), min=1.0)
