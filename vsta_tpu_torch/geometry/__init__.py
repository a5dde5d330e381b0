from .homography import compute_homography, invert_homography, project_points, rodrigues
from .bev import (
    bev_indices_to_meters,
    bev_sample_coords_with_depth,
    ground_grid,
    meters_to_bev_indices,
)

__all__ = [
    "rodrigues",
    "compute_homography",
    "invert_homography",
    "project_points",
    "ground_grid",
    "meters_to_bev_indices",
    "bev_indices_to_meters",
    "bev_sample_coords_with_depth",
]
