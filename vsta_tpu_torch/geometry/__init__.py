from .homography import (
    compute_homography,
    geom_consistency_error,
    invert_homography,
    pixel_to_world,
    project_points,
    rodrigues,
)
from .bev import (
    bev_indices_to_meters,
    bev_sample_coords,
    bev_sample_coords_with_depth,
    ground_grid,
    meters_to_bev_indices,
)

__all__ = [
    "rodrigues",
    "compute_homography",
    "invert_homography",
    "project_points",
    "pixel_to_world",
    "geom_consistency_error",
    "ground_grid",
    "meters_to_bev_indices",
    "bev_indices_to_meters",
    "bev_sample_coords",
    "bev_sample_coords_with_depth",
]
