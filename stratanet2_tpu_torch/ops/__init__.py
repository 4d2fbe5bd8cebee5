"""Point-cloud ops of the port. Kernels and their plain versions live in
`cuda_kernels.py`; the modules here hold the logic around them."""

from stratanet2_tpu_torch.ops.ballquery import ball_query_grouped
from stratanet2_tpu_torch.ops.fps import farthest_point_sampling
from stratanet2_tpu_torch.ops.knn import knn_interpolate
from stratanet2_tpu_torch.ops.projection import (
    batched_raster_projection,
    plotwise_coverages,
    raster_projection,
)

__all__ = [
    "ball_query_grouped",
    "farthest_point_sampling",
    "knn_interpolate",
    "plotwise_coverages",
    "raster_projection",
    "batched_raster_projection",
]
