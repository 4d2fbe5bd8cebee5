from stratanet2_tpu_torch.models.pointnet2 import (
    PointNet2,
    count_params,
    init_pointnet2,
)

__all__ = ["PointNet2", "count_params", "init_pointnet2"]
