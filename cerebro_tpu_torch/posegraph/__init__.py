"""posegraph of the PyTorch port (counterpart of cerebro_tpu.posegraph)."""

from cerebro_tpu_torch.posegraph.distributed import optimize_sharded, pad_graph  # noqa: F401
from cerebro_tpu_torch.posegraph.optimizer import (  # noqa: F401
    PoseGraph,
    initialize_worlds,
    optimize,
    poses_from_xyzyaw,
    relative_se3,
    relative_yaw_t,
    relative_yaw_t_np,
)
