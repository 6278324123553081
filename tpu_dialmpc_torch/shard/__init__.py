"""The sample-parallel planner on torch.distributed (counterpart of
`tpu_dialmpc/shard/`): the sample layout (`mesh.py`), the process-group
bootstrap (`distributed.py`), `ShardedMBDPI` (`planner.py`) and the scaling
reports (`scaling.py`)."""

from tpu_dialmpc_torch.shard.mesh import make_mesh, sample_sharding
from tpu_dialmpc_torch.shard.planner import ShardedMBDPI

__all__ = ["make_mesh", "sample_sharding", "ShardedMBDPI"]
