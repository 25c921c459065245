"""parallel of the PyTorch port (counterpart of cerebro_tpu.parallel).

The idiom changes from the JAX package: there, a ``jax.sharding.Mesh`` is
one process driving n devices, and ``shard_map`` runs a function on each
device's shard. Here every device has a process of its own, the processes
are joined in a ``torch.distributed`` process group
(``multihost.init_multihost``: NCCL on CUDA devices, gloo on the CPU), and
every process runs the same program on its own shard; ``mesh.Mesh`` names
the axes over the group's ranks. What the JAX package checks on one
process with 8 virtual CPU devices is checked here with n gloo ranks on
the CPU. NCCL takes one rank per GPU, so a single card runs a mesh of one
rank; the n-shard merge is then held in one process by applying the merge
functions to n row blocks searched one after another.
"""

from cerebro_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh_2d  # noqa: F401
from cerebro_tpu_torch.parallel.sharded_search import (  # noqa: F401
    detect_batch_quantized_sharded,
    detect_batch_sharded,
    gather_db,
    merge_argmax,
    merge_payload_bytes,
    merge_topk,
    shard_db,
    shard_db_quantized,
    sharded_max_and_argmax,
    sharded_max_and_argmax_int8,
    sharded_topk,
)
