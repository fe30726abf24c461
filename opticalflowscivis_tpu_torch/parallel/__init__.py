"""Distributed runtime: process groups, the (data, space) mesh, halo exchange.

The counterpart of the reference package's ``parallel/``, which runs a jitted
step over a ``jax.sharding.Mesh``.  Here one process drives one device under
``torch.distributed`` (NCCL on the card, gloo on the CPU): data-parallel
training averages the gradients over the ``data`` axis by one all-reduce a
step, and the depth-sharded 3-D warp exchanges halos along the ``space``
axis.
"""

from opticalflowscivis_tpu_torch.parallel.mesh import (
    Mesh,
    data_parallel_mesh,
    make_mesh,
    shard_batch,
)
from opticalflowscivis_tpu_torch.parallel.multihost import initialize_multihost

__all__ = ["Mesh", "data_parallel_mesh", "make_mesh", "shard_batch", "initialize_multihost"]
