"""Distributed runtime: process groups, the (data, space) mesh, halo exchange.

The counterpart of the reference package's ``parallel/``, which runs a jitted
step over a ``jax.sharding.Mesh``.  Here one process drives one device under
``torch.distributed`` (NCCL on the card, gloo on the CPU): data-parallel
training averages the gradients over the ``data`` axis by one all-reduce a
step; spatially sharded training splits each volume's depth over the
``space`` axis, and its layers exchange halos along it.
"""

from opticalflowscivis_tpu_torch.parallel.mesh import (
    Mesh,
    data_parallel_mesh,
    make_mesh,
    shard_batch,
    trainer_mesh,
)
from opticalflowscivis_tpu_torch.parallel.multihost import initialize_multihost
from opticalflowscivis_tpu_torch.parallel.spatial import DepthShard, volume_batch_sharding

__all__ = ["Mesh", "data_parallel_mesh", "make_mesh", "shard_batch", "trainer_mesh",
           "initialize_multihost", "DepthShard", "volume_batch_sharding"]
