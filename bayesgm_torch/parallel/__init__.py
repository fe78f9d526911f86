"""Data-parallel runs over ``torch.distributed`` (port of ``bayesgm_tpu/parallel``).

The scalable axes of the workload are the dataset axis ``n`` (per-sample
latent rows and MCMC chains are independent) and the chain axis: both
split by rank over a 1-D ``data`` mesh, one process per rank, with the nets
replicated.  Every ``mesh=`` argument of the models takes a :class:`Mesh`
from :func:`make_mesh`; :mod:`bayesgm_torch.parallel.sharded` holds the
full-batch training step and the sharded MH predict, and
``python -m bayesgm_torch.parallel.dryrun --world N`` drives them all.
"""

from bayesgm_torch.parallel.mesh import (
    Mesh,
    RowSplit,
    data_sharding,
    make_mesh,
    replicate,
    replicated_shard_map,
    rowwise_shard_map,
    shard_rows,
)

__all__ = ["make_mesh", "shard_rows", "replicate", "data_sharding",
           "rowwise_shard_map", "replicated_shard_map"]
