"""Multi-rank sharding layer on ``torch.distributed``: meshes of ranks,
sharded search, sharded k-means (BASELINE config 5).

Port of ``lotus_tpu/parallel``.  A mesh slot is a rank; each rank holds one
shard on its own device and runs the body of the reference's ``shard_map``;
``all_gather`` / ``all_reduce`` stand for ``jax.lax.all_gather`` / ``psum``.
Every rank calls the sharded functions with the same queries and gets the
same merged result.  Under gloo (several ranks sharing one card, or the
CPU) the collectives cross the host; under NCCL each rank has its own card.
"""

from lotus_tpu_torch.parallel.mesh import ShardMesh, default_mesh, shard_rows
from lotus_tpu_torch.parallel.search import sharded_flat_search
from lotus_tpu_torch.parallel.kmeans import sharded_kmeans_fit
from lotus_tpu_torch.parallel.distributed import (
    hybrid_mesh,
    init_runtime,
    load_index_shard,
    save_index_shards,
    serving_mesh,
)
from lotus_tpu_torch.parallel.ivf import (
    load_sharded_ivf_state,
    plan_ivf_shards,
    save_ivf_shards,
    shard_ivf_state,
    sharded_ivf_search,
    sharded_ivf_search_pallas,
)

__all__ = [
    "default_mesh",
    "shard_rows",
    "sharded_flat_search",
    "sharded_kmeans_fit",
    "shard_ivf_state",
    "sharded_ivf_search",
    "sharded_ivf_search_pallas",
    "plan_ivf_shards",
    "save_ivf_shards",
    "load_sharded_ivf_state",
    "init_runtime",
    "hybrid_mesh",
    "serving_mesh",
    "save_index_shards",
    "load_index_shard",
    "ShardMesh",
]
