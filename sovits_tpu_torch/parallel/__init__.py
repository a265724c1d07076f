"""The device mesh, parameter sharding and the time-sharded decode
(counterpart of ``sovits_tpu/parallel/``)."""

from .mesh import (
    data_sharding,
    make_mesh,
    replicate_tree,
    replicated,
    shard_batch,
)
from .sharding import param_spec, shard_params, tree_shardings
