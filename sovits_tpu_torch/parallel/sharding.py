"""Parameter sharding over the mesh's "model" axis (counterpart of
``sovits_tpu/parallel/sharding.py``).

The JAX package shards a parameter's output-feature axis over "model" when
that axis is at least ``min_size`` and divisible by the axis size, and
pins the layout on its jitted step so that parameters and AdamW moments
stay sharded across updates. Here FSDP2's ``fully_shard`` holds each
parameter as a DTensor sharded on that axis; the optimizer's moments
follow the parameters' placement, and each forward all-gathers the full
tensors, so the kernels see plain tensors. FSDP2 shards every parameter
somewhere: one that the JAX rule replicates takes FSDP2's default
``Shard(0)``. With a "data" axis over 1 the 2-D mesh gives hybrid
sharding (replicated over "data", sharded over "model").
"""

from __future__ import annotations

from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import Shard

from ..nn.conv import WNConvTranspose1d


def _feature_dims(module: nn.Module) -> dict[int, int]:
    """{id(parameter): its output-feature dim in the port's layout}, for the
    parameters whose counterpart in the JAX package is a kernel or a table:
    the flax kernel's trailing axis is dim 0 of a conv or linear weight
    ([out, in, k...]) and dim 1 of a transposed conv's ([in, out, k]) and of
    an embedding table ([n, features]). Weight norm's g ([out or in, 1, 1]
    here, a vector in the JAX package) and biases have none."""
    dims = {}
    for mod in module.modules():
        if isinstance(mod, WNConvTranspose1d):
            dims[id(mod.weight_v)] = 1
        elif hasattr(mod, "weight_v"):
            dims[id(mod.weight_v)] = 0
        elif isinstance(mod, nn.Embedding):
            dims[id(mod.weight)] = 1
        elif isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            dims[id(getattr(mod, "weight_orig", mod.weight))] = 0
    return dims


def param_spec(param: nn.Parameter, feature_dim: int | None, model_size: int,
               min_size: int = 128) -> Shard | None:
    """``Shard(feature_dim)`` when the JAX rule shards this parameter over
    "model" (its output-feature axis is at least ``min_size`` and divisible
    by the axis size), else None (the JAX rule replicates it)."""
    if feature_dim is None or param.dim() < 2:
        return None
    n = param.shape[feature_dim]
    return Shard(feature_dim) if n >= min_size and n % model_size == 0 else None


def tree_shardings(module: nn.Module, model_size: int, min_size: int = 128) -> dict[str, Shard | None]:
    """{parameter name: its placement on "model" under the JAX rule, or
    None where that rule replicates it}."""
    dims = _feature_dims(module)
    return {name: param_spec(p, dims.get(id(p)), model_size, min_size)
            for name, p in module.named_parameters()}


def shard_params(module: nn.Module, mesh: DeviceMesh | None, min_size: int = 128) -> nn.Module:
    """``fully_shard`` ``module`` over the mesh's "model" axis (hybrid over
    the 2-D mesh when "data" is over 1), each parameter on its
    output-feature dim where the JAX rule shards it. Returns the module,
    which FSDP2 changes in place; with no mesh it is left as it is."""
    if mesh is None:
        return module
    model_size = mesh["model"].size()
    dims = _feature_dims(module)

    def placement(p: nn.Parameter) -> Shard:
        return param_spec(p, dims.get(id(p)), model_size, min_size) or Shard(0)

    target = mesh if mesh["data"].size() > 1 else mesh["model"]
    fully_shard(module, mesh=target, shard_placement_fn=placement)
    return module
