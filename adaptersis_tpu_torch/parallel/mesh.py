"""The device mesh and parameter sharding (counterpart of the JAX package's
`parallel/mesh.py`): a 2-D mesh ("data", "fsdp") of W // fsdp × fsdp
ranks. Data groups replicate; the "fsdp" group shards a module with FSDP2
(`fully_shard`), which all-gathers each transformer block's parameters
before its forward (the blocks' kernels see whole, plain tensors) and
reduce-scatters the gradients of trained ones. `fsdp_shard` is the
counterpart of `fsdp_shard_params` (the JAX rule shards each large leaf on
its largest divisible axis, FSDP2 each parameter on its first; the numbers
do not depend on the rule); `broadcast_module` of `replicate_tree`.

`shard_batch` has no counterpart: every rank's loader reads only its own
rows of the global batch (`data/samplers.py`), so there is nothing to
scatter. The helpers at the end move state between the sharded modules
and the checkpoint files, which hold whole tensors.
"""

from __future__ import annotations

from typing import Any, Iterable

import torch
import torch.distributed as dist
from torch import nn

from .dist import get_world_size

# the backbone's entry points other than forward, around which FSDP2
# unshards the root's own parameters (tokens, pos_embed, patch_embed, final
# norm). A frozen walk calls the pieces (embed, run_blocks, ...) from
# outside; a trained backbone registers only entry points that call no
# other registered one, since a nested call would hook the root's gradient
# reduction onto an inner output, before the outer backward has finished
FROZEN_METHODS = ("embed", "run_blocks", "collect_block_outputs", "final_norm",
                  "forward_with_masks", "forward_packed_crops", "get_intermediate_layers",
                  "get_last_selfattention")
TRAINED_METHODS = ("forward_with_masks", "forward_packed_crops", "get_intermediate_layers",
                   "get_last_selfattention")


def get_mesh(fsdp: int = 1, device_type: str = "cuda"):
    """The ("data", "fsdp") mesh over the job's W ranks; None for a single
    process. Raises when `fsdp` does not divide W."""
    W = get_world_size()
    if fsdp < 1 or W % fsdp:
        raise ValueError(f"{W} ranks not divisible by fsdp={fsdp}")
    if W == 1:
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (W // fsdp, fsdp), mesh_dim_names=("data", "fsdp"))


def fsdp_shard(module: nn.Module, mesh, methods: Iterable[str] = FROZEN_METHODS) -> nn.Module:
    """FSDP2 over `mesh`: each block of `module.blocks`, then the root, whose
    `methods` (those it has) unshard its own parameters as `forward` does.
    A no-op without a mesh."""
    if mesh is None:
        return module
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    for blk in getattr(module, "blocks", ()):
        fully_shard(blk, mesh=mesh)
    fully_shard(module, mesh=mesh)
    for name in methods:
        if hasattr(module, name):
            register_fsdp_forward_method(module, name)
    return module


def reshard(module: nn.Module) -> None:
    """Put every FSDP2 module under `module` back to its shards (a root
    keeps its parameters whole after a forward that no backward follows)."""
    from torch.distributed.fsdp import FSDPModule

    for m in module.modules():
        if isinstance(m, FSDPModule):
            m.reshard()


def broadcast_module(module: nn.Module, src: int = 0) -> nn.Module:
    """Copy rank `src`'s parameters and buffers to every rank (plain
    tensors only: a sharded module is already consistent)."""
    if get_world_size() > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                if not is_sharded(t):
                    dist.broadcast(t.data, src)
    return module


def is_sharded(t: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a sharded tensor (in-place updates reach the
    parameter), the tensor itself otherwise."""
    return t.to_local() if is_sharded(t) else t


def full(t: Any) -> Any:
    """The whole tensor of a sharded one (a collective: every rank calls
    it), detached; anything else unchanged."""
    return t.detach().full_tensor() if is_sharded(t) else t


def full_tree(obj: Any) -> Any:
    """`full` over nested dicts, lists and tuples (a state dict, an
    optimizer's state)."""
    if isinstance(obj, dict):
        return {k: full_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(full_tree(v) for v in obj)
    return full(obj)


def shard_like(whole: torch.Tensor, like: Any) -> Any:
    """`whole` cut as the sharded `like` is (each rank keeps its own chunk,
    no communication), or `whole` when `like` is a plain tensor."""
    if not is_sharded(like):
        return whole
    from torch.distributed.tensor import distribute_tensor

    whole = whole.detach().to(device=like.device, dtype=like.dtype)
    return distribute_tensor(whole, like.device_mesh, like.placements, src_data_rank=None)


def gather_like(local_t: torch.Tensor, like: Any) -> torch.Tensor:
    """The whole tensor of a per-rank shard `local_t` cut as `like` (an
    optimizer moment kept beside a sharded parameter)."""
    if not is_sharded(like):
        return local_t
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local_t, like.device_mesh, like.placements, shape=like.shape,
                              stride=like.stride()).full_tensor()


def local_like(whole: torch.Tensor, like: Any) -> torch.Tensor:
    """This rank's chunk of `whole`, cut as `like` is."""
    return local(shard_like(whole, like)).clone() if is_sharded(like) else whole
