"""Process management (counterpart of the JAX package's `parallel/dist.py`):
one process per GPU, started by `torchrun`, by SLURM's `srun`, or by hand
with `--dist_url tcp://host:port`.

`init_distributed` reads the rank and the world size in the order of the
reference's `init_distributed_mode`:
  1. `RANK`, `WORLD_SIZE` and `LOCAL_RANK`, as `torchrun` sets them;
  2. else `SLURM_PROCID`, `SLURM_NTASKS` and `SLURM_LOCALID`, with
     `MASTER_ADDR` and `MASTER_PORT` from the environment;
  3. else a `tcp://host:port` `--dist_url`, `--local_rank` as the rank and
     `WORLD_SIZE` from the environment.
A single process with none of these stays uninitialised (world size 1).
The backend follows the device the caller asked for: NCCL for `cuda`,
gloo for `cpu`; it is never switched behind the caller's back. The group
gets a timeout, so that a lost rank fails the run instead of hanging it.
"""

from __future__ import annotations

import builtins
import datetime
import os
from typing import Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)


class Ranks(NamedTuple):
    rank: int
    world_size: int
    local_rank: int
    init_method: str


_local_rank = 0


def ranks_from_env(env: Mapping[str, str], dist_url: str = "env://",
                   local_rank: int = 0) -> Optional[Ranks]:
    """The process's place in the job as the environment (or the tcp
    `dist_url`) gives it; None for a single process launched alone."""
    if "RANK" in env and "WORLD_SIZE" in env:
        return Ranks(int(env["RANK"]), int(env["WORLD_SIZE"]),
                     int(env.get("LOCAL_RANK", local_rank)), "env://")
    if "SLURM_PROCID" in env and int(env.get("SLURM_NTASKS", "1")) > 1:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise RuntimeError("a SLURM job of several tasks needs MASTER_ADDR and MASTER_PORT "
                               "(the sbatch script of parallel/launch.py sets them)")
        return Ranks(int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"]),
                     int(env.get("SLURM_LOCALID", "0")),
                     f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}")
    if dist_url.startswith("tcp://") and int(env.get("WORLD_SIZE", "1")) > 1:
        return Ranks(local_rank, int(env["WORLD_SIZE"]), local_rank, dist_url)
    return None


def init_distributed(dist_url: str = "env://", device: str = "cuda",
                     local_rank: int = 0) -> torch.device:
    """Join the job's process group if the process is one of several, and
    return the device this rank runs on (`cuda:<local rank>` for "cuda")."""
    global _local_rank
    kind = torch.device(device).type
    found = None if dist.is_initialized() else ranks_from_env(os.environ, dist_url, local_rank)
    if found is not None:
        _local_rank = found.local_rank
        if kind == "cuda":
            if not torch.cuda.is_available():
                raise SystemExit("error: no CUDA device is available (use --device cpu)")
            # before anything is allocated on the card
            torch.cuda.set_device(found.local_rank)
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                init_method=found.init_method, rank=found.rank,
                                world_size=found.world_size, timeout=TIMEOUT)
    if kind == "cuda" and get_world_size() > 1 and torch.device(device).index is None:
        return torch.device("cuda", get_local_rank())
    return torch.device(device)


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_local_rank() -> int:
    return _local_rank if dist.is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def barrier() -> None:
    if get_world_size() > 1:
        dist.barrier()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ over the ranks, in place; `t` itself at world size 1."""
    if get_world_size() > 1:
        dist.all_reduce(t)
    return t


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks, in place; `t` itself at world size 1."""
    W = get_world_size()
    if W > 1:
        dist.all_reduce(t)
        t.div_(W)
    return t


def average_gradients(params) -> None:
    """The mean over the ranks of each parameter's `.grad` (a missing one
    taken as zeros), one flat all-reduced buffer per dtype in the order of
    `params`; a no-op at world size 1. Only all-reduce is needed, which
    every backend carries on CUDA tensors."""
    W = get_world_size()
    if W == 1:
        return
    by_dtype: dict = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat.div_(W)
        torch._foreach_copy_(grads, [f.view_as(g) for f, g in
                                     zip(flat.split([g.numel() for g in grads]), grads)])


class _GatherRows(torch.autograd.Function):
    """Every rank's tensor stacked (W, ...) by an all-reduce of a zero stack
    holding this rank's slot (adding zeros is exact); the backward sums the
    ranks' gradients of the stack and keeps this rank's slot, as a
    reduce-scatter would."""

    @staticmethod
    def forward(ctx, x):
        ctx.rank = get_rank()
        out = x.new_zeros((get_world_size(),) + tuple(x.shape))
        out[ctx.rank] = x
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad[ctx.rank]


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """(W, *x.shape): every rank's `x`, differentiable on each rank."""
    if get_world_size() == 1:
        return x[None]
    return _GatherRows.apply(x)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of `x` (any count per rank, the same trailing
    shape), concatenated in rank order on every rank; `x` itself at world
    size 1. The counts by one all-reduce, then the rows padded to the
    largest count through `all_gather_with_grad`."""
    W = get_world_size()
    if W == 1:
        return x
    counts = torch.zeros(W, dtype=torch.int64, device=x.device)
    counts[get_rank()] = x.shape[0]
    counts = all_reduce_sum(counts).tolist()
    pad = x.new_zeros((max(counts),) + tuple(x.shape[1:]))
    pad[:x.shape[0]] = x
    with torch.no_grad():
        stack = all_gather_with_grad(pad)
    return torch.cat([stack[r, :c] for r, c in enumerate(counts)])


def print_on_main_only() -> None:
    """Silence `print` on every rank but 0, as the reference's
    `setup_for_distributed` does (`print(..., force=True)` still prints)."""
    if is_main_process():
        return
    plain = builtins.print

    def quiet(*args, force: bool = False, **kwargs):
        if force:
            plain(*args, **kwargs)

    builtins.print = quiet
