"""Checkpoints in the port's own format: one `torch.save` file per name in
the output directory (the JAX package's `train/checkpoint.py` writes orbax
directories). A save goes to a temporary name in the same directory and is
then renamed over the old file, so a run killed mid-write leaves the last
good checkpoint in place. A restore maps every tensor onto the given device.

`PeriodicCheckpointer` keeps the JAX package's iteration-keyed retention
(fvcore's, as DINOv2's SSL trainer uses it):
  * every `period` iterations it saves `model_{iteration:07d}`;
  * it keeps the newest `max_to_keep` of those (never `model_final` or a
    name of the caller's own);
  * it writes a `last_checkpoint` tag naming the newest save;
  * at `max_iter − 1` it also saves `model_final`.

With several ranks the state is gathered whole by every rank before a save
(`Trainer.state_dict`, `SSLMetaArch.checkpoint_state`), rank 0 alone writes
it, between barriers, in the single-process layout; every rank restores
the whole file and cuts its own shards (`parallel/mesh.py:shard_like`), so
a checkpoint resumes at any world size.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import torch

from ..parallel.dist import barrier, is_main_process

SUFFIX = ".pth"


def checkpoint_path(output_dir, name: str = "checkpoint") -> Path:
    return Path(output_dir).resolve() / f"{name}{SUFFIX}"


def _atomic_write(path: Path, write) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def save_checkpoint(output_dir, state: Dict[str, Any], name: str = "checkpoint") -> Path:
    """Write `state` (nested dicts, lists, tensors and numbers) as
    `<output_dir>/<name>.pth`."""
    path = checkpoint_path(output_dir, name)
    _atomic_write(path, lambda tmp: torch.save(state, tmp))
    return path


def save_on_main(output_dir, state: Dict[str, Any], name: str = "checkpoint") -> None:
    """Rank 0 writes `state` (`save_checkpoint`); every rank waits at a
    barrier before and after, so none reads a half-written file."""
    barrier()
    if is_main_process():
        save_checkpoint(output_dir, state, name=name)
    barrier()


def restore_checkpoint(output_dir, name: str = "checkpoint",
                       map_location: Union[str, torch.device] = "cpu"
                       ) -> Optional[Dict[str, Any]]:
    """The state saved under `name`, its tensors on `map_location`; None when
    there is none (a run starts fresh)."""
    path = checkpoint_path(output_dir, name)
    if not path.exists():
        return None
    return torch.load(path, map_location=map_location, weights_only=True)


class PeriodicCheckpointer:
    def __init__(self, output_dir, period: int, max_iter: Optional[int] = None,
                 max_to_keep: Optional[int] = None):
        self.output_dir = Path(output_dir).resolve()
        self.period = int(period)
        self.max_iter = max_iter
        self.max_to_keep = max_to_keep
        self._recent: List[str] = []
        self.output_dir.mkdir(parents=True, exist_ok=True)

    @property
    def tag_path(self) -> Path:
        return self.output_dir / "last_checkpoint"

    def last_name(self) -> str:
        """The newest save's name by the tag file, '' if there is none."""
        return self.tag_path.read_text().strip() if self.tag_path.exists() else ""

    def save(self, name: str, state: Dict[str, Any]) -> None:
        save_checkpoint(self.output_dir, state, name=name)
        _atomic_write(self.tag_path, lambda tmp: tmp.write_text(name))

    def step(self, iteration: int, state: Dict[str, Any]) -> None:
        """Save what `iteration` calls for; with several ranks every rank
        calls it and rank 0 writes, between barriers."""
        barrier()
        if is_main_process():
            self._step(iteration, state)
        barrier()

    def _step(self, iteration: int, state: Dict[str, Any]) -> None:
        if (iteration + 1) % self.period == 0:
            name = f"model_{iteration:07d}"
            self.save(name, state)
            self._recent.append(name)
            if self.max_to_keep is not None:
                while len(self._recent) > self.max_to_keep:
                    checkpoint_path(self.output_dir, self._recent.pop(0)).unlink(missing_ok=True)
        if self.max_iter is not None and iteration >= self.max_iter - 1:
            self.save("model_final", state)
