"""Rank-aware logging (counterpart of the JAX package's
`utils/setup_logging.py`; DINOv2's `logging/__init__.py`): a glog-style
formatter, stdout on rank 0 only, a `log.txt` file per rank
(`log.txt.rank<N>` beyond rank 0), and `patch_print_rank0`, which silences
the builtin print on every rank but 0 unless `force` is given. The rank is
`torch.distributed`'s (0 without a process group)."""

from __future__ import annotations

import builtins
import functools
import logging
import os
import sys
from typing import Optional

from ..parallel.dist import get_rank


class _GlogFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        level = {"DEBUG": "D", "INFO": "I", "WARNING": "W", "ERROR": "E",
                 "CRITICAL": "C"}.get(record.levelname, "I")
        prefix = (f"{level}{self.formatTime(record, '%Y%m%d %H:%M:%S')} "
                  f"{record.process} {record.name} {record.filename}:{record.lineno}]")
        return f"{prefix} {record.getMessage()}"


def setup_logging(output_dir: Optional[str] = None, name: str = "adaptersis",
                  level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()
    rank = get_rank()
    if rank == 0:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(_GlogFormatter())
        logger.addHandler(h)
    if output_dir:
        suffix = "" if rank == 0 else f".rank{rank}"
        fh = logging.FileHandler(os.path.join(output_dir, f"log.txt{suffix}"))
        fh.setFormatter(_GlogFormatter())
        logger.addHandler(fh)
    return logger


def patch_print_rank0(force: bool = False) -> None:
    """Builtin print on rank 0 only (every rank with `force`, or a call
    with force=True)."""
    builtin_print = builtins.print

    @functools.wraps(builtin_print)
    def print_(*args, **kwargs):
        if kwargs.pop("force", False) or force or get_rank() == 0:
            builtin_print(*args, **kwargs)

    builtins.print = print_
