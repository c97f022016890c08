"""Validation preprocessing (counterpart of the JAX package's
`data/augment.py`: `val_preprocess`, `apply_input_norm`)."""

from __future__ import annotations

import torch


def val_preprocess(images: torch.Tensor) -> torch.Tensor:
    """uint8 → float32 / 255, no normalisation."""
    return images.float() / 255.0


def apply_input_norm(x01: torch.Tensor, mode: str) -> torch.Tensor:
    """Input normalisation after the /255; "none" is the main path's."""
    if mode == "none":
        return x01
    raise NotImplementedError(
        f"input_norm {mode!r} is not ported yet (ROADMAP.md, item M11); only 'none' is")
