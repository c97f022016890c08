"""CUDA events around every call of a frozen ViT block (`models/vit.py`'s
`backbone.blocks[i]`, forward pre- and post-hooks): both walks."""

from ..trace import Spans


def install(driver) -> Spans:
    return Spans().on_modules(driver.probe_modules()["walk"])
