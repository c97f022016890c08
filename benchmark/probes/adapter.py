"""CUDA events around every forward of the adapters (`models/adapters.py`'s
`cross_vit` and `cross_cnn`, forward pre- and post-hooks: K1 and their
projections, forward only)."""

from ..trace import Spans


def install(driver) -> Spans:
    return Spans().on_modules(driver.probe_modules()["adapter"])
