"""CUDA events around the on-device augmentation (`data/augment.py`,
`data/clahe.py`) as the program's trainer calls it: its
`apply_train_augment` is wrapped where `train/trainer.py` looks it up."""

from ..trace import Spans


def install(driver) -> Spans:
    module, attr = driver.probe_modules()["augment"]
    return Spans().on_function(module, attr)
