"""Device ms a train step spends in the on-device augmentation with CLAHE: CUDA
events around apply_train_augment where train/trainer.py calls it."""

UNIT = "ms"
LAYER = "data augment: data/augment.py, data/clahe.py"
MOVES = "train_img_per_s"
PROBES = ("augment",)


def read(r):
    return r.spans.get("augment")
