"""The frozen analytic FLOPs of a train step (counts/flops.py) times the steps
a second of the window, over the configuration's dense peak (peaks.json);
nothing where the card has no peak there."""

UNIT = "%"
LAYER = "step: train/trainer.py"
MOVES = "train_img_per_s"
PROBES = ()


def read(r):
    if r.peak_flops is None:
        return None
    return 100.0 * r.flops_per_step * r.steps_per_s / r.peak_flops
