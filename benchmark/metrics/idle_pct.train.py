"""The share of a short torch.profiler stretch of train steps in which no
operation ran on the card."""

UNIT = "%"
LAYER = "device"
MOVES = "train_img_per_s"
PROBES = ()


def read(r):
    if r.profile is None:
        return None
    return 100.0 * (1.0 - r.profile["busy_s"] / r.profile["window_s"])
