"""Host ms spent inside the train step call before it returns, with no probe
installed, averaged over every step of the window."""

UNIT = "ms"
LAYER = "entry: the step call the window drives"
MOVES = "train_img_per_s"
PROBES = ()


def read(r):
    return sum(r.window["dispatch_s"]) / len(r.window["dispatch_s"]) * 1e3
