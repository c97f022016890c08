"""Device ms a serve step spends in the adapters' forwards: CUDA events from
forward pre- and post-hooks on cross_vit and cross_cnn (the backward, K2, is
not in it)."""

UNIT = "ms"
LAYER = "model: adapters, models/adapters.py and ops/msda_cuda.py"
MOVES = "serve_img_per_s"
PROBES = ("adapter",)


def read(r):
    return r.spans.get("adapter")
