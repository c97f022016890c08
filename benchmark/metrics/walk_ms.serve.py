"""Device ms a serve step spends in the frozen blocks of both walks: CUDA
events from forward pre- and post-hooks on every backbone.blocks[i], summed
over the step."""

UNIT = "ms"
LAYER = "model: frozen walks, models/vit.py"
MOVES = "serve_img_per_s"
PROBES = ("walk",)


def read(r):
    return r.spans.get("walk")
