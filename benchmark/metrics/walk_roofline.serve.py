"""The walks' least time, the larger of their frozen operations over the
configuration's peak and their bytes over the card's bandwidth
(counts/flops.py, peaks.json), as a share of walk_ms: the same work whatever
kernel does it."""

UNIT = "%"
LAYER = "kernels of the walks: ops/flash_fwd, fused_qkv, fused_mlp, layernorm and csrc"
MOVES = "serve_img_per_s"
PROBES = ("walk",)


def read(r):
    ms = r.spans.get("walk")
    if ms is None or r.peak_flops is None or r.hbm_bytes_per_s is None:
        return None
    least = max(r.walk_flops_per_step / r.peak_flops, r.walk_bytes_per_step / r.hbm_bytes_per_s)
    return 100.0 * least / (ms / 1e3)
