"""The 95th percentile (nearest rank) of the latencies of all requests of the
window: submission to masks in pinned host memory, by CUDA events."""

import math

UNIT = "ms"


def read(r):
    lat = sorted(r.window.get("latency_ms") or [])
    if r.kind != "serve" or not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1]
