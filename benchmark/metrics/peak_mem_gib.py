"""torch.cuda.max_memory_allocated over set-up, warm-up and the window (and the
probes' steps in a traced run), before the reference runs."""

UNIT = "GiB"


def read(r):
    return None if r.peak_bytes is None else r.peak_bytes / 2 ** 30
