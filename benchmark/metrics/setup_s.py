"""Seconds from the process's start to the first timed step: imports, the
kernel library's build or load, inputs and weights, the model, and the warm-
up steps."""

UNIT = "s"


def read(r):
    return r.setup_s
