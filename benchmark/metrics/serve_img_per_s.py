"""Frames whose masks reached host memory in the window, over the window's
seconds (host clock)."""

UNIT = "img/s"


def read(r):
    if r.kind != "serve":
        return None
    return r.window["units"] / r.window["seconds"]
