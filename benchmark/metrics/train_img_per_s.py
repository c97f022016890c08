"""Images trained in the window over the window's seconds (host clock, from the
first step's call to the synchronise after the last)."""

UNIT = "img/s"


def read(r):
    if r.kind != "train":
        return None
    return r.window["units"] / r.window["seconds"]
