"""End to end: nowcast frames on the host per second of the window.

Every frame of every request completed in the window (requests x S x B x
T), over the seconds from the window's start to the end of the last request
completed.
"""


def read(r):
    return r.answers * r.frames / r.window_s if r.answers else None
