"""Dispatch: kernel records on the device per request (memcpys and memsets not counted)."""


def read(r):
    if r.trace is None or not r.answers:
        return None
    n = len(r.trace.kernels())
    return n / r.answers if n else None
