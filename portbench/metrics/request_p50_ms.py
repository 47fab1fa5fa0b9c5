"""Entry point: the median host milliseconds of a request in the traced window."""

import statistics


def read(r):
    return 1e3 * statistics.median(r.latencies) if r.latencies else None
