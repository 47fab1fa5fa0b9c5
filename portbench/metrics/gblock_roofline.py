"""Kernels: the eval GBlock kernels' share of their roofline.

The least time of the GBlocks' work in the traced window
(``portbench/work/gblock_fused.py``, at the configuration's peak and the
card's bandwidth), over the device time of the kernels named
``gblock_conv``.
"""

from portbench.work import gblock_fused


def read(r):
    if r.trace is None or not r.answers:
        return None
    found = r.trace.kernels(lambda name: "gblock_conv" in name)
    busy = sum(e.end - e.start for e in found)
    if busy <= 0:
        return None
    peak, bw = r.config["peak_flops"], r.config["peak_bytes_per_s"]
    least = sum(max(f / peak, b / bw) for batch in r.forwards
                for f, b in gblock_fused.work(r.config, batch, r.elem))
    return 100.0 * r.answers * least / busy
