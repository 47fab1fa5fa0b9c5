"""Kernels: the ConvGRU rollout kernels' share of their roofline.

The least time of the rollouts' work in the traced window (each rollout's
FLOPs at the configuration's peak or its bytes at the card's bandwidth,
whichever is longer: ``portbench/work/gru_rollout.py``), over the device
time of the kernels named ``gru_rollout``.
"""

from portbench.work import gru_rollout


def read(r):
    if r.trace is None or not r.answers:
        return None
    found = r.trace.kernels(lambda name: "gru_rollout" in name)
    busy = sum(e.end - e.start for e in found)
    if busy <= 0:
        return None
    peak, bw = r.config["peak_flops"], r.config["peak_bytes_per_s"]
    least = sum(max(f / peak, b / bw) for batch in r.forwards
                for f, b in gru_rollout.work(r.config, batch, r.elem))
    return 100.0 * r.answers * least / busy
