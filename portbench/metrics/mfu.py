"""Device: the whole forward's share of the card's peak.

The least FLOPs of the model for the requests completed in the traced
window (``portbench/work/dgmr_forward.py``: each context stack, latent
stack and sampler pass a request needs, counted once), over the traced
window's seconds, over the configuration's peak.
"""

from portbench.work import dgmr_forward


def read(r):
    if r.trace is None or not r.answers or r.trace.window_s <= 0 or not r.trace.kernels():
        return None
    need = r.least_work
    flops = (need["context"] * dgmr_forward.context(r.config)
             + need["latent"] * dgmr_forward.latent(r.config)
             + need["sampler"] * dgmr_forward.sampler(r.config))
    return 100.0 * r.answers * flops / r.trace.window_s / r.config["peak_flops"]
