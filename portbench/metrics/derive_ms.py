"""Dispatch: stream milliseconds per request of the weight derivations every forward repeats.

The outermost ``dgmr.derive.*`` spans: spectral norm at each weight read
(``sn``), the GBlock folds and the rollouts' weights (``gblock``,
``rollout``) and, on the card, the kernels' layouts of them
(``gblock_layout``, ``rollout_layout``), each timed by CUDA events on its
stream, idle inside included.
"""

from portbench.harness.spans import stream_ms


def read(r):
    return stream_ms(r, lambda name: name.startswith("dgmr.derive."))
