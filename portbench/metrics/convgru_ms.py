"""Model stacks: stream milliseconds per request of the ConvGRUs.

The ``dgmr.convgru`` spans: each level's weights, input-part conv and
rollout kernel, timed by CUDA events on the stream, idle inside included.
"""

from portbench.harness.spans import stream_ms


def read(r):
    return stream_ms(r, lambda name: name == "dgmr.convgru")
