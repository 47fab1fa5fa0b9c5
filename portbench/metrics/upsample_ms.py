"""Model stacks: stream milliseconds per request of the UpsampleGBlocks.

The ``dgmr.upsample_gblock`` spans: nearest upsampling, BatchNorm, the
three spectrally normalized convs and the residual add of each level,
eager PyTorch, timed by CUDA events on the stream, idle inside included.
"""

from portbench.harness.spans import stream_ms


def read(r):
    return stream_ms(r, lambda name: name == "dgmr.upsample_gblock")
