"""Model stacks: device milliseconds per request of the library conv and GEMM kernels.

The kernels that cuDNN and cuBLAS (and the CUTLASS kernels they ship) run
for ``F.conv2d`` and matmuls, known by their names: implicit-GEMM and
direct convs, cuDNN's FFT convs (the ``DSE::`` transforms, complex GEMMs,
filter flips), its layout transforms, and cuBLAS's GEMMs, GEMVs and dots
(the spectral norms' ``W v``). The port's own kernels are left out.
"""

import re

LIBRARY = re.compile(r"cudnn|cublas|xmma|cutlass|nvjet|gemm|gemv|conv(?!ert)|winograd|fft|DSE::"
                     r"|flip_filter|region_transform|nchwToNhwc|nhwcToNchw", re.IGNORECASE)
PORT = re.compile(r"gru_rollout|gblock_conv")


def is_library(name):
    return bool(LIBRARY.search(name)) and not PORT.search(name)


def read(r):
    if r.trace is None or not r.answers:
        return None
    found = r.trace.kernels(is_library)
    if not found:
        return None
    return 1e3 * sum(e.end - e.start for e in found) / r.answers
