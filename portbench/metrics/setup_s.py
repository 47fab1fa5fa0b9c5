"""End to end: seconds from the process's start to the window's start.

Imports, the CUDA context, the kernel library built or loaded from the
checkout's cache, the weights drawn on the card and loaded, the inputs
drawn, and one whole request run to warm every shape the window uses.
"""


def read(r):
    return r.setup_s
