"""Entry point: idle milliseconds per field put down to the tiler's own steps.

The device's idle gaps whose midpoint lies in a ``dgmr.tiler.*`` step span
(upload, pad, host_buffer, gather, scatter, fetch) and in no
``dgmr.forward`` span.
"""

from portbench.harness.spans import idle_ms


def read(r):
    return idle_ms(r, lambda name: name.startswith("dgmr.tiler."),
                   lambda name: name == "dgmr.forward")
