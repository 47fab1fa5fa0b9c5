"""Dispatch: idle milliseconds per request put down to the model's forwards.

The device's idle gaps whose midpoint lies in a ``dgmr.forward`` span: the
host did not keep the card fed while it dispatched a forward.
"""

from portbench.harness.spans import idle_ms


def read(r):
    return idle_ms(r, lambda name: name == "dgmr.forward")
