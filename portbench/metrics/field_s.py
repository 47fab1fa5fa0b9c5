"""End to end: seconds per field.

The seconds from the window's start to the end of the last field
completed, over the fields completed. The field in flight when the window's
time is up finishes and counts.
"""


def read(r):
    return r.window_s / r.answers if r.answers else None
