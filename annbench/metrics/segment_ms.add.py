"""``segment_ms.add``: the median host ms of the program's ``ivf.add`` roots
in the device stretch's steps, one a segment. A segment ends in
``add_batch``'s copies of its keys and codes to the host, so its device
work is done inside it."""

import statistics

from annbench.metrics._spans import spans


def read(ctx):
    s = spans(ctx)
    if s is None:
        return None
    return statistics.median(r1 - r0 for r0, r1 in s.roots) / 1e3
