"""``coarse_span_ms.search``: device ms per call of the whole query set, of
the operations launched inside the program's ``ivf.coarse`` spans (coarse
selection), from the device stretch."""

from annbench.metrics._spans import span_ms


def read(ctx):
    return span_ms(ctx, "ivf.coarse")
