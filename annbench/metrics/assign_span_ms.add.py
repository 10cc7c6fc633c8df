"""``assign_span_ms.add``: device ms per added segment, of the operations
launched inside the program's ``ivf.assign`` spans (exact assignment), from
the device stretch."""

from annbench.metrics._spans import span_ms


def read(ctx):
    return span_ms(ctx, "ivf.assign")
