"""``topk_span_ms.search``: device ms per call of the whole query set, of
the operations launched inside the program's ``ivf.topk`` spans (the bin-32
min over the padded scan output, the top-k, the labels), from the device
stretch."""

from annbench.metrics._spans import span_ms


def read(ctx):
    return span_ms(ctx, "ivf.topk")
