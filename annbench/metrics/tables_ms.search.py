"""``tables_ms.search``: device ms per call of the whole query set, of the
operations the layer file ``layers/tables.json`` claims, from the layers
stretch."""

from annbench.metrics._layer import layer_ms


def read(ctx):
    return layer_ms(ctx, "tables")
