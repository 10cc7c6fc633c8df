"""``encode_ms.add``: device ms per added segment, of the operations the
layer file ``layers/encode.json`` claims, from the layers stretch."""

from annbench.metrics._layer import layer_ms


def read(ctx):
    return layer_ms(ctx, "encode")
