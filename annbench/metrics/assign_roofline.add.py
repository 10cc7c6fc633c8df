"""``assign_roofline.add``: the f32 operations exact assignment needs, over
the device time of the exact-assignment layer (its GEMMs and
``top1_update``) in the traced segments, against the f32 peak, in %.

Counted from shapes: each row of a segment against each of the nc
centroids takes 2d operations in the GEMM and 3 in the distance epilogue
(x -2, + ||x||^2, + ||c||^2). The bytes (rows, centroids, one key a row)
bound it far less."""

from annbench.metrics._layer import load_peaks


def read(ctx):
    t = ctx.trace
    if t is None or t.n_steps == 0:
        return None
    us = t.layer_us("assign")
    if us <= 0:
        return None
    cfg = ctx.run.cfg
    rows = ctx.run.traffic["segment_rows"] * t.n_steps
    ops = rows * cfg["nc"] * (2 * cfg["d"] + 3)
    return 100.0 * ops / load_peaks()["f32_ops_per_s"] / (us * 1e-6)
