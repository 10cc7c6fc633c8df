"""Time the exact nearest-centroid assignment of the streamed builds and
project the bench stages' exact-assignment seconds from it.

The rows and the centroids are SIFT-like descriptors drawn on the device
(``utils/siftlike.py::SiftLikeDeviceGen``, the scale3sl / scale4 law, two
seeds). ``IVFADCIndex._assign_exact_t`` (float32, TF32 off: the path of
``add_batch_device`` when the routed assigner is off) assigns ``-rows``
rows; each variant ``B:C`` runs the same arithmetic on the first
``-variant_rows`` rows in row batches of B against centroid blocks of C
(``ops/distances.py::streaming_topk_l2``, each block reduced by a
minimum), and ``B:C:topk`` reduces each block with ``torch.topk``
(``ops/topk.py::topk_smallest``) and merges it with ``merge_topk``, the
reduction before the minimum; each is held to the production labels
(equal but where two centroids tie). Host clock, the device
synchronised at both ends, after one warm-up batch.

    python -m ivfhnsw_tpu_torch.tools.assign_probe [-nc 1048576]
        [-rows 2097152] [-variant_rows 524288]
        [-variants 4096:16384,4096:16384:topk] [-device cuda]

Prints one JSON line: the device, seconds and seconds per 1M rows of each
variant, and the projected exact assignment of scale3sl (S3SL_NB rows) and
of scale4's extension (S4_NB - S3SL_NB rows) at that rate.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ivfhnsw_tpu_torch.drivers.common import _sync
from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex
from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
from ivfhnsw_tpu_torch.ops.topk import merge_topk, topk_smallest
from ivfhnsw_tpu_torch.tools import bench, scale3
from ivfhnsw_tpu_torch.utils.config import IndexConfig
from ivfhnsw_tpu_torch.utils.siftlike import SiftLikeDeviceGen


def topk_top1(q: torch.Tensor, points: torch.Tensor, psq: torch.Tensor,
              block: int) -> torch.Tensor:
    """streaming_topk_l2's top-1 with each block reduced by topk_smallest
    and merged by merge_topk."""
    qsq = (q * q).sum(-1)
    best_d = torch.full((q.shape[0], 1), float("inf"), device=q.device)
    best_i = torch.zeros((q.shape[0], 1), dtype=torch.int64, device=q.device)
    for s in range(0, points.shape[0], block):
        dists = (q @ points[s:s + block].T).mul_(-2.0)
        dists.add_(qsq[:, None]).add_(psq[None, s:s + block])
        d, j = topk_smallest(dists, 1)
        best_d, best_i = merge_topk(best_d, best_i, d, j + s, 1)
    return best_i[:, 0]


def assign_variant(idx, x: torch.Tensor, batch: int, block: int,
                   reduce: str = "min") -> torch.Tensor:
    """``_assign_exact_t``'s loop at row batch ``batch`` and centroid block
    ``block``, each block reduced by a minimum or (``reduce`` "topk") by
    :func:`topk_top1`."""
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for off in range(0, x.shape[0], batch):
        if reduce == "topk":
            out[off:off + batch] = topk_top1(x[off:off + batch],
                                             idx.centroids,
                                             idx.centroid_norms, block)
            continue
        _, i = streaming_topk_l2(x[off:off + batch], idx.centroids, 1,
                                 block=block,
                                 point_sqnorms=idx.centroid_norms)
        out[off:off + batch] = i[:, 0]
    return out


def timed(device, fn):
    _sync(device)
    t = time.perf_counter()
    r = fn()
    _sync(device)
    return r, time.perf_counter() - t


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m ivfhnsw_tpu_torch.tools.assign_probe")
    ap.add_argument("-nc", type=int, default=1_048_576)
    ap.add_argument("-rows", type=int, default=2_097_152)
    ap.add_argument("-variant_rows", type=int, default=524_288)
    ap.add_argument("-variants", default="4096:16384,4096:16384:topk")
    ap.add_argument("-device", default="cuda")
    a = ap.parse_args(argv)
    device = scale3.resolve_device(a.device)
    S = bench.FULL
    sg = SiftLikeDeviceGen(device, n_classes=S["S3SL_NCLS"],
                           sigma=S["S3SL_SIGMA"], seed=7,
                           skew=S["S3SL_SKEW"])
    idx = IVFADCIndex(IndexConfig(d=128, nc=a.nc, code_size=16), device)
    idx.set_centroids(sg.batch_device(11, a.nc))
    x = sg.batch_device(12, a.rows)
    sg.release()
    idx._assign_exact_t(x[:4096])                         # warm-up
    ref, sec = timed(device, lambda: idx._assign_exact_t(x))
    per_m = sec / a.rows * 1e6
    out = {"device": bench.device_line(device), "torch": torch.__version__,
           "nc": a.nc, "rows": a.rows, "production_seconds": sec,
           "production_seconds_per_1m_rows": per_m,
           "projected_exact_assign_seconds": {
               "scale3sl": per_m * S["S3SL_NB"] / 1e6,
               "scale4_extension": per_m * (S["S4_NB"] - S["S3SL_NB"]) / 1e6},
           "variants": []}
    n = min(a.variant_rows, a.rows)
    for v in a.variants.split(","):
        b, c, *red = v.split(":")
        b, c, red = int(b), int(c), (red or ["min"])[0]
        assign_variant(idx, x[:4096], b, c, red)
        got, vs = timed(device, lambda: assign_variant(idx, x[:n], b, c,
                                                       red))
        out["variants"].append({
            "batch": b, "block": c, "reduce": red, "rows": n, "seconds": vs,
            "seconds_per_1m_rows": vs / n * 1e6,
            "labels_equal": int((got == ref[:n]).sum()) / n})
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
