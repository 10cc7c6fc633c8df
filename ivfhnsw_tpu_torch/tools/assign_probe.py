"""Time the exact nearest-centroid assignment of the streamed builds and
project the bench stages' exact-assignment seconds from it.

The rows and the centroids are SIFT-like descriptors drawn on the device
(``utils/siftlike.py::SiftLikeDeviceGen``, the scale3sl / scale4 law, two
seeds). ``IVFADCIndex._assign_exact_t`` (float32, TF32 off: the path of
``add_batch_device`` when the routed assigner is off) assigns ``-rows``
rows; each variant ``B:C:reduce`` runs ``_assign_exact_t``'s loop on the
first ``-variant_rows`` rows in row batches of B against centroid blocks
of C, each score block reduced by

- ``kernel`` (the default, the production path): ``streaming_topk_l2``,
  the GEMM then ``ops/cuda/assign_min.py::top1_update`` (one read of the
  block);
- ``passes``: the composition the kernel replaced, ``mul_(-2)``,
  ``add_(||q||^2)``, ``add_(||c||^2)``, ``min`` and ``merge_topk`` (four
  passes over the block);
- ``topk``: the same with ``torch.topk`` (``ops/topk.py::topk_smallest``)
  in place of ``min``, the reduction before the minimum;
- ``gemm``: the score GEMMs alone, no reduction (no labels).

Each is held to the production labels (equal but where two centroids
tie). Host clock, the device synchronised at both ends, after one warm-up
batch.

    python -m ivfhnsw_tpu_torch.tools.assign_probe [-nc 1048576]
        [-rows 2097152] [-variant_rows 524288]
        [-variants 4096:16384:kernel,4096:16384:passes,4096:16384:gemm]
        [-device cuda]

Prints one JSON line: the device, seconds and seconds per 1M rows of the
production path and of each variant, and the projected exact assignment of
scale3sl (S3SL_NB rows) and of scale4's extension (S4_NB - S3SL_NB rows) at
the production rate.
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


REDUCES = ("kernel", "passes", "topk", "gemm")


def reduce_top1(q: torch.Tensor, points: torch.Tensor, psq: torch.Tensor,
                block: int, reduce: str) -> torch.Tensor | None:
    """streaming_topk_l2's top-1 as it was before the kernel: each block
    formed by mul_ / add_ / add_, reduced by a minimum (``passes``) or by
    topk_smallest (``topk``) and merged by merge_topk; ``gemm`` computes the
    blocks' products alone and returns None."""
    qsq = (q * q).sum(-1)
    best_d = torch.full((q.shape[0], 1), float("inf"), device=q.device)
    best_i = torch.zeros((q.shape[0], 1), dtype=torch.int64, device=q.device)
    for s in range(0, points.shape[0], block):
        dists = q @ points[s:s + block].T
        if reduce == "gemm":
            continue
        dists.mul_(-2.0).add_(qsq[:, None]).add_(psq[None, s:s + block])
        if reduce == "topk":
            d, j = topk_smallest(dists, 1)
        else:
            d, j = dists.min(dim=1, keepdim=True)
        best_d, best_i = merge_topk(best_d, best_i, d, j + s, 1)
    return None if reduce == "gemm" else best_i[:, 0]


def assign_variant(idx, x: torch.Tensor, batch: int, block: int,
                   reduce: str = "kernel") -> torch.Tensor:
    """``_assign_exact_t``'s loop at row batch ``batch`` and centroid block
    ``block``, each block reduced as ``reduce`` (:data:`REDUCES`) says; ids
    -1 under ``gemm``."""
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce {reduce!r}, expected one of "
                         f"{REDUCES}")
    out = torch.full((x.shape[0],), -1, dtype=torch.int64, device=x.device)
    for off in range(0, x.shape[0], batch):
        if reduce == "kernel":
            _, i = streaming_topk_l2(x[off:off + batch], idx.centroids, 1,
                                     block=block,
                                     point_sqnorms=idx.centroid_norms)
            out[off:off + batch] = i[:, 0]
            continue
        i = reduce_top1(x[off:off + batch], idx.centroids,
                        idx.centroid_norms, block, reduce)
        if i is not None:
            out[off:off + batch] = i
    return out


def moved_labels(x: torch.Tensor, centroids: torch.Tensor,
                 got: torch.Tensor, ref: torch.Tensor) -> dict:
    """The share of ``got`` equal to ``ref``, and how many of the rest do
    not lie at exactly ref's distance in float64 (0: every moved id is an
    exact tie)."""
    moved = torch.nonzero(got != ref)[:, 0]
    xr = x[moved].double()
    da = ((xr - centroids[got[moved]].double()) ** 2).sum(-1)
    db = ((xr - centroids[ref[moved]].double()) ** 2).sum(-1)
    return {"labels_equal": 1.0 - len(moved) / len(ref),
            "labels_moved_off_tie": int((da != db).sum())}


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
    ap.add_argument("-variants", default="4096:16384:kernel,4096:16384:passes,"
                    "4096:16384:gemm")
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
        b, c, red = int(b), int(c), (red or ["kernel"])[0]
        assign_variant(idx, x[:4096], b, c, red)
        got, vs = timed(device, lambda: assign_variant(idx, x[:n], b, c,
                                                       red))
        out["variants"].append({
            "batch": b, "block": c, "reduce": red, "rows": n, "seconds": vs,
            "seconds_per_1m_rows": vs / n * 1e6,
            **({"labels_equal": None, "labels_moved_off_tie": None}
               if red == "gemm" else moved_labels(x[:n], idx.centroids,
                                                  got, ref[:n]))})
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
