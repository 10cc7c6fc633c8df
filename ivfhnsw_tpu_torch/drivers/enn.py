"""Exact-NN self-test driver on PyTorch. Counterpart of
``ivfhnsw_tpu/drivers/enn.py`` (the reference's test_ivfhnsw_sift1b_enn,
tests/test_ivfhnsw_sift1b_enn.cpp:27-44): the queries are the first ``nq``
stored base vectors, the ground truth is the identity, and a k=1, nprobe=1
search (``IVFADCIndex.search_enn``) must find each vector itself. Logs
Recall@1 and the time per query.

Usage (the flags of ``ivfadc_eval``: the reference ``-flag value`` grammar
with its -path_* files, plus -synthetic and -device, which defaults to
cuda; -device cpu runs the kernels' plain versions):
    python -m ivfhnsw_tpu_torch.drivers.enn -d 128 -nc 16384 \\
        -path_base b.bvecs -path_learn l.bvecs -path_q q.bvecs \\
        -path_gt gt.ivecs -path_centroids c.fvecs -path_pq x.pq \\
        -path_norm_pq x.norm_pq -path_precomputed_idxs idxs.ivecs \\
        -path_index x.index -nb 1000000000 -nt 10000000 -nq 10000
    python -m ivfhnsw_tpu_torch.drivers.enn -synthetic 0 \\
        -d 128 -nc 4096 -code_size 16 -nb 2000000 -nt 200000 -nq 10000
"""

from __future__ import annotations

import numpy as np

from ivfhnsw_tpu_torch.drivers import common as C
from ivfhnsw_tpu_torch.drivers.ivfadc_eval import build


def main(argv=None) -> float:
    cfg, extras = C.parse_driver_args(("synthetic", "device"), argv)
    index, ds, _ = build(cfg, extras)
    nq = min(cfg.nq or 10_000, ds.total_base)
    _, first = next(ds.base_batches())
    queries = first[:nq]
    index.search_enn(queries[:min(256, nq)])  # warm-up (kernel build and load)
    w = C.StopW()
    _, labels = index.search_enn(queries)
    dt = w.getElapsedTimeMicro()
    rate = float((labels == np.arange(nq)).mean())
    C.log(f"Recall@1: {rate:.4f}")
    C.log(f"Time per query: {dt / nq:.1f} us")
    return rate


if __name__ == "__main__":
    main()
