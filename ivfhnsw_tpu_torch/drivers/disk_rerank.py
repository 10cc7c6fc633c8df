"""Grouping + disk-rerank eval driver on PyTorch. Counterpart of
``ivfhnsw_tpu/drivers/disk_rerank.py`` (the reference's
test_ivfhnsw_grouping_sift1b_disk,
tests/test_ivfhnsw_grouping_sift1b_disk.cpp:237): the grouping pipeline of
``grouping_eval``, but the query loop calls ``search_disk``: an ANN search
for 2k candidates, an exact L2 rerank against the raw base file, the
distance-then-label tiebreak (reference utils.cpp:193-202).

Usage: the flags of ``grouping_eval`` (reference ``-flag value`` grammar
with its -path_* files, plus -synthetic and -device, which defaults to
cuda):
    python -m ivfhnsw_tpu_torch.drivers.disk_rerank -d 128 -nc 16384 \\
        -nsubc 64 -do_opq on -do_pruning on -path_base b.bvecs \\
        -path_learn l.bvecs -path_q q.bvecs -path_gt gt.ivecs \\
        -path_centroids c.fvecs -path_pq x.pq -path_norm_pq x.norm_pq \\
        -path_opq_matrix x.opq -path_precomputed_idxs idxs.ivecs \\
        -path_index x.index -nb 1000000000 -nq 10000 -ngt 1000 \\
        -nprobe 32 -max_codes 10000 -k 10
The rerank reads ``-path_base``; a synthetic corpus is first written to a
temporary .fvecs file, so that the raw-file path is the one that runs.
"""

from __future__ import annotations

import os
import tempfile

from ivfhnsw_tpu_torch.drivers import common as C
from ivfhnsw_tpu_torch.drivers.grouping_eval import build
from ivfhnsw_tpu_torch.utils import io
from ivfhnsw_tpu_torch.utils.config import SearchParams
from ivfhnsw_tpu_torch.utils.recall import recall_at_k


def rerank_eval(index, cfg, ds, base_file: io.XvecFile) -> dict:
    """The timed ``search_disk`` loop + Recall@k in the reference's output
    format."""
    p = cfg.search
    params = SearchParams(k=p.k, nprobe=p.nprobe, max_codes=p.max_codes,
                          do_pruning=p.do_pruning)
    w = C.StopW()
    dists, labels = index.search_disk(ds.queries, params, base_file)
    dt = w.getElapsedTimeMicro()
    recalls = recall_at_k(labels, ds.gt, ks=(1, min(p.k, 10), p.k))
    for k, r in sorted(recalls.items()):
        C.log(f"Recall@{k}: {r:.4f}")
    C.log(f"Time per query: {dt / ds.nq:.1f} us")
    return {"recalls": recalls, "us_per_query": dt / ds.nq, "dists": dists,
            "labels": labels}


def main(argv=None) -> dict:
    cfg, extras = C.parse_driver_args(("synthetic", "device"), argv)
    index, ds, stages = build(cfg, extras)
    if isinstance(ds, C.FileDataset):
        res = rerank_eval(index, cfg, ds,
                          io.XvecFile(cfg.path_base, cfg.index.d))
    else:
        with tempfile.TemporaryDirectory(prefix="disk_rerank_") as tmp:
            path = os.path.join(tmp, "base.fvecs")
            io.write_xvec(path, ds.base)
            res = rerank_eval(index, cfg, ds, io.XvecFile(path, cfg.index.d))
    return {**res, "stages": stages}


if __name__ == "__main__":
    main()
