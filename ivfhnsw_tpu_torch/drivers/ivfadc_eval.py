"""IVFADC end-to-end build + eval driver on PyTorch. Counterpart of
``ivfhnsw_tpu/drivers/ivfadc_eval.py`` (the reference's test_ivfhnsw_sift1b
and test_ivfhnsw_deep1b, which differ only in the base file's element type,
read here by its extension), and of the reference's test_sift1b_orca
add_batch2 exercise with -orca_obuf (any value): add_batch2 over the first
base batch, its ORCV output buffer's size logged and returned, then an
empty builder before the index is read or built.

Usage (reference ``-flag value`` grammar, plus -synthetic, -orca_obuf and
-device, which defaults to cuda; -device cpu runs the kernels' plain
versions):
    python -m ivfhnsw_tpu_torch.drivers.ivfadc_eval -d 128 -nc 16384 \\
        -path_base b.bvecs -path_learn l.bvecs -path_q q.bvecs \\
        -path_gt gt.ivecs -path_centroids c.fvecs -path_pq x.pq \\
        -path_norm_pq x.norm_pq -path_precomputed_idxs idxs.ivecs \\
        -path_index x.index -nb 1000000000 -nt 10000000 -nq 10000 \\
        -ngt 1000 -nprobe 32 -max_codes 10000 -k 10
    python -m ivfhnsw_tpu_torch.drivers.ivfadc_eval -synthetic 0 \\
        -d 128 -nc 4096 -code_size 16 -nb 2000000 -nt 200000 -nq 8192 \\
        -nprobe 32 -max_codes 10000 -k 10
Every -path_* artifact that exists is loaded; one that does not is computed
and written, so a second run resumes from the first one's files.
"""

from __future__ import annotations

import numpy as np

from ivfhnsw_tpu_torch.drivers import common as C
from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex
from ivfhnsw_tpu_torch.models.storage import PostingListBuilder


def build(cfg, extras, obuf: dict | None = None):
    """The build stages of the IVFADC drivers; returns (index, dataset,
    stage record of ``common.build_pipeline``). Given a dict ``obuf``,
    :func:`orca_obuf` runs before the index is read or built and its
    buffer goes into ``obuf["obuf"]``."""
    device, ds = C.driver_setup(cfg, extras)
    index = IVFADCIndex(cfg.index, device)
    hook = None
    if obuf is not None:
        def hook(idxs):
            obuf["obuf"] = orca_obuf(index, ds, idxs)
    return index, ds, C.build_pipeline(index, cfg, ds, before_index=hook)


def orca_obuf(index, ds, idxs) -> bytes:
    """add_batch2 over the first base batch (test_sift1b_orca.cpp:151-158,
    eids 0..n-1), its buffer's size logged; then the builder is emptied,
    before the index is read or built (``read`` seeds the builder)."""
    _, batch = next(ds.base_batches())
    n = batch.shape[0]
    buf = index.add_batch2(batch, np.arange(n, dtype=np.int32), idxs[:n],
                           np.arange(n, dtype=np.uint64))
    C.log(f"add_batch2 obuf: {len(buf)} bytes for {n} vectors")
    index.builder = PostingListBuilder(index.nc, index.config.pq_m)
    return buf


def main(argv=None) -> dict:
    """Returns ``common.eval_search``'s record plus "stages" (the build's
    stage record), "index", "dataset" and, with -orca_obuf, "obuf" (the
    add_batch2 buffer)."""
    cfg, extras = C.parse_driver_args(("synthetic", "device", "orca_obuf"),
                                      argv)
    out = {} if "orca_obuf" in extras else None
    index, ds, stages = build(cfg, extras, out)
    return {**C.eval_search(index, cfg, ds), "stages": stages,
            "index": index, "dataset": ds, **(out or {})}


if __name__ == "__main__":
    main()
