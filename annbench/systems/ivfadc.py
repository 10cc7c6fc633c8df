"""The system under test for ``"index": "ivfadc"`` configurations: the
port's ``IVFADCIndex``, built through its normal path (``set_centroids``,
the quantizers, ``add_batch`` with the precomputed lists, ``finalize``)
from the deployment's data."""

from __future__ import annotations

import numpy as np

from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex
from ivfhnsw_tpu_torch.utils.config import IndexConfig, SearchParams


def index_config(cfg: dict) -> IndexConfig:
    return IndexConfig(d=cfg["d"], nc=cfg["nc"], code_size=cfg["code_size"],
                       do_opq=cfg["do_opq"], nsubc=cfg.get("nsubc", 0))


def search_params(cfg: dict) -> SearchParams:
    return SearchParams(k=cfg["k"], nprobe=cfg["nprobe"],
                        max_codes=cfg["max_codes"],
                        do_pruning=cfg.get("do_pruning", False))


def install_quantizers(idx, dep, cb, norms) -> None:
    idx.set_centroids(dep.centroids)
    idx.pq.codebooks = cb
    idx.norm_pq.centroids = norms
    if dep.rotation is not None:
        idx.opq_R = dep.rotation


def build(dep, cb, norms, log):
    """The index over the deployment's nb base rows (ids = row numbers)."""
    idx = IVFADCIndex(index_config(dep.cfg), dep.device)
    install_quantizers(idx, dep, cb, norms)
    for i in range(dep.n_chunks()):
        x, keys = dep.chunk(i)
        off = i * dep.chunk_rows
        idx.add_batch(x, np.arange(off, off + x.shape[0], dtype=np.int32),
                      precomputed_idx=keys)
        del x
    log(f"added {dep.nb} rows")
    idx.finalize()
    return idx


def judge_state(idx) -> dict:
    """Derived state the reference takes as its start (none for IVFADC)."""
    return {}
