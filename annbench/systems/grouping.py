"""The system under test for ``"index": "grouping"`` configurations: the
port's ``IVFADCGroupingIndex``, built as the upstream's grouping
construction orders it (neighbour centroids, the alpha pass over every
base row, the encode pass with the precomputed lists, ``finalize``, the
inter-centroid distances), with pruning as the cell's operating point
sets it."""

from __future__ import annotations

import numpy as np

from annbench.systems.ivfadc import (index_config, install_quantizers,
                                     search_params)
from ivfhnsw_tpu_torch.models.grouping import IVFADCGroupingIndex

__all__ = ["build", "judge_state", "search_params"]


def build(dep, cb, norms, log):
    idx = IVFADCGroupingIndex(index_config(dep.cfg), dep.device)
    install_quantizers(idx, dep, cb, norms)
    idx.compute_neighbor_centroids()
    for i in range(dep.n_chunks()):
        x, keys = dep.chunk(i)
        idx.alpha_pass_device(x, keys)
        del x
    idx.finalize_alphas()
    log("alphas learned")
    for i in range(dep.n_chunks()):
        x, keys = dep.chunk(i)
        off = i * dep.chunk_rows
        idx.add_batch_device(x, np.arange(off, off + x.shape[0],
                                          dtype=np.int32),
                             precomputed_idx=keys)
        del x
    log(f"added {dep.nb} rows")
    idx.finalize()
    idx.compute_inter_centroid_dists()
    idx.do_pruning = bool(dep.cfg["do_pruning"])
    return idx


def judge_state(idx) -> dict:
    """The neighbour lists and group alphas the build derived: the
    reference checks them by themselves, then follows the program from
    them (a near-tie among a row's 64 candidate directions moves a group's
    alpha, so no independent build reproduces every code)."""
    return {"nn": idx.nn_centroid_idxs.clone(), "alphas": idx.alphas.clone()}
