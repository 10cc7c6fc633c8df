"""Checkpoint directories: one ``.npy`` file per array and a JSON
manifest. Counterpart of ``ivfhnsw_tpu/utils/checkpoint.py``: the whole
index (``save_index`` / ``load_index``) and the per-shard layout of a
sharded index (``save_sharded`` / ``load_sharded_arrays``, and
``load_sharded``, which builds a ``parallel.ShardedIVFADC`` from it), with
the same file names, dtypes, manifest keys and format strings, so a
checkpoint written by either package loads in the other.

The reference's own persistence is stage-granular files (the ``.index``
formats, faiss ``.pq``, the precomputed assignments), which ``write`` /
``read`` and the drivers reproduce byte for byte; this directory is the
flat-array layer beside them: no per-list framing, self-describing.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

MANIFEST = "manifest.json"
FORMAT = "ivfhnsw_tpu.checkpoint.v1"


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_index(index, path: str) -> None:
    """Save an ``IVFADCIndex`` or ``IVFADCGroupingIndex`` (finalized first
    if it is not) into the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    store = index._ensure_store()
    grouping = getattr(index.config, "nsubc", 0) > 0
    manifest = {"format": FORMAT,
                "config": dataclasses.asdict(index.config),
                "ntotal": store.ntotal, "grouping": grouping}
    arrays = {
        "centroids": index.centroids,
        "centroid_norms": index.centroid_norms,
        "pq_codebooks": index.pq.codebooks,
        "norm_centroids": index.norm_pq.centroids,
        "codes": store.codes,
        "ids": store.ids,
        "norm_codes": store.norm_codes,
        "list_offsets": store.list_offsets,
    }
    if index.do_opq:
        arrays["opq_R"] = index.opq_R
    if grouping:
        # int32 on disk, as the JAX package keeps its neighbour ids
        arrays["nn_centroid_idxs"] = _host(index.nn_centroid_idxs).astype(
            np.int32)
        arrays["inter_centroid_dists"] = index.inter_centroid_dists
        arrays["alphas"] = index.alphas
    for name, arr in arrays.items():
        np.save(os.path.join(path, f"{name}.npy"), _host(arr))
    manifest["arrays"] = sorted(arrays)
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)


def load_index(path: str, device):
    """The index of a checkpoint directory, its tensors on ``device``. The
    builder is seeded from the store (as ``read`` seeds it), so
    ``add_batch`` + ``finalize`` extend the loaded index."""
    from ivfhnsw_tpu_torch.models.grouping import IVFADCGroupingIndex
    from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex
    from ivfhnsw_tpu_torch.utils.config import IndexConfig

    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"unrecognized checkpoint format in {path}")
    cfg = IndexConfig(**manifest["config"])
    a = {name: np.load(os.path.join(path, f"{name}.npy"))
         for name in manifest["arrays"]}
    common = (cfg, a["centroids"], a["pq_codebooks"], a["norm_centroids"],
              a["codes"], a["ids"], a["norm_codes"], a["list_offsets"])
    if manifest["grouping"]:
        index = IVFADCGroupingIndex.from_numpy_state(
            *common, a["nn_centroid_idxs"], a["alphas"],
            a["inter_centroid_dists"], a.get("opq_R"), device)
    else:
        index = IVFADCIndex.from_numpy_state(*common, device,
                                             opq_R=a.get("opq_R"))
    index.centroid_norms = index._tensor(a["centroid_norms"])
    return index


SHARDED_FORMAT = "ivfhnsw_tpu.sharded_checkpoint.v1"
SHARD_ARRAYS = ("centroids", "centroid_norms", "codes", "ids", "norm_codes",
                "offsets")
REPLICATED = ("codebooks", "norm_centroids", "R")


def save_sharded(sharded, path: str) -> None:
    """Per-shard checkpoint of a ``parallel.ShardedIVFADC``, the files of
    the JAX package's ``save_sharded`` byte for byte: a manifest
    (format, n_shards, nc_loc), ``<name>.shardNNN.npy`` for each shard's
    centroids, centroid_norms, codes, ids, norm_codes and offsets (the
    store padded to the largest shard's load, ids -1, as the JAX layout
    holds it in memory; offsets and ids int32), and the replicated
    codebooks, norm_centroids and R ((0, 0) without OPQ). Each process of
    a distributed group writes the shards it serves; the one serving
    shard 0 writes the manifest and the replicated arrays."""
    os.makedirs(path, exist_ok=True)
    g = sharded.group
    loads = g.all_gather([torch.tensor([sh.store.ntotal], device=sh.device)
                          for sh in sharded.shards])
    nmax = max(int(loads.max()), 1)
    for sh in sharded.shards:
        st, n = sh.store, sh.store.ntotal
        codes = np.zeros((nmax, st.code_m), np.uint8)
        ids = np.full(nmax, -1, np.int32)
        ncodes = np.zeros(nmax, np.uint8)
        codes[:n], ids[:n], ncodes[:n] = st.codes, st.ids, st.norm_codes
        arrays = {"centroids": _host(sh.centroids),
                  "centroid_norms": _host(sh.centroid_norms),
                  "codes": codes, "ids": ids, "norm_codes": ncodes,
                  "offsets": st.list_offsets.astype(np.int32)}
        for name in SHARD_ARRAYS:
            np.save(os.path.join(path, f"{name}.shard{sh.rank:03d}.npy"),
                    arrays[name])
    if 0 in g.ranks:
        sh = sharded.shards[0]
        R = (_host(sh.R) if sh.R is not None
             else np.zeros((0, 0), np.float32))
        for name, arr in zip(REPLICATED, (_host(sh.codebooks),
                                          _host(sh.norm_centroids), R)):
            np.save(os.path.join(path, f"{name}.npy"), arr)
        with open(os.path.join(path, MANIFEST), "w") as f:
            json.dump({"format": SHARDED_FORMAT, "n_shards": g.size,
                       "nc_loc": sharded.nc_loc}, f, indent=2)


def load_sharded_arrays(path: str, shard: int) -> dict:
    """One shard's arrays of a sharded checkpoint (either package's), with
    the replicated ones and the manifest: the host-local restore."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != SHARDED_FORMAT:
        raise ValueError(f"unrecognized sharded checkpoint format in {path}")
    out = {"manifest": manifest}
    for name in SHARD_ARRAYS:
        out[name] = np.load(os.path.join(path, f"{name}.shard{shard:03d}.npy"))
    for name in REPLICATED:
        out[name] = np.load(os.path.join(path, f"{name}.npy"))
    return out


def load_sharded(path: str, group):
    """The ``parallel.ShardedIVFADC`` of a sharded checkpoint over
    ``group``, with only the shards this process serves read from disk
    (each shard's padding dropped). The group's size must be the
    checkpoint's shard count."""
    from ivfhnsw_tpu_torch.models.storage import PostingListStore
    from ivfhnsw_tpu_torch.parallel.sharded import ShardedIVFADC

    shards, a = {}, None
    for s in group.ranks:
        a = load_sharded_arrays(path, s)
        if a["manifest"]["n_shards"] != group.size:
            raise ValueError(f"{path} holds {a['manifest']['n_shards']} "
                             f"shards, the group has {group.size}")
        n = int(a["offsets"][-1])
        shards[s] = (a["centroids"], a["centroid_norms"], PostingListStore(
            codes=a["codes"][:n], ids=a["ids"][:n],
            norm_codes=a["norm_codes"][:n], list_offsets=a["offsets"],
            nc=a["offsets"].shape[0] - 1, device=group.device(s)))
    return ShardedIVFADC.from_arrays(
        group, a["manifest"]["nc_loc"], shards, a["codebooks"],
        a["norm_centroids"], a["R"] if a["R"].size else None)
