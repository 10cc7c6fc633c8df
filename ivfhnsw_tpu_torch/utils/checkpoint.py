"""Whole-index checkpoint directory: one ``.npy`` file per array and a JSON
manifest. Counterpart of the single-index half of
``ivfhnsw_tpu/utils/checkpoint.py`` (``save_index`` / ``load_index``),
with the same file names, dtypes, manifest keys and format string, so a
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
