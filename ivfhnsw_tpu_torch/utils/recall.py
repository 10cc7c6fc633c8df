"""Recall evaluation, replicating the reference drivers' protocol.

Reference semantics (test_ivfhnsw_sift1b.cpp:172-215): the answer set per
query is ONLY the groundtruth top-1, and a query counts as a hit at k if any
of the returned top-k labels equals it.
"""

from __future__ import annotations

import numpy as np


def recall_at_k(labels: np.ndarray, gt: np.ndarray, ks=(1, 10, 100)) -> dict:
    """labels: [nq, >=max(ks)] returned ids; gt: [nq, ngt] groundtruth ids
    (only column 0 is used, matching the reference). Returns {k: recall}."""
    labels = np.asarray(labels)
    true_nn = np.asarray(gt)[:, 0:1]
    out = {}
    for k in ks:
        kk = min(k, labels.shape[1])
        out[k] = float((labels[:, :kk] == true_nn).any(axis=1).mean())
    return out


def rerank_order(dists: np.ndarray, labels: np.ndarray, eps: float = 1e-3):
    """Sort (distance, label) pairs with the reference's comparator `cmp`
    (utils.cpp:193-202): ascending distance, ties within eps broken by
    ascending label. Distances fall into eps-wide buckets, so near-equal
    distances compare equal; then a lexsort by (bucket, label)."""
    dists = np.asarray(dists)
    labels = np.asarray(labels)
    buckets = np.floor(dists / eps).astype(np.int64)
    order = np.lexsort((labels, buckets))
    return dists[order], labels[order]
