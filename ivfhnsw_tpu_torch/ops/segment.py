"""Deterministic segment sums: the counterpart of ``jax.ops.segment_sum`` as
the JAX package uses it (k-means cluster sums, the grouping index's alpha
statistics).

``Tensor.index_add_`` adds with float atomics on a CUDA tensor, in an order
that changes from run to run, so one seed gave k-means centroids that
differed in their low bits from run to run, and then by whole points. Here
the order of summation is fixed by the data alone: a stable sort puts equal
keys next to each other in input order, and ``torch.segment_reduce`` sums
each run of equal keys on its own, with no atomics. The same inputs give
the same bits on every run.
"""

from __future__ import annotations

import torch


def segment_sum(values: torch.Tensor, keys: torch.Tensor,
                nseg: int) -> torch.Tensor:
    """Sum the rows of ``values`` [n, ...] that share a key: returns
    [nseg, ...] with row s = sum of values[i] over keys[i] == s, in input
    order; 0 for a key that never occurs. Keys must lie in [0, nseg)."""
    sk, order = torch.sort(keys.long(), stable=True)
    bounds = torch.searchsorted(
        sk, torch.arange(nseg + 1, device=keys.device))
    return torch.segment_reduce(values[order], "sum", lengths=bounds.diff(),
                                axis=0, unsafe=True)
