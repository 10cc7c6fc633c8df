"""Per-query terms of the Grouping(+Pruning) search, shared by both engines
of ``models.grouping.IVFADCGroupingIndex``. Counterpart of the term math in
``ivfhnsw_tpu/models/grouping.py::_grouping_search_core`` (:129-182) and
``ivfhnsw_tpu/ops/pallas/grouping_scan.py::grouping_pallas_search_core``
(:445-504), after IndexIVF_HNSW_Grouping.cpp:188-363.

The distance of a code y in subgroup (probe c, neighbour n, group alpha a):

    d = (1-a)(||q-c||^2 - ||c||^2)        term1, one per probe
        + a(||q-n||^2 - ||n||^2)          term2, one per subgroup
        + ||y||^2 - 2<q, y_R>             norm code + LUT sum

Pruning skips the subgroups whose estimated query-subcentroid distance
qsd = (1-a)||q-c||^2 + a||q-n||^2 - a(1-a)||c-n||^2 is not below the mean
qsd over the subgroups of the probes whose groups, counted before them,
hold fewer than 2 * max_codes codes (:251-262).

Both engines take these terms from :func:`query_terms`, so their pruning
decisions are the same bits and the engines differ only in the scan. The
sharded search (``parallel/sharded_grouping.py``) takes its pieces
(:func:`group_terms`, :func:`pruning_sums`, :func:`prune`) with sums over
the shard group between them.
"""

from __future__ import annotations

import torch

# Bound on the [queries, nc] f32 inner-product block of neighbor_dists.
IP_BLOCK_ELEMS = 1 << 26


def neighbor_dists(queries: torch.Tensor, centroids: torch.Tensor,
                   centroid_norms: torch.Tensor,
                   p_nn: torch.Tensor) -> torch.Tensor:
    """||q - n||^2 = ||q||^2 - 2<q, n> + ||n||^2 for the neighbour centroids
    p_nn [B, P, S] of each query's probes -> [B, P, S] f32. The inner
    products come from one matmul against all centroids per block of
    queries (the JAX package gathers [B, S, d] centroid rows per probe
    instead: 64x the bytes at nsubc=64)."""
    B = queries.shape[0]
    q_sq = (queries * queries).sum(dim=1)
    step = max(1, IP_BLOCK_ELEMS // max(1, centroids.shape[0]))
    ip = torch.empty(p_nn.shape, dtype=torch.float32, device=queries.device)
    for s in range(0, B, step):
        blk = queries[s:s + step] @ centroids.T               # [b, nc]
        ip[s:s + step] = torch.gather(
            blk, 1, p_nn[s:s + step].reshape(blk.shape[0], -1)
        ).reshape(p_nn[s:s + step].shape)
    return q_sq[:, None, None] - 2.0 * ip + centroid_norms[p_nn]


def group_terms(queries: torch.Tensor, qc_dists: torch.Tensor,
                probes: torch.Tensor, centroids: torch.Tensor,
                centroid_norms: torch.Tensor, nn_idxs: torch.Tensor,
                alphas: torch.Tensor, inter_dists: torch.Tensor,
                sub_sizes: torch.Tensor, with_qsd: bool,
                groups: torch.Tensor | None = None):
    """The per-probe grouping terms of a query batch. queries [B, d];
    qc_dists, probes [B, P] (ascending coarse distance, ids into centroids
    [nc, d] / centroid_norms [nc]); nn_idxs, inter_dists, sub_sizes
    [ng, S] and alphas [ng], the per-group state, indexed by ``groups``
    [B, P] (default: ``probes``; a shard passes its local group ids).

    Returns (term1 [B, P] f32, term2 [B, P, S] f32, qsd [B, P, S] f32 —
    the estimated query-subcentroid distance, None unless ``with_qsd`` —,
    ssz [B, P, S] int64 subgroup sizes)."""
    p = probes.long()
    g = p if groups is None else groups.long()
    p_nn = nn_idxs[g]                                         # [B, P, S]
    qn = neighbor_dists(queries, centroids, centroid_norms, p_nn)
    a = alphas[g]                                             # [B, P]
    one_m_a = (1.0 - a)[:, :, None]
    a_b = a[:, :, None]
    qsd = (one_m_a * qc_dists[:, :, None] + a_b * qn
           - a_b * one_m_a * inter_dists[g]) if with_qsd else None
    term1 = (1.0 - a) * (qc_dists - centroid_norms[p])
    term2 = a_b * (qn - centroid_norms[p_nn])
    return term1, term2, qsd, sub_sizes[g]


def pruning_sums(qsd: torch.Tensor, ssz: torch.Tensor,
                 group_sizes: torch.Tensor, max_codes: int):
    """The two parts of the pruning threshold (the mean qsd over the
    non-empty subgroups of the probes whose groups, counted before them by
    ``group_sizes`` [B, P], hold fewer than 2 * max_codes codes): (sum of
    those qsd [B] f32, their count [B] int64)."""
    g_cum_before = torch.cumsum(group_sizes, dim=1) - group_sizes
    thr_probe = (g_cum_before < 2 * max_codes) | (max_codes <= 0)
    thr_mask = (ssz > 0) & thr_probe[:, :, None]
    return (torch.where(thr_mask, qsd, 0.0).sum(dim=(1, 2)),
            thr_mask.sum(dim=(1, 2)))


def prune(qsd: torch.Tensor, ssz: torch.Tensor, total: torch.Tensor,
          count: torch.Tensor) -> torch.Tensor:
    """[B, P, S] bool: the non-empty subgroups whose qsd is below the
    threshold total / count (:func:`pruning_sums`)."""
    threshold = total / count.clamp_min(1)
    return (ssz > 0) & (qsd < threshold[:, None, None])


def query_terms(queries: torch.Tensor, qc_dists: torch.Tensor,
                probes: torch.Tensor, centroids: torch.Tensor,
                centroid_norms: torch.Tensor, nn_idxs: torch.Tensor,
                alphas: torch.Tensor, inter_dists: torch.Tensor,
                sub_sizes: torch.Tensor, max_codes: int, do_pruning: bool):
    """The grouping terms of a query batch. queries [B, d]; qc_dists,
    probes [B, P] (ascending coarse distance); nn_idxs, inter_dists,
    sub_sizes [nc, S]; alphas [nc].

    Returns (term1 [B, P] f32, term2 [B, P, S] f32,
             scan [B, P, S] bool — subgroup non-empty and not pruned,
             ssz [B, P, S] int64 — subgroup sizes)."""
    term1, term2, qsd, ssz = group_terms(
        queries, qc_dists, probes, centroids, centroid_norms, nn_idxs,
        alphas, inter_dists, sub_sizes, do_pruning)
    if do_pruning:
        scan = prune(qsd, ssz, *pruning_sums(qsd, ssz, ssz.sum(dim=2),
                                             max_codes))
    else:
        scan = ssz > 0
    return term1, term2, scan, ssz


def subgroup_windows(scan: torch.Tensor, ssz: torch.Tensor,
                     groups: torch.Tensor, budget_sizes: torch.Tensor,
                     max_codes: int):
    """The portable engine's scan windows: each probe's scanned subgroups
    (lists groups * S + subc of the store), the probe admitted by the
    max_codes budget over ``budget_sizes`` [B, P] (unpruned codes per
    probe). Returns (lists [B, P*S] int64, sizes [B, P*S] int64,
    included [B, P] bool)."""
    B, P, S = ssz.shape
    eff = torch.where(scan, ssz, 0)
    inc = probe_budget(budget_sizes, max_codes)
    lists = groups.long()[:, :, None] * S + torch.arange(S,
                                                         device=ssz.device)
    return (lists.reshape(B, -1), (eff * inc[:, :, None]).reshape(B, -1),
            inc)


def probe_budget(eff_sizes: torch.Tensor, max_codes: int) -> torch.Tensor:
    """[B, P] bool: probes the max_codes budget admits, counted over the
    unpruned sizes of the probes before them (the reference's ncode
    accounting, IndexIVF_HNSW_Grouping.cpp:350-353)."""
    cum_before = torch.cumsum(eff_sizes, dim=1) - eff_sizes
    return (cum_before < max_codes) | (max_codes <= 0)
