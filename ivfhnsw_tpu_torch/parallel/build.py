"""Sharded index-build step: data-parallel assign + PQ-encode over a shard
group. Counterpart of ``ivfhnsw_tpu/parallel/build.py``.

A batch of base vectors is split over the shards (data parallel); the
centroid table, sharded by range, is all-gathered; each shard assigns its
rows to their nearest centroid and encodes them with the index's own
encoder (``models.ivfadc.encode_batch``: residual, [OPQ rotation,] PQ,
decode, [unrotation,] reconstruction, the norm code of the
reconstruction), so its output equals ``IVFADCIndex._encode_batch``. The
streaming orchestrator around it is :mod:`.pipeline`.
"""

from __future__ import annotations

import torch

from ivfhnsw_tpu_torch.models.ivfadc import encode_batch
from ivfhnsw_tpu_torch.ops.distances import assign_top1


def make_assign_encode_step(group, coarse_block: int = 16384,
                            use_opq: bool = False):
    """The step (the counterpart of the JAX ``make_assign_encode_step``
    under ``shard_map``), as a function

        step(x_parts, centroid_parts, codebooks, R, norm_centroids)
          -> [(keys [b] int32, codes [b, M] u8, norm_codes [b] u8), ...]

    with one entry per shard this process serves (``group.ranks``):
    x_parts, that shard's rows [b, d] f32 on its device; centroid_parts,
    its range of the centroid table [nc_loc, d], the same nc_loc on every
    shard (pad the table with rows of 1e30 to a multiple of the group's
    size, as the JAX pipeline does). codebooks [M, 256, dsub], R [d, d]
    (ignored unless ``use_opq``) and norm_centroids [256] are replicated
    and moved to each shard's device."""

    def step(x_parts, centroid_parts, codebooks, R, norm_centroids):
        cents = group.all_gather(list(centroid_parts), dim=0)    # [nc, d]
        out = []
        for s, x in zip(group.ranks, x_parts):
            dev = group.device(s)
            c = cents.to(dev)
            keys = assign_top1(x, c, block=coarse_block)[1]
            codes, ncodes = encode_batch(
                x, keys, c, codebooks.to(dev), norm_centroids.to(dev),
                R.to(dev) if use_opq else None)
            out.append((keys.to(torch.int32), codes, ncodes))
        return out

    return step
