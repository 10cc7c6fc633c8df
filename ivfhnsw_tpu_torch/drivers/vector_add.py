"""Incremental vector-add driver on PyTorch. Counterpart of
``ivfhnsw_tpu/drivers/vector_add.py`` (the reference's
test_ivfhnsw_grouping_sift1b_vector_add,
tests/test_ivfhnsw_grouping_sift1b_vector_add.cpp:97-127, 262-274):
discover base / precomputed-idx segment pairs in a directory, add one
segment per iteration, write ``index_NN.index`` after each, and run the
full query / recall suite again after every segment.

Incremental grouping policy, as in the JAX package: the alpha statistics
ACCUMULATE across segments (the per-group numerator and denominator sums
live on the index), the group alphas are finalized again after each
segment, and only the NEW segment is encoded; codes of earlier segments
keep their encodings. Total work is linear in the corpus, like the
reference's append (whose add_group instead overwrites a group's alpha
with the last segment's, IndexIVF_HNSW_Grouping.cpp:78-87).

Usage (reference ``-flag value`` grammar, plus -device, which defaults to
cuda, and the segment flags):
    python -m ivfhnsw_tpu_torch.drivers.vector_add -d 128 -nc 16384 \\
        -nsubc 64 -do_opq on -do_pruning on -segment_dir SEGMENTS \\
        -path_learn l.bvecs -path_q q.bvecs -path_gt gt.ivecs \\
        -path_base b.bvecs -path_centroids c.fvecs -path_pq x.pq \\
        -path_norm_pq x.norm_pq -path_opq_matrix x.opq \\
        -path_index OUT/index -nt 10000000 -nq 10000 -ngt 1000 \\
        -nprobe 32 -max_codes 10000 -k 10
    python -m ivfhnsw_tpu_torch.drivers.vector_add -synthetic 0 \\
        -segments 4 -nsubc 64 -d 128 -nc 4096 -nb 2000000 -nq 8192
``-segment_dir DIR`` holds ``*.fvecs`` (or ``*.bvecs``) base segments and,
optionally, as many ``*.ivecs`` precomputed-idx segments, paired in sorted
order (the output of the reference's vector_split; the JAX package's
tools/vector_split.py is not ported yet). Without it, the dataset's base is
split into ``-segments N`` (default 5) segment pairs in a temporary
directory, which also holds the ``index_NN.index`` files when no
``-path_index`` prefix is given, and is removed when the run ends. With
-nsubc 0 the plain IVFADC index is built instead.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as np
import torch

from ivfhnsw_tpu_torch.drivers import common as C
from ivfhnsw_tpu_torch.models.grouping import IVFADCGroupingIndex
from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex
from ivfhnsw_tpu_torch.utils import io


def read_idx_segment(path: str) -> np.ndarray:
    """A precomputed-idx segment: xvec framing with batch-sized records
    (the reference writes 1M-idx batches, readXvec<idx_t>(..., batch, 1),
    test_ivfhnsw_grouping_sift1b_vector_add.cpp:162)."""
    return C.read_assignments(path)


def write_synthetic_segments(index, base: np.ndarray, nseg: int,
                             seg_dir: str) -> None:
    """Split ``base`` into ``nseg`` base_NN.fvecs / precomputed_idxs_NN.ivecs
    segment pairs in ``seg_dir``."""
    per = -(-base.shape[0] // nseg)
    for i in range(nseg):
        blk = base[i * per:(i + 1) * per]
        io.write_xvec(os.path.join(seg_dir, f"base_{i:02d}.fvecs"), blk)
        C.write_assignments(
            os.path.join(seg_dir, f"precomputed_idxs_{i:02d}.ivecs"),
            index.assign(blk))


def add_segments(index, cfg, ds, seg_dir: str) -> list:
    """The segment loop over the pairs in ``seg_dir``; returns one record
    per segment: ``common.eval_search``'s recalls and us_per_query, plus
    "ntotal", "alphas" (the group alphas after the segment, None for
    IVFADC) and "index_path"."""
    grouping = isinstance(index, IVFADCGroupingIndex)
    base_files = io.get_files(seg_dir, ".fvecs") or io.get_files(seg_dir,
                                                                 ".bvecs")
    idx_files = io.get_files(seg_dir, ".ivecs")
    C.log(f"found {len(base_files)} base segments in {seg_dir}")
    if idx_files and len(idx_files) != len(base_files):
        raise ValueError(
            f"base vector segments ({len(base_files)}) do not match idx "
            f"segments ({len(idx_files)})")  # the reference asserts here too
    results = []
    next_id = 0
    for i, fname in enumerate(base_files):
        seg = io.read_xvec_fvec(os.path.join(seg_dir, fname), cfg.index.d)
        n = seg.shape[0]
        C.log(f"=== segment {i}: {fname} ({n} vectors) ===")
        if idx_files:
            keys = read_idx_segment(os.path.join(seg_dir, idx_files[i]))
            if keys.shape[0] != n:
                raise ValueError(
                    f"idx segment {idx_files[i]} has {keys.shape[0]} "
                    f"entries for {n} vectors")
        else:
            keys = index.assign(seg)
        ids = np.arange(next_id, next_id + n, dtype=np.int32)
        if grouping:
            # Accumulate the alpha statistics, finalize the alphas again,
            # encode ONLY the new segment (the builder keeps the earlier
            # segments' codes across finalize).
            index.alpha_pass(seg, keys)
            index.finalize_alphas()
            index.add_batch(seg, ids, keys)
            index.finalize()
            index.compute_inter_centroid_dists()
        else:
            index.add_batch(seg, ids, keys)
            index.finalize()
        next_id += n
        out = io.get_index_name(cfg.path_index or
                                os.path.join(seg_dir, "index"), i)
        index.write(out, do_trunc=True)
        C.log(f"wrote {out}")
        res = C.eval_search(index, cfg, ds)
        results.append({
            "recalls": res["recalls"], "us_per_query": res["us_per_query"],
            "ntotal": next_id, "index_path": out,
            "alphas": index.alphas.cpu().numpy() if grouping else None})
    return results


def main(argv=None) -> list:
    cfg, extras = C.parse_driver_args(
        ("synthetic", "device", "segments", "segment_dir"), argv)
    device, ds = C.driver_setup(cfg, extras)
    grouping = cfg.index.nsubc > 0
    index = (IVFADCGroupingIndex if grouping else IVFADCIndex)(cfg.index,
                                                               device)
    gen = torch.Generator(device=device).manual_seed(0)
    C.setup_quantizer(index, cfg, ds, gen)
    if grouping:
        index.compute_neighbor_centroids()
    C.setup_pq(index, cfg, ds, gen)
    with contextlib.ExitStack() as stack:
        if "segment_dir" in extras:
            seg_dir = extras["segment_dir"]
        else:
            seg_dir = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="vector_add_"))
            base = (ds.base if isinstance(ds, C.SyntheticDataset) else
                    io.read_xvec_fvec(cfg.path_base, cfg.index.d,
                                      ds.total_base))
            write_synthetic_segments(index, base,
                                     int(extras.get("segments", 5)), seg_dir)
        return add_segments(index, cfg, ds, seg_dir)


if __name__ == "__main__":
    main()
