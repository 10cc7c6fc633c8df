"""``scan_topk_roofline.search``: the least time the scan-and-top-k layer's
work needs on the card, over that layer's device time in the traced
stretch, in %. Every traced step is one call of the query set, which the
program searches in the traffic's chunks.

The work is counted by the benchmark from its own inputs (the reference's
lists or subgroups that the nprobe / max_codes rule, and pruning, admit for
certain), never from the program's padded arrays, so a wide, two-phase or
fused implementation is held to the same count. Per chunk: the per-query
tables (B x M x 256 f32, the norm table, and for grouping the B x P x nsubc
term table) read once; of the store, the M code bytes and the norm byte of
every distinct admitted row read once (for grouping, those of kept rows,
and one subgroup byte of every row of an admitted group); the [B, k]
results (f32 distance, int64 label) written once and their int32 ids read
once. Operations: M + 1 additions per admitted lane. The least time is the
larger of bytes over the HBM rate and operations over the f32 peak
(``peaks.json``)."""

import torch

from annbench.metrics._layer import load_peaks


def batch_work(ref, cfg, works):
    """(bytes, operations) of one batch from its queries' ``ref.work``."""
    M, k, B = ref.M, cfg["k"], len(works)
    nbytes = B * M * 256 * 4 + 256 * 4 + B * k * (4 + 8 + 4)
    if cfg["index"] == "grouping":
        groups = torch.cat([w[0] for w in works])
        kept = torch.cat([w[1] for w in works])
        sizes = ref.size_lo.view(-1)
        lanes = int(sizes[kept].sum())
        nbytes += B * cfg["nprobe"] * cfg["nsubc"] * 4
        nbytes += int(ref.sizes[torch.unique(groups)].sum())
        nbytes += int(sizes[torch.unique(kept)].sum()) * (M + 1)
    else:
        lists = torch.cat(works)
        lanes = int(ref.sizes[lists].sum())
        nbytes += int(ref.sizes[torch.unique(lists)].sum()) * (M + 1)
    return nbytes, lanes * (M + 1)


def read(ctx):
    t, ref = ctx.trace, ctx.ref
    if t is None or ref is None or not ctx.chunks or t.n_steps == 0:
        return None
    layer_s = t.layer_us("scan_topk") * 1e-6
    if layer_s <= 0:
        return None
    pk = load_peaks()
    cfg = ctx.run.cfg
    Q = ctx.run.state["pool_q"]
    calls = ctx.chunks[:t.n_steps]
    uniq = torch.unique(torch.cat([q for call in calls for q in call]))
    ref.prepare_for(Q[uniq])
    work = {}
    for s in range(0, uniq.numel(), 256):
        qi = uniq[s:s + 256]
        work.update(zip(qi.tolist(), ref.work(Q[qi])))
    least = 0.0
    for call in calls:
        for qidx in call:
            nbytes, ops = batch_work(ref, cfg,
                                     [work[i] for i in qidx.tolist()])
            least += max(nbytes / pk["hbm_bytes_per_s"],
                         ops / pk["f32_ops_per_s"])
    return 100.0 * least / layer_s
