"""Search the spill of tools/build_1b.py shard by shard on one card: the
counterpart of ``tools/search_1b.py``, with its flags, steps and report
fields.

1. Global coarse step: one exact ``streaming_topk_l2`` top-nprobe of the
   1024 queries over all nc centroids (TF32 off).
2. Per centroid range [lo, hi) of ``--shards`` equal ranges, one after the
   other: the shard's store assembled from the spill files on the device
   (:func:`assemble_shard`: the keys masked to the range and placed by a
   stable counting sort, a chunk of the spill at a time; the order of
   ``PostingListBuilder``), then the fused engine's scan of the probes the
   shard owns (``parallel/sharded.py::IVFShard.scan``: the slot schedule
   and the scan kernels K1/K2 wide, or K3/K4 and a rescan two-phase), the
   other probes masked out (no codes, no slots), a local top-k.
3. The shards' top-k merged by (distance, label).

The ``max_codes`` budget of a shard is counted over that shard's own
probes, in global distance order (:func:`shard_probes`): the JAX tool's
rule (its ``search_precomputed`` per shard, tools/search_1b.py:174-178),
not its docstring's. A probe is included iff the shard's codes before it
number fewer than max_codes, so S shards may together scan up to S times
the single store's budget; ``--shards 1`` is the single-store search
exactly. The store's offsets and the schedule's row starts are int64 on
the device; the spill's ids are int32, as the JAX tool's.

Recall is against the in-stream exact ground truth of tools/build_1b.py
(``<workdir>/gt.npy``). A progressive ``search1b.json`` is written to the
cache directory after each shard and the final one at the end, with the
JAX tool's fields; never ``RESULTS_SEARCH1B.json``, the TPU's record.
``--scan-layout`` (auto, chunk = 256 codes a slot, quad = 1024) and
``--scan-topk`` (auto = wide, wide, twophase) take comma lists: each
combination searches every shard once it is assembled, and gets its own
times and recall in the record's ``combos``; the first one fills the
JAX tool's fields. On a CUDA device the coarse step runs once untimed,
and each combination scans a shard once untimed, before the timed pass
(host clock, synced), so the times leave out the first pass's set-up and
allocations.

    python -m ivfhnsw_tpu_torch.tools.search_1b [--shards 4] [--nprobe 128]
        [--max-codes 100000] [--k 100] [--workdir DIR] [--device cuda]
        [--scan-layout auto] [--scan-topk auto]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ivfhnsw_tpu_torch.drivers.common import _sync
from ivfhnsw_tpu_torch.models.ivfadc import (IVFADCIndex, resolve_layout,
                                             resolve_two_phase)
from ivfhnsw_tpu_torch.models.storage import PostingListStore
from ivfhnsw_tpu_torch.ops.cuda import adc_scan as fused
from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
from ivfhnsw_tpu_torch.ops.grouping import probe_budget
from ivfhnsw_tpu_torch.parallel.pipeline import CURSOR
from ivfhnsw_tpu_torch.parallel.sharded import IVFShard
from ivfhnsw_tpu_torch.tools import scale3
from ivfhnsw_tpu_torch.utils.config import IndexConfig
from ivfhnsw_tpu_torch.utils.recall import recall_at_k

ASSEMBLY_ROWS = 1 << 24   # spill rows per step of a shard's assembly
BATCH = 1024              # queries per scan batch


class Spill(NamedTuple):
    """The committed rows of a build's spill (or any store's arrays), in
    insertion order: keys [N] int32, ids [N] int32, codes [N, M] uint8,
    norm_codes [N] uint8 (numpy arrays or memory maps)."""
    keys: np.ndarray
    ids: np.ndarray
    codes: np.ndarray
    norm_codes: np.ndarray


def open_spill(workdir: str, M: int) -> Spill:
    """Memory maps of the first ``processed`` rows (the cursor's) of the
    spill files in ``workdir``, copy-on-write so nothing reaches the
    files."""
    with open(os.path.join(workdir, CURSOR)) as f:
        n = json.load(f)["processed"]

    def mm(name, dtype, shape):
        return np.memmap(os.path.join(workdir, name), dtype, mode="c",
                         shape=shape)

    return Spill(mm("keys.i32", "<i4", (n,)), mm("ids.i32", "<i4", (n,)),
                 mm("codes.u8", "u1", (n, M)),
                 mm("norm_codes.u8", "u1", (n,)))


def _upload(a: np.ndarray, lo: int, hi: int, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(device)


def assemble_shard(spill: Spill, lo: int, hi: int, device,
                   rows: int = ASSEMBLY_ROWS) -> PostingListStore:
    """The store of lists [lo, hi) (local ids 0 .. hi - lo - 1) of
    ``spill`` on ``device``, in the order of ``PostingListBuilder`` (by
    key, insertion order within a key). Two passes over the spill, ``rows``
    rows a step: the list sizes, then each step's rows of the range
    stable-sorted by key and written at their lists' running cursors. The
    device holds the store and one step's arrays, never a permutation of
    the whole spill."""
    nc_loc, n = hi - lo, spill.keys.shape[0]
    M = spill.codes.shape[1]

    def keys_at(o):
        k = _upload(spill.keys, o, o + rows, device).long()
        return k - lo, (k >= lo) & (k < hi)

    sizes = torch.zeros(nc_loc, dtype=torch.int64, device=device)
    for o in range(0, n, rows):
        k, m = keys_at(o)
        sizes += torch.bincount(k[m], minlength=nc_loc)
    offsets = torch.zeros(nc_loc + 1, dtype=torch.int64, device=device)
    torch.cumsum(sizes, 0, out=offsets[1:])
    total = int(offsets[-1])
    if total >= 2 ** 31:
        raise ValueError(f"shard [{lo}, {hi}) holds {total} codes; the "
                         "store's host offsets are int32")
    codes = torch.empty((total, M), dtype=torch.uint8, device=device)
    ids = torch.empty(total, dtype=torch.int32, device=device)
    norm_codes = torch.empty(total, dtype=torch.uint8, device=device)
    cursor = offsets[:-1].clone()
    for o in range(0, n, rows):
        k, m = keys_at(o)
        sel = m.nonzero().squeeze(1)
        sk, order = torch.sort(k[sel], stable=True)
        src = sel[order]
        cnt = torch.bincount(sk, minlength=nc_loc)
        rank = (torch.arange(sk.shape[0], device=device)
                - (torch.cumsum(cnt, 0) - cnt)[sk])
        pos = cursor[sk] + rank
        cursor += cnt
        codes[pos] = _upload(spill.codes, o, o + rows, device)[src]
        ids[pos] = _upload(spill.ids, o, o + rows, device)[src]
        norm_codes[pos] = _upload(spill.norm_codes, o, o + rows, device)[src]
    store = PostingListStore(codes=codes.cpu().numpy(),
                             ids=ids.cpu().numpy(),
                             norm_codes=norm_codes.cpu().numpy(),
                             list_offsets=offsets.cpu().numpy(), nc=nc_loc,
                             device=device)
    store._dev.update(codes=codes, ids=ids, norm_codes=norm_codes,
                      list_offsets=offsets)
    return store


def make_shard(proto: IVFADCIndex, store: PostingListStore, rank: int,
               lo: int) -> IVFShard:
    """The shard of ``proto``'s centroid rows [lo, lo + store.nc) over
    ``store``, with its quantizers (no OPQ)."""
    hi = lo + store.nc
    return IVFShard(rank, proto.device, lo, store.nc, proto.centroids[lo:hi],
                    proto.centroid_norms[lo:hi], store, proto.pq.codebooks,
                    proto.norm_pq.centroids, None, lo)


def shard_probes(shard: IVFShard, probes: torch.Tensor, qc: torch.Tensor,
                 max_codes: int):
    """The shard's share of global probes [B, P] (ascending distances qc):
    (included [B, P] bool, term1 [B, P] f32, sizes [B, P] int64). A probe
    is included iff the shard owns it and the codes of the shard's own
    probes before it number fewer than ``max_codes``: the budget counted
    per shard, as the JAX tool counts it."""
    own, lp = shard.own(probes)
    off = shard.store.list_offsets_t
    sizes = torch.where(own, off[lp + 1] - off[lp], 0)
    included = probe_budget(sizes, max_codes) & own
    term1 = qc.to(shard.device) - torch.where(own,
                                              shard.centroid_norms[lp], 0.0)
    return included, term1, sizes


def merge_topk(all_d: np.ndarray, all_l: np.ndarray, k: int):
    """The k best of the shards' concatenated top-k [nq, S * k], ordered
    by (distance, label), as the JAX tool merges them."""
    sel = np.lexsort((all_l, all_d), axis=1)[:, :k]
    return (np.take_along_axis(all_d, sel, axis=1),
            np.take_along_axis(all_l, sel, axis=1))


def load_proto(cache: str, device) -> IVFADCIndex:
    """The index state every shard shares: centroids and quantizers of
    ``<cache>/scale3/``, no store."""
    sdir = os.path.join(cache, "scale3")
    cents = np.load(os.path.join(sdir, "centroids.npy"))
    nc, d = cents.shape
    proto = IVFADCIndex(IndexConfig(d=d, nc=nc,
                                    code_size=scale3.CODE_SIZE), device)
    proto.set_centroids(cents)
    proto.load_quantizers(os.path.join(sdir, "scale3.pq"),
                          os.path.join(sdir, "scale3.norm_pq"))
    return proto


def combos_of(layouts: str, topks: str) -> list:
    return [(lay, top) for lay in layouts.split(",")
            for top in topks.split(",")]


def parse(argv):
    cache = scale3.cache_dir()
    ap = argparse.ArgumentParser(
        prog="python -m ivfhnsw_tpu_torch.tools.search_1b",
        description="Shard-streamed search of the 1B spill on one card.")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--nprobe", type=int, default=128)
    ap.add_argument("--max-codes", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--workdir", default=os.path.join(cache, "build1b"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scan-layout", default="auto")
    ap.add_argument("--scan-topk", default="auto")
    return ap.parse_args(argv), cache


def write_json(path: str, out: dict) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)


def main(argv=None, on_shard=None) -> dict:
    """The search; returns the final ``search1b.json`` record.
    ``on_shard(info)``, when given, is called after each shard's scans
    with a dict: "shard" (the IVFShard), "proto", "queries" (device),
    "probes", "qc", "included", "term1", "sizes" and "out" {(layout,
    topk): (dists, labels, slots, seconds)} of this shard (host arrays)."""
    args, cache = parse(argv)
    device = scale3.resolve_device(args.device)
    S, nprobe, k, mc = args.shards, args.nprobe, args.k, args.max_codes
    proto = load_proto(cache, device)
    nc, M = proto.nc, proto.config.pq_m
    spill = open_spill(args.workdir, M)
    ntotal = spill.keys.shape[0]
    queries = np.load(os.path.join(args.workdir, "queries.npy"))
    gt = np.load(os.path.join(args.workdir, "gt.npy"))
    nq = queries.shape[0]
    combos = combos_of(args.scan_layout, args.scan_topk)
    print(f"1B search: ntotal={ntotal} nc={nc} shards={S} nq={nq} "
          f"nprobe={nprobe} max_codes={mc} k={k} combos={combos} on "
          f"{device}", flush=True)

    # Global coarse top-nprobe: the single index's exact sweep.
    q = torch.tensor(queries, device=device)

    def coarse():
        return streaming_topk_l2(q, proto.centroids, nprobe,
                                 block=proto._cb(),
                                 point_sqnorms=proto.centroid_norms)

    if device.type == "cuda":
        coarse()        # untimed: the process's first matmuls set up cuBLAS
    t = time.perf_counter()
    qc, probes = coarse()
    _sync(device)
    coarse_s = time.perf_counter() - t
    print(f"global coarse top-{nprobe}: {coarse_s:.3f}s "
          f"({coarse_s * 1e6 / nq:.1f} us/q)", flush=True)

    per_shard = []
    runs = {c: {"d": np.full((nq, S * k), np.inf, np.float32),
                "l": np.full((nq, S * k), -1, np.int64), "seconds": 0.0,
                "slots": []} for c in combos}
    codes_q = torch.zeros(nq, dtype=torch.int64, device=device)
    nc_per = -(-nc // S)
    p_json = os.path.join(cache, "search1b.json")
    for s in range(S):
        lo, hi = min(s * nc_per, nc), min((s + 1) * nc_per, nc)
        t = time.perf_counter()
        shard = make_shard(proto, assemble_shard(spill, lo, hi, device), s,
                           lo)
        _sync(device)
        assemble_s = time.perf_counter() - t
        included, term1, sizes = shard_probes(shard, probes, qc, mc)
        codes_q += torch.where(included, sizes, 0).sum(1)
        out = {}
        for c in combos:
            layout, topk = c
            gran = (fused.RCHUNK if resolve_layout(layout, ntotal, nc)
                    == "quad" else fused.CHUNK)
            two_phase = resolve_two_phase(topk)

            def scan():
                parts = [shard.scan(q[o:o + BATCH], probes[o:o + BATCH],
                                    included[o:o + BATCH],
                                    term1[o:o + BATCH], k, "fused", gran,
                                    two_phase, None)
                         for o in range(0, nq, BATCH)]
                return (torch.cat([p[0] for p in parts]).cpu().numpy(),
                        torch.cat([p[1] for p in parts]).cpu().numpy(),
                        max(p[2] for p in parts))

            if device.type == "cuda":
                scan()      # untimed: the first pass allocates its buffers
            t = time.perf_counter()
            d, lab, slots = scan()
            secs = time.perf_counter() - t
            run = runs[c]
            run["d"][:, s * k:(s + 1) * k] = d
            run["l"][:, s * k:(s + 1) * k] = lab
            run["seconds"] += secs
            run["slots"].append(slots)
            out[c] = (d, lab, slots, secs)
        c0 = runs[combos[0]]
        secs = out[combos[0]][3]
        rec = {"shard": s, "nc": hi - lo, "codes": shard.store.ntotal,
               "host_assemble_seconds": round(assemble_s, 3),
               "search_seconds": round(secs, 4),
               "us_per_query": round(secs * 1e6 / nq, 1),
               "qps": round(nq / max(secs, 1e-9), 1),
               "slots": out[combos[0]][2]}
        per_shard.append(rec)
        print(f"shard {s}: {rec['codes']} codes, assemble "
              f"{assemble_s:.3f}s, search {rec['search_seconds']:.4f}s "
              f"({rec['us_per_query']:.1f} us/q, {rec['slots']} slots)",
              flush=True)
        if on_shard is not None:
            on_shard({"shard": shard, "proto": proto, "queries": q,
                      "probes": probes, "qc": qc, "included": included,
                      "term1": term1, "sizes": sizes, "out": out})
        del shard, included, term1, sizes, out
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # Progressive report: shards 0..s searched; its recall against the
        # full ground truth is a lower bound that reaches the final one.
        _, lab_p = merge_topk(c0["d"], c0["l"], k)
        rec_p = recall_at_k(lab_p, gt, ks=(1, 10, 100))
        write_json(p_json, {
            "nb": ntotal, "nc": nc, "shards": S, "shards_done": s + 1,
            "partial": s + 1 < S, "nq": nq, "nprobe": nprobe,
            "max_codes": mc, "k": k,
            "codes_covered": int(sum(p["codes"] for p in per_shard)),
            "recall_at_1": round(rec_p[1], 4),
            "recall_at_10": round(rec_p[10], 4),
            "recall_at_100": round(rec_p[100], 4),
            "coarse_seconds": round(coarse_s, 3), "per_shard": per_shard})

    results = {}
    for c in combos:
        run = runs[c]
        _, lab = merge_topk(run["d"], run["l"], k)
        r = recall_at_k(lab, gt, ks=(1, 10, 100))
        results[f"{c[0]}/{c[1]}"] = {
            "recall_at_1": round(r[1], 4), "recall_at_10": round(r[10], 4),
            "recall_at_100": round(r[100], 4),
            "search_seconds": round(run["seconds"], 4),
            "us_per_query": round((coarse_s + run["seconds"]) * 1e6 / nq, 2),
            "slots_per_shard": run["slots"]}
    first = results[f"{combos[0][0]}/{combos[0][1]}"]
    total_search = runs[combos[0]]["seconds"]
    out = {
        "nb": ntotal, "nc": nc, "shards": S, "shards_done": S,
        "partial": False,
        "codes_covered": int(sum(p["codes"] for p in per_shard)),
        "nq": nq, "nprobe": nprobe, "max_codes": mc, "k": k,
        "recall_at_1": first["recall_at_1"],
        "recall_at_10": first["recall_at_10"],
        "recall_at_100": first["recall_at_100"],
        "coarse_seconds": round(coarse_s, 3), "per_shard": per_shard,
        "total_search_seconds": round(total_search, 4),
        "us_per_query_total": round((coarse_s + total_search) * 1e6 / nq,
                                    2),
        "qps_effective": round(nq / (coarse_s + total_search), 2),
        "codes_scanned_per_query": float(codes_q.float().mean()),
        "combos": results,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        **scale3.peaks(device),
        "engine": "fused (IVFShard.scan: the scan kernels on a card, their "
                  "plain versions on the CPU), sequential shard streaming; "
                  "per-shard max_codes budget as the JAX tool's",
    }
    print(json.dumps(out), flush=True)
    write_json(p_json, out)
    return out


if __name__ == "__main__":
    main()
