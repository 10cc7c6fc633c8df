"""Smoke run of the PyTorch port (ivfhnsw_tpu_torch) on one NVIDIA GPU.

Phases, each of which raises on failure (nothing is caught and carried on):

1. device: the card's name and power limit, torch and CUDA versions;
2. build: compile the hand-written kernels (csrc/adc_scan.cu,
   csrc/grouping_scan.cu and csrc/scan_lab.cu) with nvcc from this
   checkout, one nvcc process per source, started together;
3. each kernel against its plain PyTorch version on the card, at the
   primary shapes (B=1024, M=16, 2M codes) with empty, partial and full
   slots (and, for the grouping kernel, pruned subgroups), at both slot
   widths (256 and 1024 codes); the min-scan kernel bit for bit
   (torch.equal) against its plain version and the wide kernel's per-slot
   minima;
4. the IVFADC main path through the port's driver functions at the primary
   point: synthetic 2M x 128d corpus, nc=4096, code_size=16; train
   centroids and PQ, assign, add, finalize; search 8192 queries with engine
   "fused" at both slot widths (nprobe=32, max_codes=10000, k=10); the
   kernel's launch count must grow; 512 queries are checked against engine
   "torch"; recall against exact ground truth computed on the card;
5. on the main path's own schedule for one search batch (all 8192
   queries at the default batch): the kernel compared
   with its plain version, both timed, and each layer of the fused search
   timed (CUDA events, median after warm-up); then the whole 8192-query
   search at each slot width and at batch 1024 and 8192, in turns;
6. the two-phase top-k path (scan_topk="twophase") over phase 4's index:
   all 8192 queries through the driver's search loop at both slot widths,
   the min-scan kernel's launch count reset before and required to grow at
   both; results equal to phase 4's wide engine on every query, and at
   k=1 and k=64 on 512 queries; on the path's own schedule for one
   8192-query batch the min kernel against its plain version (bit-equal,
   both timed) and each layer of the two-phase search_core timed; then
   whole-search walls of two-phase against wide at batch 1024 and 8192,
   in turns;
6b. banks (tools/bank_probe.py): on the main path's schedule for one
   8192-query batch at both widths, the wide and min kernels, the lab's
   direct* variants (those kernels as first ported) and its skew* variants
   (a bank-skewed LUT) over
   three stores that differ only in the shared-memory banks their lookups
   hit (the real codes; r % 32, no conflict in a row-major LUT; 32 *
   (r % 8), 8 words in one bank), and over the second with every slot at
   row 0 (codes from L1); each torch.equal to its plain version on each,
   then timed, with the staging of the LUT alone, and each production
   kernel against its direct twin in turns; no time is asserted;
7. determinism: k-means at the primary point (200k learn rows, nc=4096,
   15 iterations) twice from one seed gives the same centroids, bit for bit;
8. the Grouping+Pruning+OPQ main path at the flagship point (the JAX
   bench's own sizes, bench.py:10-11, :686-693): phase 4's corpus, ground
   truth, coarse centroids and assignments, nsubc=64, OPQ on; neighbours,
   OPQ + PQ, the alpha pass, the add loop, finalize (each stage timed);
   search 8192 queries with pruning (nprobe=32, max_codes=10000, k=10) with
   engine "fused" at both slot widths, the grouping kernel's launch count
   reset before and read after and required to grow at both widths; 512
   queries checked against engine "torch" with pruning on and off; recall;
9. on the grouping path's own schedule for one 8192-query batch: the
   grouping kernel compared with its plain version, both timed, and each
   layer of the fused grouping search timed;
10. the query surface: search_device on 8192 device-resident queries
   (CUDA tensors equal to search's output, both timed); scan_slot_demand
   of the IVFADC index and of the flagship, and the flagship searched
   under scan_budget = max demand * gran (slot count, lane fill, time;
   results equal to the unbudgeted run's on all 8192 queries); search_enn
   on 10,000 stored vectors (Recall@1);
11. the scan lab: phase 4's index written as a lab cache (save_quantizers,
   write, np.save of centroids and queries) and read back through the lab's
   loader into a fresh index; its files rewrite byte-identically and its
   search equals phase 4's results on all 8192 queries at both slot widths;
   then every variant of ops/cuda/scan_lab.py (the Hopper counterparts of
   the TPU lab rigs L1-L4 of tools/kernel_lab.py) on the main path's
   schedule for one 8192-query batch at both widths, each checked
   (torch.equal to its plain version and, for a full-function variant, to
   adc_scan_slots / adc_scan_slots_min) and timed, with every lab launch
   count reset before and required to grow; a [lab] line with the
   compute-only / copy-only / LUT-copies decomposition. The skew variants
   add a lane's rows in a rotated order and are held to the production
   kernels within RTOL / ATOL instead.

Every kernel record carries bound_ms, the least time the card could take
for the call (ivfhnsw_tpu_torch/utils/roofline.py): the larger of its bytes
(each input read once: LUTs, norm table, the schedule and the store rows
the schedule touches; the output written once) over 3.35 TB/s and its f32
operations over 67 TFLOP/s, the H100 SXM data-sheet peaks at 700 W; and
lookup_ms, the time of its shared-memory table lookups at one word per bank
per clock on every SM (SM count x 32 x the maximum SM clock that nvidia-smi
reports), which is not part of the bound.

Then one JSON line of kernel results, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}.

Run from the root of a checkout:  python3 chip_smoke.py
It needs one CUDA device and exits non-zero, printing no result, without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

from ivfhnsw_tpu_torch.utils.timer import device_ms

RTOL, ATOL = 1e-4, 1e-3
PRIMARY = dict(nb=2_000_000, nt=200_000, nq=8192, d=128, nc=4096,
               code_size=16, k=10, nprobe=32, max_codes=10000)
KERNELS = {256: "ivfhnsw_tpu/ops/pallas/adc_scan.py:216",
           1024: "ivfhnsw_tpu/ops/pallas/adc_scan.py:368"}
MIN_KERNELS = {256: "ivfhnsw_tpu/ops/pallas/adc_scan.py:545",
               1024: "ivfhnsw_tpu/ops/pallas/adc_scan.py:685"}
SOURCE = "ivfhnsw_tpu_torch/csrc/adc_scan.cu"
GROUPING_KERNELS = {256: "ivfhnsw_tpu/ops/pallas/grouping_scan.py:113",
                    1024: "ivfhnsw_tpu/ops/pallas/grouping_scan.py:248"}
GROUPING_SOURCE = "ivfhnsw_tpu_torch/csrc/grouping_scan.cu"
FLAGSHIP = dict(nsubc=64, do_opq=True, do_pruning=True)
SEARCH_BATCH = 8192  # IVFADCIndex.search's default batch
LAB_SOURCE = "ivfhnsw_tpu_torch/csrc/scan_lab.cu"


def smi_line(fields: str = "name,power.limit") -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def compare(out, ref, what: str) -> float:
    """Same +inf pattern, finite lanes within RTOL/ATOL; returns the max
    absolute error over finite lanes."""
    import torch
    if not torch.equal(torch.isinf(out), torch.isinf(ref)):
        raise AssertionError(f"{what}: +inf patterns differ")
    fin = torch.isfinite(ref)
    if not fin.any():
        raise AssertionError(f"{what}: no finite lanes")
    torch.testing.assert_close(out[fin], ref[fin], rtol=RTOL, atol=ATOL,
                               msg=lambda m: f"{what}: {m}")
    return float((out[fin] - ref[fin]).abs().max())


def assert_same(d1, l1, d2, l2, what: str) -> None:
    """The cross-engine contract: distances within RTOL/ATOL, labels may
    differ only where distances tie."""
    np.testing.assert_allclose(d2, d1, rtol=RTOL, atol=ATOL, err_msg=what)
    mism = l1 != l2
    if mism.any() and not np.allclose(d1[mism], d2[mism], rtol=RTOL,
                                      atol=ATOL):
        raise AssertionError(f"{what}: labels differ at unequal distances")


def phase_kernels_vs_plain(device, nb: int) -> None:
    """Both kernels against their plain versions on synthetic slots at the
    primary shapes: empty, partial and full slots; for the grouping kernel
    also the flagship's P=32 probes of nsubc=64, 40% of the subgroups and
    one whole probe pruned (+inf term2)."""
    import torch
    from ivfhnsw_tpu_torch.drivers.common import _sync
    from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
    from ivfhnsw_tpu_torch.ops.cuda import grouping_scan as tg
    g = torch.Generator(device=device).manual_seed(0)
    B, M, N, P, S = 1024, 16, nb, 32, 64

    def rand_u8(shape, high=256):
        return torch.randint(0, high, shape, dtype=torch.uint8,
                             device=device, generator=g)

    codes, ncodes, subc = rand_u8((N, M)), rand_u8((N,)), rand_u8((N,), S)
    lut = torch.randn((B, M, 256), device=device, generator=g)
    ntab = torch.rand((256,), device=device, generator=g) * 100
    t2 = torch.randn((B, P, S), device=device, generator=g)
    t2[torch.rand((B, P, S), device=device, generator=g) < 0.4] = float("inf")
    t2[:, 5] = float("inf")
    for gran, nslots in ((256, 80), (1024, 24)):
        kind = torch.randint(0, 3, (B, nslots), device=device, generator=g)
        partial = torch.randint(1, gran, (B, nslots), device=device,
                                generator=g)
        length = torch.where(kind == 0, 0, torch.where(kind == 1, partial,
                                                       gran)).int()
        start = torch.randint(0, N - gran, (B, nslots), device=device,
                              generator=g)
        bias = torch.randn((B, nslots), device=device, generator=g)
        seg = torch.randint(0, P, (B, nslots), device=device,
                            generator=g).int()
        for tag, fn, plain, args in (
                ("kernel", tk.adc_scan_slots, tk.adc_scan_slots_plain,
                 (lut, ntab, codes, ncodes, start, length, bias, gran)),
                ("gkernel", tg.grouping_scan_slots,
                 tg.grouping_scan_slots_plain,
                 (lut, ntab, t2, codes, ncodes, subc, start, length, bias,
                  seg, gran))):
            out = fn(*args)
            _sync(device)
            if torch.isnan(out).any():
                raise AssertionError(f"{tag} gran={gran}: NaN lanes")
            err = compare(out, plain(*args), f"{tag} synthetic gran={gran}")
            print(f"[{tag}] gran={gran} B={B} slots={nslots}: matches plain, "
                  f"max_abs_err={err!r}", flush=True)
            if tag == "kernel":
                check_min_kernel(args, out, f"synthetic gran={gran}")


def check_min_kernel(args, wide, what: str) -> None:
    """The min-scan kernel on ``args`` against its plain version and the
    wide kernel's output ``wide`` reduced per slot: torch.equal to both."""
    import torch
    from ivfhnsw_tpu_torch.drivers.common import _sync
    from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
    start, gran = args[4], args[7]
    mins = tk.adc_scan_slots_min(*args)
    _sync(mins.device)
    for ref, name in ((tk.adc_scan_slots_min_plain(*args), "its plain version"),
                      (wide.view(*start.shape, gran).amin(-1),
                       "the wide kernel's slot minima")):
        if not torch.equal(mins, ref):
            raise AssertionError(f"min kernel {what}: differs from {name}")
    print(f"[mkernel] {what} B={start.shape[0]} slots={start.shape[1]}: "
          f"torch.equal to plain and to the wide kernel's slot minima, "
          f"{int(torch.isinf(mins).sum())} empty slots", flush=True)


def timed(stages: dict, name: str, fn, device):
    """fn() with its host seconds, device synced, recorded in stages."""
    from ivfhnsw_tpu_torch.drivers.common import _sync
    t = time.perf_counter()
    r = fn()
    _sync(device)
    stages[name] = time.perf_counter() - t
    return r


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
    from ivfhnsw_tpu_torch.ops.cuda import build as kbuild

    # 1. device
    device = torch.device("cuda", 0)
    smi = smi_line()
    print(f"[device] {smi}, clocks.max.sm "
          f"{smi_line('clocks.max.sm')}, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs",
          flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}", flush=True)

    # 2. build, one nvcc per source, all started together
    from ivfhnsw_tpu_torch.ops.cuda import grouping_scan as tg
    t0 = time.perf_counter()
    sos = kbuild.build_all(["adc_scan", "grouping_scan", "scan_lab"])
    tk._entry("ivf_adc_scan_slots")
    tk._entry("ivf_adc_scan_slots_min")
    tg._kernel()
    from ivfhnsw_tpu_torch.ops.cuda import scan_lab as sl
    for name in sl.VARIANTS:
        sl._entry(name)
    print(f"[build] {sos} in {time.perf_counter() - t0:.2f}s", flush=True)
    for so in sos:
        with open(so[:-3] + ".log") as f:
            print("[build] nvcc: " + " | ".join(
                ln.strip() for ln in f if "ptxas" in ln or "error" in ln),
                flush=True)

    kernels = run(device, PRIMARY)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(device, p: dict) -> list:
    """Phases 3-11 on ``device`` at the sizes ``p``; returns the kernel
    result records."""
    import torch
    from ivfhnsw_tpu_torch import IVFADCIndex
    from ivfhnsw_tpu_torch.drivers import common as C
    from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
    from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
    from ivfhnsw_tpu_torch.ops.topk import binned_topk_smallest
    from ivfhnsw_tpu_torch.utils.config import (IndexConfig, RunConfig,
                                                SearchParams)
    from ivfhnsw_tpu_torch.utils.roofline import scan_bound

    # 3. kernels against plain on synthetic slots
    phase_kernels_vs_plain(device, p["nb"])

    # 4. main path
    cfg = RunConfig()
    cfg.index = IndexConfig(d=p["d"], nc=p["nc"], code_size=p["code_size"])
    cfg.search = SearchParams(k=p["k"], nprobe=p["nprobe"],
                              max_codes=p["max_codes"])
    cfg.nb, cfg.nt, cfg.nq = p["nb"], p["nt"], p["nq"]
    stages = {}

    def stage(name, fn):
        return timed(stages, name, fn, device)

    tk.adc_scan_slots.launches = 0
    ds = stage("dataset_host", lambda: C.SyntheticDataset(cfg, 0, device))
    index = IVFADCIndex(cfg.index, device)
    gen = torch.Generator(device=device).manual_seed(0)
    stage("train_centroids", lambda: C.setup_quantizer(index, cfg, ds, gen))
    stage("train_pq", lambda: C.setup_pq(index, cfg, ds, gen))
    idxs = stage("assign", lambda: C.load_or_assign(index, cfg, ds))
    stage("add_finalize", lambda: C.build_or_read_index(index, cfg, ds,
                                                        idxs))
    stage("ground_truth", lambda: ds.gt)
    index.scan_layout = "auto"
    print(f"[main] store {index.store.ntotal} codes, max list "
          f"{index.store.max_list_size()}, auto layout -> "
          f"{index._resolve_layout()}", flush=True)
    results, launches = {}, {}
    for layout in ("chunk", "quad"):
        index.engine, index.scan_layout = "fused", layout
        before = tk.adc_scan_slots.launches
        r = C.eval_search(index, cfg, ds)
        launches[index.scan_gran()] = tk.adc_scan_slots.launches - before
        results[layout] = r
        stages[f"search_{layout}"] = r["us_per_query"] * ds.nq / 1e6
    for gran, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel gran={gran} never launched on the "
                                 "main path")
    params = cfg.search
    sub = 512
    index.engine = "torch"
    d_ref, l_ref = index.search(ds.queries[:sub], params)
    for layout, r in results.items():
        d, l = r["dists"], r["labels"]
        if d.shape != (ds.nq, params.k) or not np.isfinite(d).all():
            raise AssertionError(f"{layout}: bad distances {d.shape}")
        if l.min() < 0 or l.max() >= ds.nb:
            raise AssertionError(f"{layout}: labels out of range")
        assert_same(d_ref, l_ref, d[:sub], l[:sub],
                    f"fused {layout} vs torch engine")
        if r["recalls"][10] < 0.1:
            raise AssertionError(f"{layout}: R@10 {r['recalls'][10]}")
        us = r["us_per_query"]
        print(f"[main] fused {layout}: {us:.2f} us/query, "
              f"{1e6 / us:.0f} QPS, R@1 {r['recalls'][1]:.4f} "
              f"R@10 {r['recalls'][10]:.4f}, matches torch engine on "
              f"{sub} queries", flush=True)
    print("[main] stages_s " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}), flush=True)

    # 5. on the main path's own schedule for one default-size search batch
    # (8192 queries): kernel against
    # plain (compared, then timed), and every layer of search_core timed
    kernels = []
    q = torch.tensor(ds.queries[:SEARCH_BATCH], device=device)
    B = q.shape[0]
    st = index.store
    for layout in ("chunk", "quad"):
        index.scan_layout = layout
        gran = index.scan_gran()
        args = (*index.scan_inputs(q, params), gran)
        start, length = args[4], args[5]
        nslots = start.shape[1]
        # the engine's layers one by one, for their times
        coarse = lambda: streaming_topk_l2(
            q, index.centroids, params.nprobe,
            block=index._coarse_block_for(q.shape[0]),
            point_sqnorms=index.centroid_norms)
        qc, probes = coarse()
        sched = lambda: tk.probe_schedule(
            probes, qc, index.centroid_norms, st.list_offsets_t,
            params.max_codes, nslots, gran)
        luts = lambda: tk.build_luts(q, index.pq.codebooks)
        dists = tk.adc_scan_slots(*args)
        err = compare(dists, tk.adc_scan_slots_plain(*args),
                      f"main-path gran={gran}")
        topk = lambda: binned_topk_smallest(dists, params.k, bin_size=32)
        best, sel = topk()
        ids = lambda: st.ids_t[torch.gather(start, 1, sel // gran)
                               + sel % gran]
        core = lambda: tk.search_core(
            q, index.centroids, index.centroid_norms, index.pq.codebooks,
            index.norm_pq.centroids, st.codes_t, st.ids_t, st.norm_codes_t,
            st.list_offsets_t, params.max_codes, nprobe=params.nprobe,
            k=params.k, nslots=nslots, gran=gran,
            coarse_block=index._coarse_block_for(q.shape[0]))
        ms = device_ms(lambda: tk.adc_scan_slots(*args))
        plain_ms = device_ms(lambda: tk.adc_scan_slots_plain(*args))
        layers = {"coarse": device_ms(coarse), "luts": device_ms(luts),
                  "schedule": device_ms(sched), "scan": ms,
                  "topk": device_ms(topk), "ids": device_ms(ids),
                  "search_core": device_ms(core)}
        valid = int(length.sum())
        nbytes = (valid * (st.code_m + 1) + dists.numel() * 4
                  + B * (st.code_m + 1) * 1024)
        print(f"[kernel] main-path gran={gran} B={B} slots={nslots} "
              f"lane fill {valid / dists.numel():.3f}: kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.1f} GB/s of codes+output+LUT), plain "
              f"{plain_ms:.4f} ms, max_abs_err {err!r}", flush=True)
        print(f"[layers] gran={gran} B={B} ms " + json.dumps(
            {k: round(v, 4) for k, v in layers.items()}), flush=True)
        kernels.append({"name": f"adc_scan_slots_gran{gran}", "route": "cuda",
                        "source": SOURCE, "replaces": KERNELS[gran],
                        "launches": launches[gran], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms,
                        **scan_bound(args, dists.numel(), st.code_m + 1,
                                     st.code_m + 1),
                        "library_ms": None})
    # End to end, engine "fused": each slot width at batch 1024 and 8192
    # (the default), in turns (A B C D D C B A), after phase 4's runs.
    index.engine = "fused"
    order = [("chunk", 1024), ("quad", 1024), ("chunk", SEARCH_BATCH),
             ("quad", SEARCH_BATCH)]
    walls = {c: [] for c in order}
    for layout, batch in order + order[::-1]:
        index.scan_layout = layout
        index.search(ds.queries[:batch], params, batch=batch)  # warm shapes
        t = time.perf_counter()
        index.search(ds.queries, params, batch=batch)
        walls[(layout, batch)].append(time.perf_counter() - t)
    for (layout, batch), w in walls.items():
        print(f"[search] fused {layout} batch {batch}, {ds.nq} queries: wall "
              f"s {[round(x, 4) for x in w]} -> {1e6 * min(w) / ds.nq:.3f} "
              f"us/query, {ds.nq / min(w):.0f} QPS (best of 2)", flush=True)

    # 6. the two-phase top-k path over the same index
    kernels += run_two_phase(device, cfg, ds, index, results)

    # 6b. the scan kernels over stores that differ only in their banks
    from ivfhnsw_tpu_torch.tools import bank_probe
    bank_probe.run(index, ds.queries, params, device, batch=SEARCH_BATCH,
                   log=lambda m: print(m, flush=True))

    # 7. determinism of k-means at the primary point
    phase_determinism(ds, p, device)

    # 8-9. the grouping main path at the flagship point, then its layers
    gkernels, gi, gresults = run_grouping(device, p, cfg, ds, index, idxs)
    kernels += gkernels

    # 10. the query surface
    run_surface(device, cfg, ds, index, gi, gresults)

    # 11. the scan lab, through the index read back from disk
    kernels += run_lab(device, cfg, ds, index, results)
    return kernels


def run_lab(device, cfg, ds, index, results: dict) -> list:
    """Phase 11: phase 4's index through the lab cache files and the lab's
    loader, then every lab variant on the main path's schedule; returns
    one kernel record per lab record."""
    import filecmp
    import tempfile

    from ivfhnsw_tpu_torch.ops.cuda import scan_lab as sl
    from ivfhnsw_tpu_torch.tools import kernel_lab as kl

    params = cfg.search
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        kl.write_cache(index, ds.queries, tmp)
        t_write = time.perf_counter() - t
        t = time.perf_counter()
        lab_index, queries = kl.load_cache(tmp, device)
        t_read = time.perf_counter() - t
        again = os.path.join(tmp, "again")
        kl.write_cache(lab_index, queries, again)
        names = sorted(os.listdir(again))
        for name in names:
            if not filecmp.cmp(os.path.join(tmp, name),
                               os.path.join(again, name), shallow=False):
                raise AssertionError(f"lab cache: {name} does not rewrite "
                                     "byte-identically")
        nbytes = os.path.getsize(os.path.join(tmp, "bench.index"))
    for layout in ("chunk", "quad"):
        lab_index.engine, lab_index.scan_layout = "fused", layout
        d, l = lab_index.search(queries, params)
        r = results[layout]
        if not (np.array_equal(d, r["dists"])
                and np.array_equal(l, r["labels"])):
            raise AssertionError(f"index read from disk: {layout} search "
                                 "differs from phase 4's")
    print(f"[lab] cache {names}: bench.index {nbytes} B written in "
          f"{t_write:.3f} s, read in {t_read:.3f} s; every file rewrites "
          f"byte-identically; the read index's search equals phase 4's on "
          f"all {len(queries)} queries at both slot widths", flush=True)

    sl.reset_launches()
    records = kl.run(lab_index, queries, params, device, batch=SEARCH_BATCH,
                     log=lambda m: print(m, flush=True))
    launches = dict(sl.LAUNCHES)
    idle = [n for n, c in launches.items() if c <= 0]
    if idle:
        raise AssertionError(f"lab kernels never launched: {idle}")
    print("[lab] " + json.dumps(kl.decomposition(records)), flush=True)
    return [{"name": f"lab_{r['name']}", "route": "cuda",
             "source": LAB_SOURCE, "replaces": r["replaces"],
             "launches": launches[r["variant"]],
             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "lookup_ms": r["lookup_ms"],
             "library_ms": None,
             "blocks_per_sm": r["blocks_per_sm"],
             "smem_bytes": r["smem_bytes"]} for r in records]


def run_two_phase(device, cfg, ds, index, wide: dict) -> list:
    """Phase 6: the two-phase top-k path over phase 4's index, against
    phase 4's wide results ``wide``; returns the min-scan kernel's result
    records."""
    import dataclasses

    import torch
    from ivfhnsw_tpu_torch.drivers import common as C
    from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
    from ivfhnsw_tpu_torch.ops.topk import topk_smallest
    from ivfhnsw_tpu_torch.utils.roofline import scan_bound

    params = cfg.search
    index.engine, index.scan_topk = "fused", "twophase"
    tk.adc_scan_slots_min.launches = 0
    launches = {}
    for layout in ("chunk", "quad"):
        index.scan_layout = layout
        before = tk.adc_scan_slots_min.launches
        r = C.eval_search(index, cfg, ds)
        launches[index.scan_gran()] = tk.adc_scan_slots_min.launches - before
        w = wide[layout]
        assert_same(w["dists"], w["labels"], r["dists"], r["labels"],
                    f"two-phase {layout} vs wide, {ds.nq} queries")
        us = r["us_per_query"]
        print(f"[twophase] fused {layout}: {us:.2f} us/query, R@1 "
              f"{r['recalls'][1]:.4f} R@10 {r['recalls'][10]:.4f}, equal to "
              f"the wide engine on all {ds.nq} queries", flush=True)
    for gran, n in launches.items():
        if n <= 0:
            raise AssertionError(f"min kernel gran={gran} never launched on "
                                 "the two-phase path")
    sub = min(512, ds.nq)
    for layout in ("chunk", "quad"):
        index.scan_layout = layout
        for k in (1, 64):
            pk = dataclasses.replace(params, k=k)
            index.scan_topk = "wide"
            d1, l1 = index.search(ds.queries[:sub], pk)
            index.scan_topk = "twophase"
            d2, l2 = index.search(ds.queries[:sub], pk)
            if d2.shape != (sub, k) or not np.array_equal(l2 < 0,
                                                          np.isinf(d2)):
                raise AssertionError(f"two-phase {layout} k={k}: bad shape "
                                     "or labels of +inf distances")
            assert_same(d1, l1, d2, l2, f"two-phase {layout} k={k} vs wide")
    print(f"[twophase] equal to wide at k=1 and k=64 on {sub} queries, both "
          "widths", flush=True)

    # on the path's own schedule for one 8192-query batch
    kernels = []
    q = torch.tensor(ds.queries[:SEARCH_BATCH], device=device)
    B, st = q.shape[0], index.store
    for layout in ("chunk", "quad"):
        index.scan_layout = layout
        gran = index.scan_gran()
        args = (*index.scan_inputs(q, params), gran)
        start, length, bias = args[4:7]
        nslots = start.shape[1]
        check_min_kernel(args, tk.adc_scan_slots(*args),
                         f"main-path gran={gran}")
        mins = tk.adc_scan_slots_min(*args)
        err = compare(mins, tk.adc_scan_slots_min_plain(*args),
                      f"min kernel main-path gran={gran}")
        ksel = min(params.k, nslots)
        mtopk = lambda: topk_smallest(mins, ksel)
        _, ssel = mtopk()

        def rescan():
            chosen = [torch.gather(x, 1, ssel) for x in (start, length, bias)]
            return tk.adc_scan_slots(*args[:4], *chosen, gran), chosen[0]
        lanes, st2 = rescan()
        final = lambda: tk.slot_labels(*topk_smallest(lanes, params.k), st2,
                                       st.ids_t, gran)
        core = lambda: tk.search_core(
            q, index.centroids, index.centroid_norms, index.pq.codebooks,
            index.norm_pq.centroids, st.codes_t, st.ids_t, st.norm_codes_t,
            st.list_offsets_t, params.max_codes, nprobe=params.nprobe,
            k=params.k, nslots=nslots, gran=gran,
            coarse_block=index._coarse_block_for(B), two_phase=True)
        ms = device_ms(lambda: tk.adc_scan_slots_min(*args))
        plain_ms = device_ms(lambda: tk.adc_scan_slots_min_plain(*args),
                             reps=5)
        layers = {"phase1_min": ms, "minima_topk": device_ms(mtopk),
                  "gather_rescan": device_ms(rescan),
                  "final_topk_ids": device_ms(final),
                  "search_core_2p": device_ms(core)}
        b = scan_bound(args, mins.numel(), st.code_m + 1, st.code_m + 2)
        valid = int(length.sum())
        print(f"[mkernel] main-path gran={gran} B={B} slots={nslots} lane "
              f"fill {valid / (B * nslots * gran):.3f}, rescan {ksel} slots: "
              f"kernel {ms:.4f} ms (bound {b['bound_ms']:.4f} ms by "
              f"{b['bound_by']}, lookups {b['lookup_ms']:.4f} ms), plain "
              f"{plain_ms:.4f} ms, max_abs_err {err!r}", flush=True)
        print(f"[tplayers] gran={gran} B={B} ms " + json.dumps(
            {k: round(v, 4) for k, v in layers.items()}), flush=True)
        kernels.append({"name": f"adc_scan_slots_min_gran{gran}",
                        "route": "cuda", "source": SOURCE,
                        "replaces": MIN_KERNELS[gran],
                        "launches": launches[gran], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, **b,
                        "library_ms": None})

    # whole search, two-phase against wide at each width and batch, in
    # turns (A B C D ... D C B A)
    order = [(layout, topk, batch) for batch in (1024, SEARCH_BATCH)
             for layout in ("chunk", "quad") for topk in ("wide", "twophase")]
    walls = {c: [] for c in order}
    for layout, topk, batch in order + order[::-1]:
        index.scan_layout, index.scan_topk = layout, topk
        index.search(ds.queries[:batch], params, batch=batch)  # warm shapes
        t = time.perf_counter()
        index.search(ds.queries, params, batch=batch)
        walls[(layout, topk, batch)].append(time.perf_counter() - t)
    for (layout, topk, batch), w in walls.items():
        print(f"[search] fused {layout} {topk} batch {batch}, {ds.nq} "
              f"queries: wall s {[round(x, 4) for x in w]} -> "
              f"{1e6 * min(w) / ds.nq:.3f} us/query (best of 2)", flush=True)
    index.scan_topk = "auto"
    return kernels


def run_surface(device, cfg, ds, index, gi, gresults: dict) -> None:
    """Phase 10: search_device, scan_slot_demand (IVFADC and the flagship,
    the flagship then searched under its profiled budget) and search_enn."""
    import dataclasses

    import torch
    from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
    from ivfhnsw_tpu_torch.ops.grouping import query_terms

    params = cfg.search
    index.engine, index.scan_layout, index.scan_topk = "fused", "chunk", "auto"
    qd = torch.tensor(ds.queries, device=device)
    d_h, l_h = index.search(ds.queries, params)
    d_d, l_d = index.search_device(qd, params)
    d_g, l_g = index.search_device(qd.reshape(8, ds.nq // 8, -1), params)
    if any(t.device.type != device.type for t in (d_d, l_d, d_g, l_g)):
        raise AssertionError("search_device returned tensors off the card")
    if d_d.shape != (ds.nq, params.k) or d_g.shape != (8, ds.nq // 8,
                                                       params.k):
        raise AssertionError(f"search_device shapes {tuple(d_d.shape)}, "
                             f"{tuple(d_g.shape)}")
    if not np.array_equal(d_d.cpu().numpy(), d_h):
        raise AssertionError("search_device distances differ from search's")
    assert_same(d_h, l_h, d_d.cpu().numpy(), l_d.cpu().numpy(),
                "search_device vs search")
    assert_same(d_h, l_h, d_g.reshape(ds.nq, -1).cpu().numpy(),
                l_g.reshape(ds.nq, -1).cpu().numpy(),
                "search_device [8, B, d] vs search")

    def on_device():
        index.search_device(qd, params)
        torch.cuda.synchronize()
    walls = {"search": [], "search_device": []}
    for name in ("search", "search_device", "search_device", "search"):
        fn = on_device if name == "search_device" else (
            lambda: index.search(ds.queries, params))
        t = time.perf_counter()
        fn()
        walls[name].append(time.perf_counter() - t)
    print(f"[surface] search_device on {ds.nq} device queries: CUDA tensors "
          f"equal to search's output; wall s " + json.dumps(
              {k: [round(x, 5) for x in v] for k, v in walls.items()}),
          flush=True)

    # slot demand, IVFADC
    for layout in ("chunk", "quad"):
        index.scan_layout = layout
        dem = index.scan_slot_demand(ds.queries, params)
        print(f"[surface] ivfadc {layout} slot demand max {int(dem.max())} "
              f"p99 {int(np.percentile(dem, 99))} mean {dem.mean():.1f}, "
              f"worst case {index._scan_slots(params, params.nprobe)}",
              flush=True)

    # slot demand of the flagship, then its search under the profiled budget
    gp = dataclasses.replace(params, do_pruning=True)
    gi.engine = "fused"
    q = qd[:SEARCH_BATCH]
    qc, probes = streaming_topk_l2(q, gi.centroids, gp.nprobe,
                                   block=gi._coarse_block_for(q.shape[0]),
                                   point_sqnorms=gi.centroid_norms)
    term1, _, scan, ssz = query_terms(
        q, qc, probes, gi.centroids, gi.centroid_norms, gi.nn_centroid_idxs,
        gi.alphas, gi.inter_centroid_dists, gi._grouped().sub_sizes_t,
        gp.max_codes, gp.do_pruning)
    for layout in ("chunk", "quad"):
        gi.scan_layout = layout
        gran = gi.scan_gran()
        dem = gi.scan_slot_demand(ds.queries, gp)
        capped = dataclasses.replace(gp, scan_budget=int(dem.max()) * gran)
        worst, nslots = (gi._scan_slots(gp, gp.nprobe),
                         gi._scan_slots(capped, gp.nprobe))
        if nslots != int(dem.max()) or nslots > worst:
            raise AssertionError(f"flagship {layout}: budgeted slots {nslots}"
                                 f", demand max {int(dem.max())}, worst "
                                 f"{worst}")
        fill = {}
        for n in (worst, nslots):
            length = grouping_sched(gi, probes, term1, scan, ssz, gp, n,
                                    gran)[1]
            fill[n] = int(length.sum()) / (length.numel() * gran)
        walls, out = {worst: [], nslots: []}, {}
        for prm in (gp, capped, capped, gp):
            n = gi._scan_slots(prm, gp.nprobe)
            gi.search(ds.queries[:256], prm)                  # warm shapes
            t = time.perf_counter()
            out[n] = gi.search(ds.queries, prm)
            walls[n].append(time.perf_counter() - t)
        d, l = out[nslots]
        ref = gresults[layout]
        if not np.array_equal(d, ref["dists"]):
            raise AssertionError(f"flagship {layout}: budgeted distances "
                                 "differ from the unbudgeted run's")
        assert_same(ref["dists"], ref["labels"], d, l,
                    f"flagship {layout} budgeted vs unbudgeted")
        us = {n: 1e6 * min(w) / ds.nq for n, w in walls.items()}
        print(f"[surface] flagship {layout} slot demand max "
              f"{int(dem.max())} p99 {int(np.percentile(dem, 99))} mean "
              f"{dem.mean():.1f}; scan_budget {capped.scan_budget}: slots "
              f"{nslots} (worst case {worst}), lane fill {fill[nslots]:.3f} "
              f"(worst case {fill[worst]:.3f}), {us[nslots]:.3f} us/query "
              f"(worst case {us[worst]:.3f}, best of 2, in turns); equal to "
              f"the unbudgeted run on all {ds.nq} queries", flush=True)

    # search_enn: stored vectors must find themselves
    n = min(10_000, ds.nb)
    index.scan_layout = "auto"
    index.search_enn(ds.base[:256])                           # warm shapes
    t = time.perf_counter()
    d, l = index.search_enn(ds.base[:n])
    dt = time.perf_counter() - t
    if d.shape != (n,) or not np.isfinite(d).all():
        raise AssertionError(f"search_enn: bad distances {d.shape}")
    print(f"[surface] search_enn on {n} stored vectors: Recall@1 "
          f"{float((l == np.arange(n)).mean()):.4f}, "
          f"{1e6 * dt / n:.3f} us/query", flush=True)


def phase_determinism(ds, p: dict, device) -> None:
    import torch
    from ivfhnsw_tpu_torch.drivers.common import _sync
    from ivfhnsw_tpu_torch.ops.kmeans import kmeans
    learn = torch.tensor(ds.learn[:200_000], device=device)
    runs = []
    for _ in range(2):
        t = time.perf_counter()
        c, _ = kmeans(torch.Generator(device=device).manual_seed(0), learn,
                      p["nc"], niter=15)
        _sync(device)
        runs.append((c, time.perf_counter() - t))
    if not torch.equal(runs[0][0], runs[1][0]):
        raise AssertionError("k-means is not bit-reproducible: max abs "
                             f"diff {(runs[0][0] - runs[1][0]).abs().max()}")
    print(f"[determinism] kmeans n={learn.shape[0]} k={p['nc']} niter=15 "
          f"twice from seed 0: torch.equal centroids, "
          f"{runs[0][1]:.3f} s / {runs[1][1]:.3f} s", flush=True)


def run_grouping(device, p: dict, cfg, ds, index, idxs):
    """Phases 8-9 at the flagship point over phase 4's corpus; returns the
    grouping kernel's result records, the flagship index and its search
    results at each slot width."""
    import dataclasses

    import torch
    from ivfhnsw_tpu_torch import IVFADCGroupingIndex
    from ivfhnsw_tpu_torch.drivers import common as C
    from ivfhnsw_tpu_torch.ops.cuda import grouping_scan as tg
    from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
    from ivfhnsw_tpu_torch.ops.grouping import query_terms
    from ivfhnsw_tpu_torch.utils.roofline import scan_bound

    gcfg = dataclasses.replace(
        cfg, index=dataclasses.replace(cfg.index, nsubc=FLAGSHIP["nsubc"],
                                       do_opq=FLAGSHIP["do_opq"]),
        search=dataclasses.replace(cfg.search,
                                   do_pruning=FLAGSHIP["do_pruning"]))
    stages = {}

    # 8. the main path, in the grouping driver's order (drivers/
    # grouping_eval.py::build), with the coarse centroids and assignments
    # of phase 4
    tg.grouping_scan_slots.launches = 0
    gi = IVFADCGroupingIndex(gcfg.index, device)
    gi.set_centroids(index.centroids)
    gen = torch.Generator(device=device).manual_seed(0)
    timed(stages, "neighbors", gi.compute_neighbor_centroids, device)
    timed(stages, "opq_pq", lambda: C.setup_pq(gi, gcfg, ds, gen), device)
    stages.update(C.build_or_read_index(gi, gcfg, ds, idxs, grouping=True))
    gsizes = gi.store.grouped(gi.nsubc).group_sizes
    print(f"[grouping] store {gi.store.ntotal} codes in {gi.nc} groups x "
          f"{gi.nsubc} subgroups, max group {int(gsizes.max())}, alphas "
          f"mean {float(gi.alphas.mean()):.4f}, auto layout -> "
          f"{gi._resolve_layout()}", flush=True)
    results, launches = {}, {}
    for layout in ("chunk", "quad"):
        gi.engine, gi.scan_layout = "fused", layout
        before = tg.grouping_scan_slots.launches
        r = C.eval_search(gi, gcfg, ds)
        launches[gi.scan_gran()] = tg.grouping_scan_slots.launches - before
        results[layout] = r
        stages[f"search_{layout}"] = r["us_per_query"] * ds.nq / 1e6
    for gran, n in launches.items():
        if n <= 0:
            raise AssertionError(f"grouping kernel gran={gran} never launched "
                                 "on the main path")
    sub = 512
    for pruning in (True, False):
        params = dataclasses.replace(gcfg.search, do_pruning=pruning)
        gi.engine = "torch"
        d_ref, l_ref = gi.search(ds.queries[:sub], params)
        for layout in ("chunk", "quad"):
            gi.engine, gi.scan_layout = "fused", layout
            if pruning:
                d, l = (results[layout]["dists"][:sub],
                        results[layout]["labels"][:sub])
            else:
                d, l = gi.search(ds.queries[:sub], params)
            assert_same(d_ref, l_ref, d, l, f"grouping fused {layout} vs "
                        f"torch engine, pruning={pruning}")
        print(f"[grouping] fused matches torch engine on {sub} queries at "
              f"both widths, pruning={pruning}", flush=True)
    for layout, r in results.items():
        d, l = r["dists"], r["labels"]
        if d.shape != (ds.nq, gcfg.search.k) or not np.isfinite(d).all():
            raise AssertionError(f"grouping {layout}: bad distances")
        if l.min() < 0 or l.max() >= ds.nb:
            raise AssertionError(f"grouping {layout}: labels out of range")
        if r["recalls"][10] < 0.1:
            raise AssertionError(f"grouping {layout}: R@10 "
                                 f"{r['recalls'][10]}")
        us = r["us_per_query"]
        print(f"[grouping] fused {layout}: {us:.2f} us/query, "
              f"{1e6 / us:.0f} QPS, R@1 {r['recalls'][1]:.4f} "
              f"R@10 {r['recalls'][10]:.4f}", flush=True)
    print("[grouping] stages_s " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}), flush=True)

    # 9. on the path's own schedule for one 8192-query batch
    kernels = []
    params = gcfg.search
    q = torch.tensor(ds.queries[:SEARCH_BATCH], device=device)
    B, st, gv = q.shape[0], gi.store, gi.store.grouped(gi.nsubc)
    q_rot = gi._rotate(q)
    for layout in ("chunk", "quad"):
        gi.scan_layout = layout
        gran = gi.scan_gran()
        nslots = gi._scan_slots(params, params.nprobe)
        coarse = lambda: streaming_topk_l2(
            q, gi.centroids, params.nprobe,
            block=gi._coarse_block_for(B), point_sqnorms=gi.centroid_norms)
        qc, probes = coarse()
        terms = lambda: query_terms(
            q, qc, probes, gi.centroids, gi.centroid_norms,
            gi.nn_centroid_idxs, gi.alphas, gi.inter_centroid_dists,
            gv.sub_sizes_t, params.max_codes, params.do_pruning)
        term1, term2, scan, ssz = terms()
        t2 = torch.where(scan, term2, float("inf"))
        sched = lambda: grouping_sched(gi, probes, term1, scan, ssz, params,
                                       nslots, gran)
        start, length, bias, seg = sched()
        luts = lambda: tg.build_luts(q_rot, gi.pq.codebooks)
        args = (luts(), gi.norm_pq.centroids, t2, st.codes_t,
                st.norm_codes_t, gv.subc_t, start, length, bias, seg, gran)
        dists = tg.grouping_scan_slots(*args)
        err = compare(dists, tg.grouping_scan_slots_plain(*args),
                      f"grouping main-path gran={gran}")
        topk = lambda: tg.topk_labels(dists, start, st.ids_t, params.k, gran)
        core = lambda: gi._search_fused(q, params, params.nprobe, nslots,
                                        gran, "topk", False)
        ms = device_ms(lambda: tg.grouping_scan_slots(*args))
        plain_ms = device_ms(lambda: tg.grouping_scan_slots_plain(*args),
                             reps=5)
        layers = {"coarse": device_ms(coarse), "terms": device_ms(terms),
                  "schedule": device_ms(sched), "luts": device_ms(luts),
                  "scan": ms, "topk_ids": device_ms(topk),
                  "search_core": device_ms(core)}
        valid = int(length.sum())
        kept = int((~torch.isinf(dists)).sum())
        nbytes = (valid * (st.code_m + 2) + dists.numel() * 4
                  + B * ((st.code_m + 1) * 1024 + t2[0].numel() * 4))
        print(f"[gkernel] main-path gran={gran} B={B} slots={nslots} lane "
              f"fill {valid / dists.numel():.3f}, unpruned lanes "
              f"{kept / max(valid, 1):.3f} of filled: kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.1f} GB/s of codes+output+tables), plain "
              f"{plain_ms:.4f} ms, max_abs_err {err!r}", flush=True)
        print(f"[glayers] gran={gran} B={B} ms " + json.dumps(
            {k: round(v, 4) for k, v in layers.items()}), flush=True)
        kernels.append({"name": f"grouping_scan_slots_gran{gran}",
                        "route": "cuda", "source": GROUPING_SOURCE,
                        "replaces": GROUPING_KERNELS[gran],
                        "launches": launches[gran], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms,
                        **scan_bound([args[i] for i in (0, 1, 3, 4, 6, 7)],
                                     dists.numel(),
                                     st.code_m + 2, st.code_m + 2,
                                     extra_bytes=t2.numel() * 4
                                     + seg.numel() * 4,
                                     lookups_per_lane=st.code_m + 2),
                        "library_ms": None})
    return kernels, gi, results


def grouping_sched(gi, probes, term1, scan, ssz, params, nslots: int,
                   gran: int):
    """The flagship's slot schedule of one batch, as its fused engine lays
    it out (ops/cuda/grouping_scan.py::search_core)."""
    import torch
    from ivfhnsw_tpu_torch.ops.cuda import grouping_scan as tg
    eff = torch.where(scan, ssz, 0).sum(dim=2)
    return tg.grouping_schedule(probes, term1, eff, ssz.sum(dim=2),
                                gi._grouped().group_offsets_t,
                                params.max_codes, nslots, gran)


if __name__ == "__main__":
    sys.exit(main())
