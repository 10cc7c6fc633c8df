"""Smoke run of the PyTorch port (ivfhnsw_tpu_torch) on one NVIDIA GPU.

Phases, each of which raises on failure (nothing is caught and carried on):

1. device: the card's name and power limit, torch and CUDA versions;
2. build: compile the hand-written kernels (csrc/adc_scan.cu,
   csrc/grouping_scan.cu, csrc/grouping_lab.cu and csrc/scan_lab.cu) with
   nvcc from this checkout, one nvcc process per source, started together;
3. each kernel against its plain PyTorch version on the card, at the
   primary shapes (B=1024, M=16, 2M codes) with empty, partial and full
   slots (and, for the grouping kernel, pruned subgroups), at both slot
   widths (256 and 1024 codes); the min-scan and the grouping kernel bit
   for bit (torch.equal) against their plain versions, the min-scan kernel
   also against the wide kernel's per-slot minima;
4. the IVFADC main path through the file-backed driver command
   (drivers/ivfadc_eval.py::main over -path_* flags, run 1 of phase 12) at
   the primary point: the synthetic 2M x 128d corpus of seed 0 and its
   exact ground truth (computed on the card) written as base.fvecs,
   learn.fvecs, query.fvecs, gt.ivecs in a temporary directory; nc=4096,
   code_size=16; the driver trains centroids and PQ, assigns, adds,
   finalizes, writes every artifact and searches 8192 queries (nprobe=32,
   max_codes=10000, k=10); its index is handed on, and searched with
   engine "fused" at both slot widths; the kernel's launch count must grow
   in each; 512 queries are checked against engine "torch"; recall;
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
   bench's own sizes, bench.py:10-11, :686-693) through
   drivers/grouping_eval.py::main over the same files (run 1 of phase 12):
   it loads phase 4's coarse centroids and assignments from their files,
   nsubc=64, OPQ on; neighbours, OPQ + PQ, the alpha pass, the add loop,
   finalize, the write (each stage timed); its index is handed on and
   searched with pruning (nprobe=32, max_codes=10000, k=10) with engine
   "fused" at both slot widths, the grouping kernel's launch count reset
   before and read after and required to grow at both widths; 512 queries
   checked against engine "torch" with pruning on and off; recall;
9. on the grouping path's own schedule for one 8192-query batch: the
   grouping kernel torch.equal to its plain version, both timed, its bound
   (a pruned lane counts the one subc byte any implementation must read),
   and each layer of the fused grouping search timed; then
   tools/grouping_probe.py: the engine's kernel and every design step of
   ops/cuda/grouping_lab.py (from "direct", the kernel as first ported)
   each torch.equal to the plain version, timed, and timed against
   "direct" in turns (A B B A x 4), with the lab's launch counts reset
   before and required to grow;
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
12. files: run 2 of both driver commands over phase 4's and 8's files must
   load every artifact (asserted on the drivers' stage records) and return
   labels equal to run 1's on all 8192 queries, distances within RTOL /
   ATOL and equal recall, with the scan kernels' launch counts reset
   before and required to grow; each read-back index rewrites its .index
   byte-identically; drivers/disk_rerank.py over the grouping files against
   base.fvecs (R@10 no lower than the ANN search's); drivers/vector_add.py
   -synthetic 0 -segments 4 at the flagship sizes over the grouping
   quantizer files (four index_NN.index files, ntotal 0.5M / 1M / 1.5M /
   2M, the last segment's recall beside the one-shot build's); [files]
   lines with every stage's seconds cold and warm and the files' sizes.

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
GROUPING_LAB_SOURCE = "ivfhnsw_tpu_torch/csrc/grouping_lab.cu"
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
            ref = plain(*args)
            err = compare(out, ref, f"{tag} synthetic gran={gran}")
            if tag == "gkernel" and not torch.equal(out, ref):
                raise AssertionError(f"gkernel synthetic gran={gran}: not "
                                     "torch.equal to its plain version")
            print(f"[{tag}] gran={gran} B={B} slots={nslots}: matches plain"
                  + (" (torch.equal)" if tag == "gkernel" else "")
                  + f", max_abs_err={err!r}", flush=True)
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


class SmokeFiles:
    """The corpus and artifact files of the file-backed phases in one
    directory, and the drivers' command lines over them. The two indexes
    share the corpus, the coarse centroids and the assignments; each has its
    own quantizer and ``.index`` files."""

    CORPUS = {"path_base": "base.fvecs", "path_learn": "learn.fvecs",
              "path_q": "query.fvecs", "path_gt": "gt.ivecs"}
    SHARED = {"path_centroids": "centroids.fvecs",
              "path_precomputed_idxs": "precomputed_idxs.ivecs"}
    OWN = {"ivfadc": {"path_pq": "ivfadc.pq", "path_norm_pq": "ivfadc.norm_pq",
                      "path_index": "ivfadc.index"},
           "grouping": {"path_pq": "grouping.pq",
                        "path_norm_pq": "grouping.norm_pq",
                        "path_opq_matrix": "grouping.opq",
                        "path_index": "grouping.index"}}

    def __init__(self, root: str, p: dict):
        self.root, self.p = root, p

    def path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def sizes(self) -> list:
        p = self.p
        return ["-d", p["d"], "-nc", p["nc"], "-code_size", p["code_size"],
                "-nb", p["nb"], "-nt", p["nt"], "-nq", p["nq"], "-ngt", 1,
                "-k", p["k"], "-nprobe", p["nprobe"], "-max_codes",
                p["max_codes"]]

    def flagship(self) -> list:
        return ["-nsubc", FLAGSHIP["nsubc"],
                "-do_opq", "on" if FLAGSHIP["do_opq"] else "off",
                "-do_pruning", "on" if FLAGSHIP["do_pruning"] else "off"]

    def flags(self, names: dict) -> list:
        return [x for k, v in names.items() for x in (f"-{k}", self.path(v))]

    def argv(self, which: str) -> list:
        """The command line of ivfadc_eval ("ivfadc") or grouping_eval /
        disk_rerank ("grouping") over the files."""
        extra = self.flagship() if which == "grouping" else []
        return [str(x) for x in self.sizes() + extra + self.flags(
            {**self.CORPUS, **self.SHARED, **self.OWN[which]})]

    def vector_add_argv(self, out_dir: str, segments: int) -> list:
        """vector_add over the synthetic corpus, the coarse centroids and
        the flagship's quantizer files; its indexes go to ``out_dir``."""
        quant = {k: v for k, v in {**self.SHARED,
                                   **self.OWN["grouping"]}.items()
                 if k not in ("path_precomputed_idxs", "path_index")}
        return [str(x) for x in
                ["-synthetic", 0, "-segments", segments] + self.sizes()
                + self.flagship() + self.flags(quant)
                + ["-path_index", os.path.join(out_dir, "index")]]

    def write_corpus(self, ds) -> int:
        """The synthetic corpus and its ground truth as the reference's
        files; returns the bytes of base.fvecs."""
        from ivfhnsw_tpu_torch.utils import io
        io.write_xvec(self.path("base.fvecs"), ds.base)
        io.write_xvec(self.path("learn.fvecs"), ds.learn)
        io.write_xvec(self.path("query.fvecs"), ds.queries)
        io.write_xvec(self.path("gt.ivecs"), ds.gt.astype(np.int32))
        return os.path.getsize(self.path("base.fvecs"))


COLD = {"ivfadc": {"centroids": "trained", "pq": "trained",
                   "assign": "computed", "index": "built"},
        # the flagship takes phase 4's coarse centroids and assignments
        "grouping": {"centroids": "loaded", "pq": "trained",
                     "assign": "loaded", "index": "built"}}
WARM = {"centroids": "loaded", "pq": "loaded", "assign": "loaded",
        "index": "read"}


def run_driver(main, argv: list, how: dict, what: str) -> dict:
    """One driver command with its wall seconds; its stage record must say
    ``how`` each artifact came about (loaded or computed)."""
    t = time.perf_counter()
    res = main(argv)
    res["wall_s"] = time.perf_counter() - t
    if res["stages"]["how"] != how:
        raise AssertionError(f"{what}: stages {res['stages']['how']}, "
                             f"expected {how}")
    return res


def run_files(device, files: SmokeFiles, ds, first: dict) -> None:
    """Phase 12 after run 1 of both drivers (``first``: their results by
    index): run 2 from the files, the byte-identical rewrite, disk_rerank
    and vector_add."""
    import filecmp

    from ivfhnsw_tpu_torch.drivers import (disk_rerank, grouping_eval,
                                           ivfadc_eval, vector_add)
    from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
    from ivfhnsw_tpu_torch.ops.cuda import grouping_scan as tg

    mains = {"ivfadc": (ivfadc_eval.main, tk.adc_scan_slots),
             "grouping": (grouping_eval.main, tg.grouping_scan_slots)}
    for which, (main, wrapper) in mains.items():
        r1 = first[which]
        wrapper.launches = 0
        r2 = run_driver(main, files.argv(which), WARM, f"{which} run 2")
        if wrapper.launches <= 0:
            raise AssertionError(f"{which} run 2: its scan kernel never "
                                 "launched")
        if not np.array_equal(r2["labels"], r1["labels"]):
            raise AssertionError(f"{which}: run 2's labels differ from run "
                                 f"1's on {ds.nq} queries")
        np.testing.assert_allclose(r2["dists"], r1["dists"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{which} run 2")
        if r2["recalls"] != r1["recalls"]:
            raise AssertionError(f"{which}: recall {r2['recalls']} after "
                                 f"loading, {r1['recalls']} after building")
        own = files.path(files.OWN[which]["path_index"])
        again = files.path(f"{which}.again.index")
        t = time.perf_counter()
        r2["index"].write(again)
        t_write = time.perf_counter() - t
        if not filecmp.cmp(own, again, shallow=False):
            raise AssertionError(f"{which}: the index read from {own} does "
                                 "not rewrite it byte-identically")
        os.remove(again)
        cold, warm = r1["stages"]["seconds"], r2["stages"]["seconds"]
        print(f"[files] {which}: run 1 (cold) {r1['wall_s']:.2f} s, stages_s "
              + json.dumps({k: round(v, 3) for k, v in cold.items()})
              + f"; run 2 (warm, every artifact loaded) {r2['wall_s']:.2f} s, "
              "stages_s " + json.dumps({k: round(v, 3)
                                        for k, v in warm.items()})
              + f"; {os.path.basename(own)} {os.path.getsize(own)} B, written "
              f"in {cold['write']:.3f} s, read in {warm['read']:.3f} s, "
              f"rewritten byte-identically in {t_write:.3f} s; labels equal "
              f"on all {ds.nq} queries, R@1 {r2['recalls'][1]:.4f} R@10 "
              f"{r2['recalls'][10]:.4f} in both runs; kernel launches in "
              f"run 2: {wrapper.launches}", flush=True)

    # disk rerank over the grouping files, against the raw base file
    ann = first["grouping"]["recalls"]
    rr = run_driver(disk_rerank.main, files.argv("grouping"), WARM,
                    "disk_rerank")
    if rr["recalls"][10] < ann[10]:
        raise AssertionError(f"disk_rerank R@10 {rr['recalls'][10]} below the "
                             f"ANN search's {ann[10]}")
    print(f"[files] disk_rerank over grouping.index and base.fvecs: R@1 "
          f"{rr['recalls'][1]:.4f} R@10 {rr['recalls'][10]:.4f} (ANN search "
          f"{ann[1]:.4f} / {ann[10]:.4f}), {rr['us_per_query']:.1f} us/query "
          f"(ANN for 20 candidates + host rerank), command "
          f"{rr['wall_s']:.2f} s", flush=True)

    # incremental build in four segments, over the flagship's quantizers
    va_dir = files.path("vector_add")
    os.makedirs(va_dir)
    t = time.perf_counter()
    res = vector_add.main(files.vector_add_argv(va_dir, 4))
    wall = time.perf_counter() - t
    names = sorted(os.listdir(va_dir))
    want = [f"index_{i:02d}.index" for i in range(4)]
    quarter = files.p["nb"] // 4
    if names != want or [r["ntotal"] for r in res] != [
            quarter * (i + 1) for i in range(4)]:
        raise AssertionError(f"vector_add: files {names}, ntotal "
                             f"{[r['ntotal'] for r in res]}")
    last = res[-1]["recalls"]
    print(f"[files] vector_add -synthetic 0 -segments 4: ntotal "
          f"{[r['ntotal'] for r in res]}, R@10 per segment "
          f"{[round(r['recalls'][10], 4) for r in res]}, after the last "
          f"segment R@1 {last[1]:.4f} R@10 {last[10]:.4f} (one-shot build "
          f"{ann[1]:.4f} / {ann[10]:.4f}), index files "
          f"{[os.path.getsize(os.path.join(va_dir, n)) for n in names]} B, "
          f"command {wall:.2f} s", flush=True)


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
    sos = kbuild.build_all(["adc_scan", "grouping_scan", "grouping_lab",
                            "scan_lab"])
    tk._entry("ivf_adc_scan_slots")
    tk._entry("ivf_adc_scan_slots_min")
    tg._kernel()
    from ivfhnsw_tpu_torch.ops.cuda import grouping_lab as gl
    gl._entry()
    from ivfhnsw_tpu_torch.ops.cuda import scan_lab as sl
    for name in sl.VARIANTS:
        sl._entry(name)
    print(f"[build] {sos} in {time.perf_counter() - t0:.2f}s", flush=True)
    for so in sos:
        with open(so[:-3] + ".log") as f:
            print("[build] nvcc: " + " | ".join(
                ln.strip() for ln in f if "ptxas" in ln or "error" in ln),
                flush=True)

    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        kernels = run(device, PRIMARY, SmokeFiles(tmp, PRIMARY))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(device, p: dict, files: SmokeFiles) -> list:
    """Phases 3-12 on ``device`` at the sizes ``p`` over the files
    ``files``; returns the kernel result records."""
    import torch
    from ivfhnsw_tpu_torch.drivers import common as C
    from ivfhnsw_tpu_torch.drivers import ivfadc_eval
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
    stage("ground_truth", lambda: ds.gt)
    base_bytes = stage("write_corpus", lambda: files.write_corpus(ds))
    print(f"[files] corpus in {files.root}: base.fvecs {base_bytes} B, "
          f"learn.fvecs, query.fvecs, gt.ivecs written in "
          f"{stages['write_corpus']:.2f} s", flush=True)
    first = {"ivfadc": run_driver(ivfadc_eval.main, files.argv("ivfadc"),
                                  COLD["ivfadc"], "ivfadc run 1")}
    if tk.adc_scan_slots.launches <= 0:
        raise AssertionError("ivfadc_eval over files never launched the scan "
                             "kernel")
    index = first["ivfadc"]["index"]
    stages.update(first["ivfadc"]["stages"]["seconds"])
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
    gkernels, gi, gresults, first["grouping"] = run_grouping(
        device, p, cfg, ds, files)
    kernels += gkernels

    # 10. the query surface
    run_surface(device, cfg, ds, index, gi, gresults)

    # 11. the scan lab, through the index read back from disk
    kernels += run_lab(device, cfg, ds, index, results)

    # 12. run 2 of both drivers from the files, disk_rerank, vector_add
    run_files(device, files, ds, first)
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


def run_grouping(device, p: dict, cfg, ds, files: SmokeFiles):
    """Phases 8-9 at the flagship point over phase 4's files; returns the
    grouping kernels' result records, the flagship index, its search
    results at each slot width and the driver command's result."""
    import dataclasses

    import torch
    from ivfhnsw_tpu_torch.drivers import common as C
    from ivfhnsw_tpu_torch.drivers import grouping_eval
    from ivfhnsw_tpu_torch.ops.cuda import grouping_lab as gl
    from ivfhnsw_tpu_torch.ops.cuda import grouping_scan as tg
    from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
    from ivfhnsw_tpu_torch.ops.grouping import query_terms
    from ivfhnsw_tpu_torch.tools import grouping_probe
    from ivfhnsw_tpu_torch.utils.roofline import grouping_scan_bound

    gcfg = dataclasses.replace(
        cfg, index=dataclasses.replace(cfg.index, nsubc=FLAGSHIP["nsubc"],
                                       do_opq=FLAGSHIP["do_opq"]),
        search=dataclasses.replace(cfg.search,
                                   do_pruning=FLAGSHIP["do_pruning"]))

    # 8. the main path: the grouping driver's command over the files, with
    # the coarse centroids and assignments that phase 4's run wrote
    tg.grouping_scan_slots.launches = 0
    g1 = run_driver(grouping_eval.main, files.argv("grouping"),
                    COLD["grouping"], "grouping run 1")
    if tg.grouping_scan_slots.launches <= 0:
        raise AssertionError("grouping_eval over files never launched the "
                             "grouping kernel")
    gi = g1["index"]
    stages = dict(g1["stages"]["seconds"])
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
    kernels, bounds, plain_times = [], {}, {}
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
        ref = tg.grouping_scan_slots_plain(*args)
        err = compare(dists, ref, f"grouping main-path gran={gran}")
        if not torch.equal(dists, ref):
            raise AssertionError(f"grouping main-path gran={gran}: kernel "
                                 "not torch.equal to its plain version")
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
        b = grouping_scan_bound(args[:-1], dists, gran)
        valid, kept = b.pop("filled_lanes"), b.pop("kept_lanes")
        print(f"[gkernel] main-path gran={gran} B={B} slots={nslots} lane "
              f"fill {valid / dists.numel():.3f}, unpruned lanes "
              f"{kept / max(valid, 1):.3f} of filled: kernel {ms:.4f} ms "
              f"(bound {b['bound_ms']:.4f} ms by {b['bound_by']}, "
              f"{b['bound_ms'] / ms:.3f} of the kernel's time; lookups "
              f"{b['lookup_ms']:.4f} ms), plain {plain_ms:.4f} ms, "
              f"torch.equal to plain, max_abs_err {err!r}", flush=True)
        print(f"[glayers] gran={gran} B={B} ms " + json.dumps(
            {k: round(v, 4) for k, v in layers.items()}), flush=True)
        bounds[gran] = b
        kernels.append({"name": f"grouping_scan_slots_gran{gran}",
                        "route": "cuda", "source": GROUPING_SOURCE,
                        "replaces": GROUPING_KERNELS[gran],
                        "launches": launches[gran], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, **b,
                        "library_ms": None})
        plain_times[gran] = plain_ms

    # the engine's kernel and the lab's design steps, each against the
    # kernel as first ported, in turns
    gl.reset_launches()
    records = grouping_probe.run(gi, ds.queries, params, device,
                                 batch=SEARCH_BATCH,
                                 log=lambda m: print(m, flush=True))
    idle = [n for n, c in gl.LAUNCHES.items() if c <= 0]
    if idle:
        raise AssertionError(f"grouping lab kernels never launched: {idle}")
    for r in records:
        g = r["gran"]
        if r["name"] == grouping_probe.ENGINE:
            next(k for k in kernels if k["name"].endswith(f"gran{g}"))[
                "over_direct_in_turns"] = r["over_baseline"]
        elif r["name"].startswith("lab_"):
            kernels.append({
                "name": f"grouping_{r['name']}_gran{g}", "route": "cuda",
                "source": GROUPING_LAB_SOURCE,
                "replaces": GROUPING_KERNELS[g],
                "launches": gl.LAUNCHES[r["name"][4:]],
                "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": plain_times[g], **bounds[g],
                "library_ms": None,
                "over_direct_in_turns": r.get("over_baseline")})
    return kernels, gi, results, g1


def grouping_sched(gi, probes, term1, scan, ssz, params, nslots: int,
                   gran: int):
    """The flagship's slot schedule of one batch, as its fused engine lays
    it out (ops/cuda/grouping_scan.py::scan_inputs)."""
    import torch
    from ivfhnsw_tpu_torch.ops.cuda import grouping_scan as tg
    eff = torch.where(scan, ssz, 0).sum(dim=2)
    return tg.grouping_schedule(probes, term1, eff, ssz.sum(dim=2),
                                gi._grouped().group_offsets_t,
                                params.max_codes, nslots, gran)


if __name__ == "__main__":
    sys.exit(main())
