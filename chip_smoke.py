"""Smoke run of the PyTorch port (ivfhnsw_tpu_torch) on one NVIDIA GPU.

Phases, each of which raises on failure (nothing is caught and carried on):

1. device: the card's name and power limit, torch and CUDA versions;
2. build: compile the hand-written kernels (csrc/adc_scan.cu,
   csrc/grouping_scan.cu, csrc/grouping_lab.cu, csrc/scan_lab.cu and
   csrc/assign_min.cu) with nvcc from this checkout, one nvcc process per
   source, started together;
3. each kernel against its plain PyTorch version on the card, at the
   primary shapes (B=1024, M=16, 2M codes) with empty, partial and full
   slots (and, for the grouping kernel, pruned subgroups), at both slot
   widths (256 and 1024 codes); the min-scan and the grouping kernel bit
   for bit (torch.equal) against their plain versions, the min-scan kernel
   also against the wide kernel's per-slot minima; the wide and grouping
   kernels launched as the search launches them, with the bin-32 minima
   of their lanes, which are torch.equal to the plain lanes' minima, and
   the lanes the same without them (here and wherever a later phase checks
   or times K1/K2 or K5/K6, it launches them so);
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
   both timed), against its first port (scan_lab.cu's direct_min_kernel)
   in turns, and each layer of the two-phase search_core timed; then
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
6c. mprobe (tools/min_probe.py): on the same schedule at both widths, over
   the real store and the conflict-free one, the min kernel's design steps
   (csrc/min_scan.cuh through scan_lab.py's MIN_STEPS: the first port, its
   compute-only and loads-only split, one switch a step, the production
   setting and its split, the prefetching lead) and the production
   kernel, each
   torch.equal to its plain version (a full step also to production) and
   timed against the first port in turns, with the staging alone; the
   shared-memory wavefronts that the store's codes cost the lookups and the
   floor they set; each kernel's SASS instructions per warp and code from
   cuobjdump; the lab's min-step launch counts reset before and required
   to grow; [mprobe] lines, K3/K4 records gain "mprobe";
6d. wprobe (tools/wide_probe.py): on the same schedule at both widths,
   over the real store and the conflict-free one, the write floor (one
   fill_ of a tensor of the wide output's shape), the wide kernel's
   design steps (csrc/wide_scan.cuh through scan_lab.py's WIDE_STEPS: the
   first port, its split into stores only, no output, lookups only and
   code reads only, one switch a step to the two production settings,
   and the warp setting's split) and the production kernel, each torch.equal to its plain
   version (a full step also to production) and timed against the first
   port in turns, each kernel's SASS instructions per warp and code; the
   lab's wide-step launch counts reset before and required to grow;
   [wprobe] lines, K1/K2 records gain "wprobe";
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
   -segments 4 at the flagship sizes over base.fvecs and the grouping
   quantizer files (four index_NN.index files, ntotal 0.5M / 1M / 1.5M /
   2M, the last segment's recall beside the one-shot build's); [files]
   lines with every stage's seconds cold and warm and the files' sizes.
13-16. trace and counters, ORCV, the device-resident build with
   checkpoints and vector_split, the SIFT-like corpus (see their functions;
   phase 16 ends with 6c's probe on the SIFT-like index's real store,
   [mprobe siftlike] lines, K3/K4 records gain "siftlike_mprobe").
17. the large-nc path at the JAX bench's scale2 point (bench.py:66-75,
   :957-1075), nothing cut, built by the port's bench tool
   (tools/bench.py::build_scale2, in a temporary cache): 134,217,728 x
   128d drawn on the card from the bench's two-level corpus, nc=2^17;
   centroids by hierarchical seeding and 4 Lloyd rounds over 2M rows, PQ
   on 262,144; the routed two-level assigner (w=4, 2048 supers) adopted if
   its match rate against exact assignment on 32,768 rows is >= 0.98; 128
   batches of 1,048,576 through add_batch_device with the exact top-1
   ground truth of 1024 queries merged per batch; finalize; each stage
   timed, host RSS and device peak; beside the build, one Lloyd pass split
   into seeding, score GEMMs, sweep and segment sums, and batch 0 assigned
   routed and exact.
   Then the routed coarse structure: probe overlap against exact at w =
   16, 32, 64; w = n_super equal to exact but at f32 ties, in its probes
   and in a search that admits every probe; the routed side table's row
   offsets and sizes equal to the store's for every query; each coarse
   mode (exact, binned, approx, routed) searched wide and two-phase at
   both slot widths under scan_budget = max scan_slot_demand * gran, in
   turns, with the scan kernels' launch counts required to grow; recall
   per mode, R@100 at k=100, the budgeted search equal to the unbudgeted
   one and 64 queries equal to engine "torch"; each scan kernel torch.equal
   to its plain version on this point's schedule, both timed; the inputs
   of the approx decision ([scale2] lines; records gain "scale2");
17b. coarse selection at nc=2^20 on the bench's scale3 corpus (bench.py:
   1078-1120): hierarchical_seed at k=2^20 over 8,388,608 rows (seconds,
   the list sizes of those rows under the routed assigner), then exact,
   binned, approx and routed selection of 128 probes for 1024 queries,
   timed, with their probe overlaps against exact ([coarse20] lines).
   ``python3 chip_smoke.py --only 17,17b`` builds the kernels and runs
   just these two phases (a partial run: it prints no result line).
18. the sharded paths (ivfhnsw_tpu_torch/parallel/), [sharded] lines:
   18a: phase 17's index over 8 shards on the one card (LocalShards),
   searched wide and two-phase at both slot widths, in turns with the
   single index under phase 17's profiled budget; results equal on every
   query whose sharded probe list equals the single index's (the others
   counted and shown to differ only at f32 ties); µs/query of both, each
   shard's slots (its own demand), the coarse step of both, device peak;
   the scan kernels on the busiest shard's schedule torch.equal to plain;
   18b: the same index as one rank of a single-rank NCCL process group
   (DistributedShards), equal to the single index; 18c: phase 8's flagship
   over 8 shards, pruning off and on, both widths, against phase 8's
   single index, pruning flips counted and shown at the threshold, the
   grouping kernel torch.equal to plain on a shard's schedule; 18d: the
   streamed build (StreamedIndexBuild over 8 shards, batches of 262,144)
   of phase 4's 2M rows, stopped after half, torn bytes appended past the
   cursor, resumed; then two hosts' slices built apart and merged; each
   store equal to phase 4's up to counted near-ties; rows/s, finalize
   seconds; 18e: the 8-shard primary index through save_sharded /
   load_sharded, searching bit-equal after the round trip.
   ``python3 chip_smoke.py --only 17,18`` runs phases 17 and 18a-18b.
19. the 1B path ([1b] lines): ivfhnsw_tpu_torch/tools/build_1b.py and
   tools/search_1b.py run in process at the scale3 geometry (nc=2^20,
   d=128, code_size 16, 1024 queries, nprobe 128, max_codes 100,000, k=100,
   batches of 2^21), cut only in --target: 2^28 vectors (a 6.7 GB spill)
   where users run 1e9; the free disk is printed first. The build runs to
   half the target, gets torn bytes appended past its cursor and runs to
   the target (one resume; its ground truth equal to one uninterrupted
   merge, labels and distances); stage seconds, vectors/s, match rate and
   drift series, spill bytes, host RSS and device peak. search_1b.py then
   runs at --shards 4 and 1, each at 256- and 1024-code slots, wide and
   two-phase, the scan kernels' launch counts required to grow in each;
   on 64 queries every result equals the torch engine's (the shard's own
   at 4, IVFADCIndex's over the same store at 1); K1-K4 torch.equal to
   their plain versions on the busiest shard's schedule, both timed;
   coarse ms, per-shard assembly and search seconds, µs/query, codes
   scanned per query at 4 against 1 shard (the JAX tool's per-shard
   max_codes budget), R@1/10/100. ``--only 19`` runs just this phase.
20. the bench tool's stages ([bench20] lines; ivfhnsw_tpu_torch/tools/
   bench.py in process): ``deep`` (d=96, PQ16 so dsub=6, nc=2^17, nprobe
   128, max_codes 30k, 2048 queries) and ``grouping_scale`` (nc=2^17,
   nsubc 64, OPQ, pruning, max_codes 100k, 1024 queries) at the tool's
   sizes, nothing cut (20M and 33.5M vectors); each built by the tool's
   builder (seconds by stage) and evaluated by its stage function (the
   exact-ADC ceiling and its seconds, R@1/10/100, sustained and
   single-launch µs/query), the scan kernel required to launch; then both
   slot widths with wide and two-phase top-k (deep) or pruning on and off
   (grouping), each through the tool's timed_qps with the scan kernels'
   launch counts required to grow, results equal across widths (and
   top-k), 64 queries equal to engine "torch"; K1-K4 (deep) and K5/K6
   (grouping_scale) torch.equal to their plain versions on that stage's
   schedule, timed, bound beside them (records gain "deep" / "gscale").
   Phase 17 also prints the scale2 exact-ADC ceiling beside its recall.
   ``--only 20`` runs just this phase.
21. the bench tool's ``scale3sl`` and then ``scale4`` stages ([bench21]
   lines; tools/bench.py in process, through phase 20's stage routine,
   records gain "s3sl" / "s4"): d=128, PQ16 + norm PQ, SIFT statistics,
   the sweep 32/10k, 64/30k, 128/100k, k 10 and 100, 1024 queries, 128
   then 256 codes a list, with one cut: nc=2^17 over 2^24 rows, extended
   to 2^25, where the stages run nc=2^20 over 2^27 / 2^28 (an eighth of
   the exact assignment's nb x nc; cutting nb alone would leave 8-16
   codes a list, another regime for the kernels). scale4 extends
   scale3sl's cached index, and its store must be scale3sl's plus the
   extension; then examples_torch/run_sift1b.sh runs on the card with its
   default device at a tiny synthetic size (rc 0, a Recall@ line).
   ``--only 21`` runs just this phase.
22. the evidence tools ([evidence] lines; ivfhnsw_tpu_torch/tools/
   assign_ab.py, coarse_ab.py, routed_tune.py, siftlike_scale_calibrate.py
   in process): 22a assign_ab at its own size, 16,777,216 SIFT-like rows
   over phase 20's grouping_scale centroids (nc=2^17): three twins (exact,
   routed w=4, w=16) with their recall, match rates and list sizes, each
   searched at both slot widths, wide and two-phase, equal across them and
   on 64 queries to engine "torch", with K1-K4 torch.equal to their plain
   versions on the routed twins' schedules (records "ab_w4" / "ab_w16");
   22b coarse_ab on phase 21's scale3sl (its cut), then the bench record's
   evidence fields from that cache; 22c routed_tune --quick on phase 17's
   scale2 index (B=256) and the routed gate's top-100 result overlap at w
   = 16, 32, 64 and n_super, each missing label classed (outranked at the
   boundary, in a list the routed search did not admit, and whether the
   partition placed that list's centroid outside its 8 nearest supers);
   22d siftlike_scale_calibrate at a cut of its density (2^21 rows over
   nc 2^14, 128 codes a list) at the tool's 128-byte codes and at 16
   bytes. ``--only 22`` runs just this phase, building what it needs.
23. the bench tool's run control and its helpers ([bench23] lines;
   ivfhnsw_tpu_torch/tools/warm_cache.py, scale4_eval.py, bench.py,
   render_results.py) on phase 21's cut cache: 23a warm_cache scale3sl,
   scale4 with their ceiling files removed finds both builds and writes
   only the two ceilings, equal to the stages'; 23b scale4_eval as the
   phase's main path (K1 or K2 required to launch), its eval.json equal to
   the scale4 stage's fields run just after but for the measured times, K1
   and K3 torch.equal to plain on scale4's schedule (records "s4eval");
   23c a bench subprocess at the BENCH_SMOKE sizes sent SIGTERM on the
   first stderr line of its second stage's (deep's) build: rc 143, its last stdout line =
   last_result.json with terminated_by_signal; 23d bench at the
   BENCH_SMOKE sizes in a temporary cache with scale2 warm under a budget
   of scale2's warm seconds and 20 (only the warm stages run) and under
   budget 0 (every stage skipped), each
   skipped stage with its marker and no field; 23e render_results on those
   records into a copy of README.md, every measured row with this card's
   nvidia-smi line. ``--only 23`` runs just this phase, building the cut
   cache first.
24. exact assignment's kernel ([assign] lines; csrc/assign_min.cu through
   ops/cuda/assign_min.py::top1_update, which every exact top-1 sweep of
   ops/distances.py::streaming_topk_l2 calls once per score block): the
   kernel torch.equal to its plain version, distances and ids, on a
   [4096, 16384] block of SIFT-like rows against nc=2^20 SiftLikeDeviceGen
   centroids (two blocks carried), over a ragged sweep (B 4097, 2 x 16384
   + 77 centroids) and on duplicated centroids within a block and across a
   block edge (the first index wins); its time per block against its
   bound and the plain version's; then tools/assign_probe.py at nc=2^20
   over 2^21 rows as the phase's main path: s per 1M rows of the kernel
   path, the four passes it replaced and the GEMMs alone, ids equal but
   at exact ties, beside the nvidia-smi line. Phases 4, 17, 20 and 21
   require the kernel to launch in their builds; its record's launches are
   theirs and this phase's. ``--only 24`` runs just this phase.
25. the search properties of SURVEY.md §4 (tests/test_properties.py) on
   phase 4's index ([props] lines): with engine "fused" through
   search_device at each slot width x top-k (K1/K2 wide, K3/K4 two-phase),
   R@100 at k=100 monotone within 1e-9 over nprobe 8 / 32 / 128 / 512 and
   over max_codes 2k / 10k / 50k / unlimited at nprobe 128; every point
   searched twice and torch.equal; distances sorted; k=400 at nprobe 1
   padded with +inf and label -1 exactly past the probed list's size
   (lists hold 488 codes on average, so some hold fewer than 400); every
   combination equal to chunk-wide's under the cross-engine contract; each
   combination's kernel must launch, its launches filed under phase 25.
   ``--only 25`` runs just this phase, building the primary index first.

Every min-kernel check on a path's schedule (phases 6, 17-23, s4full)
also times K3/K4 against the first port in turns (10 pairs, and in how
many of them it was the faster; phases 17 and 18a also the min steps of
MIN_RIVALS, each torch.equal to production) and counts the lookups' bank
conflicts (lookup_conflict_ms); every wide-kernel check there (and in
phases 5 and 16) holds K1/K2 torch.equal to their first port
(direct_wide_kernel) and times them against it in turns (10 pairs).

Every kernel record carries bound_ms, the least time the card could take
for the call (ivfhnsw_tpu_torch/utils/roofline.py): the larger of its bytes
(each input read once: LUTs, norm table, the schedule and the store rows
the schedule touches; the output written once) over 3.35 TB/s and its f32
operations over 67 TFLOP/s, the H100 SXM data-sheet peaks at 700 W; and
lookup_ms, the time of its shared-memory table lookups at one word per bank
per clock on every SM (SM count x 32 x the maximum SM clock that nvidia-smi
reports), which is not part of the bound.

Then the command's seconds ([time] command_s), one JSON line of kernel
results, the nvidia-smi line, and as the last line {"ok": true, "device":
{...}}.

Run from the root of a checkout:  python3 chip_smoke.py
It needs one CUDA device and exits non-zero, printing no result, without one.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time

from concurrent.futures import ThreadPoolExecutor

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
ASSIGN_SOURCE = "ivfhnsw_tpu_torch/csrc/assign_min.cu"
GROUPING_KERNELS = {256: "ivfhnsw_tpu/ops/pallas/grouping_scan.py:113",
                    1024: "ivfhnsw_tpu/ops/pallas/grouping_scan.py:248"}
GROUPING_SOURCE = "ivfhnsw_tpu_torch/csrc/grouping_scan.cu"
GROUPING_LAB_SOURCE = "ivfhnsw_tpu_torch/csrc/grouping_lab.cu"
FLAGSHIP = dict(nsubc=64, do_opq=True, do_pruning=True)
SEARCH_BATCH = 8192  # IVFADCIndex.search's default batch
LAB_SOURCE = "ivfhnsw_tpu_torch/csrc/scan_lab.cu"
# Phase 17: the JAX bench's scale2 point (bench.py:66-75, :957-1075,
# :3130-3195) built by the port's tools/bench.py at its sizes, nothing cut;
# k and the queries held to the torch engine here. Phase 17b: its scale3
# corpus at nc=2^20, coarse selection only (bench.py:76-83, :1078-1120,
# :1170-1185).
SCALE2 = dict(k=10, ctl=64)
COARSE20 = dict(nc=1_048_576, learn=8_388_608, nq=1024, d=128, nprobe=128,
                n_super=2048, match_sample=32_768)
OVERLAP_TARGET = 0.95
# Phase 19: the 1B tools at the scale3 geometry (nc=2^20, d=128, code_size
# 16, 1024 queries, nprobe 128, max_codes 100,000, k=100, batches of 2^21),
# cut in one thing only: 2^28 vectors where users build 1e9.
ONE_B = dict(target=268_435_456, batch=2_097_152, nprobe=128,
             max_codes=100_000, k=100, ctl=64)


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


def assert_same(d1, l1, d2, l2, what: str, atol: float = ATOL) -> None:
    """The cross-engine contract: distances within RTOL / ``atol``, labels
    may differ only where distances tie."""
    np.testing.assert_allclose(d2, d1, rtol=RTOL, atol=atol, err_msg=what)
    mism = l1 != l2
    if mism.any() and not np.allclose(d1[mism], d2[mism], rtol=RTOL,
                                      atol=atol):
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
            out, bins = fn(*args, bins=True)
            _sync(device)
            if torch.isnan(out).any():
                raise AssertionError(f"{tag} gran={gran}: NaN lanes")
            ref = plain(*args)
            err = compare(out, ref, f"{tag} synthetic gran={gran}")
            if tag == "gkernel" and not torch.equal(out, ref):
                raise AssertionError(f"gkernel synthetic gran={gran}: not "
                                     "torch.equal to its plain version")
            check_bins(bins, ref, f"{tag} synthetic gran={gran}")
            if not torch.equal(fn(*args), out):
                raise AssertionError(f"{tag} synthetic gran={gran}: lanes "
                                     "differ without bin minima")
            print(f"[{tag}] gran={gran} B={B} slots={nslots}: matches plain"
                  + (" (torch.equal)" if tag == "gkernel" else "")
                  + f", max_abs_err={err!r}; bin minima torch.equal to the "
                  "plain lanes', lanes the same without them", flush=True)
            if tag == "kernel":
                check_min_kernel(args, out, f"synthetic gran={gran}")


# Min-scan steps (scan_lab.MIN_STEPS) that phases 17 and 18a time against
# the first port beside production, on stores larger than L2 (dense and
# sparse schedules): two codes a lane a step (production before it took
# one) and the prefetching lead.
MIN_RIVALS = ("dp4a_tma_b8", "dp4a_pf_b6")


def first_port_turns(args, rounds: int = 5, rivals=(),
                     wide: bool = False) -> dict:
    """The production min kernel (with ``wide`` the wide kernel, writing
    its bin minima as the search does) against
    its first port (``scan_lab.scan_min_step`` / ``scan_wide_step``
    "first_port": ``direct_min_kernel`` / ``direct_wide_kernel``) on
    ``args`` (the scan wrappers' arguments, gran last), the first port and
    each step named in ``rivals`` first held torch.equal to production,
    then timed in turns (A B B A, ``rounds`` times, CUDA events): both
    medians, their ratio and in how many of the 2 * ``rounds`` pairs
    production was the faster; the same under "rivals" for each rival."""
    import torch
    from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
    from ivfhnsw_tpu_torch.ops.cuda import scan_lab as sl
    from ivfhnsw_tpu_torch.tools.min_probe import in_turns, wins
    prod_fn = wide_lanes if wide else tk.adc_scan_slots_min
    table, run_step = ((sl.WIDE_STEPS, sl.scan_wide_step) if wide
                       else (sl.MIN_STEPS, sl.scan_min_step))

    def step(name):
        return lambda: run_step(*args[:7], args[7], table[name])
    prod = prod_fn(*args)
    for name in ("first_port", *rivals):
        if not torch.equal(step(name)(), prod):
            raise AssertionError(f"{'wide' if wide else 'min'} step {name}: "
                                 "not torch.equal to production")
    del prod
    new, old, ta, tb = in_turns(lambda: prod_fn(*args), step("first_port"),
                                device_ms, rounds)
    out = {"in_turns_ms": new, "first_port_ms": old,
           "over_first_port": new / old, "wins": wins(ta, tb),
           "pairs": len(ta)}
    if rivals:
        out["rivals"] = {}
        for name in rivals:
            m, f, ta, tb = in_turns(step(name), step("first_port"),
                                    device_ms, rounds)
            out["rivals"][name] = {"ms": m, "first_port_ms": f,
                                   "over_first_port": m / f,
                                   "wins": wins(ta, tb), "pairs": len(ta)}
    return out


def turns_text(r: dict) -> str:
    """``first_port_turns``' result as the end of a line."""
    return (f"in turns {r['in_turns_ms']:.4f} ms against the first port's "
            f"{r['first_port_ms']:.4f} ms: "
            f"{r['over_first_port']:.3f}x, faster in {r['wins']} of "
            f"{r['pairs']} pairs" + "".join(
                f"; step {n} {v['ms']:.4f} ms: {v['over_first_port']:.3f}x, "
                f"faster in {v['wins']} of {v['pairs']}"
                for n, v in r.get("rivals", {}).items()))


# Wide-scan steps (scan_lab.WIDE_STEPS) that phases 17 and 18a time against
# the first port beside production, on stores larger than L2 (dense and
# sparse schedules): the first port's stores as production had them
# before this design, and the two layouts production takes by slot width.
WIDE_RIVALS = ("stream", "warp", "dp4a")


def check_bins(bins, ref, what: str) -> None:
    """The bin-32 minima a production scan wrote beside its lanes:
    torch.equal to the minima of its plain version's lanes ``ref``."""
    import torch
    from ivfhnsw_tpu_torch.ops.cuda.adc_scan import bin_minima
    if not torch.equal(bins, bin_minima(ref)):
        raise AssertionError(f"{what}: bin minima not torch.equal to the "
                             "plain lanes' minima")


def wide_lanes(*args):
    """K1 / K2 as the search launches them, writing the bin minima too;
    returns the lanes."""
    from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
    return tk.adc_scan_slots(*args, bins=True)[0]


def grouping_lanes(*args):
    """K5 / K6 as the search launches them, writing the bin minima too;
    returns the lanes."""
    from ivfhnsw_tpu_torch.ops.cuda import grouping_scan as tg
    return tg.grouping_scan_slots(*args, bins=True)[0]


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


class PhaseClock:
    """Host seconds of each phase of :func:`run`, from one mark to the
    next."""

    def __init__(self):
        self.seconds, self._t = {}, time.perf_counter()

    def mark(self, phase: str) -> None:
        now = time.perf_counter()
        self.seconds[phase] = round(now - self._t, 2)
        self._t = now


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

    def vector_add_argv(self, out_dir: str, segments: int = 0,
                        segment_dir: str = "") -> list:
        """vector_add over the corpus files, the coarse centroids and the
        flagship's quantizer files: the base split into ``segments``, or
        the segments in ``segment_dir``; its indexes go to ``out_dir``."""
        quant = {k: v for k, v in {**self.SHARED,
                                   **self.OWN["grouping"]}.items()
                 if k not in ("path_precomputed_idxs", "path_index")}
        split = (["-segment_dir", segment_dir] if segment_dir
                 else ["-segments", segments])
        return [str(x) for x in
                split + self.sizes() + self.flagship()
                + self.flags({**self.CORPUS, **quant})
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


def run_files(device, files: SmokeFiles, ds, first: dict) -> list:
    """Phase 12 after run 1 of both drivers (``first``: their results by
    index): run 2 from the files, the byte-identical rewrite, disk_rerank
    and vector_add; returns vector_add's per-segment records."""
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
    print(f"[files] vector_add -segments 4 over base.fvecs: ntotal "
          f"{[r['ntotal'] for r in res]}, R@10 per segment "
          f"{[round(r['recalls'][10], 4) for r in res]}, after the last "
          f"segment R@1 {last[1]:.4f} R@10 {last[10]:.4f} (one-shot build "
          f"{ann[1]:.4f} / {ann[10]:.4f}), index files "
          f"{[os.path.getsize(os.path.join(va_dir, n)) for n in names]} B, "
          f"command {wall:.2f} s", flush=True)
    return res


def main(argv: list) -> int:
    """The smoke run; ``--only 17,17b,18,19,20,21,22,23,24,25`` builds the
    kernels and runs only the named large-nc phases (18: its scale2 part,
    18a-18b, after phase 17; 19: the 1B path; 20, 21: the bench stages;
    22: the evidence tools, 23: the bench's run control and helpers, each
    building what it needs; 24: exact assignment's kernel; 25: the search
    properties on the primary index, which it builds; ``s4full``:
    K1-K4 on a full-size scale4 build in the bench tool's cache,
    :func:`run_scale4_kernels`; a partial run: no kernels line, no
    result)."""
    import torch
    t_command = time.perf_counter()
    only = (argv[argv.index("--only") + 1].split(",") if "--only" in argv
            else None)
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
                            "scan_lab", "assign_min"])
    tk._entry("ivf_adc_scan_slots")
    tk._entry("ivf_adc_scan_slots_min")
    tg._kernel()
    from ivfhnsw_tpu_torch.ops.cuda import grouping_lab as gl
    gl._entry()
    from ivfhnsw_tpu_torch.ops.cuda import scan_lab as sl
    for name in sl.VARIANTS:
        sl._entry(name)
    sl._mstep_entry()
    sl._wstep_entry()
    from ivfhnsw_tpu_torch.ops.cuda import assign_min as am
    am._kernel()
    print(f"[build] {sos} in {time.perf_counter() - t0:.2f}s", flush=True)
    for so in sos:
        with open(so[:-3] + ".log") as f:
            print("[build] nvcc: " + " | ".join(
                ln.strip() for ln in f if "ptxas" in ln or "error" in ln),
                flush=True)

    if only:
        pl, clock = PhaseLaunches(), PhaseClock()
        if "17" in only or "18" in only:       # 18 shards phase 17's index
            s2res = run_scale2(device, SCALE2, pl, [])
            clock.mark("17")
        if "17b" in only:
            run_coarse20(device, COARSE20)
            clock.mark("17b")
        if "18" in only:
            run_sharded_scale2(device, s2res, pl, [])
            clock.mark("18a-b")
        if "19" in only:
            run_onebillion(device, ONE_B, pl, [])
            clock.mark("19")
        if "20" in only:
            run_bench20(device, pl, [])
            clock.mark("20")
        if "21" in only:
            run_bench21(device, pl, [])
            clock.mark("21")
        if "22" in only:
            run_evidence(device, pl, [])
            clock.mark("22")
        if "23" in only:
            run_bench23(device, pl, [])
            clock.mark("23")
        if "24" in only:
            run_assign_min(device, pl, [])
            clock.mark("24")
        if "s4full" in only:
            run_scale4_kernels(device)
            clock.mark("s4full")
        if "25" in only:
            run_props(device, *primary_index(device), pl)
            clock.mark("25")
        print("[time] phases_s " + json.dumps(clock.seconds) + "; launches "
              + json.dumps(pl.by_kernel) + f"; command_s "
              f"{time.perf_counter() - t_command:.2f}", flush=True)
        return 0

    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        kernels = run(device, PRIMARY, SmokeFiles(tmp, PRIMARY))
    print(f"[time] command_s {time.perf_counter() - t_command:.2f}",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(device, p: dict, files: SmokeFiles, s2: dict = SCALE2,
        s20: dict = COARSE20, onebillion: dict = ONE_B) -> list:
    """Phases 3-25 on ``device`` at the sizes ``p`` (phases 17 / 17b / 19:
    ``s2`` / ``s20`` / ``onebillion``; phases 20-23 at the bench tool's) over
    the files ``files``; returns the kernel result records."""
    import torch
    from ivfhnsw_tpu_torch.drivers import common as C
    from ivfhnsw_tpu_torch.drivers import ivfadc_eval
    from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
    from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
    from ivfhnsw_tpu_torch.ops.topk import binned_topk_smallest
    from ivfhnsw_tpu_torch.utils.config import (IndexConfig, RunConfig,
                                                SearchParams)
    from ivfhnsw_tpu_torch.utils.roofline import scan_bound

    clock = PhaseClock()
    pl = PhaseLaunches()
    # 3. kernels against plain on synthetic slots
    phase_kernels_vs_plain(device, p["nb"])
    clock.mark("3")

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
    first = {"ivfadc": pl.assign("4", lambda: run_driver(
        ivfadc_eval.main, files.argv("ivfadc"), COLD["ivfadc"],
        "ivfadc run 1"), "ivfadc_eval's build")}
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

    clock.mark("4")

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
        dists, bins = tk.adc_scan_slots(*args, bins=True)
        ref = tk.adc_scan_slots_plain(*args)
        err = compare(dists, ref, f"main-path gran={gran}")
        check_bins(bins, ref, f"main-path gran={gran}")
        del ref
        topk = lambda: binned_topk_smallest(dists, params.k, bin_size=32,
                                            bmin=bins)
        best, sel = topk()
        ids = lambda: st.ids_t[torch.gather(start, 1, sel // gran)
                               + sel % gran]
        core = lambda: tk.search_core(
            q, index.centroids, index.centroid_norms, index.pq.codebooks,
            index.norm_pq.centroids, st.codes_t, st.ids_t, st.norm_codes_t,
            st.list_offsets_t, params.max_codes, nprobe=params.nprobe,
            k=params.k, nslots=nslots, gran=gran,
            coarse_block=index._coarse_block_for(q.shape[0]))
        ms = device_ms(lambda: wide_lanes(*args))
        plain_ms = device_ms(lambda: tk.adc_scan_slots_plain(*args))
        layers = {"coarse": device_ms(coarse), "luts": device_ms(luts),
                  "schedule": device_ms(sched), "scan": ms,
                  "topk": device_ms(topk), "ids": device_ms(ids),
                  "search_core": device_ms(core)}
        valid = int(length.sum())
        nbytes = (valid * (st.code_m + 1) + dists.numel() * 4
                  + bins.numel() * 4 + B * (st.code_m + 1) * 1024)
        wturns = first_port_turns(args, wide=True)
        print(f"[kernel] main-path gran={gran} B={B} slots={nslots} "
              f"lane fill {valid / dists.numel():.3f}: kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.1f} GB/s of codes+output+bins+LUT), "
              f"bin minima torch.equal to the plain lanes', plain "
              f"{plain_ms:.4f} ms, max_abs_err {err!r}; "
              f"{turns_text(wturns)}", flush=True)
        print(f"[layers] gran={gran} B={B} ms " + json.dumps(
            {k: round(v, 4) for k, v in layers.items()}), flush=True)
        kernels.append({"name": f"adc_scan_slots_gran{gran}", "route": "cuda",
                        "source": SOURCE, "replaces": KERNELS[gran],
                        "launches": launches[gran], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms,
                        **scan_bound(args, dists.numel(), st.code_m + 1,
                                     st.code_m + 1, bins=True),
                        "library_ms": None, **wturns})
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

    del args, dists         # they hold the store's device tensors
    clock.mark("5")

    # 6. the two-phase top-k path over the same index
    kernels += run_two_phase(device, cfg, ds, index, results)
    clock.mark("6")

    # 6b. the scan kernels over stores that differ only in their banks
    from ivfhnsw_tpu_torch.tools import bank_probe
    bank_probe.run(index, ds.queries, params, device, batch=SEARCH_BATCH,
                   log=lambda m: print(m, flush=True))
    clock.mark("6b")

    # 6c. the min kernel's design steps against its first port
    kernels += run_min_probe(device, index, ds.queries, params, kernels,
                             ("real", "free"), "[mprobe]", "mprobe")
    clock.mark("6c")

    # 6d. the wide kernel taken apart, its design steps against its first
    # port
    kernels += run_wide_probe(device, index, ds.queries, params, kernels)
    clock.mark("6d")

    # 7. determinism of k-means at the primary point
    phase_determinism(ds, p, device)
    clock.mark("7")

    # 8-9. the grouping main path at the flagship point, then its layers
    gkernels, gi, gresults, first["grouping"] = run_grouping(
        device, p, cfg, ds, files)
    kernels += gkernels
    clock.mark("8-9")

    # 10. the query surface
    run_surface(device, cfg, ds, index, gi, gresults)
    clock.mark("10")

    # 11. the scan lab, through the index read back from disk
    kernels += run_lab(device, cfg, ds, index, results)
    clock.mark("11")

    # 12. run 2 of both drivers from the files, disk_rerank, vector_add
    va = run_files(device, files, ds, first)
    clock.mark("12")

    # 13-16. trace and counters; ORCV; device build, checkpoint and
    # vector_split; the SIFT-like corpus
    gcfg = flagship_cfg(cfg)
    run_trace(device, cfg, gcfg, ds, index, gi, files, pl)
    clock.mark("13")
    run_orcv(device, cfg, ds, index, gi, files, first, pl)
    clock.mark("14")
    run_device_build(device, cfg, gcfg, ds, index, gi, files, results,
                     gresults, va, pl)
    clock.mark("15")
    run_siftlike(device, p, cfg, gcfg, results, gresults, kernels, pl)
    clock.mark("16")
    # 17-17b. the large-nc path: the scale2 point, coarse at nc=2^20 (the
    # earlier phases' cached blocks go back to the card first)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    s2res = run_scale2(device, s2, pl, kernels)
    clock.mark("17")
    run_coarse20(device, s20)
    clock.mark("17b")
    # 18. the sharded paths: scale2 over 8 local shards and one NCCL rank,
    # then the flagship, the streamed build and the sharded checkpoint
    run_sharded_scale2(device, s2res, pl, kernels)
    s2res["index"].release_device()      # its host store waits for 22c
    if device.type == "cuda":
        torch.cuda.empty_cache()
    clock.mark("18a-b")
    run_sharded_primary(device, cfg, ds, index, gi, pl, kernels)
    clock.mark("18c-e")
    # 19. the 1B path: build_1b.py with a resume, search_1b.py at 4 and 1
    # shards, both slot widths, wide and two-phase
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run_onebillion(device, onebillion, pl, kernels)
    clock.mark("19")
    # 20-22. the bench tool's deep and grouping_scale stages; its scale3sl
    # and scale4 stages, one launcher; the evidence tools on their caches
    # and on phase 17's index
    import tempfile
    with tempfile.TemporaryDirectory(prefix="bench2x_") as tmp:
        caches = {ph: os.path.join(tmp, ph) for ph in ("20", "21")}
        for c in caches.values():
            os.makedirs(c)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        run_bench20(device, pl, kernels, caches["20"])
        clock.mark("20")
        if device.type == "cuda":
            torch.cuda.empty_cache()
        run_bench21(device, pl, kernels, cache=caches["21"])
        clock.mark("21")
        if device.type == "cuda":
            torch.cuda.empty_cache()
        run_evidence(device, pl, kernels, caches, s2res)
        del s2res
        clock.mark("22")
        if device.type == "cuda":
            torch.cuda.empty_cache()
        run_bench23(device, pl, kernels, cache=caches["21"])
        clock.mark("23")
    # 24. exact assignment's kernel against plain, the probe at nc=2^20
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run_assign_min(device, pl, kernels)
    clock.mark("24")
    # 25. SURVEY.md §4's properties on phase 4's index, K1-K4
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run_props(device, index, ds, pl)
    clock.mark("25")
    pl.attach(kernels)
    print("[time] phases_s " + json.dumps(clock.seconds), flush=True)
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
        turns = first_port_turns(args)
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
              f"{plain_ms:.4f} ms, max_abs_err {err!r}; "
              f"{turns_text(turns)}", flush=True)
        print(f"[tplayers] gran={gran} B={B} ms " + json.dumps(
            {k: round(v, 4) for k, v in layers.items()}), flush=True)
        kernels.append({"name": f"adc_scan_slots_min_gran{gran}",
                        "route": "cuda", "source": SOURCE,
                        "replaces": MIN_KERNELS[gran],
                        "launches": launches[gran], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, **b,
                        "library_ms": None, **turns})

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


def run_min_probe(device, index, queries, params, kernels: list, stores,
                  tag: str, key: str, steps=None) -> list:
    """Phase 6c (and phase 16's last part): tools/min_probe.py on
    ``index``'s schedule for one 8192-query batch at both slot widths over
    ``stores``: each step of ``steps`` (default min_probe.SMOKE_STEPS: the
    first port's compute-only / loads-only split, one switch a step to the
    production setting, and production's split) and the production min
    kernel torch.equal to its plain version and timed against the first
    port in turns, the lookups' shared-memory wavefronts and conflict floor,
    and (with ``key`` "mprobe") each kernel's SASS instructions per warp and
    code; the lab's min-step launch counts reset before and required to
    grow. Production's time in turns, the first port's, and the floors go
    under ``key`` in the K3/K4 records of ``kernels``. Returns one kernel
    record per step and width on the real store (none for phase 16)."""
    from ivfhnsw_tpu_torch.ops.cuda import scan_lab as sl
    from ivfhnsw_tpu_torch.tools import min_probe
    steps = tuple(steps or min_probe.SMOKE_STEPS)
    for n in sl.MIN_LAUNCHES:
        sl.MIN_LAUNCHES[n] = 0
    recs = min_probe.run(index, queries, params, device, batch=SEARCH_BATCH,
                         steps=steps, stores=stores, rounds=1,
                         sass=key == "mprobe", tag=tag,
                         log=lambda m: print(m, flush=True))
    idle = [n for n in steps if sl.MIN_LAUNCHES[n] <= 0]
    if idle:
        raise AssertionError(f"{tag}: min steps never launched: {idle}")
    out = []
    for gran in (256, 1024):
        by = {(r["name"], r["store"]): r for r in recs
              if r.get("gran") == gran}
        prod, look = by[("production", "real")], by[("lookups", "real")]
        rec = next(k for k in kernels
                   if k["name"] == f"adc_scan_slots_min_gran{gran}")
        rec[key] = {"ms": prod["ms"], "first_port_ms": prod["first_port_ms"],
                    "over_first_port": prod["over_first_port"],
                    "lookup_ms": look["lookup_ms"],
                    "lookup_conflict_ms": look["lookup_conflict_ms"],
                    "wavefronts_per_lookup":
                        32 * look["wavefronts"] / max(look["lookups"], 1)}
        if key != "mprobe":
            continue
        for name in steps:
            r = by[(name, "real")]
            out.append({"name": f"lab_mstep_{name}_gran{gran}",
                        "route": "cuda", "source": LAB_SOURCE,
                        "replaces": MIN_KERNELS[gran],
                        "launches": sl.MIN_LAUNCHES[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "lookup_ms": r["lookup_ms"], "library_ms": None,
                        "mode": sl.MIN_STEPS[name].mode,
                        "first_port_ms": r.get("first_port_ms"),
                        "over_first_port": r.get("over_first_port")})
    return out


def run_wide_probe(device, index, queries, params, kernels: list,
                   stores=("real", "free"), tag: str = "[wprobe]",
                   key: str = "wprobe", steps=None) -> list:
    """Phase 6d: tools/wide_probe.py on ``index``'s schedule for one
    8192-query batch at both slot widths over ``stores``: the ``fill_``
    floor, each step of ``steps`` (default wide_probe.SMOKE_STEPS: every
    step of scan_lab.WIDE_STEPS)
    and the production wide kernel torch.equal to its plain version and
    timed against the first port in turns (2 pairs; tools/wide_probe.py
    takes 10 and more), each kernel's SASS instructions per warp and code;
    the lab's wide-step launch counts reset before and required to grow.
    Production's time in turns, the first port's, the split and the floor
    go under ``key`` in the K1/K2 records of ``kernels``. Returns one kernel
    record per step and width on the real store."""
    from ivfhnsw_tpu_torch.ops.cuda import scan_lab as sl
    from ivfhnsw_tpu_torch.tools import wide_probe
    steps = tuple(steps or wide_probe.SMOKE_STEPS)
    for n in sl.WIDE_LAUNCHES:
        sl.WIDE_LAUNCHES[n] = 0
    recs = wide_probe.run(index, queries, params, device, batch=SEARCH_BATCH,
                          steps=steps, stores=stores, rounds=1, tag=tag,
                          log=lambda m: print(m, flush=True))
    idle = [n for n in steps if sl.WIDE_LAUNCHES[n] <= 0]
    if idle:
        raise AssertionError(f"{tag}: wide steps never launched: {idle}")
    sass = {r["name"]: r["sass"] for r in recs if "sass" in r}
    out = []
    for gran in (256, 1024):
        by = {(r["name"], r.get("store")): r for r in recs
              if r.get("gran") == gran}
        prod = by[(wide_probe.PRODUCTION, "real")]
        rec = next(k for k in kernels
                   if k["name"] == f"adc_scan_slots_gran{gran}")
        rec[key] = {
            "ms": prod["ms"], "first_port_ms": prod["first_port_ms"],
            "over_first_port": prod["over_first_port"],
            "fill_ms": by[(wide_probe.FILL, None)]["ms"],
            "split": {f"{n}/{st}": {"ms": by[(n, st)]["ms"],
                                    "over_first_port":
                                        by[(n, st)].get("over_first_port")}
                      for n, st in wide_probe.SPLIT if (n, st) in by},
            "step": sl.wide_production_step(gran).name,
            "sass_per_code": {n: (sass[n] or {}).get("per_code")
                              for n in (sl.wide_production_step(gran).name,
                                        wide_probe.BASELINE) if n in sass}}
        for name in steps:
            r = by[(name, "real")]
            out.append({"name": f"lab_wstep_{name}_gran{gran}",
                        "route": "cuda", "source": LAB_SOURCE,
                        "replaces": KERNELS[gran],
                        "launches": sl.WIDE_LAUNCHES[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "lookup_ms": r["lookup_ms"], "library_ms": None,
                        "mode": sl.WIDE_STEPS[name].mode,
                        "first_port_ms": r.get("first_port_ms"),
                        "over_first_port": r.get("over_first_port")})
    return out


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


def flagship_cfg(cfg):
    """The run configuration ``cfg`` at the flagship point."""
    import dataclasses
    return dataclasses.replace(
        cfg, index=dataclasses.replace(cfg.index, nsubc=FLAGSHIP["nsubc"],
                                       do_opq=FLAGSHIP["do_opq"]),
        search=dataclasses.replace(cfg.search,
                                   do_pruning=FLAGSHIP["do_pruning"]))


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

    gcfg = flagship_cfg(cfg)

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
        dists, bins = tg.grouping_scan_slots(*args, bins=True)
        ref = tg.grouping_scan_slots_plain(*args)
        err = compare(dists, ref, f"grouping main-path gran={gran}")
        if not torch.equal(dists, ref):
            raise AssertionError(f"grouping main-path gran={gran}: kernel "
                                 "not torch.equal to its plain version")
        check_bins(bins, ref, f"grouping main-path gran={gran}")
        topk = lambda: tg.topk_labels(dists, start, st.ids_t, params.k, gran,
                                      bins)
        core = lambda: gi._search_fused(
            q, params, params.nprobe, nslots, gran,
            gi._coarse_for(params, params.nprobe), False)
        ms = device_ms(lambda: grouping_lanes(*args))
        plain_ms = device_ms(lambda: tg.grouping_scan_slots_plain(*args),
                             reps=5)
        layers = {"coarse": device_ms(coarse), "terms": device_ms(terms),
                  "schedule": device_ms(sched), "luts": device_ms(luts),
                  "scan": ms, "topk_ids": device_ms(topk),
                  "search_core": device_ms(core)}
        b = grouping_scan_bound(args[:-1], dists, gran, bins=True)
        valid, kept = b.pop("filled_lanes"), b.pop("kept_lanes")
        print(f"[gkernel] main-path gran={gran} B={B} slots={nslots} lane "
              f"fill {valid / dists.numel():.3f}, unpruned lanes "
              f"{kept / max(valid, 1):.3f} of filled: kernel {ms:.4f} ms "
              f"(bound {b['bound_ms']:.4f} ms by {b['bound_by']}, "
              f"{b['bound_ms'] / ms:.3f} of the kernel's time; lookups "
              f"{b['lookup_ms']:.4f} ms), plain {plain_ms:.4f} ms, "
              f"torch.equal to plain, bin minima too, max_abs_err "
              f"{err!r}", flush=True)
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


# ---------------------------------------------------------------------------
# Phases 13-16: the rest of the single-index surface
# ---------------------------------------------------------------------------

KERNEL_OF = {"ivfadc": "adc_scan_slots", "flagship": "grouping_scan_slots"}


def scan_wrappers() -> dict:
    """The production scan kernels' wrappers, by name."""
    from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
    from ivfhnsw_tpu_torch.ops.cuda import grouping_scan as tg
    return {"adc_scan_slots": tk.adc_scan_slots,
            "adc_scan_slots_min": tk.adc_scan_slots_min,
            "grouping_scan_slots": tg.grouping_scan_slots}


class PhaseLaunches:
    """The production scan kernels' launches on the main paths of phases
    13-16, by kernel record name and phase."""

    def __init__(self):
        self.by_kernel: dict = {}

    def counted(self, phase: str, gran, need, fn, what: str):
        """fn() as one main path: every production scan kernel's launch
        count set to 0 just before it and read just after; each kernel
        named in ``need`` must have launched. With a slot width ``gran``
        the counts are filed under ``phase`` (None: the path changes width
        as it goes, so they are only checked)."""
        wrappers = scan_wrappers()
        for w in wrappers.values():
            w.launches = 0
        r = fn()
        if gran is not None:
            for name, w in wrappers.items():
                if w.launches:
                    per = self.by_kernel.setdefault(f"{name}_gran{gran}", {})
                    per[phase] = per.get(phase, 0) + w.launches
        idle = [n for n in need if wrappers[n].launches <= 0]
        if idle:
            raise AssertionError(f"{what}: {idle} never launched")
        return r

    def assign(self, phase: str, fn, what: str):
        """fn() as one main path of exact assignment: the assign_min
        kernel's launch count set to 0 just before it and read just after,
        filed under ``phase``; it must have launched."""
        from ivfhnsw_tpu_torch.ops.cuda import assign_min as am
        am.top1_update.launches = 0
        r = fn()
        n = am.top1_update.launches
        if n <= 0:
            raise AssertionError(f"{what}: assign_min never launched")
        per = self.by_kernel.setdefault("assign_min", {})
        per[phase] = per.get(phase, 0) + n
        return r

    def attach(self, kernels: list) -> None:
        """Each production kernel record's launches over every main path:
        the phase that first drove it (4, 6 or 8) and phases 13-16, with
        the count per phase beside the total."""
        origin = {"adc_scan_slots": "4", "adc_scan_slots_min": "6",
                  "grouping_scan_slots": "8"}
        for rec in kernels:
            base = rec["name"].rsplit("_gran", 1)[0]
            if base in origin:
                by = {origin[base]: rec["launches"],
                      **self.by_kernel.get(rec["name"], {})}
                rec["launches_by_phase"] = by
                rec["launches"] = sum(by.values())


def mem_reset(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak_gib(device):
    """Peak device memory allocated since :func:`mem_reset`, GiB (None off
    the card)."""
    import torch
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def in_dir(path: str, fn):
    """fn() with ``path`` as the working directory (the ORCV drivers write
    their logs there)."""
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def log_blocks(path: str) -> int:
    with open(path) as f:
        return sum(1 for line in f if line.startswith("query "))


def run_trace(device, cfg, gcfg, ds, index, gi, files: SmokeFiles,
              pl: PhaseLaunches) -> None:
    """Phase 13: search(trace=True) and the stats counters of both indexes
    against their fused engines; orca_debug over phase 12's files; one
    search batch under utils/profiling.py::device_trace."""
    import tempfile

    import torch
    from ivfhnsw_tpu_torch.drivers import orca_debug
    from ivfhnsw_tpu_torch.ops.cuda import grouping_scan as tg
    from ivfhnsw_tpu_torch.utils.profiling import TRACE_FILE, device_trace

    nq = ds.nq
    q_all = torch.tensor(ds.queries, device=device)
    for name, idx, prm in (("ivfadc", index, cfg.search),
                           ("flagship", gi, gcfg.search)):
        idx.engine, idx.scan_layout, idx.scan_topk = "fused", "auto", "auto"
        gran, P = idx.scan_gran(), min(prm.nprobe, idx.nc)
        d1, l1 = pl.counted("13", gran, [KERNEL_OF[name]],
                            lambda: idx.search(ds.queries, prm),
                            f"{name} fused search")
        idx.stats = {"queries": 0, "codes_scanned": 0}
        mem_reset(device)
        t = time.perf_counter()
        d2, l2, tr = idx.search(ds.queries, prm, trace=True)
        secs = time.perf_counter() - t
        peak = peak_gib(device)
        for key, dt, shape in (("probes", np.int32, (nq, P)),
                               ("qc_dists", np.float32, (nq, P)),
                               ("included", np.bool_, (nq, P)),
                               ("n_scanned", np.int32, (nq,))):
            if tr[key].dtype != dt or tr[key].shape != shape:
                raise AssertionError(f"{name} trace {key}: {tr[key].dtype} "
                                     f"{tr[key].shape}")
        if (np.diff(tr["qc_dists"], axis=1) < 0).any():
            raise AssertionError(f"{name} trace: probes not ascending")
        if not tr["included"][:, 0].all():
            raise AssertionError(f"{name} trace: a nearest probe excluded")
        assert_same(d1, l1, d2, l2, f"{name} traced vs fused")
        swapped = int((l1 != l2).any(axis=1).sum())
        nsc = tr["n_scanned"].astype(np.int64)
        want = {"queries": nq, "codes_scanned": int(nsc.sum())}
        if idx.stats != want:
            raise AssertionError(f"{name} stats {idx.stats}, expected {want}")
        # n_scanned against the fused schedule, batch by batch: IVFADC
        # scans every code of its schedule; the flagship's schedule holds
        # whole groups of the budgeted probes and its kernel writes +inf on
        # pruned subgroups, so n_scanned is the count of finite lanes.
        held = []
        for off in range(0, nq, SEARCH_BATCH):
            q = q_all[off:off + SEARCH_BATCH]
            if name == "ivfadc":
                length = idx.scan_inputs(q, prm)[5]
                sched = length.sum(dim=1)
                scanned = sched
            else:
                args = idx.grouping_scan_inputs(q, prm)
                sched = args[7].sum(dim=1)
                scanned = torch.isfinite(
                    tg.grouping_scan_slots(*args, gran)).sum(dim=1)
            held.append((sched.cpu().numpy(), scanned.cpu().numpy()))
        sched = np.concatenate([h[0] for h in held]).astype(np.int64)
        scanned = np.concatenate([h[1] for h in held]).astype(np.int64)
        if not np.array_equal(nsc, scanned) or (sched < nsc).any():
            raise AssertionError(
                f"{name}: n_scanned differs from the fused schedule on "
                f"{int((nsc != scanned).sum())} queries")
        relation = ("= the schedule's lengths" if name == "ivfadc" else
                    f"= its finite lanes (pruned share "
                    f"{1 - nsc.sum() / max(sched.sum(), 1):.3f} of the "
                    "schedule's lengths)")
        print(f"[trace] {name}: search(trace=True) of {nq} queries (torch "
              f"engine) in {secs:.3f} s, peak device memory "
              f"{peak if peak is None else round(peak, 3)} GiB; labels equal "
              f"to the fused engine's (gran {gran}) on {nq - swapped} "
              f"queries; on {swapped} they differ only where the distances "
              f"agree within rtol {RTOL} / atol {ATOL} (D4, D5); "
              f"n_scanned per query {relation} on every query, mean "
              f"{nsc.mean():.1f} max {nsc.max()}; included probes mean "
              f"{tr['included'].sum(1).mean():.2f} of {P}; stats "
              + json.dumps(idx.stats), flush=True)
        before = dict(idx.stats)
        idx.search(ds.queries[:256], prm)
        if idx.stats != {"queries": before["queries"] + 256,
                         "codes_scanned": before["codes_scanned"]}:
            raise AssertionError(f"{name}: stats after an untraced search "
                                 f"{idx.stats}")

    # orca_debug over the IVFADC files, in a working directory of its own
    work = tempfile.mkdtemp(prefix="orca_debug_", dir=files.root)
    mem_reset(device)
    t = time.perf_counter()
    res = pl.counted("13", index.scan_gran(), [],
                     lambda: in_dir(work, lambda: orca_debug.main(
                         files.argv("ivfadc"))), "orca_debug")
    secs = time.perf_counter() - t
    peak = peak_gib(device)
    nblocks = {log: log_blocks(os.path.join(work, log))
               for log in (orca_debug.HIT_LOG, orca_debug.MISS_LOG)}
    if sum(nblocks.values()) != nq:
        raise AssertionError(f"orca_debug logs hold {nblocks} query blocks, "
                             f"expected {nq} in all")
    if res is None or res["query"] < 0:
        raise AssertionError(f"orca_debug found no miss: {res}")
    print(f"[trace] orca_debug over the IVFADC files: {secs:.2f} s, peak "
          f"device memory {peak if peak is None else round(peak, 3)} GiB; "
          f"first miss {json.dumps(res)}; log blocks "
          + json.dumps(nblocks), flush=True)

    # one search batch under device_trace
    index.engine, index.scan_layout = "fused", "auto"
    gran = index.scan_gran()
    index.search(ds.queries[:256], cfg.search)                # warm shapes
    with tempfile.TemporaryDirectory(dir=files.root) as tdir:
        with device_trace(tdir, device) as prof:
            pl.counted("13", gran, ["adc_scan_slots"],
                       lambda: index.search(ds.queries[:SEARCH_BATCH],
                                            cfg.search), "traced batch")
        size = os.path.getsize(os.path.join(tdir, TRACE_FILE))
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")),
                  key=lambda r: -r[1])
    if device.type == "cuda" and not any("adc_scan" in r[0] for r in rows):
        raise AssertionError("device_trace: no scan kernel among the device "
                             f"events {[r[0] for r in rows[:10]]}")
    total = sum(r[1] for r in rows)
    print(f"[trace] device_trace of one {min(SEARCH_BATCH, nq)}-query batch "
          f"(IVFADC, gran {gran}): {TRACE_FILE} {size} B; device time "
          f"{total / 1e3:.4f} ms over {len(rows)} kernels; top "
          + json.dumps([[r[0][:60], round(r[1] / 1e3, 4), r[2]]
                        for r in rows[:8]]), flush=True)


def run_orcv(device, cfg, ds, index, gi, files: SmokeFiles, first: dict,
             pl: PhaseLaunches) -> None:
    """Phase 14: write2 of both indexes; load_home_dir of the IVFADC dir
    (equal store, equal search); mkindex and ivfadc_eval -orca_obuf over
    phase 12's files."""
    import filecmp
    import tempfile

    import torch
    from ivfhnsw_tpu_torch.drivers import common as C
    from ivfhnsw_tpu_torch.drivers import ivfadc_eval, mkindex
    from ivfhnsw_tpu_torch.utils.orcv import load_home_dir

    homes = {}
    for name, idx in (("ivfadc", index), ("flagship", gi)):
        home = files.path(f"orcv_{name}")
        t = time.perf_counter()
        idx.write2(home, n_vecs=idx.store.ntotal)
        secs = time.perf_counter() - t
        sizes = {f: os.path.getsize(os.path.join(home, f))
                 for f in sorted(os.listdir(home))}
        homes[name] = home
        print(f"[orcv] {name} write2 in {secs:.3f} s: "
              f"{sum(sizes.values())} B, " + json.dumps(sizes), flush=True)

    own = files.OWN["ivfadc"]
    t = time.perf_counter()
    r, hdr = load_home_dir(homes["ivfadc"], device,
                           centroids_path=files.path(
                               files.SHARED["path_centroids"]))
    r.load_quantizers(files.path(own["path_pq"]),
                      files.path(own["path_norm_pq"]))
    C._sync(device)
    t_load = time.perf_counter() - t
    st, rs = index.store, r.store
    for what, a, b in (("codes", st.codes_t, rs.codes_t),
                       ("norm codes", st.norm_codes_t, rs.norm_codes_t),
                       ("list offsets", st.list_offsets_t, rs.list_offsets_t),
                       ("centroid norms", index.centroid_norms,
                        r.centroid_norms)):
        if not torch.equal(a, b):
            raise AssertionError(f"load_home_dir: {what} differ")
    params = cfg.search
    index.engine = r.engine = "fused"
    index.scan_layout = r.scan_layout = "auto"
    index.scan_topk = r.scan_topk = "auto"
    d1, l1 = index.search(ds.queries, params)
    d2, l2 = pl.counted("14", r.scan_gran(), ["adc_scan_slots"],
                        lambda: r.search(ds.queries, params),
                        "search over the loaded home dir")
    mapped = np.where(l2 >= 0, st.ids[np.maximum(l2, 0)], -1)
    if not np.array_equal(d2, d1) or not np.array_equal(mapped, l1):
        raise AssertionError("load_home_dir: the loaded index searches "
                             "differently")
    rg, hdr_g = load_home_dir(homes["flagship"], device)
    first_nc = int(gi.store.list_offsets[gi.nc])
    if (hdr_g.nc != gi.nc or hdr_g.n != gi.store.ntotal
            or not np.array_equal(rg.store.codes, gi.store.codes[:first_nc])
            or not np.array_equal(rg.store.list_offsets,
                                  gi.store.list_offsets[:gi.nc + 1])):
        raise AssertionError("load_home_dir of the flagship's dir: not its "
                             "first nc subgroup lists")
    print(f"[orcv] load_home_dir of the IVFADC dir (+ centroids and "
          f"quantizer files) in {t_load:.3f} s: codes, norm codes, offsets, "
          f"centroid norms torch.equal to the store's; search of {ds.nq} "
          f"queries: distances equal, labels equal through store.ids; the "
          f"flagship's dir reads back as its first {gi.nc} of "
          f"{gi.nc * gi.nsubc} subgroup lists ({hdr_g.nc} in the header, "
          f"the write2 quirk both packages share)", flush=True)

    # mkindex over the flagship's files: loads every artifact
    work = tempfile.mkdtemp(prefix="mkindex_", dir=files.root)
    out = os.path.join(work, "orcv")
    t = time.perf_counter()
    mk = in_dir(work, lambda: mkindex.main(files.argv("grouping")
                                           + ["-orcv_home", out]))
    secs = time.perf_counter() - t
    if mk["stages"]["how"] != WARM:
        raise AssertionError(f"mkindex: stages {mk['stages']['how']}")
    names = sorted(os.listdir(homes["flagship"]))
    if sorted(os.listdir(out)) != names or not all(
            filecmp.cmp(os.path.join(out, n),
                        os.path.join(homes["flagship"], n), shallow=False)
            for n in names):
        raise AssertionError("mkindex: its ORCV dir differs from the "
                             "flagship's write2")
    with open(os.path.join(work, mkindex.LOG)) as f:
        nlines = sum(1 for _ in f)
    if nlines != gi.nc * gi.nsubc:
        raise AssertionError(f"mkindex: {mkindex.LOG} has {nlines} lines")
    print(f"[orcv] mkindex over the flagship's files: {secs:.2f} s, every "
          f"artifact loaded, {mkindex.LOG} {nlines} lines, ORCV dir "
          f"byte-identical to the flagship's write2", flush=True)

    # ivfadc_eval -orca_obuf over the IVFADC files
    t = time.perf_counter()
    argv = files.argv("ivfadc") + ["-orca_obuf", "1"]
    ob = pl.counted("14", index.scan_gran(), ["adc_scan_slots"],
                    lambda: run_driver(ivfadc_eval.main, argv, WARM,
                                       "ivfadc_eval -orca_obuf"),
                    "ivfadc_eval -orca_obuf")
    secs = time.perf_counter() - t
    rec = np.frombuffer(ob["obuf"], dtype=[
        ("eid", "<u8"), ("code", "u1", (st.code_m,)), ("norm", "u1")])
    n = rec.shape[0]
    row = np.empty(st.ntotal, np.int64)
    row[st.ids] = np.arange(st.ntotal)
    if (n != min(C.ASSIGN_BATCH, ds.nb)
            or not np.array_equal(rec["eid"], np.arange(n))
            or not np.array_equal(rec["code"], st.codes[row[:n]])
            or not np.array_equal(rec["norm"], st.norm_codes[row[:n]])):
        raise AssertionError("-orca_obuf: the buffer's records differ from "
                             "add_batch's codes for that batch")
    if ob["index"].store.ntotal != ds.nb or not np.array_equal(
            ob["labels"], first["ivfadc"]["labels"]):
        raise AssertionError("-orca_obuf: the index or its labels differ "
                             "from a plain run's")
    print(f"[orcv] ivfadc_eval -orca_obuf over the IVFADC files: {secs:.2f} "
          f"s; add_batch2 buffer {len(ob['obuf'])} B for {n} vectors, codes "
          f"and norm codes equal to the store's for ids 0..{n - 1}; index "
          f"{ob['index'].store.ntotal} codes (the builder was emptied before "
          f"the read); labels equal to phase 12's on all {ds.nq} queries",
          flush=True)


def same_store(a, b, what: str) -> None:
    import torch
    for name in ("codes_t", "ids_t", "norm_codes_t", "list_offsets_t"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"{what}: store {name} differs")


def run_device_build(device, cfg, gcfg, ds, index, gi, files: SmokeFiles,
                     results: dict, gresults: dict, va: list,
                     pl: PhaseLaunches) -> None:
    """Phase 15: the device-resident build of both indexes from the base
    uploaded once; release_device; save_index / load_index; vector_split
    of base.fvecs, then vector_add -segment_dir."""
    import filecmp

    import torch
    from ivfhnsw_tpu_torch.drivers import common as C
    from ivfhnsw_tpu_torch.drivers import vector_add
    from ivfhnsw_tpu_torch.models.grouping import IVFADCGroupingIndex
    from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex
    from ivfhnsw_tpu_torch.tools import vector_split
    from ivfhnsw_tpu_torch.utils import checkpoint

    nb, step = ds.nb, C.ASSIGN_BATCH
    stages = {}

    def stage(name, fn):
        return timed(stages, name, fn, device)
    x_dev = stage("upload", lambda: torch.tensor(ds.base, device=device))
    keys = C.read_assignments(files.path(
        files.SHARED["path_precomputed_idxs"]))[:nb]
    ids = np.arange(nb, dtype=np.int32)

    def fresh_ivf():
        f = IVFADCIndex(index.config, device)
        f.set_centroids(index.centroids)
        f.pq, f.norm_pq = index.pq, index.norm_pq
        return f

    def fresh_grp():
        g = IVFADCGroupingIndex(gi.config, device)
        g.set_centroids(gi.centroids)
        g.compute_neighbor_centroids()
        g.pq, g.norm_pq, g.opq_R = gi.pq, gi.norm_pq, gi.opq_R
        return g

    # each build twice, from host batches (uploaded by the call) and from
    # the device copy: the same assignment and encoding, so the same store
    for where, rows in (("host", lambda o: ds.base[o:o + step]),
                        ("device", lambda o: x_dev[o:o + step])):
        f, g = fresh_ivf(), fresh_grp()
        add = f.add_batch if where == "host" else f.add_batch_device
        alpha = g.alpha_pass if where == "host" else g.alpha_pass_device
        gadd = g.add_batch if where == "host" else g.add_batch_device

        def add_ivf():
            for off in range(0, nb, step):
                add(rows(off), ids[off:off + step])

        def alpha_grp():
            for off in range(0, nb, step):
                alpha(rows(off), keys[off:off + step])
            g.finalize_alphas()

        def add_grp():
            for off in range(0, nb, step):
                gadd(rows(off), ids[off:off + step], keys[off:off + step])
        stage(f"ivfadc_add_{where}", add_ivf)
        stage(f"ivfadc_finalize_{where}", f.finalize)
        same_store(f.store, index.store, f"ivfadc build from {where} rows")
        stage(f"flagship_alpha_pass_{where}", alpha_grp)
        stage(f"flagship_add_{where}", add_grp)
        stage(f"flagship_finalize_{where}", lambda: (
            g.finalize(), g.compute_inter_centroid_dists()))
        if not torch.equal(g.alphas, gi.alphas):
            raise AssertionError(f"flagship build from {where} rows: alphas "
                                 "differ from phase 8's")
        same_store(g.store, gi.store, f"flagship build from {where} rows")
        del f, g
    del x_dev
    if device.type == "cuda":
        torch.cuda.empty_cache()
    print(f"[device] both indexes built from host rows (add_batch, "
          f"alpha_pass) and from the base uploaded once (add_batch_device, "
          f"alpha_pass_device): every store torch.equal to phases 4 / 8, "
          f"alphas torch.equal; seconds "
          + json.dumps({k: round(v, 3) for k, v in stages.items()}),
          flush=True)

    # release_device, then the same search
    for name, idx, prm, ref in (("ivfadc", index, cfg.search, results),
                                ("flagship", gi, gcfg.search, gresults)):
        idx.engine, idx.scan_layout, idx.scan_topk = "fused", "auto", "auto"
        want = ref[idx._resolve_layout()]
        st = idx.store
        dropped = sum(t.numel() * t.element_size() for t in st._dev.values())
        held = torch.cuda.memory_allocated(device) if device.type == "cuda" \
            else 0
        idx.release_device()
        freed = (held - torch.cuda.memory_allocated(device)
                 if device.type == "cuda" else 0)
        if st._dev or st._grouped is not None or (
                device.type == "cuda" and freed < dropped):
            raise AssertionError(f"{name} release_device: {freed} B freed "
                                 f"of the store's {dropped} B")
        t = time.perf_counter()
        d, l = pl.counted("15", idx.scan_gran(), [KERNEL_OF[name]],
                          lambda: idx.search(ds.queries, prm),
                          f"{name} search after release_device")
        secs = time.perf_counter() - t
        if not (np.array_equal(d, want["dists"])
                and np.array_equal(l, want["labels"])):
            raise AssertionError(f"{name}: the search after release_device "
                                 "differs from the one before")
        print(f"[device] {name} release_device freed {freed} B of device "
              f"memory (of which the store's flat tensors {dropped} B); the "
              f"next search ({secs:.3f} s, the store uploaded "
              f"again) equals phase {4 if name == 'ivfadc' else 8}'s on all "
              f"{ds.nq} queries", flush=True)

    # checkpoint directories
    for name, idx, prm, ref in (("ivfadc", index, cfg.search, results),
                                ("flagship", gi, gcfg.search, gresults)):
        cdir = files.path(f"checkpoint_{name}")
        t = time.perf_counter()
        checkpoint.save_index(idx, cdir)
        t_save = time.perf_counter() - t
        nbytes = sum(os.path.getsize(os.path.join(cdir, n))
                     for n in os.listdir(cdir))
        t = time.perf_counter()
        li = checkpoint.load_index(cdir, device)
        C._sync(device)
        t_load = time.perf_counter() - t
        li.engine, li.scan_layout, li.scan_topk = "fused", "auto", "auto"
        want = ref[li._resolve_layout()]
        d, l = pl.counted("15", li.scan_gran(), [KERNEL_OF[name]],
                          lambda: li.search(ds.queries, prm),
                          f"{name} search of the loaded checkpoint")
        if not (np.array_equal(d, want["dists"])
                and np.array_equal(l, want["labels"])):
            raise AssertionError(f"{name}: the loaded checkpoint searches "
                                 "differently")
        print(f"[checkpoint] {name}: save_index {t_save:.3f} s, {nbytes} B "
              f"in {len(os.listdir(cdir))} files; load_index {t_load:.3f} s; "
              f"search equal on all {ds.nq} queries", flush=True)
        shutil.rmtree(cdir)

    # vector_split of base.fvecs, then vector_add over its segments
    seg_dir, out = files.path("segments"), files.path("vector_add_split")
    os.makedirs(out)
    t = time.perf_counter()
    written = vector_split.split(files.path("base.fvecs"), cfg.index.d, 4,
                                 seg_dir)
    t_split = time.perf_counter() - t
    t = time.perf_counter()
    res = pl.counted("15", None, ["grouping_scan_slots"],
                     lambda: vector_add.main(files.vector_add_argv(
                         out, segment_dir=seg_dir)), "vector_add -segment_dir")
    wall = time.perf_counter() - t
    names = sorted(os.listdir(out))
    if ([r["ntotal"] for r in res] != [r["ntotal"] for r in va]
            or [r["recalls"] for r in res] != [r["recalls"] for r in va]):
        raise AssertionError(
            f"vector_add over vector_split's segments: ntotal / recall "
            f"{[(r['ntotal'], r['recalls'][10]) for r in res]}, phase 12 "
            f"{[(r['ntotal'], r['recalls'][10]) for r in va]}")
    if names != sorted(os.listdir(files.path("vector_add"))) or not all(
            filecmp.cmp(os.path.join(out, n),
                        os.path.join(files.path("vector_add"), n),
                        shallow=False) for n in names):
        raise AssertionError("vector_add over vector_split's segments: its "
                             "index files differ from phase 12's")
    print(f"[split] vector_split of base.fvecs into {len(written)} segments "
          f"in {t_split:.2f} s ({[os.path.basename(w) for w in written]}); "
          f"vector_add -segment_dir over them {wall:.2f} s: ntotal "
          f"{[r['ntotal'] for r in res]}, R@10 per segment "
          f"{[round(r['recalls'][10], 4) for r in res]}, equal to phase 12's "
          f"-segments 4 run, index files byte-identical", flush=True)
    shutil.rmtree(seg_dir)


def run_siftlike(device, p: dict, cfg, gcfg, results: dict, gresults: dict,
                 kernels: list, pl: PhaseLaunches) -> None:
    """Phase 16: the SIFT-like corpus (the JAX bench's siftlike stage,
    bench.py:1787-1821): both indexes built at the primary point, searched
    with the fused engine at both slot widths (IVFADC wide and two-phase,
    the flagship wide); each kernel's time and lane fill on this corpus;
    SiftLikeDeviceGen against the host corpus."""
    import dataclasses

    import torch
    from ivfhnsw_tpu_torch.drivers import common as C
    from ivfhnsw_tpu_torch.models.grouping import IVFADCGroupingIndex
    from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex
    from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
    from ivfhnsw_tpu_torch.ops.cuda import grouping_scan as tg
    from ivfhnsw_tpu_torch.utils.recall import recall_at_k
    from ivfhnsw_tpu_torch.utils.siftlike import (D, SiftLikeCorpus,
                                                  SiftLikeDeviceGen)

    nb, nq, step = p["nb"], p["nq"], C.ASSIGN_BATCH
    stages = {}

    def stage(name, fn):
        return timed(stages, name, fn, device)
    corpus = SiftLikeCorpus(n_classes=65536, seed=1)
    per = 125_000

    def draw():
        # one RandomState per batch: the same bytes in any order, so the
        # batches are drawn on every host core at once
        with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
            parts = list(ex.map(lambda i: corpus.batch(per, seed=100 + i),
                                range(-(-nb // per))))
        return np.concatenate(parts)[:nb]
    base = stage("corpus_host", draw)
    queries = corpus.batch(nq, seed=9999)
    gt = stage("ground_truth", lambda: C.exact_nn(queries, base, device))
    icfg = dataclasses.replace(cfg.index, d=D, nsubc=0, do_opq=False)
    idx = IVFADCIndex(icfg, device)
    gen = torch.Generator(device=device).manual_seed(0)
    stage("centroids", lambda: idx.train_centroids(gen, base[:300_000],
                                                   niter=10))
    stage("pq", lambda: idx.train_pq(gen, base[:65_536]))
    keys = stage("assign", lambda: np.concatenate(
        [idx.assign(base[o:o + step]) for o in range(0, nb, step)]))
    ids = np.arange(nb, dtype=np.int32)

    def add(index):
        for o in range(0, nb, step):
            index.add_batch(base[o:o + step], ids[o:o + step],
                            keys[o:o + step])
        index.finalize()
    stage("add", lambda: add(idx))
    g = IVFADCGroupingIndex(dataclasses.replace(
        icfg, nsubc=FLAGSHIP["nsubc"], do_opq=FLAGSHIP["do_opq"]), device)
    g.set_centroids(idx.centroids)
    stage("flagship_neighbours", g.compute_neighbor_centroids)
    stage("flagship_pq", lambda: g.train_pq(gen, base[:65_536]))

    def alpha():
        for o in range(0, nb, step):
            g.alpha_pass(base[o:o + step], keys[o:o + step])
        g.finalize_alphas()
    stage("flagship_alpha_pass", alpha)
    stage("flagship_add", lambda: (add(g), g.compute_inter_centroid_dists()))
    print(f"[siftlike] corpus SiftLikeCorpus(n_classes=65536, seed=1): "
          f"{nb} x {D} base, {nq} held-out queries; lists mean "
          f"{nb / idx.nc:.1f} max {idx.store.max_list_size()}; flagship "
          f"groups max {int(g.store.grouped(g.nsubc).group_sizes.max())}; "
          f"stages_s " + json.dumps({k: round(v, 3)
                                     for k, v in stages.items()}), flush=True)

    params = cfg.search
    gp = dataclasses.replace(params, do_pruning=FLAGSHIP["do_pruning"])
    out = {}
    runs = [("ivfadc", idx, params, layout, topk) for layout in
            ("chunk", "quad") for topk in ("wide", "twophase")]
    runs += [("flagship", g, gp, layout, "wide")
             for layout in ("chunk", "quad")]
    for name, ix, prm, layout, topk in runs:
        ix.engine, ix.scan_layout, ix.scan_topk = "fused", layout, "auto"
        if name == "ivfadc":
            ix.scan_topk = topk
        need = [KERNEL_OF[name]] + (["adc_scan_slots_min"]
                                    if topk == "twophase" else [])
        ix.search(queries[:256], prm)                         # warm shapes
        t = time.perf_counter()
        d, l = pl.counted("16", ix.scan_gran(), need,
                          lambda: ix.search(queries, prm),
                          f"siftlike {name} {layout} {topk}")
        wall = time.perf_counter() - t
        if d.shape != (nq, prm.k) or not np.isfinite(d).all() or (
                l.min() < 0 or l.max() >= nb):
            raise AssertionError(f"siftlike {name} {layout} {topk}: bad "
                                 "results")
        out[name, layout, topk] = (d, l, recall_at_k(l, gt, ks=(1, 10)),
                                   wall)
    sub = min(512, nq)
    for name, ix, prm in (("ivfadc", idx, params), ("flagship", g, gp)):
        ix.engine = "torch"
        d_ref, l_ref = ix.search(queries[:sub], prm)
        for (n2, layout, topk), (d, l, _, _) in out.items():
            if n2 == name:
                assert_same(d_ref, l_ref, d[:sub], l[:sub],
                            f"siftlike {name} {layout} {topk} vs torch")
        ix.engine = "fused"
    for key, (d, l, rec, wall) in out.items():
        name, layout, topk = key
        clustered = (results if name == "ivfadc" else gresults)[layout][
            "recalls"]
        if rec[10] < 0.1:
            raise AssertionError(f"siftlike {key}: R@10 {rec[10]}")
        print(f"[siftlike] {name} {layout} {topk}: R@1 {rec[1]:.4f} R@10 "
              f"{rec[10]:.4f} (clustered corpus {clustered[1]:.4f} / "
              f"{clustered[10]:.4f}), {nq} queries at batch "
              f"{min(SEARCH_BATCH, nq)} in {wall:.4f} s "
              f"({1e6 * wall / nq:.3f} us/query); {sub} queries match the "
              "torch engine", flush=True)

    # each kernel on this corpus's schedule for one batch
    q = torch.tensor(queries[:SEARCH_BATCH], device=device)
    B = q.shape[0]
    for layout in ("chunk", "quad"):
        idx.scan_layout = g.scan_layout = layout
        gran = idx.scan_gran()
        args = (*idx.scan_inputs(q, params), gran)
        length = args[5]
        wide, bins = tk.adc_scan_slots(*args, bins=True)
        ref = tk.adc_scan_slots_plain(*args)
        err = compare(wide, ref, f"siftlike gran={gran}")
        check_bins(bins, ref, f"siftlike gran={gran}")
        del ref, bins
        check_min_kernel(args, wide, f"siftlike gran={gran}")
        fill = int(length.sum()) / (B * length.shape[1] * gran)
        ms = device_ms(lambda: wide_lanes(*args))
        ms_min = device_ms(lambda: tk.adc_scan_slots_min(*args))
        del wide
        wturns = first_port_turns(args, wide=True)
        gargs = (*g.grouping_scan_inputs(q, gp), gran)
        gout, gbins = tg.grouping_scan_slots(*gargs, bins=True)
        gref = tg.grouping_scan_slots_plain(*gargs)
        if not torch.equal(gout, gref):
            raise AssertionError(f"siftlike grouping gran={gran}: kernel "
                                 "not torch.equal to its plain version")
        check_bins(gbins, gref, f"siftlike grouping gran={gran}")
        del gref, gbins
        glen = int(gargs[7].sum())
        gfill = glen / gout.numel()
        kept = int(torch.isfinite(gout).sum()) / max(glen, 1)
        gms = device_ms(lambda: grouping_lanes(*gargs))
        for name, t_ms, lane_fill in (
                (f"adc_scan_slots_gran{gran}", ms, fill),
                (f"adc_scan_slots_min_gran{gran}", ms_min, fill),
                (f"grouping_scan_slots_gran{gran}", gms, gfill)):
            rec = next(k for k in kernels if k["name"] == name)
            rec["siftlike_ms"], rec["siftlike_lane_fill"] = t_ms, lane_fill
            if name.startswith("adc_scan_slots_gran"):
                rec["siftlike_turns"] = wturns
        print(f"[siftlike] wide kernel at gran {gran}: "
              f"{turns_text(wturns)}", flush=True)
        print(f"[siftlike] kernels at gran {gran}, B={B}: wide {ms:.4f} ms, "
              f"min {ms_min:.4f} ms, lane fill {fill:.3f} over "
              f"{length.shape[1]} slots (max_abs_err {err!r}, bin minima "
              f"and min kernel torch.equal); grouping {gms:.4f} ms, lane fill {gfill:.3f} "
              f"over {gargs[6].shape[1]} slots, unpruned {kept:.3f} of "
              f"filled lanes (torch.equal to plain)", flush=True)
    # the min kernel against its first port on this corpus's codes
    run_min_probe(device, idx, queries, params, kernels, ("real",),
                  "[mprobe siftlike]", "siftlike_mprobe",
                  steps=("first_port", "comp", "loads", "comp_new",
                         "loads_new"))
    del idx, g, q

    # the device generator against the host corpus
    dg = SiftLikeDeviceGen(device, n_classes=65536, seed=1)
    t = time.perf_counter()
    x = dg.batch_device(7, nb)
    C._sync(device)
    t_gen = time.perf_counter() - t
    if not torch.equal(x, dg.batch_device(7, nb)):
        raise AssertionError("SiftLikeDeviceGen: one seed gave two batches")
    if (x.min() < 0 or x.max() > 255 or not torch.equal(x, torch.floor(x))
            or x.shape != (nb, D)):
        raise AssertionError("SiftLikeDeviceGen: off the uint8 grid")
    stats_dev = (float((x == 0).float().mean()),
                 float(torch.linalg.vector_norm(x, dim=1).mean()),
                 float(x.mean()))
    stats_host = (float((base == 0).mean()),
                  float(np.linalg.norm(base, axis=1).mean()),
                  float(base.mean()))
    dz = abs(stats_dev[0] - stats_host[0])
    dn = abs(stats_dev[1] - stats_host[1]) / stats_host[1]
    dm = abs(stats_dev[2] - stats_host[2]) / stats_host[2]
    if dz >= 0.05 or dn >= 0.03 or dm >= 0.10:
        raise AssertionError(f"SiftLikeDeviceGen statistics {stats_dev} "
                             f"against the host corpus's {stats_host}")
    dg.release()
    del x
    print(f"[siftlike] SiftLikeDeviceGen: {nb} x {D} on the card in "
          f"{t_gen:.3f} s (host corpus {stages['corpus_host']:.2f} s); the "
          f"same seed gives the same tensor; zero share / mean norm / mean "
          f"{stats_dev[0]:.4f} / {stats_dev[1]:.2f} / {stats_dev[2]:.3f} "
          f"against the host corpus's {stats_host[0]:.4f} / "
          f"{stats_host[1]:.2f} / {stats_host[2]:.3f} (bounds 0.05, 3%, "
          "10%)", flush=True)



def host_rss_gib() -> tuple:
    """(current, peak) resident memory of this process, GiB."""
    import resource
    with open("/proc/self/status") as f:
        cur = next(int(ln.split()[1]) for ln in f if ln.startswith("VmRSS"))
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return cur / 2 ** 20, peak / 2 ** 20


def probe_overlap(probes, exact) -> float:
    """Mean share of each query's exact probes [B, P] found in ``probes``."""
    return float((probes[:, :, None] == exact[:, None, :]).any(-1)
                 .float().mean())


def check_ties_only(d_r, p_r, d_e, p_e, what: str, atol: float = ATOL):
    """Two probe selections of the same queries (ascending distances d_*,
    ids p_*): distances within RTOL / ``atol``, and a probe in one set only
    lies at the boundary, within that tolerance of the exact P-th
    distance."""
    import torch
    torch.testing.assert_close(d_r, d_e, rtol=RTOL, atol=atol,
                               msg=lambda m: f"{what}: {m}")
    miss = ~(p_r[:, :, None] == p_e[:, None, :]).any(-1)
    kth = d_e[:, -1:].expand_as(d_r)
    far = miss & ((d_r - kth).abs() > atol + RTOL * kth.abs())
    if bool(far.any()):
        raise AssertionError(f"{what}: {int(far.sum())} probes differ away "
                             "from an f32 tie at the boundary")


def lloyd_split(index, learn: "torch.Tensor") -> dict:
    """One Lloyd pass of ``index.train_centroids`` over ``learn``, split on
    the card: the hierarchical seeding's seconds, and for one block of
    ``lloyd_rows(nc)`` rows the score GEMMs alone, the whole assignment
    sweep (GEMMs, norm adds, top-1 and merge per step) and the segment sums
    (CUDA events, median). A pass is ``blocks`` such blocks."""
    import torch
    from ivfhnsw_tpu_torch.drivers.common import _sync
    from ivfhnsw_tpu_torch.ops.distances import assign_top1
    from ivfhnsw_tpu_torch.ops.kmeans import (_sums_and_counts,
                                              hierarchical_seed, lloyd_rows)
    dev, nc, cb = learn.device, index.nc, index._cb()
    t = time.perf_counter()
    hierarchical_seed(torch.Generator(device=dev).manual_seed(0), learn, nc)
    _sync(dev)
    seed_s = time.perf_counter() - t
    rows = lloyd_rows(nc)
    blk, cents, csq = learn[:rows], index.centroids, index.centroid_norms

    def gemms():
        for o in range(0, nc, cb):
            blk @ cents[o:o + cb].T

    def sweep():
        return assign_top1(blk, cents, block=cb, point_sqnorms=csq)

    idx = sweep()[1]
    r = {"seed_s": seed_s, "rows": rows, "block_c": cb,
         "blocks": -(-learn.shape[0] // rows), "gemm_ms": device_ms(gemms),
         "sweep_ms": device_ms(sweep),
         "sums_ms": device_ms(lambda: _sums_and_counts(blk, idx, nc))}
    r["pass_s"] = r["blocks"] * (r["sweep_ms"] + r["sums_ms"]) / 1e3
    return r


def run_scale2(device, s: dict, pl: PhaseLaunches, kernels: list) -> dict:
    """Phase 17: the bench tool's scale2 builder (``build_scale2``, in a
    temporary cache) with the build's diagnostics beside it (one Lloyd pass
    split, batch 0 assigned routed and exact), coarse selection (routed
    overlaps at w = 16, 32, 64 and w = n_super), every coarse mode searched
    wide and two-phase at both slot widths under the profiled scan budget,
    and each scan kernel against its plain version on this point's
    schedule; ``s`` holds k and ctl, the queries held to the torch engine.
    Returns the numbers the approx decision reads."""
    import tempfile

    import torch
    from ivfhnsw_tpu_torch.drivers.common import _sync
    from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
    from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
    from ivfhnsw_tpu_torch.ops.routed_coarse import routed_select_ext
    from ivfhnsw_tpu_torch.tools import bench
    from ivfhnsw_tpu_torch.tools.build_1b import routed_match
    from ivfhnsw_tpu_torch.utils.config import SearchParams
    from ivfhnsw_tpu_torch.utils.recall import recall_at_k
    from ivfhnsw_tpu_torch.utils.roofline import scan_bound

    def stage(name, fn):
        return timed(stages, name, fn, device)

    mem_reset(device)
    S = bench.sizes(False)
    spec = bench.scale2_spec(S, device)
    nb, nc, B, P = spec["nb"], spec["nc"], spec["nq"], S["S2_NPROBE"]
    s = {**s, "nq": B, "nprobe": P, "max_codes": S["S2_MC"]}
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_s2_") as cache:
        index, q_np, gt, meta = pl.assign(
            "17", lambda: bench.build_scale2(S, device, cache),
            "scale2's build")
    stages = {"build_scale2": time.perf_counter() - t,
              **meta["stage_seconds"]}
    q = torch.tensor(q_np, device=device)
    corpus = spec["corpus"]()
    learn = corpus.gen(spec["seeds"]["learn"], spec["learn"])
    ll = lloyd_split(index, learn)
    del learn
    print(f"[scale2] lloyd split (CUDA events): seed {ll['seed_s']:.3f} s; "
          f"per block of {ll['rows']} rows x {nc} centroids ({ll['blocks']} "
          f"a pass, {ll['block_c']} centroids a step): score GEMMs "
          f"{ll['gemm_ms']:.3f} ms, whole assignment sweep "
          f"{ll['sweep_ms']:.3f} ms, segment sums {ll['sums_ms']:.3f} ms; "
          f"a pass {ll['pass_s']:.3f} s, seed + {bench.STREAM_NITER} passes "
          f"{ll['seed_s'] + bench.STREAM_NITER * ll['pass_s']:.3f} s "
          f"against the centroids stage {stages['centroids']:.3f} s",
          flush=True)
    # batch 0 assigned both ways, for their times
    r = spec["routed"]
    sample = corpus.gen(r["sample_seed"], r["sample_rows"])
    stage("routed_match", lambda: routed_match(index, sample, r["n_super"],
                                               r["seed"]))
    blk = corpus.gen(spec["seeds"]["base"], min(bench.BATCH, nb))
    stage("assign_routed_batch0", lambda: index._assign_t(blk))
    stage("assign_exact_batch0", lambda: index._assign_exact_t(blk))
    index._fast_assigner = None
    del sample, blk
    st = index.store
    stage("upload", lambda: (st.codes_t, st.ids_t, st.norm_codes_t,
                             st.list_offsets_t))
    sizes = st.list_sizes()
    empty = torch.tensor(sizes == 0, device=device)
    near = float(torch.linalg.vector_norm(
        index.centroids[empty] - index.centroids[int(sizes.argmax())],
        dim=1).max()) if bool(empty.any()) else 0.0
    rss = host_rss_gib()
    store_gb = (st.codes.nbytes + st.ids.nbytes + st.norm_codes.nbytes) / 1e9
    print(f"[scale2] bench.build_scale2: {nb} x {index.d} at nc={nc}, "
          f"corpus bench.py scale2 (RandomState(7) supers/mids/mix, a "
          f"generator seed per batch): routed match rate "
          f"{meta['routed_match_rate']:.4f} on {r['sample_rows']} rows "
          f"({meta['assignment_mode']} assignment), lists mean "
          f"{sizes.mean():.1f} max {sizes.max()} empty "
          f"{int((sizes == 0).sum())} (their centroids within {near:.4f} of "
          f"the largest list's), store {store_gb:.3f} GB; host RSS "
          f"{rss[0]:.2f} GiB (peak {rss[1]:.2f}), device peak "
          f"{peak_gib(device)} GiB; stages_s "
          + json.dumps({k: round(v, 3) for k, v in stages.items()}),
          flush=True)

    # coarse selection: routed overlaps against exact, w = n_super exact
    stage("routed_coarse_setup", lambda: index.enable_routed_coarse(
        generator=torch.Generator(device=device).manual_seed(90)))
    rc = index._routed_coarse
    cb = index._coarse_block_for(B)
    ex_d, ex_p = streaming_topk_l2(q, index.centroids, P, block=cb,
                                   point_sqnorms=index.centroid_norms)
    pr = SearchParams(nprobe=P, coarse_mode="routed")
    overlaps, w_sel = {}, None
    for w in (16, 32, 64):
        index.routed_w = w
        routed, rw = index._routed_for(pr, P)
        overlaps[rw] = probe_overlap(
            routed_select_ext(q, *routed, nprobe=P, w=rw)[1], ex_p)
        if w_sel is None and overlaps[rw] >= OVERLAP_TARGET:
            w_sel = w
    w_sel = w_sel or 64
    ctl = s["ctl"]
    full_d, full_p = routed_select_ext(q[:ctl], *routed, nprobe=P,
                                       w=rc.n_super)[:2]
    # The two orders of one f32 dot product differ by a few ulps of
    # ||q||^2 + ||c||^2 (~7000 on this corpus: 4.9e-4 an ulp), far above
    # ATOL beside distances of 2-5: an f32 tie is 16 ulps of that sum.
    tie_atol = 16 * 2.0 ** -24 * float((q * q).sum(1).max()
                                       + index.centroid_norms.max())
    check_ties_only(full_d, full_p, ex_d[:ctl], ex_p[:ctl],
                    "routed w=n_super vs exact", tie_atol)
    ap_p = streaming_topk_l2(q, index.centroids, P, block=cb,
                             point_sqnorms=index.centroid_norms,
                             approx=True)[1]
    bn_d, bn_p = streaming_topk_l2(q, index.centroids, P, block=cb,
                                   point_sqnorms=index.centroid_norms,
                                   exact_reduce="binned")
    check_ties_only(bn_d, bn_p, ex_d, ex_p, "binned vs exact")
    index.routed_w = w_sel
    coarse_kw = {"exact": {}, "binned": {"exact_reduce": "binned"},
                 "approx": {"approx": True},
                 "routed": index._coarse_for(pr, P)}
    coarse_ms = {m: device_ms(lambda kw=kw: tk.select_probes(
        q, index.centroids, index.centroid_norms, st.list_offsets_t,
        nprobe=P, coarse_block=cb, **kw)) for m, kw in coarse_kw.items()}
    # the routed side table against the store, for every query: each
    # probe's first row and size (int64: offsets pass 2^24 at this point)
    off = st.list_offsets_t
    r_qc, r_p, r_t1, r_lo, r_sz = tk.select_probes(
        q, index.centroids, index.centroid_norms, off, nprobe=P,
        coarse_block=cb, **coarse_kw["routed"])
    if not (torch.equal(r_lo, off[r_p])
            and torch.equal(r_sz, off[r_p + 1] - r_lo)):
        raise AssertionError("scale2 routed: the side table's row offsets "
                             "or sizes differ from the store's")
    torch.testing.assert_close(
        r_t1, r_qc - index.centroid_norms[r_p], rtol=RTOL, atol=ATOL,
        msg=lambda m: f"scale2 routed term1: {m}")
    print(f"[scale2] routed side table equals the store's offsets and sizes "
          f"for {B} x {P} probes; row offsets up to {int(r_lo.max())}, "
          f"{int((r_lo > 2 ** 24).sum())} past 2^24", flush=True)
    ov = {"approx": probe_overlap(ap_p, ex_p),
          "binned": probe_overlap(bn_p, ex_p), "routed": overlaps[w_sel]}
    print(f"[scale2] coarse B={B} nprobe={P}: routed structure {rc.n_super} "
          f"supers x cap {rc.cap}; probe overlap against exact at w "
          + json.dumps({str(k): round(v, 4) for k, v in overlaps.items()})
          + f" -> w={w_sel}; w=n_super ({rc.n_super}) equals exact on "
          f"{ctl} queries except at f32 ties (atol {tie_atol:.2e}); approx (recall_target 0.95) "
          f"overlap {ov['approx']:.4f}, binned {ov['binned']:.4f}; "
          f"selection ms " + json.dumps({k: round(v, 4) for k, v in
                                         coarse_ms.items()}), flush=True)

    # profiled scan budget per width (the largest demand over the modes)
    base = dict(k=s["k"], nprobe=P, max_codes=s["max_codes"])
    modes = ("exact", "binned", "approx", "routed")
    budget = {}
    for layout in ("chunk", "quad"):
        index.scan_layout = layout
        gran = index.scan_gran()
        worst = index._scan_slots(SearchParams(**base), P, gran)
        dem = {m: int(index.scan_slot_demand(
            q_np, SearchParams(**base, coarse_mode=m), batch=B).max())
            for m in modes}
        budget[layout] = max(dem.values()) * gran
        print(f"[scale2] {layout} ({gran} codes/slot): scan slots worst case "
              f"{worst}, profiled max demand " + json.dumps(dem), flush=True)

    # every mode, wide and two-phase, both widths, in turns
    index.engine = "fused"
    order = [(layout, topk, m) for layout in ("chunk", "quad")
             for topk in ("wide", "twophase") for m in modes]
    walls, out = {c: [] for c in order}, {}
    for layout, topk, m in order + order[::-1]:
        index.scan_layout, index.scan_topk = layout, topk
        prm = SearchParams(**base, coarse_mode=m,
                           scan_budget=budget[layout])
        index.search(q_np[:64], prm, batch=B)                # warm shapes
        need = ["adc_scan_slots"] + (["adc_scan_slots_min"]
                                     if topk == "twophase" else [])
        t = time.perf_counter()
        out[layout, topk, m] = pl.counted(
            "17", index.scan_gran(), need,
            lambda: index.search(q_np, prm, batch=B),
            f"scale2 {layout} {topk} {m}")
        walls[layout, topk, m].append(time.perf_counter() - t)
    us = {c: 1e6 * min(w) / B for c, w in walls.items()}
    rec = {}
    index.scan_layout = "quad"
    short = {}
    for m in modes:
        d0, l0 = out["quad", "wide", m]
        # a query whose probes hold fewer than k codes returns +inf / -1
        # past them, as the reference does; every other distance is finite
        codes = index.scan_inputs(q, SearchParams(
            **base, coarse_mode=m, scan_budget=budget["quad"]))[5].sum(1)
        want = np.minimum(codes.cpu().numpy(), s["k"])
        if d0.shape != (B, s["k"]) or not np.array_equal(
                np.isfinite(d0).sum(1), want) or (l0[np.isfinite(d0)] < 0
                                                   ).any():
            raise AssertionError(f"scale2 {m}: {d0.shape} distances, finite "
                                 "ones not where the schedule has codes")
        short[m] = int((want < s["k"]).sum())
        for c in order:
            if c[2] == m:
                assert_same(d0, l0, *out[c], f"scale2 {c} vs quad wide")
        rec[m] = recall_at_k(l0, gt, ks=(1, 10))
        print(f"[scale2] coarse {m}: R@1 {rec[m][1]:.4f} R@10 "
              f"{rec[m][10]:.4f}, {short[m]} queries whose probes hold "
              f"fewer than k codes; us/query (best of 2, in turns) "
              + json.dumps({f"{c[0]}/{c[1]}": round(us[c], 3)
                            for c in order if c[2] == m}), flush=True)
    assert_same(*out["quad", "wide", "exact"], *out["quad", "wide", "binned"],
                "scale2 binned vs exact")
    index.scan_layout, index.scan_topk = "quad", "wide"
    _, l100 = index.search(q_np, SearchParams(
        **{**base, "k": 100}, coarse_mode="exact",
        scan_budget=budget["quad"]), batch=B)
    r100 = recall_at_k(l100, gt, ks=(100,))[100]
    # the budget cuts nothing for these queries; the fused engine against
    # the torch engine on ctl queries, exact coarse, no budget
    exact = SearchParams(**base, coarse_mode="exact")
    assert_same(*out["quad", "wide", "exact"], *index.search(
        q_np, exact, batch=B), "scale2 budgeted vs unbudgeted")
    d_f, l_f = index.search(q_np[:ctl], exact, batch=B)
    index.engine = "torch"
    d_t, l_t = index.search(q_np[:ctl], exact, batch=B)
    index.engine = "fused"
    assert_same(d_t, l_t, d_f, l_f, "scale2 fused vs torch engine")

    # routed at w = n_super against exact: with a max_codes that admits
    # every probe the probe order cannot matter, so each query whose probe
    # set equals the exact one gets the same results up to f32 ties
    def probes_of(prm):
        return tk.select_probes(
            q[:ctl], index.centroids, index.centroid_norms, off, nprobe=P,
            coarse_block=index._coarse_block_for(ctl),
            **index._coarse_for(prm, P))

    index.routed_w = rc.n_super
    rt, xt = (SearchParams(**base, coarse_mode=m) for m in ("routed",
                                                            "exact"))
    _, w_p, _, _, w_sz = probes_of(rt)
    _, x_p, _, _, x_sz = probes_of(xt)
    rt.max_codes = xt.max_codes = 1 + int(max(w_sz.sum(1).max(),
                                              x_sz.sum(1).max()))
    same = (w_p.sort(1).values == x_p.sort(1).values).all(1).cpu().numpy()
    if not same.any():
        raise AssertionError("scale2 routed w=n_super: no query has the "
                             "exact probe set")
    d_w, l_w = index.search(q_np[:ctl], rt, batch=B)
    d_x, l_x = index.search(q_np[:ctl], xt, batch=B)
    index.routed_w = w_sel
    assert_same(d_x[same], l_x[same], d_w[same], l_w[same],
                "scale2 routed w=n_super vs exact search", atol=tie_atol)
    print(f"[scale2] routed search at w=n_super equals the exact-coarse "
          f"search on {int(same.sum())} of {ctl} queries (the rest differ "
          f"only in boundary ties), every probe admitted (max_codes "
          f"{rt.max_codes}, atol {tie_atol:.2e})", flush=True)
    print(f"[scale2] R@100 at k=100 (exact coarse) {r100:.4f}; budgeted "
          f"search equals unbudgeted on {B} queries; fused equals the torch "
          f"engine on {ctl} queries", flush=True)
    t = time.perf_counter()
    ceil = bench.exact_adc_ceiling(index, q_np, gt, ks=(1, 10, 100),
                                   blk=131_072)[0]
    _sync(device)
    print(f"[scale2] exact-ADC ceiling (tools/bench.py, all {st.ntotal} "
          f"codes, {B} queries) R@1 {ceil[1]:.4f} R@10 {ceil[10]:.4f} R@100 "
          f"{ceil[100]:.4f} in {time.perf_counter() - t:.2f} s; the search "
          f"(exact coarse, quad wide) R@1 {rec['exact'][1]:.4f} R@10 "
          f"{rec['exact'][10]:.4f} R@100 {r100:.4f}", flush=True)

    # each scan kernel on this point's schedule for one batch
    prm = SearchParams(**base, coarse_mode="exact")
    for layout in ("chunk", "quad"):
        index.scan_layout = layout
        gran = index.scan_gran()
        prm.scan_budget = budget[layout]
        args = (*index.scan_inputs(q, prm, gran), gran)
        length = args[5]
        fill = int(length.sum()) / (B * length.shape[1] * gran)
        wide, bins = tk.adc_scan_slots(*args, bins=True)
        mins = tk.adc_scan_slots_min(*args)
        for name, got, plain in (
                (f"adc_scan_slots_gran{gran}", wide, tk.adc_scan_slots_plain),
                (f"adc_scan_slots_min_gran{gran}", mins,
                 tk.adc_scan_slots_min_plain)):
            ref = plain(*args)
            if not torch.equal(got, ref):
                raise AssertionError(f"scale2 {name}: kernel not torch.equal "
                                     "to its plain version")
            wide = "min" not in name
            if wide:
                check_bins(bins, ref, f"scale2 {name}")
            wrapper = wide_lanes if wide else tk.adc_scan_slots_min
            r = {"ms": device_ms(lambda w=wrapper: w(*args)),
                 "plain_ms": device_ms(lambda p=plain: p(*args), reps=3,
                                       warmup=1),
                 "slots": length.shape[1], "lane_fill": fill,
                 **scan_bound(args, got.numel(), st.code_m + 1,
                              st.code_m + (1 if wide else 2), bins=wide)}
            del ref
            r.update(first_port_turns(
                args, rivals=WIDE_RIVALS if wide else MIN_RIVALS, wide=wide))
            for krec in kernels:
                if krec["name"] == name:
                    krec["scale2"] = r
            print(f"[scale2] {name}: torch.equal to plain on this schedule "
                  f"(B={B}, {length.shape[1]} slots, lane fill {fill:.3f}): "
                  f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
                  f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}"
                  + f"; {turns_text(r)}",
                  flush=True)
        del args, wide, bins, mins
    index.scan_topk = "auto"
    whole = us["quad", "wide", "exact"] * B / 1e3
    fastest = min(coarse_ms["exact"], coarse_ms["binned"])
    print(f"[scale2] approx decision: the faster exact reduce "
          f"{fastest:.4f} ms of a whole {whole:.4f} ms search of {B} queries "
          f"(quad wide, exact) = {fastest / whole:.3f}; device peak "
          f"{peak_gib(device)} GiB; stages_s " + json.dumps(
              {k: round(v, 3) for k, v in stages.items()}), flush=True)
    return {"coarse_ms": coarse_ms, "whole_ms": whole, "overlap": ov,
            "index": index, "queries": q_np, "gt": gt, "budget": budget,
            "sizes": s}


def run_coarse20(device, s: dict) -> None:
    """Phase 17b at the sizes ``s``: the scale3 corpus, hierarchical seeding
    at k = nc over the learn rows (its seconds; the list sizes of those
    rows under the routed assigner over the seeds, and that assigner's
    match rate), then exact, binned, approx and routed selection timed
    against exact with their probe overlaps."""
    import torch
    from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
    from ivfhnsw_tpu_torch.ops.hierarchical import TwoLevelAssigner
    from ivfhnsw_tpu_torch.ops.kmeans import hierarchical_seed
    from ivfhnsw_tpu_torch.ops.routed_coarse import (RoutedCoarse,
                                                     routed_select_ext)
    from ivfhnsw_tpu_torch.tools.scale3 import MesoCorpus

    stages = {}

    def stage(name, fn):
        return timed(stages, name, fn, device)

    mem_reset(device)
    nc, B, P = s["nc"], s["nq"], s["nprobe"]
    corpus = stage("corpus_setup",
                   lambda: MesoCorpus(device, nc, s["d"], 11, mids_seed=83))
    q = corpus.gen(84, B)
    learn = stage("learn_draw", lambda: corpus.gen(85, s["learn"]))
    del corpus
    seeds = stage("hierarchical_seed", lambda: hierarchical_seed(
        torch.Generator(device=device).manual_seed(0), learn, nc))
    tla = stage("assigner_setup", lambda: TwoLevelAssigner(
        seeds, n_super=s["n_super"], w=4,
        generator=torch.Generator(device=device).manual_seed(90)))
    keys = stage("assign_learn", lambda: tla.assign_tensor(learn))
    m = s["match_sample"]
    match = float((tla._exact(learn[:m]) == keys[:m]).float().mean())
    counts = torch.bincount(keys, minlength=nc).cpu().numpy()
    del tla, keys, learn
    print(f"[coarse20] hierarchical_seed k={nc} over {s['learn']} rows in "
          f"{stages['hierarchical_seed']:.2f} s; those rows over the seeds "
          f"(routed assigner, {s['n_super']} supers, w=4, match rate "
          f"{match:.4f} on {m} rows): lists mean {counts.mean():.2f} std "
          f"{counts.std():.2f} max {counts.max()} p99 "
          f"{np.percentile(counts, 99):.0f}, empty share "
          f"{(counts == 0).mean():.4f}; stages_s " + json.dumps(
              {k: round(v, 3) for k, v in stages.items()}), flush=True)

    cn = (seeds * seeds).sum(1)
    offsets = torch.zeros(nc + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.tensor(np.cumsum(counts), device=device)
    rc = stage("routed_coarse_setup", lambda: RoutedCoarse(
        seeds, generator=torch.Generator(device=device).manual_seed(90)))
    table = rc.build_table(cn, offsets)
    cb = 65536          # the fused engine's coarse block at B=1024
    sel = {"exact": lambda: streaming_topk_l2(q, seeds, P, block=cb,
                                              point_sqnorms=cn),
           "binned": lambda: streaming_topk_l2(q, seeds, P, block=cb,
                                               point_sqnorms=cn,
                                               exact_reduce="binned"),
           "approx": lambda: streaming_topk_l2(q, seeds, P, block=cb,
                                               point_sqnorms=cn,
                                               approx=True)}
    for w in (16, 32, 64):
        sel[f"routed_w{w}"] = (lambda w=w: routed_select_ext(
            q, rc.supers, rc.super_sqn, table, nprobe=P, w=w)[:2])
    ex_d, ex_p = sel["exact"]()
    ms, ov = {}, {}
    for name, fn in sel.items():
        d, p = fn()
        ov[name] = probe_overlap(p, ex_p)
        if name == "binned":
            check_ties_only(d, p, ex_d, ex_p, "nc=2^20 binned vs exact")
        ms[name] = device_ms(fn, reps=5)
    setup_s = stages["routed_coarse_setup"]
    print(f"[coarse20] nc={nc} B={B} nprobe={P}, routed structure "
          f"{rc.n_super} supers x cap {rc.cap} ({setup_s:.2f} s): selection "
          "ms " + json.dumps(
              {k: round(v, 4) for k, v in ms.items()}) + "; probe overlap "
          "against exact " + json.dumps({k: round(v, 4)
                                         for k, v in ov.items()})
          + f"; device peak {peak_gib(device)} GiB", flush=True)


# ---------------------------------------------------------------------------
# Phase 18: the sharded paths
# ---------------------------------------------------------------------------

def tie_atol(q, index) -> float:
    """16 ulps of the largest ||q||^2 + ||c||^2: two orders of one f32
    distance differ by a few ulps of that sum, so distances within it are
    an f32 tie (as phase 17 allows)."""
    return 16 * 2.0 ** -24 * float((q * q).sum(1).max()
                                   + index.centroid_norms.max())


def probe_agreement(sharded, index, q, nprobe: int, what: str):
    """Each query's probe list from the sharded coarse step (every shard's
    block, gathered and merged) against the single index's fused coarse
    step: [B] bool (numpy), True where the two lists are equal in order.
    A query whose lists differ must differ only at f32 ties."""
    import torch
    from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
    from ivfhnsw_tpu_torch.parallel.sharded import global_probes
    d_s, p_s = global_probes(sharded.group, sharded.shards, q, nprobe)
    d_1, p_1 = streaming_topk_l2(q, index.centroids, nprobe,
                                 block=index._coarse_block_for(q.shape[0]),
                                 point_sqnorms=index.centroid_norms)
    same = (p_s.to(p_1.device) == p_1).all(1)
    diff = ~same
    if bool(diff.any()):
        check_ties_only(d_s.to(d_1.device)[diff], p_s.to(p_1.device)[diff],
                        d_1[diff], p_1[diff], what, tie_atol(q, index))
    return same.cpu().numpy()


def run_sharded_scale2(device, s2: dict, pl: PhaseLaunches,
                       kernels: list) -> None:
    """Phases 18a-18b over phase 17's index ``s2["index"]``."""
    import tempfile
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from ivfhnsw_tpu_torch.drivers.common import _sync
    from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
    from ivfhnsw_tpu_torch.parallel import (DistributedShards,
                                            ShardedIVFADC, make_mesh)
    from ivfhnsw_tpu_torch.parallel.sharded import global_probes
    from ivfhnsw_tpu_torch.utils.config import SearchParams
    from ivfhnsw_tpu_torch.utils.recall import recall_at_k

    index, q_np, gt, s = s2["index"], s2["queries"], s2["gt"], s2["sizes"]
    B, P = q_np.shape[0], s["nprobe"]
    q = torch.tensor(q_np, device=device)
    base = dict(k=s["k"], nprobe=P, max_codes=s["max_codes"],
                coarse_mode="exact")
    prm = SearchParams(**base)
    index.engine = "fused"
    mem_reset(device)
    t = time.perf_counter()
    sh = ShardedIVFADC(index, make_mesh(devices=[device] * 8))
    for x in sh.shards:
        x.store.codes_t, x.store.ids_t, x.store.norm_codes_t
        x.store.list_offsets_t
    _sync(device)
    layout_s = time.perf_counter() - t
    same = probe_agreement(sh, index, q, P, "scale2 sharded probes")
    # how a query's probes spread over the shards' centroid ranges
    owner = global_probes(sh.group, sh.shards, q, P)[1] // sh.nc_loc
    per = torch.zeros((B, 8), device=device).scatter_add_(
        1, owner, torch.ones(owner.shape, device=device))
    spread = {"shards_per_query": float((per > 0).sum(1).float().mean()),
              "top_shard_share": float(per.max(1).values.mean() / P)}
    cb = index._coarse_block_for(B)
    coarse = {"sharded": device_ms(lambda: global_probes(
        sh.group, sh.shards, q, P)), "single": device_ms(
        lambda: streaming_topk_l2(q, index.centroids, P, block=cb,
                                  point_sqnorms=index.centroid_norms))}
    order = [(layout, topk) for layout in ("chunk", "quad")
             for topk in ("wide", "twophase")]
    walls = {(c, w): [] for c in order for w in ("single", "sharded")}
    out, slots = {}, {}
    for i, (layout, topk) in enumerate(order + order[::-1]):
        index.scan_layout = sh.scan_layout = layout
        index.scan_topk = sh.scan_topk = topk
        gran = sh.scan_gran()
        single = SearchParams(**base, scan_budget=s2["budget"][layout])
        need = ["adc_scan_slots"] + (["adc_scan_slots_min"]
                                     if topk == "twophase" else [])
        runs = (("single", lambda: index.search(q_np, single, batch=B)),
                ("sharded", lambda: pl.counted(
                    "18a", gran, need, lambda: sh.search(q_np, prm, batch=B),
                    f"sharded scale2 {layout} {topk}")))
        for who, fn in (runs if i < len(order) else runs[::-1]):
            if i < len(order):
                fn()                                   # warm the shapes
            t = time.perf_counter()
            out[(layout, topk), who] = fn()
            walls[(layout, topk), who].append(time.perf_counter() - t)
        slots[layout] = dict(sh.last_slots)
    peak = peak_gib(device)
    us = {k: 1e6 * min(w) / B for k, w in walls.items()}
    for c in order:
        d0, l0 = out[c, "single"]
        d1, l1 = out[c, "sharded"]
        if d1.shape != (B, s["k"]) or not np.array_equal(
                np.isfinite(d1[same]), np.isfinite(d0[same])):
            raise AssertionError(f"sharded scale2 {c}: {d1.shape} distances, "
                                 "+inf where the single index has none")
        assert_same(d0[same], l0[same], d1[same], l1[same],
                    f"sharded scale2 {c} vs the single index")
    rec = recall_at_k(out[("quad", "wide"), "sharded"][1], gt, ks=(1, 10))
    loads = [x.store.ntotal for x in sh.shards]
    print(f"[sharded] 18a scale2 over 8 local shards on {device}: layout "
          f"{layout_s:.2f} s (shard loads {min(loads)}..{max(loads)} "
          f"codes); a query's {P} probes fall in "
          f"{spread['shards_per_query']:.2f} shards on average, "
          f"{spread['top_shard_share']:.3f} of them in its fullest shard; "
          f"probe lists equal to the single index's on "
          f"{int(same.sum())} of {B} queries (the rest differ only at f32 "
          f"ties), results equal on those; coarse ms sharded "
          f"{coarse['sharded']:.4f} single {coarse['single']:.4f}; R@1 "
          f"{rec[1]:.4f} R@10 {rec[10]:.4f}; device peak {peak} GiB",
          flush=True)
    for layout in ("chunk", "quad"):
        index.scan_layout = layout
        gran = index.scan_gran()
        print(f"[sharded] 18a {layout} ({gran} codes/slot): slots per shard "
              + json.dumps(slots[layout]) + f" (sum "
              f"{sum(slots[layout].values())}; single index worst case "
              f"{index._scan_slots(prm, P, gran)}, profiled "
              f"{s2['budget'][layout] // gran}); us/query (best of 2, in "
              f"turns) " + json.dumps(
                  {f"{topk}/{w}": round(us[(layout, topk), w], 3)
                   for topk in ("wide", "twophase")
                   for w in ("single", "sharded")}), flush=True)

    # the scan kernels on the busiest shard's schedule, against plain
    for layout in ("chunk", "quad"):
        sh.scan_layout = layout
        gran = sh.scan_gran()
        rank = max(slots[layout], key=slots[layout].get)
        args = (*sh.scan_inputs(q_np, prm, rank), gran)
        check_scan_kernels(args, kernels, "sharded", "[sharded]",
                           f"shard {rank}'s schedule", {"shard": rank},
                           rivals=MIN_RIVALS, wide_rivals=WIDE_RIVALS)
        del args
    del sh
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # 18b. one NCCL rank holding the whole index
    index.scan_layout, index.scan_topk = "quad", "wide"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/init",
                                world_size=1, rank=0,
                                timeout=timedelta(seconds=300))
        try:
            dsh = ShardedIVFADC(index, DistributedShards(device))
            same1 = probe_agreement(dsh, index, q, P, "nccl probes")
            d2, l2 = pl.counted("18b", dsh.scan_gran(), ["adc_scan_slots"],
                                lambda: dsh.search(q_np, prm, batch=B),
                                "nccl sharded search")
            d0, l0 = out[("quad", "wide"), "single"]
            assert_same(d0[same1], l0[same1], d2[same1], l2[same1],
                        "nccl sharded vs the single index")
            print(f"[sharded] 18b one NCCL rank ({dist.get_backend()}, "
                  f"world size {dist.get_world_size()}) over the whole "
                  f"index: equal to the single index on {int(same1.sum())} "
                  f"of {B} queries with equal probe lists (the rest differ "
                  f"only at f32 ties); slots {dsh.last_slots}", flush=True)
            del dsh
        finally:
            dist.destroy_process_group()
    index.scan_topk = "auto"


def store_ties(ref, got, index, base: np.ndarray, what: str) -> dict:
    """Two stores of the same vectors (ids 0..n-1): equal arrays, or each
    vector's list, PQ code and norm code equal except at a near-tie that
    is shown (its two centroids, codewords or norm centroids equally near
    to f32 rounding). Returns the counts of such ties."""
    import torch
    names = ("codes", "ids", "norm_codes", "list_offsets")
    if all(np.array_equal(getattr(ref, n), getattr(got, n)) for n in names):
        return {"keys": 0, "codes": 0, "norm_codes": 0}

    def by_id(st):
        keys = np.repeat(np.arange(st.nc), np.diff(st.list_offsets))
        order = np.argsort(st.ids, kind="stable")
        return keys[order], st.codes[order], st.norm_codes[order]

    (kr, cr, nr), (kg, cg, ng) = by_id(ref), by_id(got)
    dev = index.device
    x = torch.tensor(base, device=dev)
    ties = {}
    rows = np.nonzero(kr != kg)[0]
    ties["keys"] = int(rows.size)
    if rows.size:
        xr = x[rows]
        da, db = (((xr - index.centroids[torch.tensor(k[rows], device=dev)])
                   ** 2).sum(1) for k in (kr, kg))
        torch.testing.assert_close(da, db, rtol=1e-5, atol=1e-4,
                                   msg=lambda m: f"{what} keys: {m}")
    same_key = kr == kg
    r2, ms = np.nonzero((cr != cg) & same_key[:, None])
    ties["codes"] = int(r2.size)
    if r2.size:
        xr = x[r2] - index.centroids[torch.tensor(kr[r2], device=dev)]
        sub = index._rotate(xr).reshape(r2.size, index.pq.M, -1)[
            torch.arange(r2.size, device=dev), torch.tensor(ms, device=dev)]
        cb = index.pq.codebooks[torch.tensor(ms, device=dev)]
        da, db = (((sub - cb[torch.arange(r2.size, device=dev), torch.tensor(
            c[r2, ms].astype(np.int64), device=dev)]) ** 2).sum(1)
            for c in (cr, cg))
        torch.testing.assert_close(da, db, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: f"{what} codes: {m}")
    r3 = np.nonzero((nr != ng) & same_key & (cr == cg).all(1))[0]
    ties["norm_codes"] = int(r3.size)
    if r3.size:
        c = index.centroids[torch.tensor(kr[r3], device=dev)]
        rec = index._decode(torch.tensor(cr[r3], device=dev)) + c
        norms = (rec * rec).sum(1)
        cents = index.norm_pq.centroids
        da, db = ((norms - cents[torch.tensor(n[r3].astype(np.int64),
                                              device=dev)]).abs()
                  for n in (nr, ng))
        torch.testing.assert_close(da, db, rtol=0,
                                   atol=1e-5 * float(norms.max()),
                                   msg=lambda m: f"{what} norm codes: {m}")
    return ties


def run_sharded_primary(device, cfg, ds, index, gi, pl: PhaseLaunches,
                        kernels: list) -> None:
    """Phases 18c-18e over phase 8's flagship ``gi`` and phase 4's
    primary index ``index`` and its corpus ``ds``."""
    import dataclasses
    import functools
    import tempfile

    import torch
    from ivfhnsw_tpu_torch.drivers.common import _sync
    from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex
    from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
    from ivfhnsw_tpu_torch.ops.grouping import (group_terms, pruning_sums,
                                                query_terms)
    from ivfhnsw_tpu_torch.parallel import (ShardedGrouping, ShardedIVFADC,
                                            make_mesh)
    from ivfhnsw_tpu_torch.parallel.pipeline import (StreamedIndexBuild,
                                                     host_slice,
                                                     merge_host_spills)
    from ivfhnsw_tpu_torch.utils.checkpoint import load_sharded, save_sharded

    g8 = make_mesh(devices=[device] * 8)
    q_np = ds.queries[:SEARCH_BATCH]
    q = torch.tensor(q_np, device=device)
    B = q.shape[0]

    # 18c. the flagship over 8 shards, pruning off and on, both widths
    gcfg = flagship_cfg(cfg)
    P = gcfg.search.nprobe
    gi.engine = "fused"
    gsh = ShardedGrouping(gi, g8)
    same = probe_agreement(gsh, gi, q, P, "flagship sharded probes")
    gv = gi._grouped()
    qc, probes = streaming_topk_l2(q, gi.centroids, P,
                                   block=gi._coarse_block_for(B),
                                   point_sqnorms=gi.centroid_norms)
    for pruning in (False, True):
        prm = dataclasses.replace(gcfg.search, do_pruning=pruning)
        keep, nflip = same, 0
        if pruning:
            # the decisions of both against each other on the queries
            # whose probe lists agree: a flip lies at the threshold
            _, _, scan1, _ = query_terms(
                q, qc, probes, gi.centroids, gi.centroid_norms,
                gi.nn_centroid_idxs, gi.alphas, gi.inter_centroid_dists,
                gv.sub_sizes_t, prm.max_codes, True)
            terms, scans, _ = gsh._terms(q, prm)
            scan_s = functools.reduce(torch.logical_or,
                                      [x.to(device) for x in scans])
            agree = torch.tensor(same, device=device)[:, None, None]
            flips = (scan1 != scan_s) & agree
            nflip = int(flips.sum())
            if nflip:
                _, _, qsd, ssz = group_terms(
                    q, qc, probes, gi.centroids, gi.centroid_norms,
                    gi.nn_centroid_idxs, gi.alphas, gi.inter_centroid_dists,
                    gv.sub_sizes_t, True)
                tot, cnt = pruning_sums(qsd, ssz, ssz.sum(2), prm.max_codes)
                thr = (tot / cnt.clamp_min(1))[:, None, None].expand_as(qsd)
                gap = ((qsd - thr).abs() / thr.abs())[flips]
                if float(gap.max()) > 1e-5:
                    raise AssertionError(f"flagship sharded: a pruning flip "
                                         f"{float(gap.max())} (relative) "
                                         "from the threshold")
            keep = same & ~flips.any((1, 2)).cpu().numpy()
            del terms, scans, scan_s, scan1
        for layout in ("chunk", "quad"):
            gi.scan_layout = gsh.scan_layout = layout
            gran = gsh.scan_gran()
            t = time.perf_counter()
            d0, l0 = gi.search(q_np, prm)
            t_single = time.perf_counter() - t
            gsh.search(q_np[:64], prm)                      # warm the shapes
            t = time.perf_counter()
            d1, l1 = pl.counted("18c", gran, ["grouping_scan_slots"],
                                lambda: gsh.search(q_np, prm),
                                f"flagship sharded {layout}")
            t_sharded = time.perf_counter() - t
            assert_same(d0[keep], l0[keep], d1[keep], l1[keep],
                        f"flagship sharded {layout} pruning={pruning}")
            print(f"[sharded] 18c flagship over 8 shards, pruning={pruning}, "
                  f"{layout}: equal to the single index on {int(keep.sum())} "
                  f"of {B} queries (probe lists differ on "
                  f"{int((~same).sum())}, at f32 ties; {nflip} subgroups "
                  f"pruned differently, each within 1e-5 of the threshold); "
                  f"slots per shard {gsh.last_slots}; wall {t_sharded:.4f} s "
                  f"against {t_single:.4f} s single", flush=True)
    # the grouping kernel on the busiest shard's schedule
    prm = gcfg.search
    for layout in ("chunk", "quad"):
        gi.scan_layout = gsh.scan_layout = layout
        gran = gsh.scan_gran()
        gsh.search(q_np, prm)
        rank = max(gsh.last_slots, key=gsh.last_slots.get)
        check_grouping_kernel((*gsh.scan_inputs(q_np, prm, rank), gran),
                              kernels, "sharded", "[sharded]",
                              f"shard {rank}'s schedule", {"shard": rank})
    gi.scan_layout = "auto"
    del gsh

    # 18d. the streamed build of phase 4's rows over 8 shards
    def fresh():
        i = IVFADCIndex(index.config, device)
        i.set_centroids(index.centroids)
        i.pq, i.norm_pq, i.opq_R = index.pq, index.norm_pq, index.opq_R
        return i

    bs, nb = 262_144, ds.nb
    stop = (nb // 2) // bs * bs
    with tempfile.TemporaryDirectory(prefix="chip_smoke_build_") as tmp:
        wd = os.path.join(tmp, "one")
        adds = 0.0
        b = StreamedIndexBuild(fresh(), g8, wd)
        for off in range(0, stop, bs):
            t = time.perf_counter()
            b.add_batch(ds.base[off:off + bs])
            adds += time.perf_counter() - t
        b.close()
        with open(os.path.join(wd, "codes.u8"), "ab") as f:
            f.write(b"\x7f" * 777)                 # a torn write
        b = StreamedIndexBuild(fresh(), g8, wd)
        if b.processed != stop:
            raise AssertionError(f"resumed at {b.processed}, not {stop}")
        for off in range(stop, nb, bs):
            t = time.perf_counter()
            b.add_batch(ds.base[off:off + bs])
            adds += time.perf_counter() - t
        t = time.perf_counter()
        built = b.finalize()
        _sync(device)
        fin_s = time.perf_counter() - t
        ties = store_ties(index.store, built.store, index, ds.base,
                          "streamed build")
        dirs = []
        for h in range(2):
            lo, hi = host_slice(nb, 2, h)
            dirs.append(os.path.join(tmp, f"host_{h:03d}"))
            bh = StreamedIndexBuild(fresh(), g8, dirs[-1])
            for off in range(lo, hi, bs):
                e = min(off + bs, hi)
                bh.add_batch(ds.base[off:e], np.arange(off, e,
                                                       dtype=np.int32))
            bh.close()
        mties = store_ties(index.store, merge_host_spills(fresh(),
                                                          dirs).store,
                           index, ds.base, "two-host merge")
        spill = sum(os.path.getsize(os.path.join(wd, n))
                    for n in os.listdir(wd))
    print(f"[sharded] 18d streamed build of {nb} rows over 8 shards in "
          f"batches of {bs}: stopped at {stop}, torn bytes truncated, "
          f"resumed; {nb / adds:.0f} rows/s through add_batch ({adds:.3f} "
          f"s, spills {spill} B), finalize {fin_s:.3f} s; store against "
          f"phase 4's: near-ties " + json.dumps(ties) + "; two hosts "
          "merged: near-ties " + json.dumps(mties), flush=True)

    # 18e. the 8-shard primary index through a sharded checkpoint
    prm = cfg.search
    sh = ShardedIVFADC(index, g8)
    gran = sh.scan_gran()
    d0, l0 = pl.counted("18e", gran, ["adc_scan_slots"],
                        lambda: sh.search(ds.queries, prm), "sharded primary")
    same = probe_agreement(sh, index, torch.tensor(ds.queries[:B],
                                                   device=device),
                           prm.nprobe, "primary sharded probes")
    index.engine = "fused"
    ds_, ls_ = index.search(ds.queries[:B], prm)
    assert_same(ds_[same], ls_[same], d0[:B][same], l0[:B][same],
                "sharded primary vs the single index")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        t = time.perf_counter()
        save_sharded(sh, tmp)
        save_s = time.perf_counter() - t
        nbytes = sum(os.path.getsize(os.path.join(tmp, n))
                     for n in os.listdir(tmp))
        t = time.perf_counter()
        back = load_sharded(tmp, g8)
        load_s = time.perf_counter() - t
    d1, l1 = back.search(ds.queries, prm)
    if not (np.array_equal(d0, d1) and np.array_equal(l0, l1)):
        raise AssertionError("sharded checkpoint: the loaded index searches "
                             "differently")
    print(f"[sharded] 18e 8-shard checkpoint of the primary index: {nbytes} "
          f"B written in {save_s:.3f} s, loaded in {load_s:.3f} s; search "
          f"of {ds.nq} queries bit-equal after the round trip; equal to the "
          f"single index on {int(same.sum())} of {B} queries with equal "
          f"probe lists", flush=True)


# ---------------------------------------------------------------------------
# Phase 19: the 1B path
# ---------------------------------------------------------------------------

def run_onebillion(device, s: dict, pl: PhaseLaunches,
                   kernels: list) -> None:
    """Phase 19 at the sizes ``s``: ivfhnsw_tpu_torch/tools/build_1b.py to
    half the target, torn bytes past its cursor, build_1b.py to the target
    (one resume), its ground truth against an uninterrupted merge; then
    tools/search_1b.py at --shards 4 and 1 at both slot widths, wide and
    two-phase, with the scan kernels' launches required to grow, 64 queries
    against the torch engine (per shard at 4; IVFADCIndex's over the same
    store at 1), and each scan kernel torch.equal to its plain version on
    the busiest shard's schedule, both timed."""
    import shutil
    import tempfile

    import torch
    from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
    from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
    from ivfhnsw_tpu_torch.parallel.pipeline import SPILLS
    from ivfhnsw_tpu_torch.tools import build_1b, scale3, search_1b

    target, bs, ctl = s["target"], s["batch"], s["ctl"]
    k, P, mc = s["k"], s["nprobe"], s["max_codes"]
    dev = "cpu" if device.type == "cpu" else str(device)
    prior = os.environ.get("BENCH_CACHE_DIR")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_1b_") as cache:
        os.environ["BENCH_CACHE_DIR"] = cache
        try:
            free = shutil.disk_usage(cache).free
            spill_gb = target * 25 / 1e9      # key, id, code, norm code
            print(f"[1b] reduced: --target {target} ({target // bs} "
                  f"batches of {bs}, a {spill_gb:.2f} GB spill) where users "
                  f"run 1e9 (25 GB); disk free {free / 1e9:.1f} GB in "
                  f"{os.path.dirname(cache)}", flush=True)
            if free < 1.2 * spill_gb * 1e9:
                raise AssertionError(f"phase 19 needs {spill_gb:.2f} GB of "
                                     f"disk, {free / 1e9:.1f} GB free")
            flags = ["--batch", str(bs), "--device", dev]
            mem_reset(device)
            t = time.perf_counter()
            half = build_1b.main(["--target", str(target // 2), *flags])
            first_s = time.perf_counter() - t
            wd = os.path.join(cache, "build1b")
            for name in SPILLS:                     # a torn write
                with open(os.path.join(wd, name), "ab") as f:
                    f.write(b"\x7f" * 777)
            t = time.perf_counter()
            meta = build_1b.main(["--target", str(target), *flags])
            second_s = time.perf_counter() - t
            if meta["resumes"] != 1 or meta["processed"] != target:
                raise AssertionError(f"1B build: resumes {meta['resumes']}, "
                                     f"processed {meta['processed']}")
            build_peak = peak_gib(device)
            # the ground truth against one uninterrupted merge
            q = torch.tensor(np.load(os.path.join(wd, "queries.npy")),
                             device=device)
            corpus = scale3.scale3_corpus(device)
            ref = scale3.TopOne(q)
            t = time.perf_counter()
            for bi in range(target // bs):
                ref.merge(corpus.gen(scale3.SEED_BASE + bi, bs), bi * bs)
            gt_s = time.perf_counter() - t
            del corpus
            gt_l = np.load(os.path.join(wd, "gt.npy"))
            gt_d = np.load(os.path.join(wd, "gt_d.npy"))
            if not (np.array_equal(ref.labels.cpu().numpy(), gt_l)
                    and np.array_equal(ref.dists.cpu().numpy(), gt_d)):
                raise AssertionError("1B build: the resumed build's ground "
                                     "truth differs from one uninterrupted "
                                     "merge")
            rss = host_rss_gib()
            print(f"[1b] build_1b.py to {target // 2} ({first_s:.2f} s, "
                  f"{half['vectors_per_sec']:.0f} vectors/s), torn bytes "
                  f"past the cursor, to {target} ({second_s:.2f} s): "
                  f"resumes {meta['resumes']}, {meta['vectors_per_sec']:.0f} "
                  f"vectors/s over the two runs' build loops "
                  f"({meta['build_seconds']} s), prerequisites "
                  f"{meta.get('prereq_seconds')} s; routed match rate "
                  f"{meta['match_rate']}, drift " + json.dumps(
                      meta["drift_series"]) + f", routed abandoned "
                  f"{meta.get('routed_abandoned', False)}; spill "
                  f"{meta['spill_bytes']} B; ground truth of {q.shape[0]} "
                  f"queries equal to an uninterrupted merge (recomputed in "
                  f"{gt_s:.2f} s); host RSS {rss[0]:.2f} GiB (peak "
                  f"{rss[1]:.2f}), device peak {build_peak} GiB; stage "
                  "seconds (both runs) " + json.dumps(meta["stage_seconds"]),
                  flush=True)

            cents = torch.tensor(np.load(os.path.join(
                cache, "scale3", "centroids.npy")), device=device)
            coarse_ms = device_ms(lambda: streaming_topk_l2(
                q, cents, P, block=16384), reps=5)
            del cents
            q_np = q.cpu().numpy()
            res, busiest = {}, {}
            for S in (4, 1):
                for layout, gran in (("chunk", tk.CHUNK), ("quad",
                                                           tk.RCHUNK)):
                    seen = {"torch": 0}

                    def hook(info, S=S, gran=gran, layout=layout):
                        check_shard(info, S, gran, k, P, mc, ctl, q_np,
                                    seen)
                        if S == 4:
                            sl = info["out"][layout, "wide"][2]
                            if sl > busiest.get(gran, (0,))[0]:
                                sh = info["shard"]
                                busiest[gran] = (sl, sh.rank,
                                                 sh.store.ntotal, sh.scan_args(
                                    info["queries"], info["probes"],
                                    info["included"], info["term1"], gran,
                                    None))

                    mem_reset(device)
                    res[S, layout] = pl.counted(
                        "19", gran, ["adc_scan_slots", "adc_scan_slots_min"],
                        lambda: search_1b.main(
                            ["--shards", str(S), "--nprobe", str(P),
                             "--max-codes", str(mc), "--k", str(k),
                             "--scan-layout", layout,
                             "--scan-topk", "wide,twophase",
                             "--device", dev], on_shard=hook),
                        f"1B search --shards {S} {layout}")
                    res[S, layout]["peak_gib"] = peak_gib(device)
                    res[S, layout]["torch_checked"] = seen["torch"]
                    if S == 4:
                        slots, rank, rows, sched = busiest.pop(gran)
                        check_scan_kernels(
                            (*sched, gran), kernels, "onebillion", "[1b]",
                            f"shard {rank}'s schedule over {rows} rows",
                            {"shard": rank, "rows": rows})
            report_onebillion(res, coarse_ms, ctl)
        finally:
            if prior is None:
                os.environ.pop("BENCH_CACHE_DIR", None)
            else:
                os.environ["BENCH_CACHE_DIR"] = prior


def check_shard(info: dict, S: int, gran: int, k: int, P: int, mc: int,
                ctl: int, q_np, seen: dict) -> None:
    """Phase 19's check of one streamed shard: on ``ctl`` queries, each
    fused result of the shard against the torch engine, the shard's own
    (IVFShard.scan, engine "torch") at S = 4 and IVFADCIndex's over the
    same store at S = 1 (there only queries whose probe list equals the
    tool's, the others shown to differ at f32 ties)."""
    from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex
    from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
    from ivfhnsw_tpu_torch.utils.config import SearchParams
    sh, out = info["shard"], info["out"]
    if S == 1:
        proto = info["proto"]
        idx = IVFADCIndex(proto.config, proto.device)
        idx.set_centroids(proto.centroids)
        idx.pq, idx.norm_pq = proto.pq, proto.norm_pq
        idx.store, idx.engine = sh.store, "torch"
        d_t, l_t = idx.search(q_np[:ctl], SearchParams(k=k, nprobe=P,
                                                       max_codes=mc))
        q = info["queries"][:ctl]
        d_p, p_p = streaming_topk_l2(q, idx.centroids, P, block=idx._cb(),
                                     point_sqnorms=idx.centroid_norms)
        same = (p_p == info["probes"][:ctl]).all(1)
        if not bool(same.all()):
            check_ties_only(d_p[~same], p_p[~same], info["qc"][:ctl][~same],
                            info["probes"][:ctl][~same], "1B --shards 1 "
                            "probes", tie_atol(q, idx))
        same = same.cpu().numpy()
        what = "IVFADCIndex's torch engine"
    else:
        d_t, l_t, _ = sh.scan(info["queries"][:ctl], info["probes"][:ctl],
                              info["included"][:ctl], info["term1"][:ctl],
                              k, "torch", gran, False, None)
        d_t, l_t = d_t.cpu().numpy(), l_t.cpu().numpy()
        same = np.ones(ctl, bool)
        what = f"shard {sh.rank}'s torch engine"
    for (layout, topk), (d, lab, _, _) in out.items():
        assert_same(d_t[same], l_t[same], d[:ctl][same], lab[:ctl][same],
                    f"1B --shards {S} {layout} {topk} vs {what}")
    seen["torch"] += int(same.sum())


def check_scan_kernels(args: tuple, kernels: list, key: str, tag: str,
                       what: str, extra: dict, rivals=(),
                       wide_rivals=()) -> None:
    """K1 and K3 (gran 256) or K2 and K4 (gran 1024) on the schedule
    ``args`` (the scan wrappers' arguments, gran last): each torch.equal to
    its plain version (K1 / K2 launched as the search launches them, their
    bin minima torch.equal to the plain lanes' too), then both timed, with
    the bound beside them, and each against its first port in turns (K3 /
    K4 with the min steps
    ``rivals``, K1 / K2 with the wide steps ``wide_rivals``); the record (``extra`` and those numbers) goes under ``key`` in the
    kernel's entry of ``kernels`` and on a ``tag`` line."""
    import torch
    from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
    from ivfhnsw_tpu_torch.utils.roofline import (lookup_ms,
                                                  lookup_wavefronts,
                                                  scan_bound)
    gran, length, code_m = args[-1], args[5], args[2].shape[1]
    B, S = length.shape
    for name, wrapper, plain in (
            (f"adc_scan_slots_gran{gran}", wide_lanes,
             tk.adc_scan_slots_plain),
            (f"adc_scan_slots_min_gran{gran}", tk.adc_scan_slots_min,
             tk.adc_scan_slots_min_plain)):
        wide = "min" not in name
        got = wrapper(*args)
        ref = plain(*args)
        if not torch.equal(got, ref):
            raise AssertionError(f"{tag} {name} on {what}: kernel not "
                                 "torch.equal to its plain version")
        if wide:
            check_bins(tk.adc_scan_slots(*args, bins=True)[1], ref,
                       f"{tag} {name} on {what}")
        del ref
        r = {**extra, "slots": S,
             "lane_fill": int(length.sum()) / (B * S * gran),
             "ms": device_ms(lambda w=wrapper: w(*args)),
             "plain_ms": device_ms(lambda p=plain: p(*args), reps=3,
                                   warmup=1),
             **scan_bound(args, got.numel(), code_m + 1,
                          code_m + (1 if wide else 2), bins=wide)}
        r.update(first_port_turns(args, rivals=wide_rivals if wide else rivals,
                                  wide=wide))
        turns = f"; {turns_text(r)}"
        if not wide:
            looks, waves = lookup_wavefronts(args[2], args[3], args[4],
                                             length, gran)
            r["lookup_conflict_ms"] = lookup_ms(32 * waves, args[0].device)
            turns += (f"; {32 * waves / max(looks, 1):.3f} wavefronts a "
                      "lookup, conflict floor "
                      + ("n/a" if r["lookup_conflict_ms"] is None
                         else f"{r['lookup_conflict_ms']:.4f} ms"))
        for krec in kernels:
            if krec["name"] == name:
                krec[key] = r
        print(f"{tag} {name} on {what} (B={B}, {S} slots, lane fill "
              f"{r['lane_fill']:.3f}): torch.equal to plain"
              f"{', bin minima too' if wide else ''}; kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}{turns}", flush=True)
        del got


def check_grouping_kernel(args: tuple, kernels: list, key: str, tag: str,
                          what: str, extra: dict) -> None:
    """K5 (gran 256) or K6 (gran 1024) on the schedule ``args`` (the
    grouping wrapper's arguments, gran last), launched as the search
    launches it: torch.equal to its plain version, its bin minima to the
    plain lanes', then both timed, with the bound beside them; the record
    (``extra`` and those numbers) goes under ``key`` in the kernel's entry
    of ``kernels`` and on a ``tag`` line."""
    import torch
    from ivfhnsw_tpu_torch.ops.cuda import grouping_scan as tg
    from ivfhnsw_tpu_torch.utils.roofline import grouping_scan_bound
    gran = args[-1]
    name = f"grouping_scan_slots_gran{gran}"
    got, bins = tg.grouping_scan_slots(*args, bins=True)
    ref = tg.grouping_scan_slots_plain(*args)
    if not torch.equal(got, ref):
        raise AssertionError(f"{tag} {name} on {what}: kernel not "
                             "torch.equal to its plain version")
    check_bins(bins, ref, f"{tag} {name} on {what}")
    del ref, bins
    b = grouping_scan_bound(args[:-1], got, gran, bins=True)
    kept, filled = b.pop("kept_lanes"), b.pop("filled_lanes")
    r = {**extra, "slots": args[6].shape[1],
         "lane_fill": filled / got.numel(), "unpruned": kept / max(filled, 1),
         "ms": device_ms(lambda: grouping_lanes(*args)),
         "plain_ms": device_ms(lambda: tg.grouping_scan_slots_plain(*args),
                               reps=3, warmup=1), **b}
    for krec in kernels:
        if krec["name"] == name:
            krec[key] = r
    print(f"{tag} {name} on {what} (B={got.shape[0]}, {r['slots']} slots, "
          f"lane fill {r['lane_fill']:.3f}, unpruned {r['unpruned']:.3f} of "
          f"filled): torch.equal to plain, bin minima too; kernel "
          f"{r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']}", flush=True)


def report_onebillion(res: dict, coarse_ms: float, ctl: int) -> None:
    """Phase 19's [1b] search lines."""
    for (S, layout), r in res.items():
        shards = [(p["host_assemble_seconds"], p["search_seconds"])
                  for p in r["per_shard"]]
        print(f"[1b] search_1b.py --shards {S} --scan-layout {layout} "
              f"(nb {r['nb']}, nc {r['nc']}, {r['nq']} queries, nprobe "
              f"{r['nprobe']}, max_codes {r['max_codes']}, k {r['k']}): "
              f"coarse {r['coarse_seconds']} s (CUDA events "
              f"{coarse_ms:.3f} ms); per shard (assembly s, search s of the "
              f"wide scan) {shards}; codes scanned per query "
              f"{r['codes_scanned_per_query']:.1f}; device peak "
              f"{r['peak_gib']} GiB; {r['torch_checked']} query results "
              f"equal to the torch engine's on the first {ctl}; per top-k "
              + json.dumps({c: {"R@1/10/100": [v["recall_at_1"],
                                               v["recall_at_10"],
                                               v["recall_at_100"]],
                                "us_per_query": v["us_per_query"],
                                "slots": v["slots_per_shard"]}
                            for c, v in r["combos"].items()}), flush=True)
    c4 = res[4, "quad"]["codes_scanned_per_query"]
    c1 = res[1, "quad"]["codes_scanned_per_query"]
    print(f"[1b] codes scanned per query: --shards 4 {c4:.1f} against "
          f"--shards 1 {c1:.1f} ({c4 / max(c1, 1e-9):.3f}x: the per-shard "
          "max_codes budget of the JAX tool)", flush=True)


def run_bench20(device, pl: PhaseLaunches, kernels: list,
                cache: str | None = None) -> dict:
    """Phase 20: the ``deep`` and ``grouping_scale`` stages of
    ivfhnsw_tpu_torch/tools/bench.py in process at the tool's sizes
    (nothing cut: 20M and 33.5M vectors), in the bench cache ``cache`` (a
    temporary one when None); returns each stage's record."""
    import tempfile
    from ivfhnsw_tpu_torch.tools import bench
    S = bench.sizes(False)
    with tempfile.TemporaryDirectory(prefix="bench20_") as tmp:
        return {name: bench20_stage(device, name, S, cache or tmp, pl,
                                    kernels)
                for name in ("deep", "grouping_scale")}


# The bench stages of phases 20-21: record key, and (nb, nprobe, max_codes)
# of the operating point checked beside the stage's own evaluation.
BENCH_STAGES = {
    "deep": ("deep", lambda S: (S["DEEP_NB"], S["DEEP_NPROBE"],
                                S["DEEP_MC"])),
    "grouping_scale": ("gscale", lambda S: (S["GS_NB"], S["GS_NPROBE"],
                                            S["GS_MC"])),
    "scale3sl": ("s3sl", lambda S: (S["S3SL_NB"], *S["S3SL_SWEEP"][-1])),
    "scale4": ("s4", lambda S: (S["S4_NB"], S["S3_NPROBE"], S["S3_MC"]))}


def bench20_stage(device, name: str, S: dict, cache: str,
                  pl: PhaseLaunches, kernels: list, phase: str = "20",
                  on_index=None) -> dict:
    """One bench stage of phase 20 (or 21): the tool's builder and
    evaluation (the stage's main path, its scan kernel required to
    launch), then every slot width with wide and two-phase top-k (IVFADC)
    or pruning on and off (grouping) at the stage's operating point
    (:data:`BENCH_STAGES`), sustained and single-launch µs/query through
    the tool's timed_qps, the scan kernels required to launch in each;
    results equal across widths and top-k; 64 queries equal to engine
    "torch"; each scan kernel torch.equal to its plain version on this
    stage's schedule, timed, under the stage's record key ("deep",
    "gscale", "s3sl", "s4"). ``on_index(idx)``, when given, sees the index
    before it is released."""
    import torch
    from ivfhnsw_tpu_torch.drivers.common import _sync
    from ivfhnsw_tpu_torch.tools import bench
    from ivfhnsw_tpu_torch.utils.config import SearchParams
    from ivfhnsw_tpu_torch.utils.recall import recall_at_k
    build, evaluate = bench.STAGES[name]
    grouping = name == "grouping_scale"
    key, point = BENCH_STAGES[name]
    nb, nprobe, mc = point(S)
    tag = f"[bench{phase}]"
    mem_reset(device)
    t = time.perf_counter()
    idx, q_np, gt, meta = pl.assign(phase, lambda: build(S, device, cache),
                                    f"{name}'s build")
    _sync(device)
    build_s = time.perf_counter() - t
    scan = "grouping_scan_slots" if grouping else "adc_scan_slots"
    f = pl.counted(phase, None, [scan], lambda: evaluate(
        idx, q_np, gt, meta, S, cache, False), f"{name} stage")
    fp = name + "_"
    st = idx._ensure_store()
    lists = (st.list_sizes().reshape(-1, S["NSUBC"]).sum(1) if grouping
             else st.list_sizes())
    ks = [k for k in (1, 10, 100) if fp + f"ceiling_at_{k}" in f]
    print(f"{tag} {name}: nb {nb}, d {idx.d}, nc {idx.nc}"
          + (f", nsubc {S['NSUBC']}, OPQ" if grouping else "")
          + f"; lists mean {lists.mean():.2f} max {lists.max()} "
          f"empty {int((lists == 0).sum())}; build {build_s:.2f} s (stages "
          + json.dumps({k: round(v, 2) for k, v in
                        meta["stage_seconds"].items()})
          + f"; assignment {meta['assignment_mode']}); ceiling R@"
          f"{'/'.join(map(str, ks))} "
          f"{[round(f[fp + f'ceiling_at_{k}'], 4) for k in ks]} in "
          f"{f[fp + 'ceiling_seconds']:.2f} s; search R@"
          f"{'/'.join(map(str, ks))} "
          f"{[round(f[fp + f'recall_at_{k}'], 4) for k in ks]}; "
          f"default layout {idx._resolve_layout()}: sustained "
          f"{f[fp + 'us_per_query']:.3f} us/query (depth {bench.DEPTH}), "
          f"single launch {f[fp + 'us_per_query_single_launch']:.3f}; "
          f"device peak {peak_gib(device)} GiB", flush=True)
    base = dict(k=S["K"], nprobe=nprobe, max_codes=mc)
    variants = ((True, False) if grouping else ("wide", "twophase"))
    res = {}
    for layout in ("chunk", "quad"):
        idx.scan_layout = layout
        gran = idx.scan_gran()
        prm, dem = bench.profiled(idx, q_np, SearchParams(
            **base, do_pruning=grouping))
        for v in variants:
            if grouping:
                prm.do_pruning = v
            else:
                idx.scan_topk = v
            need = [scan] + (["adc_scan_slots_min"] if v == "twophase"
                             else [])
            qps, labels, single = pl.counted(
                phase, gran, need, lambda: bench.timed_qps(idx, q_np, prm),
                f"{name} {layout} {v}")
            d, l = idx.search(q_np, prm)
            if not np.array_equal(l, labels):
                raise AssertionError(f"{name} {layout} {v}: timed_qps's "
                                     "labels differ from search's")
            res[layout, v] = (d, l, 1e6 / qps, single, dem)
    idx.scan_topk = "auto"
    for v in variants:
        d0, l0 = res["quad", v][:2]
        if d0.shape != (len(q_np), S["K"]) or not np.isfinite(d0).all():
            raise AssertionError(f"{name} {v}: bad distances {d0.shape}")
        assert_same(d0, l0, *res["chunk", v][:2], f"{name} chunk vs quad "
                    f"({v})")
        if not grouping:
            assert_same(d0, l0, *res["quad", "wide"][:2],
                        f"{name} {v} vs wide")
    prm.do_pruning = grouping
    prm.scan_budget = res["quad", variants[0]][4] * idx.scan_gran()
    d_f, l_f = idx.search(q_np[:64], prm)
    idx.engine = "torch"
    d_t, l_t = idx.search(q_np[:64], prm)
    idx.engine = "auto"
    assert_same(d_t, l_t, d_f, l_f, f"{name} fused vs torch engine")
    print(f"{tag} {name} at nprobe {nprobe}, max_codes {mc}: per slot "
          "width and " + ("pruning" if grouping else "top-k")
          + " (us/query sustained, single launch, profiled slots, R@1/R@10) "
          + json.dumps(
              {f"{c[0]}/{c[1]}": [round(r[2], 3), round(r[3], 3), r[4]]
               + [round(x, 4) for x in
                  recall_at_k(r[1], gt, ks=(1, 10)).values()]
               for c, r in res.items()}) + "; equal across widths"
          + ("" if grouping else " and top-k") + "; 64 queries equal to "
          "engine torch", flush=True)
    q = torch.tensor(q_np, device=device)
    for layout in ("chunk", "quad"):
        idx.scan_layout = layout
        gran = idx.scan_gran()
        prm.scan_budget = res[layout, variants[0]][4] * gran
        if not grouping:
            check_scan_kernels((*idx.scan_inputs(q, prm, gran), gran),
                               kernels, key, tag, f"{name}'s schedule",
                               {"nb": nb})
            continue
        check_grouping_kernel((*idx.grouping_scan_inputs(q, prm, gran),
                               gran), kernels, key, tag,
                              f"{name}'s schedule", {"nb": nb})
    idx.scan_layout = "auto"
    if on_index is not None:
        on_index(idx)
    idx.release_device()
    del idx, q
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return f


# Phase 21: the bench tool's scale3sl and scale4 stages with one cut,
# nc=2^17 over 2^24 / 2^25 rows in place of nc=2^20 over 2^27 / 2^28: the
# same 128 / 256 codes a list, at an eighth of the exact assignment's nb x
# nc (bench.py:87-124 for the uncut sizes).
BENCH21 = dict(S3SL_NC=1 << 17, S3SL_NB=1 << 24, S4_NB=1 << 25)
# tests/test_drivers.py:142-151's tiny synthetic flags
LAUNCHER_FLAGS = ["-synthetic", "0", "-d", "16", "-nc", "32", "-nb", "6000",
                  "-nt", "3000", "-nq", "50", "-code_size", "4", "-nprobe",
                  "8", "-max_codes", "500", "-k", "10", "-path_base", "",
                  "-path_learn", "", "-path_q", "", "-path_gt", ""]


def run_bench21(device, pl: PhaseLaunches, kernels: list,
                cut: dict = BENCH21, cache: str | None = None) -> dict:
    """Phase 21: the ``scale3sl`` and then the ``scale4`` stage of
    ivfhnsw_tpu_torch/tools/bench.py in process (:func:`bench20_stage`,
    record keys "s3sl" / "s4") at the tool's sizes but for ``cut``; scale4
    extends scale3sl's cached index, and its store must be scale3sl's plus
    the extension (in every list scale3sl's ids and codes first, in their
    order, then only ids past scale3sl's nb). Then one launcher on the
    card: examples_torch/run_sift1b.sh with the tiny synthetic flags and
    the default device. ``cache``: the bench cache (a temporary one when
    None). Returns each stage's record."""
    import tempfile
    from ivfhnsw_tpu_torch.tools import bench
    S = {**bench.sizes(False), **cut}
    print(f"[bench21] reduced: nc {S['S3SL_NC']} over {S['S3SL_NB']} / "
          f"{S['S4_NB']} rows where the stages run nc "
          f"{bench.FULL['S3SL_NC']} over {bench.FULL['S3SL_NB']} / "
          f"{bench.FULL['S4_NB']} (the same codes a list)", flush=True)
    stores, out = {}, {}

    def keep(name):
        def on_index(idx):
            st = idx._ensure_store()
            stores[name] = (st.ids.copy(), st.codes.copy(),
                            st.list_offsets.astype(np.int64))
        return on_index

    with tempfile.TemporaryDirectory(prefix="bench21_") as tmp:
        for name in ("scale3sl", "scale4"):
            out[name] = bench20_stage(device, name, S, cache or tmp, pl,
                                      kernels, "21", keep(name))
    check_extension(stores["scale3sl"], stores["scale4"], S["S3SL_NB"],
                    S["S4_NB"])
    run_launcher(device)
    return out


def check_extension(sl: tuple, s4: tuple, nb: int, nb4: int) -> None:
    """scale4's store (ids, codes, offsets) is scale3sl's with the
    extension's rows appended to each list."""
    ids3, codes3, off3 = sl
    ids4, codes4, off4 = s4
    n3, n4 = np.diff(off3), np.diff(off4)
    if len(ids4) != nb4 or len(ids3) != nb or (n4 < n3).any():
        raise AssertionError(f"scale4: {len(ids4)} rows over lists that "
                             "lost rows of scale3sl's")
    pos = np.arange(nb4) - np.repeat(off4[:-1], n4)
    old = pos < np.repeat(n3, n4)
    if not (np.array_equal(ids4[old], ids3)
            and np.array_equal(codes4[old], codes3)
            and (ids4[~old] >= nb).all()
            and np.array_equal(np.sort(ids4[~old]), np.arange(nb, nb4))):
        raise AssertionError("scale4's store is not scale3sl's plus the "
                             "extension")
    print(f"[bench21] scale4's store is scale3sl's {nb} rows (ids and codes "
          f"in every list, in order) plus the extension's {nb4 - nb}",
          flush=True)


def run_launcher(device) -> None:
    """examples_torch/run_sift1b.sh on ``device`` (its default, -device
    left out) with the tiny synthetic flags, artifacts in a temporary
    directory: exit code 0 and a Recall@ line."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="launcher_") as tmp:
        art = [f"-{k}" if i % 2 == 0 else os.path.join(tmp, k)
               for k in ("path_centroids", "path_precomputed_idxs",
                         "path_pq", "path_norm_pq", "path_index")
               for i in range(2)]
        env = dict(os.environ, PYTHONPATH=root + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t = time.perf_counter()
        r = subprocess.run(["bash", os.path.join(root, "examples_torch",
                                                 "run_sift1b.sh"),
                            *LAUNCHER_FLAGS, *art], capture_output=True,
                           text=True, timeout=600, env=env)
    if r.returncode != 0 or "Recall@" not in r.stdout:
        raise AssertionError(f"run_sift1b.sh exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    print(f"[bench21] examples_torch/run_sift1b.sh (default device "
          f"{device.type}) rc 0 in {time.perf_counter() - t:.2f} s: "
          + " ".join(ln for ln in r.stdout.splitlines()
                     if ln.startswith("Recall@")), flush=True)


# Phase 22: the evidence tools. assign_ab at its own size (nc=2^17 from
# phase 20's grouping_scale centroids, 16,777,216 rows), coarse_ab on phase
# 21's cut scale3sl, routed_tune --quick and the routed gate's result
# overlap on phase 17's scale2 index, siftlike_scale_calibrate at a cut of
# the same 128 codes a list (nb 2^21 over nc 2^14 where the tool runs 2^23
# over 2^16), at its 128-byte codes and at the bench stages' 16.
EVIDENCE = dict(ab_nb=16_777_216, tune_b=256, result_ws=(16, 32, 64),
                calib_nb=1 << 21, calib_nc=1 << 14,
                calib_spec=(0.75, 1_048_576, 3.0))


def evidence_twin(pl: PhaseLaunches, kernels: list, nb: int, res: dict):
    """assign_ab's ``on_twin`` for phase 22a: the twin at both slot widths,
    wide and two-phase, through the fused engine (each width under its own
    profiled budget), the scan kernels required to launch in each, results
    equal across widths and top-k and on 64 queries to engine "torch";
    on a routed twin's schedule K1-K4 torch.equal to their plain versions
    (records "ab_w4" / "ab_w16"). ``res`` gains the twin's µs/query by
    combination."""
    import dataclasses

    import torch
    from ivfhnsw_tpu_torch.tools import bench

    def on_twin(v, ix, prm, q_np):
        out, us = {}, {}
        for layout in ("chunk", "quad"):
            ix.scan_layout = layout
            gran = ix.scan_gran()
            p2, _ = bench.profiled(ix, q_np, dataclasses.replace(
                prm, scan_budget=None))
            for topk in ("wide", "twophase"):
                ix.scan_topk = topk
                need = ["adc_scan_slots"] + (["adc_scan_slots_min"]
                                             if topk == "twophase" else [])
                ix.search(q_np[:256], p2, batch=256)
                t = time.perf_counter()
                out[layout, topk] = pl.counted(
                    "22", gran, need, lambda: ix.search(q_np, p2, batch=256),
                    f"assign_ab {v} {layout} {topk}")
                us[f"{layout}/{topk}"] = ((time.perf_counter() - t) * 1e6
                                          / len(q_np))
            if v != "exact":
                q = torch.tensor(q_np, device=ix.device)
                check_scan_kernels((*ix.scan_inputs(q, p2, gran), gran),
                                   kernels, "ab_" + v.split("_")[1],
                                   "[evidence]", f"assign_ab {v}'s schedule",
                                   {"nb": nb})
                del q
        d0, l0 = out["quad", "wide"]
        for c, (d, l) in out.items():
            assert_same(d0, l0, d, l, f"assign_ab {v} {c} vs quad/wide")
        ix.engine = "torch"
        d_t, l_t = ix.search(q_np[:64], p2, batch=64)
        ix.engine, ix.scan_layout, ix.scan_topk = "auto", "auto", "auto"
        assert_same(d_t, l_t, d0[:64], l0[:64], f"assign_ab {v} fused vs "
                    "torch engine")
        res[v] = us
    return on_twin


def run_evidence(device, pl: PhaseLaunches, kernels: list,
                 caches: dict | None = None, s2: dict | None = None,
                 e: dict = EVIDENCE, S: dict | None = None,
                 S21: dict | None = None) -> dict:
    """Phase 22 ([evidence] lines): the port's evidence tools in process.
    22a tools/assign_ab.py (:func:`evidence_twin` on each twin) on the
    grouping_scale centroids of ``caches["20"]`` (phase 20's bench cache;
    the centroids alone are trained when it is absent); 22b
    tools/coarse_ab.py on the scale3sl index of ``caches["21"]`` (phase
    21's cut; built when absent), then the bench's ``evidence_fields`` of
    that cache with 22a's assign_ab.json beside it; 22c
    tools/routed_tune.py --quick on ``s2``'s scale2 index (phase 17's;
    built by the bench tool when None) at B = e["tune_b"], and the routed
    gate's result overlap at e["result_ws"] and w = n_super; 22d
    tools/siftlike_scale_calibrate.py's probe at the cut e["calib_nb"] /
    e["calib_nc"], at the tool's 128-byte codes and at 16 bytes. ``S`` /
    ``S21``: the bench sizes of phases 20 / 21 (default the tool's, and
    those with phase 21's cut). Returns the records."""
    import tempfile

    import torch
    from ivfhnsw_tpu_torch.models.ivfadc import resolve_layout
    from ivfhnsw_tpu_torch.tools import (assign_ab, bench, coarse_ab,
                                         routed_tune)
    from ivfhnsw_tpu_torch.tools import siftlike_scale_calibrate as ssc
    from ivfhnsw_tpu_torch.utils.siftlike import SiftLikeDeviceGen
    S = S or bench.sizes(False)
    S21 = S21 or {**S, **BENCH21}
    rec = {}
    with tempfile.TemporaryDirectory(prefix="evidence_") as tmp:
        caches = {"20": os.path.join(tmp, "20"), "21": os.path.join(tmp, "21"),
                  **(caches or {})}

        # 22a. assign_ab
        gs = os.path.join(caches["20"], "grouping_scale")
        os.makedirs(gs, exist_ok=True)
        p_cent = os.path.join(gs, "centroids.npy")
        if not os.path.exists(p_cent):
            sg = SiftLikeDeviceGen(device, n_classes=S["S3SL_NCLS"],
                                   sigma=S["S3SL_SIGMA"], seed=13,
                                   skew=S["S3SL_SKEW"])
            bench.grouping_scale_centroids(
                S, sg, torch.Generator(device=device).manual_seed(0), p_cent)
            sg.release()
        mem_reset(device)
        t = time.perf_counter()
        us = {}
        ab = assign_ab.run(device, S, caches["20"], e["ab_nb"],
                           on_twin=evidence_twin(pl, kernels, e["ab_nb"], us))
        ab_s = time.perf_counter() - t
        print(f"[evidence] assign_ab ({e['ab_nb']} SIFT-like rows at nc "
              f"{ab['nc']}, grouping_scale's centroids; nprobe "
              f"{ab['nprobe']}, max_codes {ab['max_codes']}, k 100) in "
              f"{ab_s:.2f} s, device peak {peak_gib(device)} GiB: "
              + json.dumps({v: {k: x for k, x in r.items()
                                if k != "drift_series"}
                            for v, r in ab["variants"].items()}), flush=True)
        for v, r in ab["variants"].items():
            print(f"[evidence] assign_ab {v}: R@1/10/100 "
                  f"{r['recall_at_1']:.4f} / {r['recall_at_10']:.4f} / "
                  f"{r['recall_at_100']:.4f}; match rate "
                  f"{r.get('mean_match_rate', 1.0):.4f} (min "
                  f"{r.get('drift_min_match_rate', 1.0):.4f}); lists max "
                  f"{r['list_size_max']} p99 {r['list_size_p99']} empty "
                  f"{r['empty_lists']}; assign {r['assign_seconds']:.2f} s; "
                  f"us/query at batch 256 " + json.dumps(
                      {c: round(x, 3) for c, x in us[v].items()})
                  + "; equal across widths and top-k, 64 queries equal to "
                  "engine torch", flush=True)
        rec["assign_ab"] = ab

        # 22b. coarse_ab, then the scale3sl record's evidence fields
        gran = 1024 if resolve_layout("auto", S21["S3SL_NB"],
                                      S21["S3SL_NC"]) == "quad" else 256
        t = time.perf_counter()
        cab = pl.counted("22", gran, ["adc_scan_slots"],
                         lambda: coarse_ab.run(device, S21, caches["21"]),
                         "coarse_ab")
        print(f"[evidence] coarse_ab on scale3sl (reduced: nc "
              f"{S21['S3SL_NC']} over {S21['S3SL_NB']} rows where the stage "
              f"runs nc {S['S3SL_NC']} over {S['S3SL_NB']}) in "
              f"{time.perf_counter() - t:.2f} s: " + json.dumps(cab),
              flush=True)
        shutil.copy(os.path.join(caches["20"], "assign_ab.json"),
                    caches["21"])
        meta = bench._load(os.path.join(caches["21"], "scale3sl",
                                        "build_meta.json"))
        ev = bench.evidence_fields(caches["21"], bench._drift_min(meta))
        want = {"scale3sl_coarse_ab", "scale3sl_assign_ab"} | (
            {"scale3sl_drift_source"} if bench._drift_min(meta) is None
            else set())
        if not want <= set(ev):
            raise AssertionError(f"scale3sl evidence fields {sorted(ev)}, "
                                 f"want {sorted(want)}")
        print(f"[evidence] scale3sl record fields from the cache: "
              f"{sorted(ev)}; drift {ev.get('scale3sl_drift_min_match_rate')}"
              f" ({ev.get('scale3sl_drift_source', 'the build')})",
              flush=True)
        rec["coarse_ab"] = cab

        # 22c. routed_tune --quick on scale2, then the result overlap
        t = time.perf_counter()
        if s2 is None:
            idx, q_np, _, _ = bench.build_scale2(S, device,
                                                 os.path.join(tmp, "s2"))
            idx.enable_routed_coarse(generator=torch.Generator(
                device=device).manual_seed(routed_tune.SEED))
        else:
            idx, q_np = s2["index"], s2["queries"]
        P, B = S["S2_NPROBE"], e["tune_b"]
        q = torch.tensor(q_np[:B], device=device)
        tune = routed_tune.sweep(
            idx, q, P, routed_tune.CONFIGS[:routed_tune.QUICK],
            out=lambda m: print("[evidence] routed_tune " + m, flush=True))
        del q
        idx.scan_layout, idx.scan_topk = "quad", "wide"
        ro = pl.counted("22", 1024, ["adc_scan_slots"],
                        lambda: routed_tune.result_overlaps(
                            idx, q_np, P, S["S2_MC"], e["result_ws"],
                            out=lambda m: print("[evidence] scale2 " + m,
                                                flush=True)),
                        "routed result overlap")
        idx.scan_layout, idx.scan_topk = "auto", "auto"
        idx.release_device()
        del idx
        print(f"[evidence] routed_tune --quick (scale2, nc {S['S2_NC']}, "
              f"{S['S2_NB']} rows, B {B}, nprobe {P}) and the result "
              f"overlap in {time.perf_counter() - t:.2f} s", flush=True)
        rec["routed_tune"], rec["result_overlap"] = tune, ro
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # 22d. siftlike_scale_calibrate at a cut, 128-byte and 16-byte codes
    sigma, ncls, skew = e["calib_spec"]
    t = time.perf_counter()
    ceil = {cs: ssc.probe(sigma, ncls, skew, device, nb=e["calib_nb"],
                          nc=e["calib_nc"], code_size=cs,
                          log=lambda m: print("[evidence] calibrate" + m,
                                              flush=True))
            for cs in (ssc.CODE_SIZE, 16)}
    print(f"[evidence] siftlike_scale_calibrate sigma={sigma} n_classes="
          f"{ncls} skew={skew} (reduced: nb {e['calib_nb']} over nc "
          f"{e['calib_nc']} where the tool runs {ssc.NB} over {ssc.NC}, the "
          f"same {e['calib_nb'] // e['calib_nc']} codes a list) in "
          f"{time.perf_counter() - t:.2f} s: ceiling@1/@10 at code_size "
          f"{ssc.CODE_SIZE} (pq_m {ssc.CODE_SIZE}, the tool's) "
          f"{ceil[ssc.CODE_SIZE][1]:.4f} / {ceil[ssc.CODE_SIZE][10]:.4f}, at "
          f"code_size 16 (the bench stages') {ceil[16][1]:.4f} / "
          f"{ceil[16][10]:.4f}", flush=True)
    rec["calibrate"] = ceil
    return rec


# Phase 23: the bench tool's run control and its three helpers, on phase
# 21's cut cache (scale3sl / scale4 at nc=2^17 over 2^24 / 2^25 rows).
def _tree(root: str) -> dict:
    """{path relative to root: (size, mtime_ns)} of every file under it."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            st = os.stat(os.path.join(d, f))
            out[os.path.relpath(os.path.join(d, f), root)] = (st.st_size,
                                                              st.st_mtime_ns)
    return out


def _bench_env(cache: str) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("BENCH_SMOKE", "BENCH_BUDGET_S", "BENCH_STAGES")}
    return dict(env, BENCH_CACHE_DIR=cache)


def bench_main_quiet(cache: str, argv: list) -> dict:
    """tools/bench.py's main in process with BENCH_CACHE_DIR=``cache``, its
    JSON lines kept off this command's stdout."""
    import contextlib
    import io
    from ivfhnsw_tpu_torch.tools import bench
    saved = dict(os.environ)
    os.environ.clear()
    os.environ.update(_bench_env(cache))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return bench.main(argv)
    finally:
        os.environ.clear()
        os.environ.update(saved)


def run_bench23(device, pl: PhaseLaunches, kernels: list,
                cut: dict = BENCH21, cache: str | None = None) -> dict:
    """Phase 23 ([bench23] lines): 23a tools/warm_cache.py's warm() of
    scale3sl and scale4 on the cut cache ``cache`` (phase 21's; built here
    first when None) with their ceiling files removed: both builds found,
    only the two ceilings written, equal to the ones removed; 23b
    tools/scale4_eval.py's run() on it as the phase's main path (K1 or K2
    required to launch), its eval.json against the bench stage's fields
    run just after (equal but for the measured times), K1 and K3
    torch.equal to plain on scale4's schedule (records "s4eval"); 23c a
    bench subprocess at the BENCH_SMOKE sizes sent SIGTERM on the first
    line of its second stage's build, read from its stderr pipe (rc 143,
    its one more stdout line = last_result.json, terminated_by_signal in
    deep); 23d bench runs at the BENCH_SMOKE sizes in a temporary cache:
    scale2 warmed, then a budget of its warm seconds and 20 (below every
    cold stage's estimate: only the warm stages run), then budget 0 (every stage skipped), each skipped stage with its
    marker and no field; 23e tools/render_results.py on 23c and 23d's
    records into a copy of README.md, every measured row carrying this
    card's line."""
    import tempfile

    import torch
    from ivfhnsw_tpu_torch.models.ivfadc import resolve_layout
    from ivfhnsw_tpu_torch.tools import (bench, render_results, scale4_eval,
                                         warm_cache)
    from ivfhnsw_tpu_torch.utils.config import SearchParams
    S = {**bench.sizes(False), **cut}
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory(prefix="bench23_") as tmp:
        cache = cache or os.path.join(tmp, "21")
        names = ("scale3sl", "scale4")
        if not bench._all_present(cache, bench.NEED["scale4"].probe[:1]):
            t = time.perf_counter()
            for n in names:
                warm_cache.warm(n, S, device, cache)
            print(f"[bench23] built the cut scale3sl / scale4 cache in "
                  f"{time.perf_counter() - t:.2f} s", flush=True)

        # 23a. warm_cache on the built cache: only the ceilings written
        ceil = {n: os.path.join(cache, n, "ceiling.json") for n in names}
        before = {n: bench._load(p) for n, p in ceil.items()}
        for p in ceil.values():
            os.remove(p)
        tree = _tree(cache)
        t = time.perf_counter()
        warmed = [warm_cache.warm(n, S, device, cache) for n in names]
        changed = sorted(p for p, v in _tree(cache).items()
                         if tree.get(p) != v)
        if ([(w["build"], w["ceiling"]) for w in warmed]
                != [("cached", "computed")] * 2
                or changed != sorted(os.path.relpath(p, cache)
                                     for p in ceil.values())):
            raise AssertionError(f"warm_cache: {warmed}, changed {changed}")
        after = {n: bench._load(p) for n, p in ceil.items()}
        if after != before:
            raise AssertionError(f"warm_cache's ceilings {after} differ "
                                 f"from the stages' {before}")
        print(f"[bench23] warm_cache scale3sl,scale4 in "
              f"{time.perf_counter() - t:.2f} s: both builds found, only "
              f"{changed} written, equal to the stages' ceilings "
              + json.dumps(after), flush=True)

        # 23b. scale4_eval, the phase's main path, then the stage itself
        gran = (1024 if resolve_layout("auto", S["S4_NB"], S["S3SL_NC"])
                == "quad" else 256)
        mem_reset(device)
        t = time.perf_counter()
        ev = pl.counted("23", gran, ["adc_scan_slots"],
                        lambda: scale4_eval.run(S, device, cache),
                        "scale4_eval")
        ev_s = time.perf_counter() - t
        if bench._load(os.path.join(cache, "scale4", "eval.json")) != ev:
            raise AssertionError("scale4_eval: eval.json is not its record")
        rec = bench.run_stage("scale4", S, device, cache)
        same = sorted(set(rec) - set(scale4_eval.TIMED))
        diff = [k for k in same if ev.get(k) != rec[k]]
        extra = set(ev) - set(rec) - {"load_seconds", "timed_seconds",
                                      "device", "recorded_at"}
        if diff or extra:
            raise AssertionError(f"scale4_eval against the stage: differ "
                                 f"{diff}, extra {sorted(extra)}")
        print(f"[bench23] scale4_eval (reduced: nc {S['S3SL_NC']} over "
              f"{S['S4_NB']} rows) in {ev_s:.2f} s (load "
              f"{ev['load_seconds']:.2f}): R@1/10 "
              f"{ev['scale4_recall_at_1']:.4f} / "
              f"{ev['scale4_recall_at_10']:.4f} (ceiling "
              f"{ev['scale4_ceiling_at_1']:.4f} / "
              f"{ev['scale4_ceiling_at_10']:.4f}), "
              f"{ev['scale4_us_per_query']:.3f} us/query sustained, device "
              f"{ev['scale4_hbm_in_use_gb']} of {ev['scale4_hbm_limit_gb']} "
              f"GiB; the stage's "
              f"{len(same)} untimed fields equal, its "
              f"{rec['scale4_us_per_query']:.3f} us/query", flush=True)
        idx, q_np, _, _ = bench.build_scale4(S, device, cache)
        prm, _ = bench.profiled(idx, q_np, SearchParams(
            k=S["K"], nprobe=S["S3_NPROBE"], max_codes=S["S3_MC"]))
        q = torch.tensor(q_np, device=device)
        check_scan_kernels((*idx.scan_inputs(q, prm, idx.scan_gran()),
                            idx.scan_gran()), kernels, "s4eval",
                           "[bench23]", "scale4_eval's schedule",
                           {"nb": S["S4_NB"]})
        idx.release_device()
        del idx, q
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out["scale4_eval"] = ev

        # 23c. SIGTERM at the first line of the second stage's build: the
        # child's stderr is read as it is written, so the signal follows
        # the line at once and lands with all of deep's build still to run
        c_cache = os.path.join(tmp, "c")
        t = time.perf_counter()
        p = subprocess.Popen(
            [sys.executable, "-m", "ivfhnsw_tpu_torch.tools.bench",
             "--device", str(device), "--smoke", "--stages",
             "primary,deep,grouping_scale"], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=root,
            env=_bench_env(c_cache))
        watchdog = threading.Timer(600, p.kill)
        watchdog.start()
        try:
            err = []
            for line in p.stderr:
                err.append(line)
                if line.startswith("deep: "):
                    p.send_signal(15)
                    break
            out_c, err_c = p.communicate()
            rc = p.returncode
        finally:
            watchdog.cancel()
            p.kill()
        lines = out_c.strip().splitlines()
        first = json.loads(lines[0]) if lines else {}
        last = json.loads(lines[-1]) if len(lines) > 1 else {}
        p_last = os.path.join(c_cache, "bench_smoke", "last_result.json")
        if (rc != 143 or first.get("stages_done") != ["primary"]
                or last.get("terminated_by_signal") != 15
                or last.get("terminated_in_stage") != "deep"
                or last["stages_done"] != ["primary"]
                or bench._load(p_last) != last):
            raise AssertionError(f"bench under SIGTERM: rc {rc}, {len(lines)}"
                                 f" lines, last line {json.dumps(last)[:500]}"
                                 f"; its stderr ends "
                                 f"{''.join(err)[-800:]}{err_c[-800:]}")
        print(f"[bench23] bench --smoke --stages primary,deep,grouping_scale"
              f" sent SIGTERM on deep's first build line: rc {rc}, last "
              f"line parses, terminated_by_signal 15 in stage "
              f"{last['terminated_in_stage']}, equal to last_result.json "
              f"({time.perf_counter() - t:.2f} s)", flush=True)

        # 23d. a budget that admits only the warm stages, then budget 0
        d_cache = os.path.join(tmp, "d")
        dev = ["--device", str(device), "--smoke"]
        bench_main_quiet(d_cache, dev + ["--stages", "scale2"])
        budget = bench.NEED["scale2"].warm + 20.0   # < every cold stage
        warm = bench_main_quiet(d_cache, dev + ["--budget-s", str(budget)])
        zero = bench_main_quiet(d_cache, dev + ["--budget-s", "0"])
        for r, ran in ((warm, ["search_1b", "scale2", "build_1b"]),
                       (zero, [])):
            skipped = [m["stage"] for m in r["skipped_stages"]]
            fields = {k for s in r["stages_done"]
                      for k in r["stage_keys"][s]}
            done = r["stages_done"]
            if (done[:2] != ran[:2] or not set(done) <= set(ran)
                    or sorted(skipped + done) != sorted(bench.STAGES)
                    or any(m["reason"] != "wall-clock budget"
                           for m in r["skipped_stages"])
                    or set(r) - set(zero) != fields):
                raise AssertionError(f"budget {r['budget_seconds']}: ran "
                                     f"{r['stages_done']}, skipped "
                                     f"{skipped}")
        print(f"[bench23] budget {budget:.1f} s on a cache with scale2 "
              f"warm: ran {warm['stages_done']}, skipped "
              f"{len(warm['skipped_stages'])} stages with their markers "
              f"(primary's warm reserve "
              f"{warm['skipped_stages'][0].get('warm_reserve_seconds')} s);"
              f" budget 0: all {len(zero['skipped_stages'])} skipped; no "
              f"field of a skipped stage; launch round trip "
              f"{warm['launch_roundtrip_ms']} ms", flush=True)

        # 23e. render_results on those records into a copy of README.md
        readme = os.path.join(tmp, "README.md")
        shutil.copy(os.path.join(root, "README.md"), readme)
        recs = [p_last, os.path.join(tmp, "d_warm.json")]
        bench._dump(recs[1], warm)      # 23d's last_result.json is zero's
        if render_results.main(["--snapshot", *recs, "--readme", readme,
                                "--results",
                                os.path.join(tmp, "snap.json")]) != 0:
            raise AssertionError("render_results failed")
        with open(readme) as f:
            table = f.read().split(render_results.START)[1].split(
                render_results.END)[0]
        rows = {ln.split(" | ")[0][2:]: ln for ln in table.splitlines()
                if ln.startswith("| ") and not ln.startswith("| stage")}
        card = bench.device_line(device)
        measured = {"primary", *warm["stages_done"]}
        bad = [s for s, ln in rows.items()
               if (card in ln) != (s in measured)
               or ("| not measured |" in ln) == (s in measured)]
        if set(rows) != set(bench.STAGES) or bad:
            raise AssertionError(f"render_results rows {bad}")
        print(f"[bench23] render_results: {len(measured)} rows carry "
              f"'{card}', {len(rows) - len(measured)} read not measured",
              flush=True)
    return out


# Phase 24: exact assignment's kernel at the main path's block, [4096 rows,
# 16384 centroids] (IVFADCIndex._assign_exact_t at nc >= 16384), on the
# scale3sl / scale4 corpus law at nc=2^20; then tools/assign_probe.py there.
ASSIGN24 = dict(nc=1 << 20, rows=1 << 21, variant_rows=1 << 19,
                batch=4096, block=16384)
ASSIGN_REPLACES = ("none: XLA's fusion in ivfhnsw_tpu/ops/distances.py:"
                   "115-136 (streaming_topk_l2 at k=1, assign_top1 :147)")


def assign_both(ip, qsq, psq, best, off: int, what: str):
    """top1_update (the kernel on the card) and top1_update_plain on the
    same inputs from copies of ``best``; raises unless torch.equal, both
    distances and ids. Returns the kernel's (best_d, best_i)."""
    import torch
    from ivfhnsw_tpu_torch.ops.cuda import assign_min as am
    k = (best[0].clone(), best[1].clone())
    p = (best[0].clone(), best[1].clone())
    am.top1_update(ip, qsq, psq, *k, off)
    am.top1_update_plain(ip, qsq, psq, *p, off)
    if ip.device.type == "cuda":
        torch.cuda.synchronize()
    if not (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])):
        bad = int(((k[0] != p[0]) | (k[1] != p[1])).sum())
        raise AssertionError(f"assign_min {what}: {bad} rows differ from "
                             "the plain version")
    return k


def run_assign_min(device, pl: PhaseLaunches, kernels: list,
                   a: dict = ASSIGN24) -> dict:
    """Phase 24 ([assign] lines): the assign_min kernel torch.equal to its
    plain version on three cases (a main-path block of SIFT-like rows
    against nc=2^20 centroids, two blocks carried; a ragged sweep; ties),
    its time per block against its bound and the plain version's, then
    tools/assign_probe.py at ``a``'s sizes as the phase's main path; adds
    the kernel's record to ``kernels``, its launches those of every main
    path filed so far in ``pl``. Returns the probe's record."""
    import torch
    from ivfhnsw_tpu_torch.ops.cuda import assign_min as am
    from ivfhnsw_tpu_torch.tools import assign_probe, bench
    from ivfhnsw_tpu_torch.utils.roofline import bound
    from ivfhnsw_tpu_torch.utils.siftlike import SiftLikeDeviceGen
    S = bench.FULL
    B, C, nc = a["batch"], a["block"], a["nc"]
    sg = SiftLikeDeviceGen(device, n_classes=S["S3SL_NCLS"],
                           sigma=S["S3SL_SIGMA"], seed=7,
                           skew=S["S3SL_SKEW"])
    cents = sg.batch_device(11, nc)
    x = sg.batch_device(12, B + 1)
    sg.release()
    psq, xsq = (cents * cents).sum(-1), (x * x).sum(-1)

    # 1. the main path's block, the first from +inf, the second carried
    best = (torch.full((B,), float("inf"), device=device),
            torch.zeros(B, dtype=torch.int64, device=device))
    for s in (0, C):
        ip = x[:B] @ cents[s:s + C].T
        prev = best
        best = assign_both(ip, xsq[:B], psq[s:s + C], best, s,
                           f"[{B}, {C}] block at {s}")
    moved = int((best[1] != prev[1]).sum())
    args = (ip, xsq[:B], psq[C:2 * C])
    scratch = (prev[0].clone(), prev[1].clone())
    ms = device_ms(lambda: am.top1_update(*args, *scratch, C))
    plain_ms = device_ms(lambda: am.top1_update_plain(*args, *scratch, C))
    rec = {"name": "assign_min", "route": "cuda", "source": ASSIGN_SOURCE,
           "replaces": None, "replaces_note": ASSIGN_REPLACES,
           "launches": 0, "max_abs_err": 0.0, "ms": ms,
           "plain_ms": plain_ms,
           **bound(B * C * 4 + B * 4 + C * 4 + 2 * B * 12, 3 * B * C),
           "library_ms": None}
    print(f"[assign] kernel torch.equal to plain on a [{B}, {C}] block of "
          f"SIFT-like rows against nc={nc} centroids, two blocks carried "
          f"({moved} rows moved by the second): kernel {ms:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
          f"{rec['bound_ms'] / ms:.0%}), plain {plain_ms:.4f} ms; "
          f"{smi_line()}", flush=True)
    del ip, args, scratch

    # 2. a ragged sweep: B + 1 rows, 2 blocks and 77 centroids
    n = 2 * C + 77
    pts = cents[:n]
    d_k, i_k = torch_sweep(x, pts, C)
    best = (torch.full((B + 1,), float("inf"), device=device),
            torch.zeros(B + 1, dtype=torch.int64, device=device))
    for s in range(0, n, C):
        best = assign_both(x @ pts[s:s + C].T, xsq, psq[s:min(s + C, n)],
                           best, s, f"ragged sweep at {s}")
    if not (torch.equal(d_k, best[0]) and torch.equal(i_k, best[1])):
        raise AssertionError("streaming_topk_l2 differs from the kernel "
                             "carried by hand")
    # 3. duplicated centroids, within a block and across a block edge
    dup = cents[:3 * C].clone()
    pairs = ((5, 20), (5, C + 9), (C - 1, 2 * C + 3), (700, 701))
    for i, j in pairs:
        dup[j] = dup[i]
    q = dup[[j for _, j in pairs]]
    d_t, i_t = torch_sweep(q, dup, C)
    best = (torch.full((len(pairs),), float("inf"), device=device),
            torch.zeros(len(pairs), dtype=torch.int64, device=device))
    qs, ds = (q * q).sum(-1), (dup * dup).sum(-1)
    for s in range(0, 3 * C, C):
        best = assign_both(q @ dup[s:s + C].T, qs, ds[s:s + C], best, s,
                           f"ties at {s}")
    # the first centroid equal to each query (the pair's first, unless the
    # corpus drew an earlier copy itself)
    want = [int((dup == dup[j]).all(1).nonzero()[0]) for _, j in pairs]
    if i_t.tolist() != want or best[1].tolist() != want:
        raise AssertionError(f"ties: ids {i_t.tolist()}, expected {want}")
    print(f"[assign] kernel torch.equal to plain over a ragged sweep (B "
          f"{B + 1}, {n} centroids: a {n - 2 * C}-column last block) and on "
          f"duplicated centroids {list(pairs)} (ids {want}: the first "
          f"index wins, within a block and across block edges)", flush=True)
    del cents, x, dup, q, pts
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the probe, the phase's main path
    dev = "cpu" if device.type == "cpu" else str(device)
    variants = ",".join(f"{B}:{C}:{r}" for r in ("kernel", "passes", "gemm"))
    pr = pl.assign("24", lambda: assign_probe.main(
        ["-nc", str(nc), "-rows", str(a["rows"]), "-variant_rows",
         str(a["variant_rows"]), "-variants", variants, "-device", dev]),
        "assign_probe")
    v = {r["reduce"]: r for r in pr["variants"]}
    off_tie = {k: r["labels_moved_off_tie"] for k, r in v.items()
               if r["labels_moved_off_tie"]}
    if off_tie or v["kernel"]["labels_equal"] != 1.0:
        raise AssertionError(f"assign_probe: ids moved off exact ties "
                             f"{off_tie}, kernel labels_equal "
                             f"{v['kernel']['labels_equal']}")
    print(f"[assign] tools/assign_probe.py at nc={nc}: s per 1M rows, "
          f"production (kernel) {pr['production_seconds_per_1m_rows']:.3f} "
          f"over {a['rows']} rows; over {a['variant_rows']} rows kernel "
          f"{v['kernel']['seconds_per_1m_rows']:.3f}, four passes "
          f"{v['passes']['seconds_per_1m_rows']:.3f}, GEMMs alone "
          f"{v['gemm']['seconds_per_1m_rows']:.3f}; ids equal "
          f"(passes: {v['passes']['labels_equal']} equal, the rest at "
          f"exact ties); projected exact assignment s "
          + json.dumps({k: round(t, 1) for k, t in
                        pr["projected_exact_assign_seconds"].items()})
          + f"; {pr['device']}", flush=True)
    by = pl.by_kernel.get("assign_min", {})
    rec["launches_by_phase"] = dict(by)
    rec["launches"] = sum(by.values())
    kernels.append(rec)
    return pr


def run_scale4_kernels(device, cache: str | None = None) -> list:
    """``--only s4full``: K1-K4 each torch.equal to its plain version and
    timed, bound beside them, on the schedule of the full-size scale4 build
    in the bench tool's cache (``tools/bench.py``'s, unless ``cache``),
    under the stage's profiled budget at nprobe 128 / max_codes 100k, at
    both slot widths ([s4full] lines). Run it after ``python -m
    ivfhnsw_tpu_torch.tools.bench --stages scale3sl,scale4`` in the same
    chip call: the cache does not outlive a call. Returns the records."""
    import torch
    from ivfhnsw_tpu_torch.tools import bench
    from ivfhnsw_tpu_torch.utils.config import SearchParams
    S = bench.sizes(False)
    cache = cache or bench.cache_root(False)
    if not bench._all_present(cache, bench.NEED["scale4"].probe[:1]):
        raise SystemExit(f"s4full: no scale4 build in {cache}")
    idx, q_np, _, _ = bench.build_scale4(S, device, cache)
    recs = [{"name": f"adc_scan_slots{m}_gran{g}"} for g in (256, 1024)
            for m in ("", "_min")]
    q = torch.tensor(q_np, device=device)
    nb = idx._ensure_store().ntotal
    for layout in ("chunk", "quad"):
        idx.scan_layout = layout
        prm, _ = bench.profiled(idx, q_np, SearchParams(
            k=S["K"], nprobe=S["S3_NPROBE"], max_codes=S["S3_MC"]))
        gran = idx.scan_gran()
        check_scan_kernels((*idx.scan_inputs(q, prm, gran), gran), recs,
                           "s4full", "[s4full]", f"scale4's schedule ({nb} "
                           f"rows, nc {idx.nc})", {"nb": nb})
    print(f"[s4full] {smi_line()}", flush=True)
    idx.release_device()
    return recs


# ---------------------------------------------------------------------------
# Phase 25: SURVEY.md §4's search properties on the primary index
# ---------------------------------------------------------------------------

# The sweeps of tests/test_properties.py carried to the primary point: k=100,
# nprobe over 8 / 32 / 128 / 512 (max_codes 0), max_codes over 2k / 10k /
# 50k / unlimited at nprobe 128 (its lists average 488 codes, so every
# budget but the last binds), k=400 at nprobe 1; searched in batches of
# 1024 (a wide output at nprobe 512 is 4 MB a query).
PROPS = dict(k=100, nprobes=(8, 32, 128, 512), mc_nprobe=128,
             max_codes=(2000, 10000, 50000, 0), pad_k=400, batch=1024)
PROP_COMBOS = [(layout, topk) for layout in ("chunk", "quad")
               for topk in ("wide", "twophase")]


def primary_index(device):
    """``--only 25``: the primary index and its dataset, built by the
    IVFADC driver on the synthetic corpus as phase 4 builds it from files."""
    from ivfhnsw_tpu_torch.drivers import ivfadc_eval
    p = PRIMARY
    argv = ["-synthetic", "0", "-device", str(device)]
    for f in ("d", "nc", "code_size", "nb", "nt", "nq", "k", "nprobe",
              "max_codes"):
        argv += [f"-{f}", str(p[f])]
    r = ivfadc_eval.main(argv)
    return r["index"], r["dataset"]


def run_props(device, index, ds, pl: PhaseLaunches, s: dict = PROPS) -> None:
    """Phase 25 ([props] lines): SURVEY.md §4's five properties on the
    primary index through search_device with engine "fused", at each slot
    width x top-k (K1/K2 wide, K3/K4 two-phase), each combination one main
    path whose kernel must launch (filed under "25"): R@100 monotone in
    nprobe and in max_codes within 1e-9; every sweep point searched twice
    and torch.equal; distances sorted; k=400 at nprobe 1 padded with +inf
    and -1 exactly past the probed list's size. Every combination's results
    equal the first's under the cross-engine contract. Raises on any
    failure."""
    import torch
    from ivfhnsw_tpu_torch.utils.config import SearchParams
    from ivfhnsw_tpu_torch.utils.recall import recall_at_k
    q = torch.tensor(ds.queries, device=device)
    gt = ds.gt
    sizes = np.diff(index.store.list_offsets)
    probe1 = index.assign(ds.queries)
    points = ([SearchParams(k=s["k"], nprobe=n, max_codes=0)
               for n in s["nprobes"]]
              + [SearchParams(k=s["k"], nprobe=s["mc_nprobe"], max_codes=m)
                 for m in s["max_codes"]])
    pad = SearchParams(k=s["pad_k"], nprobe=1, max_codes=0)
    index.engine = "fused"
    first = None
    for layout, topk in PROP_COMBOS:
        index.scan_layout, index.scan_topk = layout, topk
        what = f"[props] {layout} {topk}"
        need = ["adc_scan_slots_min" if topk == "twophase"
                else "adc_scan_slots"]

        def sweep():
            res = []
            for p in points + [pad]:
                d1, l1 = index.search_device(q, p, batch=s["batch"])
                d2, l2 = index.search_device(q, p, batch=s["batch"])
                if not (torch.equal(d1, d2) and torch.equal(l1, l2)):
                    raise AssertionError(f"{what}: two calls differ at {p}")
                res.append((d1.cpu().numpy(), l1.cpu().numpy()))
            return res
        res = pl.counted("25", index.scan_gran(), need, sweep, what)
        n = len(s["nprobes"])
        rs = [recall_at_k(l, gt, ks=(100,))[100] for _, l in res[:-1]]
        for name, r in (("nprobe", rs[:n]), ("max_codes", rs[n:])):
            if not all(b >= a - 1e-9 for a, b in zip(r, r[1:])):
                raise AssertionError(f"{what}: R@100 not monotone in "
                                     f"{name}: {r}")
        for d, _ in res[:-1]:
            if not np.isfinite(d).all() or (np.diff(d, axis=1) < -1e-6).any():
                raise AssertionError(f"{what}: distances not finite and "
                                     "sorted")
        d, l = res[-1]
        short = ~np.isfinite(d)
        filled = (~short).sum(1)
        if (d.shape != (ds.nq, s["pad_k"]) or not short.any()
                or (l[short] != -1).any() or (l[~short] < 0).any()
                or not np.array_equal(filled,
                                      np.minimum(sizes[probe1], s["pad_k"]))
                or (np.diff(short.astype(np.int8), axis=1) < 0).any()):
            raise AssertionError(f"{what}: k={s['pad_k']} at nprobe 1 not "
                                 "padded with +inf and -1 past the list")
        if first is None:
            first = res
        else:
            for (d1, l1), (d2, l2), p in zip(first, res, points + [pad]):
                fin = np.isfinite(d1)
                if not np.array_equal(fin, np.isfinite(d2)):
                    raise AssertionError(f"{what}: +inf places differ from "
                                         f"{PROP_COMBOS[0]} at {p}")
                assert_same(np.where(fin, d1, 0), l1, np.where(fin, d2, 0),
                            l2, f"{what} vs {PROP_COMBOS[0]} at {p}")
        print(f"{what}: R@100 over nprobe {list(s['nprobes'])} {rs[:n]}, "
              f"over max_codes {list(s['max_codes'])} at nprobe "
              f"{s['mc_nprobe']} {rs[n:]}: monotone; {len(points) + 1} "
              f"points searched twice, torch.equal; distances sorted; "
              f"k={s['pad_k']} at nprobe 1: {int(short.any(1).sum())} of "
              f"{ds.nq} queries padded, {int(short.sum())} places +inf / -1"
              + ("" if first is res else f"; equal to {PROP_COMBOS[0]} "
                 "under the contract"), flush=True)
    print(f"[props] launches {json.dumps(pl.by_kernel)}; {smi_line()}",
          flush=True)
    index.scan_layout, index.scan_topk = "auto", "auto"


def torch_sweep(q, points, block: int):
    """streaming_topk_l2's top-1 of ``q`` over ``points`` (the production
    sweep: the kernel on the card) as ([B], [B]) tensors."""
    from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
    d, i = streaming_topk_l2(q, points, 1, block=block)
    return d[:, 0], i[:, 0]


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
