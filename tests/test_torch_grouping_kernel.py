"""The grouping scan wrapper of the PyTorch port (ivfhnsw_tpu_torch.ops.
cuda.grouping_scan.grouping_scan_slots), its lab variants
(ops.cuda.grouping_lab), its bound (utils.roofline.grouping_scan_bound),
the kernel build's hash (ops.cuda.build) and the deterministic segment sum
(ivfhnsw_tpu_torch.ops.segment.segment_sum): the plain versions on the CPU
against numpy formulas, and on a card the CUDA kernel and every lab variant
against the plain version (torch.equal, on slots of length 1, 3, gran - 1,
runs of empty slots, an output whose rows are not 16-byte aligned, and a
batch pruned whole), the kernel's bin-32 minima against an amin over its
output (torch.equal; helpers in tests/test_torch_wide_kernel.py), the fused
grouping engine against the torch engine, and k-means run twice from one
seed.

This file imports no jax, so it also runs on a machine with a GPU and no
jax; tests/conftest.py imports jax, so run it there with
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_grouping_kernel.py
Tests marked ``cuda`` skip where torch.cuda.is_available() is false.

Tolerances: the plain scan against the float64 numpy formula rtol 1e-6,
atol 1e-5 (float32 rounding of ~20 terms of magnitude ~3); the kernel
against the plain version an identical +inf pattern and finite lanes within
rtol=1e-4, atol=1e-3 (both sum in one order, so they normally agree
exactly); the fused engine against the torch engine rtol=1e-4, atol=1e-3
with labels differing only at equal distances; segment sums against a
float64 ``np.add.at`` within 1e-5 relative (of the sum of magnitudes), and
bit-equal to a sequential float32 sum in input order on the CPU; k-means
centroids of two runs on the card ``torch.equal``.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from ivfhnsw_tpu_torch import IndexConfig, IVFADCGroupingIndex, SearchParams
from ivfhnsw_tpu_torch.ops.cuda import build as kbuild
from ivfhnsw_tpu_torch.ops.cuda import grouping_lab as gl
from ivfhnsw_tpu_torch.ops.cuda import grouping_scan as tg
from ivfhnsw_tpu_torch.ops.segment import segment_sum
from ivfhnsw_tpu_torch.utils.roofline import grouping_scan_bound
from test_torch_wide_kernel import CELL_SCANS, _bin_args, _check_bins

RTOL, ATOL = 1e-4, 1e-3


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _args(device="cpu", M=8, gran=256, P=3, nsubc=4):
    """3 queries x 5 slots: empty, one code, half full, full, and a full
    slot of a probe whose subgroups 0 and 2 are pruned (+inf term2)."""
    rng = np.random.RandomState(2)
    B, S, N = 3, 5, 3000
    lut = rng.randn(B, M, 256).astype(np.float32)
    ntab = rng.rand(256).astype(np.float32)
    t2 = rng.randn(B, P, nsubc).astype(np.float32)
    t2[:, 2, [0, 2]] = np.inf
    codes = rng.randint(0, 256, (N, M)).astype(np.uint8)
    ncodes = rng.randint(0, 256, N).astype(np.uint8)
    subc = rng.randint(0, nsubc, N).astype(np.uint8)
    start = rng.randint(0, N - gran, (B, S)).astype(np.int64)
    length = np.array([[0, 1, gran // 2, gran, gran]] * B, np.int32)
    bias = rng.randn(B, S).astype(np.float32)
    seg = np.array([[0, 1, 0, 1, 2]] * B, np.int32)
    arrs = [torch.from_numpy(a).to(device) for a in
            (lut, ntab, t2, codes, ncodes, subc, start, length, bias, seg)]
    return arrs + [gran]


def _numpy_scan(lut, ntab, t2, codes, ncodes, subc, start, length, bias,
                seg, gran):
    """The kernel's function, written out lane by lane in float64."""
    B, S = start.shape
    out = np.full((B, S * gran), np.inf)
    for b in range(B):
        for s in range(S):
            for ln in range(length[b, s]):
                r = start[b, s] + ln
                out[b, s * gran + ln] = (
                    float(bias[b, s]) + ntab[ncodes[r]]
                    + t2[b, seg[b, s], subc[r]]
                    + sum(float(lut[b, m, codes[r, m]])
                          for m in range(codes.shape[1])))
    return out


def test_plain_matches_numpy_formula():
    args = _args()
    out = tg.grouping_scan_slots_plain(*args).numpy()
    ref = _numpy_scan(*[a.numpy() for a in args[:-1]], args[-1])
    assert np.array_equal(np.isinf(out), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=1e-6, atol=1e-5)
    out = out.reshape(3, 5, 256)
    assert np.isinf(out[:, 0]).all()                        # empty slot
    assert np.isfinite(out[:, 1, :1]).all() and np.isinf(out[:, 1, 1:]).all()
    assert np.isfinite(out[:, 3]).all()                     # full slot
    # The pruned probe's slot: +inf exactly on subgroups 0 and 2, no NaN.
    sub = args[5].numpy()[args[6].numpy()[0, 4]:][:256]
    np.testing.assert_array_equal(np.isinf(out[0, 4]), np.isin(sub, [0, 2]))
    assert not np.isnan(out).any()


def test_dispatcher_cpu_uses_plain_and_counts_no_launch():
    args = _args(M=16, gran=1024)
    before = tg.grouping_scan_slots.launches
    out = tg.grouping_scan_slots(*args)
    assert tg.grouping_scan_slots.launches == before
    np.testing.assert_array_equal(out.numpy(),
                                  tg.grouping_scan_slots_plain(*args).numpy())


def test_plain_scan_empty_store_is_all_inf():
    args = _args()
    for i in (3, 4, 5):                                     # codes, ncodes, subc
        args[i] = args[i][:0]
    args[7] = torch.zeros_like(args[7])
    assert torch.isinf(tg.grouping_scan_slots(*args)).all()


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "device",
                                 "smem"])
def test_dispatcher_rejects_what_the_kernel_does_not_take(bad):
    args = _args()
    if bad == "dtype":
        args[9] = args[9].long()                            # seg
    elif bad == "shape":
        args[5] = args[5][:-1]                              # subc
    elif bad == "contiguous":
        args[2] = args[2].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "device":
        args[8] = args[8].to("meta")                        # bias
    else:                                                   # 240 KB of t2
        args[2] = torch.zeros((3, 3, 20000))
    with pytest.raises((TypeError, ValueError)):
        tg.grouping_scan_slots(*args)


def test_smem_budget_of_the_flagship_fits():
    """LUT + norm + term2 at M=16, nprobe=32, nsubc=64: 25 KB per block,
    below the 48 KB a launch gets without opting in."""
    assert tg.smem_bytes(16, 32, 64) == (17 * 256 + 32 * 64) * 4 < 48 * 1024


def _edge_args(device="cpu", M=16, gran=256, pruned=False):
    """4 queries x 9 slots whose lengths exercise the kernel's padding
    paths: 1, 3 and gran - 1 codes (a tail that starts inside, at and one
    short of a 16-byte store), full slots, a run of two empty slots in the
    middle and one at the end; query 3 is empty throughout. 40% of the
    subgroups are pruned (+inf term2), all of them with ``pruned``."""
    rng = np.random.RandomState(6)
    B, S, N, P, nsubc = 4, 9, 5000, 4, 8
    lut = rng.randn(B, M, 256).astype(np.float32)
    ntab = rng.rand(256).astype(np.float32)
    t2 = rng.randn(B, P, nsubc).astype(np.float32)
    t2[rng.rand(B, P, nsubc) < 0.4] = np.inf
    if pruned:
        t2[:] = np.inf
    codes = rng.randint(0, 256, (N, M)).astype(np.uint8)
    ncodes = rng.randint(0, 256, N).astype(np.uint8)
    subc = rng.randint(0, nsubc, N).astype(np.uint8)
    start = rng.randint(0, N - gran, (B, S)).astype(np.int64)
    length = np.array([[1, 3, 0, 0, gran - 1, gran, 2, gran // 2 + 1, 0]] * B,
                      np.int32)
    length[3] = 0
    bias = rng.randn(B, S).astype(np.float32)
    seg = rng.randint(0, P, (B, S)).astype(np.int32)
    arrs = [torch.from_numpy(a).to(device) for a in
            (lut, ntab, t2, codes, ncodes, subc, start, length, bias, seg)]
    return arrs + [gran]


def test_edge_slots_plain_matches_numpy_formula():
    args = _edge_args(M=8, gran=16)
    out = tg.grouping_scan_slots_plain(*args).numpy()
    ref = _numpy_scan(*[a.numpy() for a in args[:-1]], args[-1])
    assert np.array_equal(np.isinf(out), np.isinf(ref))
    fin = np.isfinite(ref)
    assert fin.any() and np.isinf(out[3]).all()
    np.testing.assert_allclose(out[fin], ref[fin], rtol=1e-6, atol=1e-5)
    assert np.isinf(tg.grouping_scan_slots_plain(
        *_edge_args(M=8, gran=16, pruned=True)).numpy()).all()


@pytest.mark.parametrize("variant", sorted(gl.VARIANTS))
def test_lab_variant_on_cpu_uses_plain_and_counts_no_launch(variant):
    args = _edge_args(M=8, gran=32)
    gl.reset_launches()
    out = gl.grouping_lab_scan(variant, *args)
    assert gl.LAUNCHES[variant] == 0
    assert torch.equal(out, tg.grouping_scan_slots_plain(*args))
    with pytest.raises((TypeError, ValueError)):
        bad = list(args)
        bad[7] = bad[7].long()                              # length
        gl.grouping_lab_scan(variant, *bad)


def test_lab_rejects_an_unknown_variant_and_a_schedule_past_shared_memory():
    args = _edge_args(M=8, gran=32)
    with pytest.raises(ValueError, match="unknown grouping lab variant"):
        gl.grouping_lab_scan("prefetch", *args)
    # 12,000 slots x 20 B of staged schedule pass a block's 227 KB
    wide = list(args)
    for i in (6, 7, 8, 9):
        wide[i] = wide[i][:, :1].repeat(1, 12000).contiguous()
    gl.grouping_lab_scan("fill", *wide)
    with pytest.raises(ValueError, match="shared memory"):
        gl.grouping_lab_scan("staged", *wide)


def _source(name):
    with open(os.path.join(kbuild.CSRC_DIR, name)) as f:
        return f.read()


def test_lab_variant_table_matches_the_sources():
    """ops/cuda/grouping_lab.py::VARIANTS against the switch of
    csrc/grouping_lab.cu, and ENGINE_VARIANT against the instantiation of
    csrc/grouping_scan.cu."""
    cases = {int(m[1]): m.groups()[1:] for m in re.finditer(
        r"LAB_CASE\((\d), (true|false), (true|false), (true|false), "
        r"(true|false), (true|false)\)\s*// (\w+)",
        _source("grouping_lab.cu"))}
    table = {v[5]: k for k, v in cases.items()}
    two_pass = re.search(r"case (\d):\s*// (\w+): the two-pass kernel",
                         _source("grouping_lab.cu"))
    table[two_pass[2]] = int(two_pass[1])
    assert table == gl.VARIANTS
    assert cases[gl.VARIANTS["direct"]][:5] == ("false",) * 5
    engine = re.search(
        r"launch</\*FILL=\*/(\w+), /\*STREAM=\*/(\w+), /\*SKIP=\*/(\w+),"
        r"\s*/\*STAGE=\*/(\w+), /\*BULK=\*/(\w+), BINS>",
        _source("grouping_scan.cu"))
    assert engine.groups() == cases[gl.VARIANTS[gl.ENGINE_VARIANT]][:5]
    assert '#include "scan_common.cuh"' in _source("adc_scan.cu")
    assert "fill_inf" in _source("scan_common.cuh")


def test_library_hash_covers_headers(tmp_path, monkeypatch):
    """An edit of any header under csrc/ renames every library, so a stale
    build is never loaded; the build directory stays build/torch_kernels."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kbuild.CSRC_DIR, csrc)
    monkeypatch.setattr(kbuild, "CSRC_DIR", str(csrc))
    names = ["adc_scan", "grouping_scan", "grouping_lab", "scan_lab"]
    before = [kbuild.library_path(n) for n in names]
    assert before == [kbuild.library_path(n) for n in names]
    with open(csrc / "scan_common.cuh", "a") as f:
        f.write("// edited\n")
    after = [kbuild.library_path(n) for n in names]
    assert all(a != b for a, b in zip(after, before))
    with open(csrc / "grouping_scan.cu", "a") as f:
        f.write("// edited\n")
    again = [kbuild.library_path(n) for n in names]
    assert again[1] != after[1] and again[0] == after[0]
    for path in again:
        assert os.path.dirname(path) == kbuild.BUILD_DIR
        assert kbuild.BUILD_DIR.endswith(os.path.join("build",
                                                      "torch_kernels"))


@pytest.mark.parametrize("bins", [False, True])
def test_grouping_scan_bound_counts_kept_rows_once(bins):
    """Against a count lane by lane: bytes = tables + schedule + one subc
    byte per touched row + M + 1 bytes per row kept by some query + the
    output (and with ``bins`` one f32 minimum a 32 lanes); operations =
    (M + 2) per kept lane."""
    args = _edge_args(M=8, gran=32)
    gran = args[-1]
    out = tg.grouping_scan_slots_plain(*args)
    b = grouping_scan_bound(args[:-1], out, gran, bins=bins)
    lut, ntab, t2, codes, _, _, start, length = [a.numpy() for a in args[:8]]
    touched, kept, n_kept = set(), set(), 0
    o = out.numpy()
    for q in range(start.shape[0]):
        for s in range(start.shape[1]):
            for l in range(length[q, s]):
                r = int(start[q, s]) + l
                touched.add(r)
                if np.isfinite(o[q, s * gran + l]):
                    kept.add(r)
                    n_kept += 1
    assert b["kept_lanes"] == n_kept and 0 < n_kept < int(length.sum())
    assert b["filled_lanes"] == int(length.sum())
    nbytes = (lut.size * 4 + 256 * 4 + t2.size * 4 + start.size * 20
              + len(touched) + len(kept) * 9 + o.size * 4
              + bins * o.size // 32 * 4)
    assert b["bound_by"] == "bytes" and b["lookup_ms"] is None
    assert b["bound_ms"] == pytest.approx(nbytes / 3.35e9)


@pytest.mark.parametrize("shape", [(), (5,)], ids=["1d", "2d"])
def test_segment_sum_matches_numpy(shape):
    """Against float64 np.add.at, empty segments included (0)."""
    rng = np.random.RandomState(4)
    n, nseg = 4000, 50
    vals = (rng.randn(n, *shape) * 10).astype(np.float32)
    keys = rng.randint(0, nseg, n)
    keys[keys == 7] = 8                                     # segment 7 empty
    out = segment_sum(torch.from_numpy(vals), torch.from_numpy(keys),
                      nseg).numpy()
    ref = np.zeros((nseg, *shape))
    np.add.at(ref, keys, vals.astype(np.float64))
    mag = np.zeros((nseg, *shape))
    np.add.at(mag, keys, np.abs(vals.astype(np.float64)))
    assert out.shape == (nseg, *shape) and out.dtype == np.float32
    assert (np.abs(out - ref) <= 1e-5 * mag).all()
    assert (out[7] == 0).all() and (out[nseg - 1] != 0).all()


def test_segment_sum_order_is_input_order():
    """The sums are sequential float32 sums in input order: the order of
    summation is fixed by the data (bit-equal on the CPU)."""
    rng = np.random.RandomState(5)
    vals = (rng.randn(3000, 3) * 100).astype(np.float32)
    keys = rng.randint(0, 6, 3000)
    ref = np.zeros((6, 3), np.float32)
    for v, k in zip(vals, keys):
        ref[k] += v
    out = segment_sum(torch.from_numpy(vals), torch.from_numpy(keys), 6)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 16])
@pytest.mark.parametrize("gran", [256, 1024])
def test_kernel_matches_plain_on_card(M, gran):
    """M=16 takes the kernel's 16-byte code loads, M=8 its byte loop."""
    _need_card()
    args = _args("cuda", M=M, gran=gran)
    before = tg.grouping_scan_slots.launches
    out = tg.grouping_scan_slots(*args)
    torch.cuda.synchronize()
    assert tg.grouping_scan_slots.launches == before + 1
    ref = tg.grouping_scan_slots_plain(*args)
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    assert not torch.isnan(out).any()
    fin = torch.isfinite(ref)
    torch.testing.assert_close(out[fin], ref[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("gran,shape", [(256, "small"), (1024, "small"),
                                        (1024, "cell"), (256, "cell")])
def test_kernel_bins_bit_equal_on_card(gran, shape):
    """The engine's kernel with its bin minima, over pruned subgroups, a
    probe pruned whole, empty runs and ragged slots: the lanes as without
    bins and as the plain version's (small shapes), the minima torch.equal
    to amin over the same launch's output, and the fused top-k torch.equal
    to the amin path's; at the grouping search cell's chunk (B 1024, its
    slots, at its gran and at 256 with as many lanes) too."""
    _need_card()
    if shape == "cell":
        cg, cs = CELL_SCANS["grouping"]
        a = _bin_args("grouping", "cuda", gran, B=1024, S=cs * cg // gran,
                      N=1 << 22)
    else:
        a = _bin_args("grouping", "cuda", gran, B=9, S=12)
    _check_bins("grouping", a, gran, plain=shape != "cell")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernel_opts_into_large_shared_memory_on_card():
    """A term2 table of 128 probes x 256 subgroups (128 KB) needs more than
    the default 48 KB of shared memory."""
    _need_card()
    args = _args("cuda", M=16, P=128, nsubc=256)
    args[9] = torch.full_like(args[9], 127)
    out = tg.grouping_scan_slots(*args)
    torch.cuda.synchronize()
    ref = tg.grouping_scan_slots_plain(*args)
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    fin = torch.isfinite(ref)
    torch.testing.assert_close(out[fin], ref[fin], rtol=RTOL, atol=ATOL)


def _kernels():
    """The engine's kernel and every lab variant, as fn(*args)."""
    out = {"engine": tg.grouping_scan_slots}
    for name in gl.VARIANTS:
        out[name] = (lambda *a, name=name: gl.grouping_lab_scan(name, *a))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 16])
@pytest.mark.parametrize("gran", [256, 1024, 250])
@pytest.mark.parametrize("kernel", ["engine"] + sorted(gl.VARIANTS))
def test_kernel_padding_paths_equal_plain_on_card(kernel, gran, M):
    """Slots of 1, 3 and gran - 1 codes, runs of empty slots, an empty
    query: every kernel torch.equal to the plain version. The engine's slot
    widths are 256 and 1024, so its output rows (nslots * gran floats) are
    always whole 16-byte stores; gran = 250 makes rows and slot tails that
    are not, which takes the fills' one-float path."""
    _need_card()
    args = _edge_args("cuda", M=M, gran=gran)
    out = _kernels()[kernel](*args)
    torch.cuda.synchronize()
    assert torch.equal(out, tg.grouping_scan_slots_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["engine"] + sorted(gl.VARIANTS))
def test_kernel_whole_batch_pruned_is_all_inf_on_card(kernel):
    _need_card()
    args = _edge_args("cuda", pruned=True)
    out = _kernels()[kernel](*args)
    torch.cuda.synchronize()
    assert torch.isinf(out).all() and (out > 0).all()


@pytest.mark.cuda
def test_lab_counts_its_launches_on_card():
    _need_card()
    args = _edge_args("cuda")
    gl.reset_launches()
    before = tg.grouping_scan_slots.launches
    for name in gl.VARIANTS:
        gl.grouping_lab_scan(name, *args)
    torch.cuda.synchronize()
    assert gl.LAUNCHES == {name: 1 for name in gl.VARIANTS}
    assert tg.grouping_scan_slots.launches == before


@pytest.mark.cuda
def test_staged_variant_opts_into_large_shared_memory_on_card():
    """2,000 slots of staged schedule (40 KB) beside 25 KB of tables pass
    the 48 KB a launch gets without opting in."""
    _need_card()
    args = _edge_args("cuda", gran=32)
    for i in (6, 7, 8, 9):
        args[i] = args[i].repeat(1, 223)[:, :2000].contiguous()
    out = gl.grouping_lab_scan("staged", *args)
    torch.cuda.synchronize()
    assert torch.equal(out, tg.grouping_scan_slots_plain(*args))


@pytest.mark.cuda
def test_kernel_rejects_cpu_mixed_with_card():
    _need_card()
    args = _args("cuda")
    args[5] = args[5].cpu()
    with pytest.raises(ValueError):
        tg.grouping_scan_slots(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["chunk", "quad"])
def test_fused_grouping_matches_torch_engine_on_card(layout):
    """A small OPQ grouping index built on the card: engine "fused" (the
    kernel) against engine "torch", with and without pruning."""
    _need_card()
    rng = np.random.RandomState(3)
    centers = rng.randn(40, 32).astype(np.float32) * 5
    base = centers[rng.randint(0, 40, 8000)] + rng.randn(8000, 32).astype(
        np.float32)
    queries = base[:40] + 0.1
    idx = IVFADCGroupingIndex(
        IndexConfig(d=32, nc=32, code_size=8, nsubc=8, do_opq=True), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    idx.train_centroids(gen, base[:4000], niter=8)
    idx.compute_neighbor_centroids()
    idx.train_pq(gen, base[:3000], pq_niter=5, opq_niter=4)
    idx.add(base)
    idx.finalize()
    idx.compute_inter_centroid_dists()
    for pruning in (False, True):
        p = SearchParams(k=10, nprobe=8, max_codes=600, do_pruning=pruning)
        idx.engine = "torch"
        d1, l1 = idx.search(queries, p)
        idx.engine, idx.scan_layout = "fused", layout
        before = tg.grouping_scan_slots.launches
        d2, l2 = idx.search(queries, p)
        assert tg.grouping_scan_slots.launches > before
        np.testing.assert_allclose(d2, d1, rtol=RTOL, atol=ATOL)
        mism = l1 != l2
        assert np.allclose(d1[mism], d2[mism], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_segment_sum_is_deterministic_on_card():
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    vals = torch.randn((1 << 20, 9), device="cuda", generator=g) * 100
    keys = torch.randint(0, 4096, (1 << 20,), device="cuda", generator=g)
    a = segment_sum(vals, keys, 4096)
    b = segment_sum(vals, keys, 4096)
    assert torch.equal(a, b)
    ref = torch.zeros((4096, 9), dtype=torch.float64, device="cuda")
    ref.index_add_(0, keys, vals.double())
    torch.testing.assert_close(a.double(), ref, rtol=1e-5, atol=1e-2)


@pytest.mark.cuda
def test_kmeans_is_deterministic_on_card():
    """The primary point's centroid training (200k learn rows, nc=4096,
    setup_quantizer's 15 iterations), twice from one seed: the same bits."""
    _need_card()
    from ivfhnsw_tpu_torch.ops.kmeans import kmeans
    rng = np.random.RandomState(0)
    centers = rng.randn(4096, 128).astype(np.float32) * 4.0
    a = rng.randint(0, 4096, 200_000)
    learn = torch.tensor(centers[a] + rng.randn(200_000, 128).astype(
        np.float32), device="cuda")
    c1, _ = kmeans(torch.Generator(device="cuda").manual_seed(0), learn,
                   4096, niter=15)
    c2, _ = kmeans(torch.Generator(device="cuda").manual_seed(0), learn,
                   4096, niter=15)
    assert torch.equal(c1, c2)
