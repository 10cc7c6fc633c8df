"""The wide-scan kernel (K1/K2) of the PyTorch port and its design steps:
the step table against csrc/scan_lab.cu and the production setting in
csrc/adc_scan.cu, shared memory and occupancy, the steps' plain versions
(held against adc_scan_slots_plain and, at a small size, against the JAX
package's K1/K2 in interpret mode) and wrapper on the CPU,
tools/wide_probe.py on the CPU, and, on a card, every step and the
production kernel against their plain versions and the first port. The
bin-32 minima that the production scans (this kernel and the grouping
kernel, tests/test_torch_grouping_kernel.py) write beside their output:
on the CPU the definition (an amin over the output's 32-lane bins) and the
top-k over them, on a card the kernels against that definition.

The module imports no jax (the JAX parity test imports it inside), so it
also runs on a machine with a GPU and no jax; tests/conftest.py imports
jax, so run it there with
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_wide_kernel.py
Tests marked ``cuda`` skip where torch.cuda.is_available() is false.
Tolerance: none between the port's own versions. Every "full" step and the
production kernel sum each lane as the plain version does (bias, norm,
m = 0..M-1 in f32), so they are held to torch.equal with
adc_scan_slots_plain and with the first port; the split steps to
torch.equal with their own plain versions; the bin minima to torch.equal
with an amin over the same launch's output, and the top-k over them to
torch.equal with the top-k that reduces the bins itself. Against JAX's Pallas kernels
(another summation order): rtol 1e-4, atol 1e-3, the +inf pattern equal
(tests/test_pallas_adc.py:42-46).
"""

import os
import re

import numpy as np
import pytest
import torch

from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
from ivfhnsw_tpu_torch.ops.cuda import grouping_scan as tg
from ivfhnsw_tpu_torch.ops.cuda import scan_lab as sl
from ivfhnsw_tpu_torch.ops.topk import binned_topk_smallest
from ivfhnsw_tpu_torch.tools import wide_probe as wp

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ivfhnsw_tpu_torch", "csrc")
STEPS = sorted(sl.WIDE_STEPS)
FULL = [n for n in STEPS if sl.WIDE_STEPS[n].mode == "full"]
SPLIT = [n for n in STEPS if n not in FULL]
RTOL, ATOL = 1e-4, 1e-3
# The search cells' scans at their 1024-query chunk: (gran, slots a query)
# of sift1b-ivfadc16.batch-10k and deep1b-grouping-opq16.batch-10k.
CELL_SCANS = {"ivfadc": (1024, 234), "grouping": (1024, 894)}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _args(device="cpu", M=16, gran=256, B=5, misalign=False, S=12):
    """B queries x S slots (S <= 12) over a 5003-row store: empty slots
    (alone and in a run), one code, ragged partial slots, full slots, a
    slot whose len exceeds gran, a slot ending at the store's last row, and
    two slots whose rows repeat one code row (tied lanes, inside a slot and
    across the two); query 0 is all empty when B > 1. ``misalign`` puts the
    codes one byte into their buffer."""
    rng = np.random.RandomState(12)
    N = 5003
    lens = [0, 1, gran // 2 + 3, 0, 0, gran, gran + 77, 77, gran - 5, 40,
            33, 3 * gran][:S]
    starts = [0, 17, 101, 0, 0, 5, 300, N - 77, 1001, 4000, 4000, 0][:S]
    if S == 1:
        lens, starts = [gran - 9], [40]
    lut = torch.from_numpy(rng.randn(B, M, 256).astype(np.float32) * 3)
    ntab = torch.from_numpy(rng.rand(256).astype(np.float32) * 10)
    codes = rng.randint(0, 256, (N, M)).astype(np.uint8)
    ncodes = rng.randint(0, 256, N).astype(np.uint8)
    codes[4000:4040] = codes[4000]            # one row 40 times: ties
    ncodes[4000:4040] = ncodes[4000]
    codes, ncodes = torch.from_numpy(codes), torch.from_numpy(ncodes)
    start = torch.tensor([starts] * B, dtype=torch.int64)
    length = torch.tensor([lens] * B, dtype=torch.int32)
    if S > 2:
        start[B // 2:, 2] += 40
    if S == 12:
        start[:, 11] = torch.arange(B) * 7    # differs across queries
        length[:, 11] = torch.clamp(length[:, 11],
                                    max=N - int(start[:, 11].max()))
    if B > 1 and S > 1:
        length[0] = 0
    bias = torch.from_numpy(rng.randn(B, len(lens)).astype(np.float32))
    if S == 12:
        bias[:, 10] = bias[:, 9]              # the same tie in two slots
    out = [x.to(device) for x in (lut, ntab, codes, ncodes, start, length,
                                  bias)]
    if misalign:
        buf = torch.zeros(out[2].numel() + 1, dtype=torch.uint8,
                          device=device)
        buf[1:] = out[2].reshape(-1)
        out[2] = buf[1:].view(out[2].shape)
    return out


# ---- the step table -----------------------------------------------------------

_WSTEP = re.compile(r"^WSTEP\((\w+), (\d+), (\w+), (true|false), (\w+), "
                    r"(\w+), (\w+)\)\s*// (\d+)", re.M)
_MODES = {"FULL": "full", "STORES": "stores", "NOOUT": "noout",
          "COMPUTE": "compute", "LOADS": "loads"}


def _step(name, sid, minb, addr, warp, stage, out, mode):
    return sl.WideStep(name, int(sid), addr.lower(),
                       "warp" if warp == "true" else "block", stage.lower(),
                       out.lower(), _MODES[mode], int(minb))


def test_step_table_matches_the_cuda_source():
    """Every WIDE_STEPS entry but the first port is one WSTEP line of
    csrc/scan_lab.cu with the same id and switches, and ivf_lab_wstep's
    switch launches it under that id."""
    with open(os.path.join(CSRC, "scan_lab.cu")) as f:
        src = f.read()
    found = {}
    for m in _WSTEP.finditer(src):
        name, minb, addr, warp, stage, out, mode, sid = m.groups()
        found[name] = _step(name, sid, minb, addr, warp, stage, out, mode)
        assert re.search(rf"WCASE\({sid}, {name}\)", src)
    assert "case 0: fn = reinterpret_cast<const void*>(direct_wide_kernel)" \
        in src
    table = {n: s for n, s in sl.WIDE_STEPS.items() if s.step != 0}
    assert found == table
    assert sorted(s.step for s in sl.WIDE_STEPS.values()) == list(
        range(len(sl.WIDE_STEPS)))
    assert sl.WIDE_STEPS["first_port"].kernel == "direct_wide_kernel"
    assert sl.WIDE_STEPS["warp_noout"].kernel == "wstep_warp_noout"


@pytest.mark.parametrize("kernel", sorted(sl.WIDE_PRODUCTION))
def test_production_is_the_named_step(kernel):
    """csrc/adc_scan.cu's two wide kernels instantiate wide_scan.cuh's body
    at the switches and launch bounds of scan_lab.WIDE_PRODUCTION's steps
    (and their BINS switch), and the launcher takes the warp kernel below
    WARP_GRAN_BELOW codes."""
    with open(os.path.join(CSRC, "adc_scan.cu")) as f:
        src = f.read()
    m = re.search(r"template <bool BINS>\s*__global__ void "
                  r"__launch_bounds__\(wide_scan::THREADS, \d+\)\s*"
                  + kernel + r"\(wide_scan::Params p\) \{\s*"
                  r"wide_scan::body<min_scan::ADDR_(\w+), (true|false), "
                  r"min_scan::STAGE_(\w+),\s*wide_scan::OUT_(\w+), "
                  r"wide_scan::(\w+), BINS>\(p, 0u\);", src)
    assert m
    addr, warp, stage, out, mode = m.groups()
    st = sl.WIDE_STEPS[sl.WIDE_PRODUCTION[kernel]]
    b = re.search(r"__launch_bounds__\(wide_scan::THREADS, (\d+)\)\s*"
                  + kernel, src)
    assert b
    assert _step(st.name, st.step, b.group(1), addr, warp, stage, out,
                 mode) == st
    assert st.mode == "full"
    assert f"constexpr int WARP_GRAN_BELOW = {sl.WARP_GRAN_BELOW};" in src
    assert re.search(r"gran < WARP_GRAN_BELOW \? adc_scan_slots_kernel_warp"
                     r"<BINS>\s*: adc_scan_slots_kernel_block<BINS>", src)
    assert sl.wide_production_step(256).name == "warp"
    assert sl.wide_production_step(1024).name == "dp4a"


# ---- shared memory and occupancy -----------------------------------------------

@pytest.mark.parametrize("M", [8, 16, 32])
@pytest.mark.parametrize("name", STEPS)
def test_shared_memory_and_blocks_per_sm(name, M):
    """wide_smem_bytes: the tables ((M + 1) x 1 KB: 17 KB at M = 16) and,
    but for the first port, min_scan.cuh's 16-byte mbarrier, as
    ivf_lab_wstep asks for. Every step keeps the first port's 8 blocks an
    SM by shared memory up to M = 16 (6 at M = 32), and its launch bounds
    ask for no more than M = 16 allows."""
    st = sl.WIDE_STEPS[name]
    smem = sl.wide_smem_bytes(st, M)
    assert smem == (M + 1) * 1024 + (16 if st.step else 0)
    assert sl.smem_blocks_per_sm(smem) == (8 if M <= 16 else 6)
    assert st.min_blocks <= sl.smem_blocks_per_sm(sl.wide_smem_bytes(st, 16))


def test_blocks_per_sm_limits():
    assert sl.smem_blocks_per_sm(0) == 8                  # threads bind
    assert sl.smem_blocks_per_sm(227 * 1024) == 1
    assert sl.smem_blocks_per_sm(sl.SM_SMEM // 3 - 1024) == 3
    assert sl.smem_blocks_per_sm(sl.SM_SMEM // 3 - 1023) == 2


def test_owner_of_each_lane():
    """Block layout: lane l of every slot is thread l mod 256; warp layout:
    warp s mod 8, its lane l mod 32."""
    own = sl.wide_owner(sl.WIDE_STEPS["noout"], 9, 1024)
    assert torch.equal(own[3], torch.arange(1024) % 256)
    own = sl.wide_owner(sl.WIDE_STEPS["warp_noout"], 9, 256)
    assert int(own[0, 0]) == 0 and int(own[8, 33]) == 1
    assert int(own[3, 31]) == 3 * 32 + 31 and int(own[3, 32]) == 96
    assert int(own[2, 64]) == 64 and int(own[7, 127]) == 7 * 32 + 31


# ---- the bin minima --------------------------------------------------------------

def _bin_args(kind, device, gran, B, S, N=1 << 16, seed=3):
    """The scan inputs of ``kind`` ("ivfadc": adc_scan_slots', "grouping":
    grouping_scan_slots') for B queries x S slots over a random N-row
    M = 16 store: empty slots (runs of them too), full ones and ragged ones
    whose length is no multiple of 32 (below 32 too), query 0 all empty.
    grouping adds term2 tables [B, 8, 64] with half the subgroups pruned
    (+inf) and probe 1 pruned whole, so whole bins of filled lanes are
    +inf, each code's subgroup and each slot's probe."""
    g = torch.Generator().manual_seed(seed)
    lut = torch.randn((B, 16, 256), generator=g) * 3
    ntab = torch.rand((256,), generator=g) * 10
    codes = torch.randint(0, 256, (N, 16), generator=g, dtype=torch.uint8)
    ncodes = torch.randint(0, 256, (N,), generator=g, dtype=torch.uint8)
    start = torch.randint(0, N - gran, (B, S), generator=g)
    what = torch.randint(0, 4, (B, S), generator=g)
    ragged = torch.randint(1, gran, (B, S), generator=g)
    ragged = torch.where(ragged % 32 == 0, ragged - 1, ragged)
    length = torch.where(what == 1, gran, torch.where(
        what == 2, ragged, torch.where(what == 3, ragged % 32, 0)))
    length[:, 1:3] = 0                       # a run of empty slots
    length[:, 3] = gran - 5
    length[0] = 0
    bias = torch.randn((B, S), generator=g)
    a = [lut, ntab, codes, ncodes, start, length.to(torch.int32), bias]
    if kind == "grouping":
        t2 = torch.randn((B, 8, 64), generator=g)
        t2[torch.rand((B, 8, 64), generator=g) < 0.5] = float("inf")
        t2[:, 1] = float("inf")
        subc = torch.randint(0, 64, (N,), generator=g, dtype=torch.uint8)
        seg = torch.randint(0, 8, (B, S), generator=g, dtype=torch.int32)
        seg[:, 3] = 1
        a = a[:2] + [t2] + a[2:4] + [subc] + a[4:] + [seg]
    return [x.to(device) for x in a]


def _check_bins(kind, a, gran, plain=True):
    """The wrapper's bin minima and the top-k over them for inputs ``a``:
    the lanes as without bins (and, with ``plain``, as the plain
    version's), the minima torch.equal to an amin over the same launch's
    output, some +inf and some finite, and the bin-32 top-k and the search's
    top-k and labels over them torch.equal to the top-k that reduces the
    bins itself."""
    mod = tg if kind == "grouping" else tk
    scan = tg.grouping_scan_slots if kind == "grouping" else tk.adc_scan_slots
    start, length = a[6:8] if kind == "grouping" else a[4:6]
    before = scan.launches
    out, bins = scan(*a, gran, bins=True)
    B = out.shape[0]
    assert bins.shape == (B, out.shape[1] // 32)
    assert torch.equal(bins, out.view(B, -1, 32).amin(-1))
    assert torch.isinf(bins).any() and torch.isfinite(bins).any()
    assert torch.equal(out, scan(*a, gran))
    if a[0].is_cuda:
        assert scan.launches == before + 2
    if plain:
        plain_fn = (tg.grouping_scan_slots_plain if kind == "grouping"
                    else tk.adc_scan_slots_plain)
        assert torch.equal(out, plain_fn(*a, gran))
    for x, y in zip(binned_topk_smallest(out, 10, bmin=bins),
                    binned_topk_smallest(out, 10)):
        assert torch.equal(x, y)
    ids = torch.randperm(a[2 if kind == "ivfadc" else 3].shape[0],
                         device=out.device).to(torch.int32)
    got = mod.scan_topk(a, ids, 10, gran)
    want = tk.topk_labels(out, start, ids, 10, gran)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[1] >= 0).any()
    assert torch.equal(got[1] == -1, torch.isinf(got[0]))
    if not length[0].any():                  # an all-empty query
        assert (got[1][0] == -1).all()


@pytest.mark.parametrize("gran", [256, 1024])
@pytest.mark.parametrize("kind", ["ivfadc", "grouping"])
def test_bin_minima_are_the_plain_amin(kind, gran):
    """On the CPU the wrappers' bin minima are the plain output's amin, and
    the fused top-k over them gives the amin path's dists and labels."""
    a = _bin_args(kind, "cpu", gran, B=6, S=12)
    length = a[7 if kind == "grouping" else 5]
    assert ((length % 32 != 0) & (length > 0)).any()
    assert (length[1:] == 0).any() and (length[1:] == gran).any()
    _check_bins(kind, a, gran)


@pytest.mark.parametrize("kind", ["ivfadc", "grouping"])
def test_bins_need_gran_a_multiple_of_32(kind):
    a = _bin_args(kind, "cpu", 256, B=2, S=4)
    scan = tg.grouping_scan_slots if kind == "grouping" else tk.adc_scan_slots
    with pytest.raises(ValueError, match="gran % 32"):
        scan(*a, 48, bins=True)
    assert scan(*a, 48).shape == (2, 4 * 48)


def test_given_bin_minima_come_in_bins_of_32():
    """The scan kernels' minima are of 32-lane bins: binned_topk_smallest
    refuses them at another bin size rather than pick the wrong bins."""
    x = torch.randn(3, 256)
    bins = tk.bin_minima(x)
    for a, b in zip(binned_topk_smallest(x, 5, bmin=bins),
                    binned_topk_smallest(x, 5)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="bins of 32"):
        binned_topk_smallest(x, 5, bin_size=16, bmin=bins)


# ---- plain versions and the wrapper on the CPU --------------------------------

def test_card_args_cover_what_the_card_tests_need():
    """The card tests' inputs through the plain version: an all-empty
    query, a run of empty slots, a slot clipped at gran, tied lanes, S = 1."""
    a = _args(gran=256, B=5)
    wide = tk.adc_scan_slots(*a, 256).view(5, 12, 256)
    assert torch.isinf(wide[0]).all()
    assert torch.isinf(wide[1:, [0, 3, 4]]).all()
    assert torch.isfinite(wide[1:, 6]).all()          # len 333 clipped
    assert torch.isinf(wide[1:, 7, 77:]).all() and torch.isfinite(
        wide[1:, 7, :77]).all()
    assert (wide[1:, 9, :40] == wide[1:, 9, :1]).all()  # tied inside
    assert torch.equal(wide[1:, 9, :33], wide[1:, 10, :33])  # and across
    one = tk.adc_scan_slots(*_args(gran=1024, B=2, S=1), 1024)
    assert one.shape == (2, 1024) and torch.isfinite(one[:, :1015]).all()
    assert torch.isinf(one[:, 1015:]).all()


@pytest.mark.parametrize("gran", [256, 1024])
@pytest.mark.parametrize("name", STEPS)
def test_cpu_dispatch_runs_plain_and_counts_no_launch(name, gran):
    st = sl.WIDE_STEPS[name]
    a = _args(gran=gran)
    before = dict(sl.WIDE_LAUNCHES)
    out = sl.scan_wide_step(*a, gran, st)
    assert sl.WIDE_LAUNCHES == before
    assert torch.equal(out, sl.wide_step_plain(*a, gran, st))
    if st.mode == "full":
        assert torch.equal(out, tk.adc_scan_slots_plain(*a, gran))
    if st.mode == "noout":
        assert out.shape == (5, 256)
        assert torch.isinf(out[0]).all()
    else:
        assert out.shape == (5, 12 * gran)
        assert torch.isinf(out[0]).all() and torch.isinf(out[1:, :gran]).all()


def test_stores_plain_is_the_bias_in_valid_lanes():
    a = _args()
    out = sl.wide_step_plain(*a, 256, sl.WIDE_STEPS["stores"]).view(5, 12,
                                                                    256)
    wide = tk.adc_scan_slots_plain(*a, 256).view(5, 12, 256)
    assert torch.equal(torch.isinf(out), torch.isinf(wide))
    assert torch.equal(out[2, 7, :77], a[6][2, 7].expand(77))


def test_loads_plain_by_hand():
    a = _args(gran=1024)
    lut, ntab, codes, ncodes, start, length, bias = a
    out = sl.wide_step_plain(*a, 1024, sl.WIDE_STEPS["warp_loads"])
    b, s = 3, 8
    for l in (0, 5, int(length[b, s]) - 1):
        r = int(start[b, s]) + l
        w = [int.from_bytes(bytes(codes[r, 4 * q:4 * q + 4].tolist()),
                            "little") for q in range(4)]
        x = (w[0] ^ w[1] ^ w[2] ^ w[3] ^ int(ncodes[r])) & 0xFFFFFF
        assert float(out[b, s * 1024 + l]) == float(x)
    assert torch.isinf(out[b, s * 1024 + int(length[b, s]):(s + 1) * 1024]
                       ).all()


@pytest.mark.parametrize("name", ["comp", "warp_comp"])
def test_compute_plain_is_the_constant_row(name):
    """Lane l looks up store row l mod 32 with the slot's bias: the sum of
    that row as the production order sums it."""
    st = sl.WIDE_STEPS[name]
    a = _args()
    lut, ntab, codes, ncodes, start, length, bias = a
    out = sl.wide_step_plain(*a, 256, st)
    b, s, l = 2, 8, 77
    row = l % 32
    acc = torch.float32
    v = bias[b, s] + ntab[int(ncodes[row])]
    for m in range(16):
        v = (v + lut[b, m, int(codes[row, m])]).to(acc)
    assert float(out[b, s * 256 + l]) == float(v)
    assert torch.isinf(out[b, s * 256 + 251:(s + 1) * 256]).all()


@pytest.mark.parametrize("name", ["noout", "warp_noout"])
@pytest.mark.parametrize("gran", [256, 1024])
def test_noout_plain_folds_each_threads_lanes(name, gran):
    st = sl.WIDE_STEPS[name]
    a = _args(gran=gran)
    out = sl.wide_step_plain(*a, gran, st)
    wide = tk.adc_scan_slots_plain(*a, gran).view(5, 12, gran)
    own = sl.wide_owner(st, 12, gran)
    for t in (0, 37, 255):
        expect = wide[:, own == t].amin(-1)
        assert torch.equal(out[:, t], expect)


@pytest.mark.parametrize("bad", ["foreign", "dtype", "shape", "device",
                                 "gran", "m8_compute", "m8_loads",
                                 "few_rows"])
def test_wrapper_rejects_what_the_kernels_do_not_take(bad):
    a = _args()
    st, gran = sl.WIDE_STEPS["warp"], 256
    if bad == "foreign":
        st = sl.WideStep("warp", 8, addr="dp4a", layout="warp", out="bulk")
    elif bad == "dtype":
        a[4] = a[4].int()                             # start
    elif bad == "shape":
        a[0] = a[0][:, :8].contiguous()               # lut
    elif bad == "device":
        a[6] = a[6].to("meta")                        # bias
    elif bad == "gran":
        gran = 0
    elif bad == "few_rows":
        st = sl.WIDE_STEPS["comp"]
        a[2], a[3] = a[2][:31].contiguous(), a[3][:31].contiguous()
        a[5] = torch.clamp(a[5], max=0)
    else:
        a = _args(M=8)
        st = sl.WIDE_STEPS["comp" if bad == "m8_compute" else "loads"]
    with pytest.raises((TypeError, ValueError)):
        sl.scan_wide_step(*a, gran, st)


def test_reset_launches_covers_the_wide_steps():
    sl.WIDE_LAUNCHES["warp"] = 4
    sl.reset_launches()
    assert set(sl.WIDE_LAUNCHES) == set(sl.WIDE_STEPS)
    assert not any(sl.WIDE_LAUNCHES.values())


# ---- against the JAX package --------------------------------------------------

@pytest.fixture(scope="module")
def jax_built():
    """A JAX index (d=32, nc=32, code_size=16, 6000 codes), the port's index
    carried across from its arrays, and 12 queries."""
    jax = pytest.importorskip("jax")
    from ivfhnsw_tpu import IndexConfig as JaxConfig
    from ivfhnsw_tpu import IVFADCIndex as JaxIndex

    from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex
    rng = np.random.RandomState(21)
    nb, d = 6000, 32
    centers = rng.randn(40, d).astype(np.float32) * 5
    base = centers[rng.randint(0, 40, nb)] + rng.randn(nb, d).astype(
        np.float32)
    queries = centers[rng.randint(0, 40, 12)] + rng.randn(12, d).astype(
        np.float32)
    j = JaxIndex(JaxConfig(d=d, nc=32, code_size=16))
    j.set_centroids(base[rng.choice(nb, 32, replace=False)])
    j.train_pq(jax.random.PRNGKey(0), base[:3000], pq_niter=4)
    j.add_batch(base, np.arange(nb, dtype=np.int32))
    j.finalize()
    st = j.store
    t = IVFADCIndex.from_numpy_state(
        IndexConfig(d=d, nc=32, code_size=16), np.asarray(j.centroids),
        np.asarray(j.pq.codebooks), np.asarray(j.norm_pq.centroids),
        st.codes, st.ids, st.norm_codes, st.list_offsets, "cpu")
    return j, t, queries


@pytest.mark.parametrize("gran", [256, 1024])
def test_steps_plain_against_jax_kernel(jax_built, gran):
    """The full steps' plain version and the no-output split's against
    JAX's K1 (adc_scan_tiles, gran 256) / K2 (adc_scan_quad, gran 1024) in
    interpret mode on one schedule: lane for lane, and each thread's fold
    of JAX's lanes."""
    import jax.numpy as jnp

    from ivfhnsw_tpu.ops.distances import streaming_topk_l2 as jax_topk
    from ivfhnsw_tpu.ops.pallas import adc_scan as pk
    j, t, q = jax_built
    hi = pytest.importorskip("jax").lax.Precision.HIGHEST
    qc, probes = jax_topk(jnp.asarray(q), j.centroids, 8,
                          point_sqnorms=j.centroid_norms, precision=hi)
    qc, probes = np.asarray(qc), np.asarray(probes)
    from ivfhnsw_tpu_torch import SearchParams
    t.scan_layout = "quad" if gran == 1024 else "chunk"
    try:
        n = t._scan_slots(SearchParams(k=10, nprobe=8, max_codes=900), 8)
    finally:
        t.scan_layout = "auto"
    tiled = j.store.quad() if gran == 1024 else j.store.tiled()
    jtile, jlen, jbias = pk._probe_schedule(
        jnp.asarray(probes), jnp.asarray(qc), j.centroid_norms,
        tiled.tile_offsets, tiled.list_sizes, jnp.int32(900), n, gran)
    luts_ext = pk.build_luts_ext(jnp.asarray(q), j.pq.codebooks,
                                 j.norm_pq.centroids, precision=hi)
    if gran == 256:
        jout = pk.adc_scan_tiles(luts_ext, jtile, jlen, jbias, tiled.tiles,
                                 interpret=True)
    else:
        jout = pk.adc_scan_quad(pk.build_luts_quad(luts_ext), jtile, jlen,
                                jbias, tiled.tiles, interpret=True)
    jout = torch.from_numpy(np.array(jout)[:, :n * gran])
    start, length, bias = tk.probe_schedule(
        torch.from_numpy(np.array(probes)), torch.from_numpy(np.array(qc)),
        torch.from_numpy(np.array(j.centroid_norms)),
        t.store.list_offsets_t, 900, n, gran)
    args = (tk.build_luts(torch.from_numpy(q), t.pq.codebooks),
            t.norm_pq.centroids, t.store.codes_t, t.store.norm_codes_t,
            start, length, bias)
    for name in FULL + ["noout", "warp_noout"]:
        st = sl.WIDE_STEPS[name]
        out = sl.scan_wide_step(*args, gran, st)
        ref = jout
        if st.mode == "noout":
            own = sl.wide_owner(st, n, gran).reshape(-1)
            ref = torch.full((12, 256), float("inf")).scatter_reduce(
                1, own.expand(12, -1), jout, "amin")
        assert out.shape == ref.shape
        assert torch.equal(torch.isinf(out), torch.isinf(ref))
        fin = torch.isfinite(ref)
        assert fin.any() and (~torch.isfinite(jout)).any()
        torch.testing.assert_close(out[fin], ref[fin], rtol=RTOL, atol=ATOL)


# ---- tools/wide_probe.py on the CPU -----------------------------------------

def test_probe_runs_on_the_cpu():
    """The probe on a small M=16 index on the CPU (plain versions, host
    times): the fill_ floor, one record per kernel, slot width and store,
    all equal, and the split lines."""
    from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex, SearchParams
    rng = np.random.RandomState(3)
    centers = rng.randn(24, 32).astype(np.float32) * 5
    base = centers[rng.randint(0, 24, 4000)] + rng.randn(4000, 32).astype(
        np.float32)
    idx = IVFADCIndex(IndexConfig(d=32, nc=16, code_size=16), "cpu")
    gen = torch.Generator().manual_seed(0)
    idx.train_centroids(gen, base[:2000], niter=4)
    idx.train_pq(gen, base[:2000], pq_niter=3)
    idx.add_batch(base)
    idx.finalize()
    lines = []
    steps = ["first_port", "stores", "noout", "comp", "loads", "dp4a",
             "warp", "warp_noout"]
    recs = wp.run(idx, base[:6] + 0.1, SearchParams(k=5, nprobe=4,
                                                    max_codes=600),
                  "cpu", batch=6, steps=steps, rounds=1, reps=1,
                  log=lines.append)
    timed = [r for r in recs if "ms" in r and r["name"] != wp.FILL]
    assert len(timed) == 2 * 2 * (len(steps) + 1)
    assert all(r["equal_plain"] for r in timed)
    assert {r["name"] for r in timed} == set(steps) | {"production"}
    assert all("over_first_port" in r and 0 <= r["wins"] <= r["pairs"] == 2
               for r in timed if r["name"] != "first_port")
    assert sum(r["name"] == wp.FILL for r in recs) == 2
    assert sum(ln.startswith("[wprobe] split") for ln in lines) == 2
    assert all("fill_ floor" in ln for ln in lines
               if ln.startswith("[wprobe] split"))


def test_smoke_steps_are_steps():
    assert set(wp.SMOKE_STEPS) <= set(sl.WIDE_STEPS)
    assert wp.SMOKE_STEPS[0] == wp.BASELINE
    assert {n for n, _ in wp.SPLIT} - {wp.BASELINE, wp.PRODUCTION} <= set(
        sl.WIDE_STEPS)


# ---- on the card --------------------------------------------------------------

def _big_args(device, gran):
    """Two queries whose slots lie past row 2^27 of an M = 16 store, so
    start * M passes 2^31: a full slot, a ragged one and an empty one."""
    N = (1 << 27) + 3 * gran
    codes = torch.zeros((N, 16), dtype=torch.uint8, device=device)
    ncodes = torch.zeros((N,), dtype=torch.uint8, device=device)
    g = torch.Generator(device=device).manual_seed(4)
    tail = slice((1 << 27) - 8, N)
    codes[tail] = torch.randint(0, 256, codes[tail].shape, dtype=torch.uint8,
                                device=device, generator=g)
    ncodes[tail] = torch.randint(0, 256, ncodes[tail].shape,
                                 dtype=torch.uint8, device=device,
                                 generator=g)
    lut = torch.randn((2, 16, 256), device=device, generator=g)
    ntab = torch.rand((256,), device=device, generator=g)
    s0 = (1 << 27) - 5
    start = torch.tensor([[s0, s0 + gran, 0], [s0 + 2 * gran, s0, 0]],
                         dtype=torch.int64, device=device)
    length = torch.tensor([[gran, gran - 3, 0], [gran, 7, 0]],
                          dtype=torch.int32, device=device)
    bias = torch.randn((2, 3), device=device, generator=g)
    return [lut, ntab, codes, ncodes, start, length, bias]


def _run(name, a, gran):
    if name == "production":
        before = tk.adc_scan_slots.launches
        out = tk.adc_scan_slots(*a, gran)
        assert tk.adc_scan_slots.launches == before + 1
        return out
    before = dict(sl.WIDE_LAUNCHES)
    out = sl.scan_wide_step(*a, gran, sl.WIDE_STEPS[name])
    assert sl.WIDE_LAUNCHES == {**before, name: before[name] + 1}
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["m16", "m16_misaligned", "m8", "m32",
                                  "b1", "s1"])
@pytest.mark.parametrize("gran", [256, 1024])
@pytest.mark.parametrize("name", FULL + ["production"])
def test_full_kernels_bit_equal_on_card(name, gran, case):
    """Each full step and the production kernel: torch.equal to
    adc_scan_slots_plain and to the first port over ragged, clipped, empty
    and tied slots, a run of empty slots and an all-empty query; M = 16 on
    16-byte loads, M = 16 one byte off a 16-byte boundary, M = 8 and 32 on
    the byte loop; B = 1; S = 1."""
    _need_card()
    M = {"m8": 8, "m32": 32}.get(case, 16)
    a = _args("cuda", M=M, gran=gran, B=1 if case == "b1" else 5,
              misalign=case == "m16_misaligned", S=1 if case == "s1" else 12)
    out = _run(name, a, gran)
    torch.cuda.synchronize()
    assert torch.equal(out, tk.adc_scan_slots_plain(*a, gran))
    first = sl.scan_wide_step(*a, gran, sl.WIDE_STEPS["first_port"])
    assert torch.equal(out, first)
    mins = tk.adc_scan_slots_min(*a, gran)
    assert torch.equal(mins, out.view(*a[4].shape, gran).amin(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("gran", [256, 1024])
@pytest.mark.parametrize("name", FULL + ["production"])
def test_full_kernels_past_2_31_on_card(name, gran):
    """Slot bases whose start * M passes 2^31 (64-bit slot bases)."""
    _need_card()
    a = _big_args("cuda", gran)
    out = _run(name, a, gran)
    torch.cuda.synchronize()
    assert torch.equal(out, tk.adc_scan_slots_plain(*a, gran))
    assert torch.isfinite(out[:, :gran]).all()
    assert torch.isinf(out[:, 2 * gran:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("gran", [256, 1024])
@pytest.mark.parametrize("name", SPLIT)
def test_split_steps_equal_their_plain_on_card(name, gran):
    _need_card()
    st = sl.WIDE_STEPS[name]
    a = _args("cuda", gran=gran)
    out = _run(name, a, gran)
    torch.cuda.synchronize()
    assert torch.equal(out, sl.wide_step_plain(*a, gran, st))
    mis = _args("cuda", gran=gran, misalign=True)
    if st.mode in ("compute", "loads"):
        with pytest.raises(ValueError):       # no 16-byte code rows
            sl.scan_wide_step(*mis, gran, st)
    else:
        assert torch.equal(sl.scan_wide_step(*mis, gran, st),
                           sl.wide_step_plain(*mis, gran, st))


@pytest.mark.cuda
@pytest.mark.parametrize("gran,shape", [(256, "small"), (1024, "small"),
                                        (256, "b1"), (1024, "cell"),
                                        (256, "cell")])
def test_wide_bins_bit_equal_on_card(gran, shape):
    """K1 (gran 256) and K2 (gran 1024) with their bin minima: the lanes as
    without bins and as the plain version's (small shapes), the minima
    torch.equal to amin over the same launch's output, and the fused top-k
    torch.equal to the amin path's; at the IVFADC search cell's chunk (B
    1024, its slots, at its gran and at 256 with as many lanes) too."""
    _need_card()
    if shape == "cell":
        cg, cs = CELL_SCANS["ivfadc"]
        a = _bin_args("ivfadc", "cuda", gran, B=1024, S=cs * cg // gran,
                      N=1 << 22)
    else:
        a = _bin_args("ivfadc", "cuda", gran, B=1 if shape == "b1" else 9,
                      S=12)
        if shape == "b1":
            a[5][0] = torch.tensor([gran - 3, 0, 0, 31] + [gran] * 8,
                                   dtype=torch.int32)
    _check_bins("ivfadc", a, gran, plain=shape != "cell")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_step_occupancy_on_card():
    """Every step reports blocks per SM (the shared-memory bound of
    smem_blocks_per_sm, or fewer where registers bind), its shared memory
    (wide_smem_bytes) and its registers; the steps built for 8 blocks get
    8."""
    _need_card()
    for st in sl.WIDE_STEPS.values():
        blocks, smem, regs = sl.wide_step_occupancy(st, 16)
        assert smem == sl.wide_smem_bytes(st, 16) and regs > 0
        assert 1 <= blocks <= sl.smem_blocks_per_sm(smem)
        if st.min_blocks == 8:
            assert blocks == 8
