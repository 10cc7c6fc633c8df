"""Parity of the port's fused scan engine (ivfhnsw_tpu_torch.ops.cuda.
adc_scan: slot schedule, the scan kernel's plain version, search_core) and
of its portable engine (ivfhnsw_tpu_torch.ops.adc) with the JAX package,
on the CPU. JAX's Pallas kernels run in interpret mode, as its own tests run
them.

Tolerances: distances rtol=1e-4, atol=1e-3 (tests/test_pallas_adc.py:42-46),
labels may differ only where distances tie; schedules, positions and the
+inf pattern of the wide output are bit-equal.
The dispatcher and the kernel on the card are tested in
tests/test_torch_scan_kernel.py, which imports no jax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivfhnsw_tpu import IVFADCIndex as JaxIndex
from ivfhnsw_tpu import IndexConfig as JaxConfig
from ivfhnsw_tpu import SearchParams as JaxParams
from ivfhnsw_tpu.ops import adc as jadc
from ivfhnsw_tpu.ops.distances import streaming_topk_l2 as jax_topk_l2
from ivfhnsw_tpu.ops.pallas import adc_scan as pk
from ivfhnsw_tpu.ops.pq import _pq_ip_luts as jax_luts
from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex, SearchParams
from ivfhnsw_tpu_torch.ops import adc as tadc
from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-3
HIGHEST = jax.lax.Precision.HIGHEST


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def built():
    """A JAX index (d=32, nc=64, code_size=8, 9000 codes) and the port's
    index carried across from its arrays."""
    rng = np.random.RandomState(9)
    nb, d = 9000, 32
    centers = rng.randn(48, d).astype(np.float32) * 5
    base = centers[rng.randint(0, 48, nb)] + rng.randn(nb, d).astype(
        np.float32)
    queries = centers[rng.randint(0, 48, 24)] + rng.randn(24, d).astype(
        np.float32)
    j = JaxIndex(JaxConfig(d=d, nc=64, code_size=8))
    j.set_centroids(base[rng.choice(nb, 64, replace=False)])
    j.train_pq(jax.random.PRNGKey(0), base[:4000], pq_niter=5)
    j.add_batch(base, np.arange(nb, dtype=np.int32))
    j.finalize()
    st = j.store
    t = IVFADCIndex.from_numpy_state(
        IndexConfig(d=d, nc=64, code_size=8), np.asarray(j.centroids),
        np.asarray(j.pq.codebooks), np.asarray(j.norm_pq.centroids),
        st.codes, st.ids, st.norm_codes, st.list_offsets, "cpu")
    return j, t, queries


def _jax_coarse(j, queries, nprobe):
    qc, probes = jax_topk_l2(jnp.asarray(queries), j.centroids, nprobe,
                             point_sqnorms=j.centroid_norms,
                             precision=HIGHEST)
    return np.asarray(qc), np.asarray(probes)


def _layout(gran):
    return "quad" if gran == tk.RCHUNK else "chunk"


def _nslots(j, t, gran, max_codes, nprobe):
    """The slot-count rule, asserted equal in both packages."""
    p = SearchParams(k=10, nprobe=nprobe, max_codes=max_codes)
    j.scan_layout = t.scan_layout = _layout(gran)
    try:
        n = t._scan_slots(p, nprobe)
        assert n == j._pallas_nch(JaxParams(k=10, nprobe=nprobe,
                                            max_codes=max_codes), nprobe)
    finally:
        j.scan_layout = t.scan_layout = "auto"
    return n


def _tiled(j, gran):
    return j.store.quad() if gran == tk.RCHUNK else j.store.tiled()


def test_exact_coarse_probe_ids_bit_equal(built):
    j, t, q = built
    qc, probes = _jax_coarse(j, q, 16)
    tqc, tprobes = tk.streaming_topk_l2(_t(q), t.centroids, 16,
                                        point_sqnorms=t.centroid_norms)
    np.testing.assert_array_equal(tprobes.numpy(), probes)
    np.testing.assert_allclose(tqc.numpy(), qc, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("gran", [256, 1024])
@pytest.mark.parametrize("max_codes", [0, 300])
@pytest.mark.parametrize("truncate", [False, True])
def test_schedule_matches_jax(built, gran, max_codes, truncate):
    """len and bias equal JAX's _probe_schedule; start equals
    list_offsets[probe] + within * gran where JAX has its tile index
    tile_offsets[probe] + within. truncate=True gives 3 slots, fewer than
    the probes need, so the farthest probes' tails drop."""
    j, t, q = built
    qc, probes = _jax_coarse(j, q, 16)
    n = 3 if truncate else _nslots(j, t, gran, max_codes, 16)
    tiled = _tiled(j, gran)
    jtile, jlen, jbias = map(np.asarray, pk._probe_schedule(
        jnp.asarray(probes), jnp.asarray(qc), j.centroid_norms,
        tiled.tile_offsets, tiled.list_sizes, jnp.int32(max_codes), n, gran))
    # Same inputs on both sides, JAX's centroid norms included: the two
    # packages sum ||c||^2 in different orders (last-ulp differences).
    start, length, bias = tk.probe_schedule(
        _t(probes), _t(qc), _t(j.centroid_norms), t.store.list_offsets_t,
        max_codes, n, gran)
    np.testing.assert_array_equal(length.numpy(), jlen)
    np.testing.assert_array_equal(bias.numpy(), jbias)
    toff = np.asarray(tiled.tile_offsets).astype(np.int64)
    p = np.searchsorted(toff, jtile, side="right") - 1
    expect = np.where(jlen > 0,
                      j.store.list_offsets[p] + (jtile - toff[p]) * gran, 0)
    np.testing.assert_array_equal(start.numpy(), expect)


@pytest.mark.parametrize("gran", [256, 1024])
def test_wide_output_matches_jax_kernel(built, gran):
    """adc_scan_slots_plain against JAX's K1 (adc_scan_tiles, gran 256) and
    K2 (adc_scan_quad, gran 1024) in interpret mode, lane for lane."""
    j, t, q = built
    qc, probes = _jax_coarse(j, q, 16)
    n = _nslots(j, t, gran, 300, 16)
    tiled = _tiled(j, gran)
    jtile, jlen, jbias = pk._probe_schedule(
        jnp.asarray(probes), jnp.asarray(qc), j.centroid_norms,
        tiled.tile_offsets, tiled.list_sizes, jnp.int32(300), n, gran)
    luts_ext = pk.build_luts_ext(jnp.asarray(q), j.pq.codebooks,
                                 j.norm_pq.centroids, precision=HIGHEST)
    if gran == tk.CHUNK:
        jout = pk.adc_scan_tiles(luts_ext, jtile, jlen, jbias, tiled.tiles,
                                 interpret=True)
    else:
        jout = pk.adc_scan_quad(pk.build_luts_quad(luts_ext), jtile, jlen,
                                jbias, tiled.tiles, interpret=True)
    jout = np.asarray(jout)[:, :n * gran]   # JAX pads slots to its step
    start, length, bias = tk.probe_schedule(
        _t(probes), _t(qc), t.centroid_norms, t.store.list_offsets_t, 300,
        n, gran)
    lut = tk.build_luts(_t(q), t.pq.codebooks)
    args = (lut, t.norm_pq.centroids, t.store.codes_t, t.store.norm_codes_t,
            start, length, bias, gran)
    out = tk.adc_scan_slots_plain(*args).numpy()
    assert out.shape == jout.shape
    np.testing.assert_array_equal(np.isinf(out), np.isinf(jout))
    fin = np.isfinite(jout)
    assert fin.any() and (~fin).any()
    np.testing.assert_allclose(out[fin], jout[fin], rtol=RTOL, atol=ATOL)
    # The dispatcher takes the plain version for CPU tensors, no launch.
    before = tk.adc_scan_slots.launches
    np.testing.assert_array_equal(tk.adc_scan_slots(*args).numpy(), out)
    assert tk.adc_scan_slots.launches == before


def assert_same(d1, l1, d2, l2):
    np.testing.assert_allclose(d2, d1, rtol=RTOL, atol=ATOL)
    mism = l1 != l2
    if mism.any():  # exact-tie label swaps allowed
        assert np.allclose(d1[mism], d2[mism], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["chunk", "quad"])
@pytest.mark.parametrize("max_codes", [0, 300])
def test_search_core_matches_pallas_search_core(built, layout, max_codes):
    j, t, q = built
    nprobe = 8
    gran = tk.RCHUNK if layout == "quad" else tk.CHUNK
    n = _nslots(j, t, gran, max_codes, nprobe)
    j.scan_layout = layout
    try:
        jd_, jl_ = pk.pallas_search_core(
            jnp.asarray(q), *j._pallas_args(), jnp.int32(max_codes),
            nprobe=nprobe, k=10, nch=n,
            coarse_block=j._coarse_block_for(len(q)), use_opq=False,
            interpret=True, layout=layout)
    finally:
        j.scan_layout = "auto"
    st = t.store
    td_, tl_ = tk.search_core(
        _t(q), t.centroids, t.centroid_norms, t.pq.codebooks,
        t.norm_pq.centroids, st.codes_t, st.ids_t, st.norm_codes_t,
        st.list_offsets_t, max_codes, nprobe=nprobe, k=10, nslots=n,
        gran=gran, coarse_block=t._coarse_block_for(len(q)))
    assert tl_.dtype == torch.int64
    assert_same(np.asarray(jd_), np.asarray(jl_), td_.numpy(), tl_.numpy())


@pytest.mark.parametrize("gran", [256, 1024])
def test_index_scan_inputs_feed_the_fused_engine(built, gran):
    """IVFADCIndex.scan_inputs at an explicit slot width is what the fused
    engine scans under that layout: _scan_slots' slot count (JAX's rule),
    the store's own tensors, and scan_topk over it equal to the index's
    search."""
    j, t, q = built
    p = SearchParams(k=10, nprobe=8, max_codes=300)
    args = t.scan_inputs(_t(q), p, gran)
    assert args[4].shape == (len(q), _nslots(j, t, gran, 300, 8))
    assert args[2] is t.store.codes_t and args[3] is t.store.norm_codes_t
    d, lab = tk.scan_topk(args, t.store.ids_t, 10, gran)
    t.scan_layout = _layout(gran)
    try:
        d2, lab2 = t.search(q, p)
    finally:
        t.scan_layout = "auto"
    np.testing.assert_array_equal(d.numpy(), d2)
    np.testing.assert_array_equal(lab.numpy(), lab2)


@pytest.mark.parametrize("max_codes", [0, 300])
def test_probe_positions_match_jax(built, max_codes):
    j, t, q = built
    _, probes = _jax_coarse(j, q, 16)
    L = t._scan_budget(SearchParams(k=10, nprobe=16, max_codes=max_codes))
    ref = jadc.probe_positions(jnp.asarray(probes), j.store.list_offsets_d,
                               jnp.int32(max_codes), L)
    out = tadc.probe_positions(_t(probes), t.store.list_offsets_t,
                               max_codes, L)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_adc_scan_matches_jax(built):
    j, t, q = built
    qc, probes = _jax_coarse(j, q, 16)
    L = t._scan_budget(SearchParams(k=10, nprobe=16, max_codes=300))
    pos, seg, valid, _ = (x.numpy() for x in tadc.probe_positions(
        _t(probes), t.store.list_offsets_t, 300, L))
    luts = np.asarray(jax_luts(jnp.asarray(q), j.pq.codebooks))
    codes = j.store.codes[pos]
    rng = np.random.RandomState(0)
    bias = rng.rand(*pos.shape).astype(np.float32) * 10
    jd_, js = jadc.adc_scan(jnp.asarray(luts), jnp.asarray(codes),
                            jnp.asarray(bias), jnp.asarray(valid), 10)
    td_, ts = tadc.adc_scan(_t(luts), _t(codes), _t(bias), _t(valid), 10)
    jd_, js = np.asarray(jd_), np.asarray(js)
    np.testing.assert_allclose(td_.numpy(), jd_, rtol=RTOL, atol=ATOL)
    mism = ts.numpy() != js
    assert np.allclose(td_.numpy()[mism], jd_[mism], rtol=RTOL, atol=ATOL)
