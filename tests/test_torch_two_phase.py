"""The PyTorch port's two-phase top-k (ivfhnsw_tpu_torch.ops.cuda.adc_scan.
adc_scan_slots_min and two_phase_topk, ``IVFADCIndex.scan_topk``) against
the JAX package's two-phase engine, on the CPU. JAX's phase-1 kernels K3
(``adc_scan_tiles_min``) and K4 (``adc_scan_quad_min``) run in Pallas
interpret mode, as its own tests run them.

Tolerances: distances rtol=1e-4, atol=1e-3 (tests/test_pallas_adc.py:42-46),
labels may differ only where distances tie. The port's slot minima carry
the bias inside the sum and JAX adds it outside, on the raw minima; f32
rounding is monotone, so min(fl(b + x)) = fl(b + min x) and the two agree
within that tolerance, with the same +inf pattern.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivfhnsw_tpu import SearchParams as JaxParams
from ivfhnsw_tpu.ops.pallas import adc_scan as pk
from ivfhnsw_tpu_torch import SearchParams
from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
from test_torch_adc_scan import (HIGHEST, RTOL, ATOL, _jax_coarse, _nslots,
                                 _t, _tiled, assert_same, built)  # noqa: F401

torch.set_num_threads(1)
LAYOUTS = ["chunk", "quad"]


@pytest.fixture(scope="module")
def jax_two_phase(built):
    """JAX pallas_interpret two-phase results, computed once per (layout,
    params)."""
    j, _, queries = built
    cache = {}

    def get(layout, p):
        key = (layout, tuple(sorted(p.items())))
        if key not in cache:
            prev = j.engine, j.scan_layout, j.scan_topk
            j.engine, j.scan_layout, j.scan_topk = ("pallas_interpret",
                                                    layout, "twophase")
            try:
                cache[key] = tuple(map(np.asarray,
                                       j.search(queries, JaxParams(**p))))
            finally:
                j.engine, j.scan_layout, j.scan_topk = prev
        return cache[key]
    return get


def port_search(t, queries, layout, scan_topk, p):
    prev = t.engine, t.scan_layout, t.scan_topk
    t.engine, t.scan_layout, t.scan_topk = "fused", layout, scan_topk
    try:
        return t.search(queries, SearchParams(**p))
    finally:
        t.engine, t.scan_layout, t.scan_topk = prev


@pytest.mark.parametrize("max_codes", [0, 300])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_two_phase_matches_jax_two_phase(built, jax_two_phase, layout,
                                         max_codes):
    j, t, queries = built
    p = dict(k=10, nprobe=12, max_codes=max_codes)
    d1, l1 = jax_two_phase(layout, p)
    d2, l2 = port_search(t, queries, layout, "twophase", p)
    assert d2.shape == (len(queries), 10) and l2.dtype == np.int64
    assert_same(d1, l1, d2, l2)


@pytest.mark.parametrize("max_codes", [0, 300])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_two_phase_matches_port_wide(built, layout, max_codes):
    _, t, queries = built
    p = dict(k=10, nprobe=12, max_codes=max_codes)
    d1, l1 = port_search(t, queries, layout, "wide", p)
    d2, l2 = port_search(t, queries, layout, "twophase", p)
    assert_same(d1, l1, d2, l2)


@pytest.mark.parametrize("k", [1, 64])
def test_two_phase_k_edges_match_jax(built, jax_two_phase, k):
    """k=1, and k=64 above some queries' slot count (the chosen slots then
    include empty ones: +inf lanes with label -1), as JAX's own edge test
    (tests/test_pallas_adc.py:202-218)."""
    j, t, queries = built
    p = dict(k=k, nprobe=4, max_codes=0)
    d1, l1 = jax_two_phase("chunk", p)
    d2, l2 = port_search(t, queries, "chunk", "twophase", p)
    assert_same(d1, l1, d2, l2)
    np.testing.assert_array_equal(l2 < 0, np.isinf(d2))
    np.testing.assert_array_equal(l1 < 0, np.isinf(d1))


@pytest.mark.parametrize("gran", [256, 1024])
def test_min_plain_matches_jax_min_kernel(built, gran):
    """adc_scan_slots_min_plain against JAX's K3 (gran 256) / K4 (gran
    1024) in interpret mode on one max_codes=300 schedule: the port's
    minima against JAX's raw minima + bias, masked where the slot is
    empty."""
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
        raw = pk.adc_scan_tiles_min(luts_ext, jtile, jlen, tiled.tiles,
                                    interpret=True)
    else:
        raw = pk.adc_scan_quad_min(pk.build_luts_quad(luts_ext), jtile, jlen,
                                   tiled.tiles, interpret=True)
    jmin = np.where(np.asarray(jlen) > 0, np.asarray(raw) + np.asarray(jbias),
                    np.inf)
    start, length, bias = tk.probe_schedule(
        _t(probes), _t(qc), t.centroid_norms, t.store.list_offsets_t, 300,
        n, gran)
    lut = tk.build_luts(_t(q), t.pq.codebooks)
    args = (lut, t.norm_pq.centroids, t.store.codes_t, t.store.norm_codes_t,
            start, length, bias, gran)
    mins = tk.adc_scan_slots_min_plain(*args).numpy()
    assert mins.shape == jmin.shape == (len(q), n)
    np.testing.assert_array_equal(np.isinf(mins), np.isinf(jmin))
    fin = np.isfinite(jmin)
    assert fin.any() and (~fin).any()
    np.testing.assert_allclose(mins[fin], jmin[fin], rtol=RTOL, atol=ATOL)
    # The dispatcher takes the plain version for CPU tensors, no launch.
    before = tk.adc_scan_slots_min.launches
    np.testing.assert_array_equal(tk.adc_scan_slots_min(*args).numpy(), mins)
    assert tk.adc_scan_slots_min.launches == before
