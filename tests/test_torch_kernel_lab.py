"""Parity of the port's scan lab (ivfhnsw_tpu_torch.ops.cuda.scan_lab, the
plain versions its wrappers run on CPU tensors) with the TPU lab rigs L1-L4
of tools/kernel_lab.py, on the CPU, and the lab's entry point
(ivfhnsw_tpu_torch.tools.kernel_lab) on a tiny cache with -device cpu.

The JAX rigs run in Pallas interpret mode: adc_scan_runs and adc_scan_quad
take interpret=True; _variant_call and adc_scan_tiles_cps take no such
argument and run inside pltpu.force_tpu_interpret_mode with zeroed
uninitialized memory. tools/kernel_lab.py is loaded from its path and not
changed.

Both sides get the same queries, the same coarse probes and distances and
JAX's centroid norms; JAX's slot j (a tile or quad-tile index) is the
port's slot j (a store row), the mapping asserted as in
tests/test_torch_adc_scan.py. Tolerances: rtol=1e-4, atol=1e-3 (the JAX
package's cross-engine contract, tests/test_pallas_adc.py:42-46) on
distances; +inf patterns and byte sums equal.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ivfhnsw_tpu import IVFADCIndex as JaxIndex
from ivfhnsw_tpu import IndexConfig as JaxConfig
from ivfhnsw_tpu.ops.distances import streaming_topk_l2 as jax_topk_l2
from ivfhnsw_tpu.ops.pallas import adc_scan as pk
from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex
from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
from ivfhnsw_tpu_torch.ops.cuda import scan_lab as sl
from ivfhnsw_tpu_torch.tools import kernel_lab as tlab

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-3
HIGHEST = jax.lax.Precision.HIGHEST
NPROBE, MAX_CODES, B = 8, 300, 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax_lab():
    spec = importlib.util.spec_from_file_location(
        "tpu_kernel_lab", os.path.join(ROOT, "tools", "kernel_lab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def lab():
    return _load_jax_lab()


@pytest.fixture(scope="module")
def built():
    """The small index of tests/test_torch_adc_scan.py (d=32, nc=64,
    code_size=8, 9000 codes) in both packages, B queries, their JAX coarse
    probes and distances, JAX's fused LUTs and the port's LUTs."""
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
    q = queries[:B]
    qc, probes = jax_topk_l2(jnp.asarray(q), j.centroids, NPROBE,
                             point_sqnorms=j.centroid_norms,
                             precision=HIGHEST)
    luts_ext = pk.build_luts_ext(jnp.asarray(q), j.pq.codebooks,
                                 j.norm_pq.centroids, precision=HIGHEST)
    return dict(j=j, t=t, qc=np.asarray(qc), probes=np.asarray(probes),
                luts_ext=luts_ext, lut=tk.build_luts(_t(q), t.pq.codebooks))


def _port_args(b, gran, nslots):
    """The port's scan inputs on JAX's probes, distances and norms."""
    t = b["t"]
    start, length, bias = tk.probe_schedule(
        _t(b["probes"]), _t(b["qc"]), _t(b["j"].centroid_norms),
        t.store.list_offsets_t, MAX_CODES, nslots, gran)
    return (b["lut"], t.norm_pq.centroids, t.store.codes_t,
            t.store.norm_codes_t, start, length, bias)


def _assert_slot_mapping(b, tile, ln, tile_offsets, args, gran,
                         tiles_per_slot):
    """JAX slot j (first tile ``tile``, ``ln`` codes) is the port's slot j:
    equal lengths, and start = list_offsets[p] + (tile - tile_offsets[p]) *
    gran / tiles_per_slot for the list p holding the tile."""
    tile, ln = np.asarray(tile)[:, :args[4].shape[1]], np.asarray(ln)
    ln = ln[:, :args[4].shape[1]]
    np.testing.assert_array_equal(args[5].numpy(), ln)
    toff = np.asarray(tile_offsets).astype(np.int64)
    p = np.searchsorted(toff, tile, side="right") - 1
    step = gran // tiles_per_slot
    expect = np.where(ln > 0, b["j"].store.list_offsets[p]
                      + (tile - toff[p]) * step, 0)
    np.testing.assert_array_equal(args[4].numpy(), expect)


def _assert_lanes(out, jout, what):
    """Same +inf pattern, finite lanes within RTOL/ATOL."""
    out = out.numpy()
    jout = np.asarray(jout)[:, :out.shape[1]]
    np.testing.assert_array_equal(np.isinf(out), np.isinf(jout), err_msg=what)
    fin = np.isfinite(jout)
    assert fin.any() and (~fin).any(), what
    np.testing.assert_allclose(out[fin], jout[fin], rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _chunk_schedule(b):
    """JAX's chunk schedule (tile, len, bias) and the port's inputs at 256."""
    j = b["j"]
    tiled = j.store.tiled()
    n = (MAX_CODES + j.store.max_list_size()) // tk.CHUNK + NPROBE + 1
    ct, cl, cb = pk.chunk_metadata(
        jnp.asarray(b["probes"]), jnp.asarray(b["qc"]), j.centroid_norms,
        tiled.tile_offsets, tiled.list_sizes, jnp.int32(MAX_CODES), n)
    args = _port_args(b, tk.CHUNK, n)
    _assert_slot_mapping(b, ct, cl, tiled.tile_offsets, args, tk.CHUNK, 1)
    return tiled, (ct, cl, cb), args


def _zero_interpret():
    return pltpu.force_tpu_interpret_mode(
        pltpu.InterpretParams(uninitialized_memory="zero"))


def test_l1_runs_matches_scan_runs(built, lab):
    """L1 adc_scan_runs (one DMA per 4-tile run, interpret) against the
    port's scan_runs at 1024-code slots, lane for lane."""
    b, j = built, built["j"]
    tiled = j.store.tiled()
    nrun = (MAX_CODES + j.store.max_list_size()) // tk.RCHUNK + NPROBE + 1
    rt, rl, rb = lab.run_metadata(
        jnp.asarray(b["probes"]), jnp.asarray(b["qc"]), j.centroid_norms,
        tiled.tile_offsets, tiled.list_sizes, jnp.int32(MAX_CODES), nrun)
    tiles_padded = jnp.concatenate(
        [tiled.tiles, jnp.zeros((lab.RUN - 1,) + tiled.tiles.shape[1:],
                                jnp.uint8)])
    jout = lab.adc_scan_runs(b["luts_ext"], rt, rl, rb, tiles_padded,
                             interpret=True)
    args = _port_args(b, tk.RCHUNK, nrun)
    _assert_slot_mapping(b, rt, rl, tiled.tile_offsets, args, tk.RCHUNK, 4)
    np.testing.assert_array_equal(args[6].numpy(), np.asarray(rb))
    out = sl.scan_runs(*args, sl.VARIANTS["runs1024_d2"])
    _assert_lanes(out, jout, "L1 runs")


@pytest.mark.parametrize("branchless", [False, True])
@pytest.mark.parametrize("arith", [False, True])
def test_l2_quad_matches_scan_pipelined(built, lab, arith, branchless):
    """L2 adc_scan_quad over the lab's quad layout and 4x-replicated LUTs
    (interpret), at arith x branchless, against the port's 1024-code
    pipelined variant. The port has no arith axis (a 256-entry
    shared-memory row has no 128-lane halves to select between), so its
    one function is held against both."""
    b, j = built, built["j"]
    qt_np, _, qoff, sizes = lab.build_quad_layout(j.store)
    nquad = (MAX_CODES + j.store.max_list_size()) // tk.RCHUNK + NPROBE + 1
    qt, ql, qb = lab.quad_metadata(
        jnp.asarray(b["probes"]), jnp.asarray(b["qc"]), j.centroid_norms,
        jnp.asarray(qoff), jnp.asarray(sizes), jnp.int32(MAX_CODES), nquad)
    jout = lab.adc_scan_quad(lab.build_luts_quad(b["luts_ext"]), qt, ql, qb,
                             jnp.asarray(qt_np), interpret=True, arith=arith,
                             branchless=branchless)
    args = _port_args(b, tk.RCHUNK, nquad)
    _assert_slot_mapping(b, qt, ql, qoff, args, tk.RCHUNK, 1)
    v = sl.VARIANTS["pipe1024_c1_d2_s1_nb" if branchless
                    else "pipe1024_c4_d2_s1"]
    _assert_lanes(sl.scan_pipelined(*args, v), jout,
                  f"L2 arith={arith} branchless={branchless}")


def test_l3_nodma_matches_compute_only_on_a_zero_tile(built, lab):
    """L3 _adc_kernel_nodma computes over a scratch tile it never fills;
    with memory zeroed every lane of a slot with len > 0 holds
    sum_rows luts_ext[b, row, 0] (PQ rows, the norm row, zero pad rows).
    The port's compute-only variant over an all-zero store gives
    norm_tab[0] + sum_m lut[b, m, 0] on the lanes l < len of those slots
    (the Hopper kernel computes the lanes the full kernel computes)."""
    b = built
    tiled, (ct, cl, cb), args = _chunk_schedule(b)
    with _zero_interpret():
        jout = lab._variant_call(lab._adc_kernel_nodma, b["luts_ext"], ct,
                                 cl, cb, tiled.tiles)
    S = args[4].shape[1]
    jout = np.asarray(jout)[:, :S, :]
    zero = list(args)
    zero[2] = torch.zeros_like(args[2])
    zero[3] = torch.zeros_like(args[3])
    out = sl.scan_compute_only(*zero, sl.VARIANTS["comp256_wide"]).numpy()
    out = out.reshape(B, S, tk.CHUNK)
    lane = np.arange(tk.CHUNK)
    used = lane[None, None, :] < args[5].numpy()[:, :, None]
    assert used.any()
    np.testing.assert_array_equal(np.isinf(out), ~used)
    expect = np.asarray(b["luts_ext"])[:, :, 0].sum(axis=1)
    np.testing.assert_allclose(jout[used], np.broadcast_to(
        expect[:, None, None], jout.shape)[used], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out[used], jout[used], rtol=RTOL, atol=ATOL)


def test_l3_dmaonly_matches_copy_only(built, lab):
    """L3 _adc_kernel_dmaonly sums the bytes of each copied tile (code rows,
    the norm row, zero pad rows) as f32; the port's copy-only variant sums
    norm_codes[r] + codes[r, :] of the same rows. Compared on the lanes
    l < len of slots with len > 0: a TPU tile's lanes past len are list
    alignment padding, which the flat store does not have."""
    b = built
    tiled, (ct, cl, cb), args = _chunk_schedule(b)
    with _zero_interpret():
        jout = lab._variant_call(lab._adc_kernel_dmaonly, b["luts_ext"], ct,
                                 cl, cb, tiled.tiles)
    S = args[4].shape[1]
    jout = np.asarray(jout)[:, :S, :]
    out = sl.scan_copy_only(*args, sl.VARIANTS["copy256_wide"]).numpy()
    out = out.reshape(B, S, tk.CHUNK)
    used = np.arange(tk.CHUNK)[None, None, :] < args[5].numpy()[:, :, None]
    assert used.sum() > 500
    np.testing.assert_array_equal(out[used], jout[used])
    assert np.isinf(out[~used]).all()


def test_l3_v1b_matches_batched_wait_variant(built, lab):
    """L3 _adc_kernel_v1b (every wait of a step before any compute), masked
    and biased as kernel_lab.py:906-915, against the port's batched-wait
    pipelined variant."""
    b = built
    tiled, (ct, cl, cb), args = _chunk_schedule(b)
    with _zero_interpret():
        raw = lab._variant_call(lab._adc_kernel_v1b, b["luts_ext"], ct, cl,
                                cb, tiled.tiles)
    nch_p = raw.shape[1]
    lane = jnp.arange(tk.CHUNK, dtype=jnp.int32)
    clp = jnp.pad(cl, ((0, 0), (0, nch_p - cl.shape[1])))
    cbp = jnp.pad(cb, ((0, 0), (0, nch_p - cb.shape[1])))
    jout = jnp.where(lane[None, None, :] < clp[:, :, None],
                     raw + cbp[:, :, None], jnp.inf).reshape(B, -1)
    out = sl.scan_pipelined(*args, sl.VARIANTS["pipe256_c1_d16_s4_bw"])
    _assert_lanes(out, jout, "L3 v1b")


@pytest.mark.parametrize("cps,depth,bw,name", [
    (2, 8, False, "pipe256_c1_d8_s2"),
    (4, 16, True, "pipe256_c1_d16_s4_bw")])
def test_l4_cps_matches_scan_pipelined(built, lab, cps, depth, bw, name):
    """L4 adc_scan_tiles_cps (chunks per step x depth x wait placement)
    against the port's pipelined variant of the same steps and depth."""
    b = built
    tiled, (ct, cl, cb), args = _chunk_schedule(b)
    with _zero_interpret():
        jout = lab.adc_scan_tiles_cps(b["luts_ext"], ct, cl, cb, tiled.tiles,
                                      cps=cps, depth=depth, batched_wait=bw)
    v = sl.VARIANTS[name]
    assert (v.slots_per_step, v.depth, v.batched_wait) == (cps, depth, bw)
    _assert_lanes(sl.scan_pipelined(*args, v), jout, f"L4 {name}")


def test_lab_entry_point_on_a_cpu_cache(built, tmp_path, capsys):
    """python -m ivfhnsw_tpu_torch.tools.kernel_lab -device cpu on a cache
    written by the JAX package (save_quantizers, write, np.save): every
    variant matches, and the decomposition line names every part."""
    j = built["j"]
    cache = str(tmp_path)
    np.save(os.path.join(cache, "centroids.npy"), np.asarray(j.centroids))
    j.save_quantizers(os.path.join(cache, "bench.pq"),
                      os.path.join(cache, "bench.norm_pq"))
    j.write(os.path.join(cache, "bench.index"))
    rng = np.random.RandomState(1)
    np.save(os.path.join(cache, "queries.npy"),
            np.asarray(j.centroids)[rng.randint(0, 64, 16)] + 0.1)
    assert tlab.main(["-cache", cache, "-device", "cpu", "-batch", "6",
                      "-nprobe", "8", "-max_codes", "300"]) == 0
    out = capsys.readouterr().out
    assert out.count("[lab] ") == len(sl.VARIANTS)
    assert "match False" not in out
    import json
    dec = json.loads(out.strip().splitlines()[-1])["lab"]
    assert set(dec) == {"256_wide", "256_min", "1024_wide", "1024_min"}
    index, _ = tlab.load_cache(cache, "cpu")
    assert (index.d, index.nc, index.store.code_m) == (32, 64, 8)


def test_lab_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tlab.main(["-cache", str(tmp_path)])
