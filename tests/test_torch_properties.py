"""SURVEY.md §4's search properties on the port's IVFADCIndex: the
counterpart of tests/test_properties.py, on its data and at its thresholds.

Five properties, each held on every engine of the port: "torch" and
"fused" at both slot widths (chunk = 256 codes, quad = 1024) with the wide
and the two-phase top-k. On the CPU the fused engine runs the scan
kernels' plain versions.

1. recall@100 monotone in nprobe (1, 4, 16, 64; max_codes 0) within 1e-9,
   and >= 0.9 at nprobe 64;
2. recall@100 monotone in max_codes (200, 1000, 5000, 0 = unlimited) at
   nprobe 32;
3. two searches bit-equal;
4. returned distances sorted;
5. k=400 at nprobe=1, more than any probed list holds: the missing places
   are padded with +inf and label -1, and only those.

``test_recall_lists_match_jax`` carries the JAX package's index into the
port (``IVFADCIndex.from_numpy_state``) and holds the port's recall lists,
distances and labels to JAX's: distances rtol=1e-4, atol=1e-3
(tests/test_pallas_adc.py:42-46); labels, and so a query's hit, may differ
only between candidates tied at the k-th distance (D4).

The tests marked ``cuda`` run the five properties on the card through
``search_device``, so through the scan kernels K1/K2 (wide) and K3/K4
(two-phase) at both widths, hold two calls ``torch.equal``, and hold the
card's results to the CPU plain versions' under the contract above. They
skip where torch.cuda.is_available() is false. JAX is imported only by the
parity test, so on a machine with a card run them without the JAX side:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_properties.py
"""

import numpy as np
import pytest
import torch

from ivfhnsw_tpu_torch import IndexConfig, IVFADCIndex, SearchParams
from ivfhnsw_tpu_torch.ops.cuda import adc_scan as tk
from ivfhnsw_tpu_torch.utils.recall import recall_at_k

RTOL, ATOL = 1e-4, 1e-3
D, NC, CODE_SIZE = 32, 64, 8
NPROBES = (1, 4, 16, 64)
MAX_CODES = (200, 1000, 5000, 0)      # 0 = unlimited
# (engine, scan_layout, scan_topk); the torch engine ignores the last two
ENGINES = [("torch", "auto", "auto"), ("fused", "chunk", "wide"),
           ("fused", "chunk", "twophase"), ("fused", "quad", "wide"),
           ("fused", "quad", "twophase")]
FUSED = ENGINES[1:]
PROPERTIES = ("nprobe", "max_codes", "deterministic", "sorted", "padded")


def _name(e):
    return "-".join(e[:1] if e[0] == "torch" else e)


def _corpus():
    """tests/test_properties.py::built's data: 12,000 x 32d around 50
    centres x5, 64 queries, the exact top-1."""
    rng = np.random.RandomState(17)
    nb = 12000
    centers = rng.randn(50, D).astype(np.float32) * 5
    base = centers[rng.randint(0, 50, nb)] + rng.randn(nb, D).astype(
        np.float32)
    queries = centers[rng.randint(0, 50, 64)] + rng.randn(64, D).astype(
        np.float32)
    gt = np.argsort(((queries[:, None] - base[None]) ** 2).sum(-1),
                    axis=1)[:, :1]
    return base, queries, gt


@pytest.fixture(scope="module")
def data():
    return _corpus()


@pytest.fixture(scope="module")
def built(data):
    """The port's index built as JAX's fixture builds its own: k-means on
    5000 rows (10 iterations), PQ on 4000, every row added."""
    base, _, _ = data
    idx = IVFADCIndex(IndexConfig(d=D, nc=NC, code_size=CODE_SIZE),
                      device="cpu")
    g = torch.Generator().manual_seed(0)
    idx.train_centroids(g, base[:5000], niter=10)
    idx.train_pq(g, base[:4000])
    idx.add_batch(base, np.arange(len(base), dtype=np.int32))
    idx.finalize()
    return idx


def _set(idx, engine):
    idx.engine, idx.scan_layout, idx.scan_topk = engine
    return idx


# ---------------------------------------------------------------------------
# The five properties over a search function p -> (dists, labels) as numpy
# ---------------------------------------------------------------------------

def _sweeps() -> dict:
    """The searches of the properties: k=100 over nprobe (max_codes 0) and
    over max_codes (nprobe 32), and k=400 at nprobe 1."""
    return {"nprobe": [SearchParams(k=100, nprobe=n, max_codes=0)
                       for n in NPROBES],
            "max_codes": [SearchParams(k=100, nprobe=32, max_codes=m)
                          for m in MAX_CODES],
            "padded": [SearchParams(k=400, nprobe=1, max_codes=0)]}


def recalls(search, gt, sweep: str) -> list:
    """recall@100 over one of the two sweeps."""
    return [recall_at_k(search(p)[1], gt, ks=(100,))[100]
            for p in _sweeps()[sweep]]


def check_property(search, gt, prop: str, sizes, probe1) -> None:
    """One property on ``search``; ``sizes`` (the list sizes) and
    ``probe1`` (each query's nearest list) tell the padding check how many
    places each query can fill."""
    if prop in ("nprobe", "max_codes"):
        rs = recalls(search, gt, prop)
        assert all(b >= a - 1e-9 for a, b in zip(rs, rs[1:])), rs
        if prop == "nprobe":
            assert rs[-1] >= 0.9, rs
    elif prop == "deterministic":
        p = SearchParams(k=10, nprobe=16, max_codes=2000)
        d1, l1 = search(p)
        d2, l2 = search(p)
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(d1, d2)
    elif prop == "sorted":
        d, _ = search(SearchParams(k=50, nprobe=16, max_codes=0))
        assert np.isfinite(d).all()
        assert (np.diff(d, axis=1) >= -1e-6).all()
    else:
        check_padded(search, sizes, probe1)


def check_padded(search, sizes, probe1) -> None:
    """k=400 at nprobe=1: each query fills exactly as many places as its
    one probed list ``probe1`` [nq] holds, the rest +inf with label -1,
    finite places with real labels."""
    d, l = search(_sweeps()["padded"][0])
    assert d.shape == l.shape == (d.shape[0], 400)
    short = ~np.isfinite(d)
    assert short.any(), "no list is shorter than k: the case tests nothing"
    assert (l[short] == -1).all()
    assert (l[~short] >= 0).all()
    assert (np.isposinf(d) | np.isfinite(d)).all()
    # +inf only after every finite place
    assert (np.diff(short.astype(np.int8), axis=1) >= 0).all()
    np.testing.assert_array_equal((~short).sum(1),
                                  np.minimum(sizes[probe1], 400))


# ---------------------------------------------------------------------------
# CPU, every engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prop", PROPERTIES)
@pytest.mark.parametrize("engine", ENGINES, ids=_name)
def test_property(built, data, engine, prop):
    _, queries, gt = data
    idx = _set(built, engine)
    check_property(lambda p: idx.search(queries, p), gt, prop,
                   np.diff(idx.store.list_offsets), idx.assign(queries))


# ---------------------------------------------------------------------------
# Against the JAX package, on JAX's own index carried into the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_built(data):
    """JAX's index exactly as tests/test_properties.py::built builds it, its
    searches (k=100 over both sweeps, k=400 at nprobe 1), and the port's
    index carried across with from_numpy_state."""
    jax = pytest.importorskip("jax")
    from ivfhnsw_tpu import IVFADCIndex as JaxIndex
    from ivfhnsw_tpu import IndexConfig as JaxConfig
    from ivfhnsw_tpu import SearchParams as JaxParams

    base, queries, _ = data
    j = JaxIndex(JaxConfig(d=D, nc=NC, code_size=CODE_SIZE))
    key = jax.random.PRNGKey(0)
    j.train_centroids(key, base[:5000], niter=10)
    j.train_pq(key, base[:4000])
    j.add_batch(base, np.arange(len(base), dtype=np.int32))
    j.finalize()
    res = {}
    for sweep, ps in _sweeps().items():
        res[sweep] = [tuple(map(np.asarray, j.search(
            queries, JaxParams(k=p.k, nprobe=p.nprobe,
                               max_codes=p.max_codes)))) for p in ps]
    st = j.store
    t = IVFADCIndex.from_numpy_state(
        IndexConfig(d=D, nc=NC, code_size=CODE_SIZE), np.asarray(j.centroids),
        np.asarray(j.pq.codebooks), np.asarray(j.norm_pq.centroids),
        st.codes, st.ids, st.norm_codes, st.list_offsets, "cpu")
    return t, res


def tied_queries(d1, l1, d2, l2) -> np.ndarray:
    """Queries whose labels differ; raises unless each differs only in
    candidates tied at its k-th distance (D4): a label held by one side
    and not the other lies at that side's k-th distance within
    RTOL/ATOL. Distances must agree within RTOL/ATOL and share their +inf
    places."""
    np.testing.assert_array_equal(np.isinf(d1), np.isinf(d2))
    fin = np.isfinite(d1)
    np.testing.assert_allclose(d2[fin], d1[fin], rtol=RTOL, atol=ATOL)
    out = []
    for q in np.nonzero((l1 != l2).any(axis=1))[0]:
        for dd, ll, other in ((d1, l1, l2), (d2, l2, l1)):
            kth = dd[q][np.isfinite(dd[q])][-1]
            only = ~np.isin(ll[q], other[q])
            tol = ATOL + RTOL * abs(kth)
            assert (np.abs(dd[q][only] - kth) <= tol).all(), (
                f"query {q}: labels differ away from the k-th distance")
        out.append(q)
    return np.asarray(out, np.int64)


@pytest.mark.parametrize("sweep", ("nprobe", "max_codes", "padded"))
@pytest.mark.parametrize("engine", ENGINES, ids=_name)
def test_recall_lists_match_jax(jax_built, data, engine, sweep):
    """The port's recall@100 lists over nprobe and max_codes (and the k=400
    padding) on JAX's index equal JAX's: a query's hit may differ only
    where it ties at the k-th distance."""
    _, queries, gt = data
    t, res = jax_built
    idx = _set(t, engine)
    rj, rt = [], []
    for p, (dj, lj) in zip(_sweeps()[sweep], res[sweep]):
        dt, lt = idx.search(queries, p)
        tied = tied_queries(dj, lj, dt, lt)
        hj = (lj == gt[:, :1]).any(1)
        ht = (lt == gt[:, :1]).any(1)
        assert set(np.nonzero(hj != ht)[0]) <= set(tied.tolist())
        keep = np.setdiff1d(np.arange(len(queries)), tied)
        rj.append(float(hj[keep].mean()))
        rt.append(float(ht[keep].mean()))
        if sweep == "padded":
            np.testing.assert_array_equal(lt[np.isinf(dt)], -1)
    assert rt == rj, (rt, rj)


# ---------------------------------------------------------------------------
# On the card: search_device through K1/K2 and K3/K4
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card(built):
    """``built`` carried onto the card with from_numpy_state: the same
    quantizers and store, so the card's results can be held to the CPU
    plain versions'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    st = built.store
    return IVFADCIndex.from_numpy_state(
        built.config, built.centroids.numpy(), built.pq.codebooks.numpy(),
        built.norm_pq.centroids.numpy(), st.codes, st.ids, st.norm_codes,
        st.list_offsets, "cuda")


def _kernel_of(engine):
    return tk.adc_scan_slots_min if engine[2] == "twophase" else (
        tk.adc_scan_slots)


def _device_search(idx, queries, engine):
    """p -> (dists, labels) as numpy through search_device on the card;
    raises unless the engine's scan kernel launched."""
    q = torch.tensor(queries, device=idx.device)
    kern = _kernel_of(engine)

    def search(p):
        before = kern.launches
        d, l = idx.search_device(q, p)
        assert d.is_cuda and l.is_cuda
        assert kern.launches > before, f"{kern.__name__} never launched"
        return d.cpu().numpy(), l.cpu().numpy()
    return search


@pytest.mark.cuda
@pytest.mark.parametrize("prop", PROPERTIES)
@pytest.mark.parametrize("engine", FUSED, ids=_name)
def test_property_on_card(card, built, data, engine, prop):
    _, queries, gt = data
    idx = _set(card, engine)
    check_property(_device_search(idx, queries, engine), gt, prop,
                   np.diff(built.store.list_offsets), built.assign(queries))


@pytest.mark.cuda
@pytest.mark.parametrize("engine", FUSED, ids=_name)
def test_card_calls_bit_equal(card, data, engine):
    """Two search_device calls on the card: torch.equal distances and
    labels, at every point of both sweeps and at k=400."""
    _, queries, _ = data
    idx = _set(card, engine)
    q = torch.tensor(queries, device=idx.device)
    for p in sum(_sweeps().values(), []):
        d1, l1 = idx.search_device(q, p)
        d2, l2 = idx.search_device(q, p)
        assert torch.equal(d1, d2) and torch.equal(l1, l2), p


@pytest.mark.cuda
@pytest.mark.parametrize("engine", FUSED, ids=_name)
def test_card_matches_cpu(card, built, data, engine):
    """The card's kernels against the CPU plain versions over both sweeps
    and at k=400: equal recall lists but for tied queries, distances within
    RTOL/ATOL, labels tie-only."""
    _, queries, gt = data
    idx, ref = _set(card, engine), _set(built, engine)
    search = _device_search(idx, queries, engine)
    for sweep, ps in _sweeps().items():
        for p in ps:
            dc, lc = ref.search(queries, p)
            dg, lg = search(p)
            tied = tied_queries(dc, lc, dg, lg)
            hit = lambda l: (l == gt[:, :1]).any(1)
            assert set(np.nonzero(hit(lc) != hit(lg))[0]) <= set(
                tied.tolist()), (sweep, p)
