"""Sweep the routed coarse structure (n_super, cap_factor, w) on a cached
bench index: the counterpart of the JAX rig ``tools/routed_tune.py``.

For the ``scale2`` (or ``scale3``) index of the bench tool (``tools/
bench.py::build_scale2`` / ``build_scale3``, read from the cache or built)
and its first ``-B`` queries: the exact probes at full f32 (TF32 off);
then, for each of the JAX rig's six (n_super, cap_factor) structures (the
first four under ``--quick``), a ``RoutedCoarse`` (generator seed 90) and
its table over the store (``build_table(centroid_norms, list_offsets)``),
and for each w in 8, 16, 32, 64, 128 (skipped where w > n_super or w * cap
< nprobe, as the JAX rig skips; a structure of more than nc / 2 supers is
skipped too, which only the smoke sizes meet) the probe overlap against exact and the
marginal milliseconds of ``routed_select_ext`` (``utils/profiling.py::
marginal_ms``: (t_5 - t_1) / 4 over bundles synchronised once), beside the
exact sweep's own.

``--result-ws 16,32,64`` also runs the routed gate's result search
(``bench.result_search``: k=100 at nprobe / max_codes, under the routed
structure of ``bench.routed_setup``: default n_super and cap, seed 90,
``<cache>/<stage>/routed.npz``) at each w and at w = n_super, and
prints its top-100 result overlap against the exact-coarse search beside
the probe overlap of the probes that search took, with each missing label
put in one class: outranked (its distance no smaller than the routed
search's 100th less ``tie_atol``: a swap at the boundary, or the routed
search found nearer codes), its list not among the routed search's
admitted probes, or its list admitted (the rest); for the not-admitted
ones, how many lie in lists whose centroid the capacity-bounded partition
placed outside its 8 nearest supers, and the rank of the holding super.

    python -m ivfhnsw_tpu_torch.tools.routed_tune [--stage scale2|scale3]
        [--quick] [-B 256] [--result-ws 16,32,64] [--device cuda] [--smoke]

Text lines as the JAX rig prints them, then one JSON line of the records.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

from ivfhnsw_tpu_torch.ops.cuda.adc_scan import select_probes
from ivfhnsw_tpu_torch.ops.distances import streaming_topk_l2
from ivfhnsw_tpu_torch.ops.grouping import probe_budget
from ivfhnsw_tpu_torch.ops.routed_coarse import (RoutedCoarse,
                                                 routed_select_ext)
from ivfhnsw_tpu_torch.tools import bench, scale3
from ivfhnsw_tpu_torch.utils.config import SearchParams
from ivfhnsw_tpu_torch.utils.profiling import marginal_ms

# The JAX rig's structures: coarser and finer routing partitions around
# the default (2048, 1.5).
CONFIGS = ((2048, 1.5), (4096, 1.5), (8192, 1.5), (2048, 2.5), (1024, 1.5),
           (512, 2.0))
QUICK = 4
WS = (8, 16, 32, 64, 128)
SEED = 90
STAGES = {"scale2": (bench.build_scale2, "S2_NPROBE", "S2_MC"),
          "scale3": (bench.build_scale3, "S3_NPROBE", "S3_MC")}


def overlap(probes: np.ndarray, exact: np.ndarray) -> float:
    """The JAX rig's overlap: mean over rows of |set(probes) & set(exact)|
    / nprobe."""
    nprobe = exact.shape[1]
    return float(np.mean([np.intersect1d(exact[i], probes[i]).size / nprobe
                          for i in range(exact.shape[0])]))


def exact_probes(idx, q: torch.Tensor, nprobe: int) -> torch.Tensor:
    """The exact sweep's top-nprobe probes [B, nprobe] in full f32."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return streaming_topk_l2(q, idx.centroids, nprobe,
                                 block=idx._coarse_block_for(q.shape[0]),
                                 point_sqnorms=idx.centroid_norms)[1]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def sweep_structure(rc: RoutedCoarse, table, q: torch.Tensor,
                    exact: np.ndarray, nprobe: int, ws=WS,
                    timed: bool = True) -> list:
    """One structure's rows: for each w the rig does not skip, {"w",
    "candidates", "overlap", "ms", "us_per_query"} (ms None unless
    ``timed``)."""
    rows = []
    for w in ws:
        if w > rc.n_super or w * rc.cap < nprobe:
            continue
        probes = routed_select_ext(q, rc.supers, rc.super_sqn, table,
                                   nprobe=nprobe, w=w)[1]
        ms = (marginal_ms(lambda qq, _w=w: routed_select_ext(
            qq, rc.supers, rc.super_sqn, table, nprobe=nprobe, w=_w)[0], q)
            if timed else None)
        rows.append({"w": w, "candidates": w * rc.cap,
                     "overlap": overlap(probes.cpu().numpy(), exact),
                     "ms": ms, "us_per_query":
                         None if ms is None else ms * 1e3 / q.shape[0]})
    return rows


def sweep(idx, q: torch.Tensor, nprobe: int, configs=CONFIGS, ws=WS,
          timed: bool = True, out=print) -> list:
    """Every structure of ``configs`` over ``idx``'s centroids and store;
    one record per structure with its rows."""
    exact = exact_probes(idx, q, nprobe).cpu().numpy()
    store = idx._ensure_store()
    recs = []
    for n_super, capf in configs:
        if n_super > idx.nc // 2:
            out(f"--- n_super={n_super} skipped: more than nc/2 = "
                f"{idx.nc // 2} supers")
            continue
        rc = RoutedCoarse(idx.centroids, n_super=n_super, cap_factor=capf,
                          generator=torch.Generator(
                              device=idx.device).manual_seed(SEED))
        table = rc.build_table(idx.centroid_norms, store.list_offsets_t)
        kb = rc.cap * (idx.d * 4 + 4 + 3 * 8) / 1024
        out(f"--- n_super={n_super} cap={rc.cap} (capf={capf}, block="
            f"{kb:.0f} KB)")
        rows = sweep_structure(rc, table, q, exact, nprobe, ws, timed)
        for r in rows:
            ms = "" if r["ms"] is None else (
                f"  {r['ms']:7.3f} ms ({r['us_per_query']:6.2f} us/q)")
            out(f"  w={r['w']:3d}  cand={r['candidates']:6d}  "
                f"overlap={r['overlap']:.4f}{ms}")
        recs.append({"n_super": n_super, "cap_factor": capf, "cap": rc.cap,
                     "rows": rows})
        del table, rc
    return recs


def id_lists(idx) -> torch.Tensor:
    """The list of every stored id: [max id + 1] int64 on the device (-1
    where no row holds the id)."""
    st = idx._ensure_store()
    ids = st.ids_t.long()
    rows = torch.arange(st.ntotal, device=ids.device)
    out = torch.full((int(ids.max()) + 1,), -1, dtype=torch.int64,
                     device=ids.device)
    out[ids] = torch.searchsorted(st.list_offsets_t, rows, right=True) - 1
    return out


def tie_atol(idx, queries: np.ndarray) -> float:
    """16 ulps of the largest ||q||^2 + ||c||^2: the f32 rounding of the
    bias ||q||^2 - 2 q.c that two coarse paths may disagree by."""
    qsq = float((np.asarray(queries, np.float64) ** 2).sum(1).max())
    return 16 * 2.0 ** -24 * (qsq + float(idx.centroid_norms.max()))


def search_probes(idx, queries: np.ndarray, nprobe: int, max_codes: int,
                  mode: str):
    """(probes, admitted) [n, nprobe] on the device: the probes the result
    search under ``mode`` selects, batch by batch as it does, and which
    of them the max_codes budget admits."""
    prm = SearchParams(k=bench.RESULT_K, nprobe=nprobe, max_codes=max_codes,
                       coarse_mode=mode)
    coarse = idx._coarse_for(prm, nprobe)
    q_all = torch.tensor(np.asarray(queries, np.float32), device=idx.device)
    off = idx._ensure_store().list_offsets_t
    ps, inc = [], []
    for o in range(0, q_all.shape[0], bench.RESULT_BATCH):
        q = q_all[o:o + bench.RESULT_BATCH]
        _, p, _, _, sizes = select_probes(
            q, idx.centroids, idx.centroid_norms, off, nprobe=nprobe,
            coarse_block=idx._coarse_block_for(q.shape[0]), **coarse)
        ps.append(p)
        inc.append(probe_budget(sizes, max_codes))
    return torch.cat(ps), torch.cat(inc)


def placement(rc: RoutedCoarse, n_choice: int = 8) -> tuple:
    """(owner [nc] int64: the super whose members hold each centroid,
    fallback [nc] bool: held by a super outside its ``n_choice`` nearest,
    where ``greedy_partition`` puts a centroid whose nearest supers are
    all full), on the structure's device."""
    dev = rc.centroids.device
    s_idx, slot = np.nonzero(rc.valid)
    owner = torch.empty(rc.nc, dtype=torch.int64, device=dev)
    owner[torch.as_tensor(rc.members[s_idx, slot], device=dev).long()] = (
        torch.as_tensor(s_idx, device=dev))
    k = min(n_choice, rc.n_super)
    near = torch.cat([streaming_topk_l2(rc.centroids[o:o + 16384],
                                        rc.supers, k,
                                        point_sqnorms=rc.super_sqn)[1]
                      for o in range(0, rc.nc, 16384)])
    return owner, ~(near == owner[:, None]).any(1)


def result_gap(lists: torch.Tensor, ex: tuple, rt: tuple, rt_probes: tuple,
               atol: float, q: torch.Tensor, rc: RoutedCoarse,
               place: tuple) -> dict:
    """The exact-coarse search's top-k labels missing from the routed
    search's (``ex``, ``rt`` = (dists, labels) host arrays), each put in
    one class: "outranked" (its exact distance no smaller than the routed
    row's k-th less ``atol``: the routed row holds k labels as near, up to
    the two coarse paths' f32 difference), else "not_probed" (its list not
    among the routed search's admitted probes ``rt_probes`` = (probes,
    admitted)) or "admitted". For the not-probed ones: how many lie in a
    list whose centroid the partition placed by its fallback (``place``
    from :func:`placement`), and the median rank of the holding super
    among the query's supers (``q`` the queries [n, d] on the device)."""
    d_ex, l_ex = ex
    d_rt, l_rt = rt
    miss = np.zeros_like(l_ex, dtype=bool)
    for i in range(l_ex.shape[0]):
        miss[i] = (l_ex[i] >= 0) & ~np.isin(l_ex[i], l_rt[i])
    rows, cols = np.nonzero(miss)
    tie = d_ex[rows, cols] >= d_rt[rows, -1] - atol
    lab = torch.as_tensor(l_ex[rows, cols], device=lists.device)
    lst = lists[lab]
    probes, admitted = rt_probes
    r = torch.as_tensor(rows, device=lists.device)
    found = ((probes[r] == lst[:, None]) & admitted[r]).any(1).cpu().numpy()
    lost = torch.as_tensor(~tie & ~found, device=lists.device)
    owner, fallback = place
    sup = owner[lst[lost]]
    s_d = (q[r[lost]] @ rc.supers.T).mul_(-2.0).add_(rc.super_sqn)
    rank = (s_d < s_d.gather(1, sup[:, None])).sum(1)
    return {"missing": int(miss.sum()), "queries_missing": int(
                miss.any(1).sum()), "outranked": int(tie.sum()),
            "not_probed": int(lost.sum()),
            "admitted": int((~tie & found).sum()),
            "not_probed_fallback": int(fallback[lst[lost]].sum()),
            "not_probed_super_rank_median":
                float(rank.float().median()) if rank.numel() else None}


def result_overlaps(idx, queries: np.ndarray, nprobe: int, max_codes: int,
                    ws=(16, 32, 64), out=print) -> list:
    """ROADMAP Q2's measurement on an index with a routed structure
    (``enable_routed_coarse``): for each w of ``ws`` and w = n_super, the
    routed gate's top-k result overlap against the exact-coarse search,
    the probe overlap of the probes that routed search took, and
    :func:`result_gap`'s classes of the missing labels; first the count
    of centroids the partition placed by its fallback."""
    rc = idx._routed_coarse
    n = min(len(queries), 1024)
    q = queries[:n]
    ex = bench.result_search(idx, q, nprobe, max_codes, "exact")
    ex_p, _ = search_probes(idx, q, nprobe, max_codes, "exact")
    ex_p = ex_p.cpu().numpy()
    lists, atol = id_lists(idx), tie_atol(idx, q)
    q_t = torch.tensor(np.asarray(q, np.float32), device=idx.device)
    place = placement(rc)
    out(f"  routed structure: {rc.n_super} supers x cap {rc.cap}; "
        f"{int(place[1].sum())} of {rc.nc} centroids placed outside their "
        "8 nearest supers (all full)")
    keep, recs = idx.routed_w, []
    try:
        for w in (*ws, rc.n_super):
            idx.routed_w = w
            rt = bench.result_search(idx, q, nprobe, max_codes, "routed")
            rt_p = search_probes(idx, q, nprobe, max_codes, "routed")
            rec = {"w": w, "probe_overlap": overlap(rt_p[0].cpu().numpy(),
                                                    ex_p),
                   "result_overlap": bench.result_overlap(ex[1], rt[1]),
                   **result_gap(lists, ex, rt, rt_p, atol, q_t, rc,
                                place)}
            recs.append(rec)
            out(f"  result w={w}: probe overlap {rec['probe_overlap']:.4f}"
                f", top-{bench.RESULT_K} result overlap "
                f"{rec['result_overlap']:.4f}; missing {rec['missing']} "
                f"over {rec['queries_missing']} queries: "
                f"{rec['outranked']} outranked (atol {atol:.2e}), "
                f"{rec['not_probed']} in lists not admitted "
                f"({rec['not_probed_fallback']} of them in lists placed "
                f"outside their 8 nearest supers; median rank of the "
                f"holding super for the query "
                f"{rec['not_probed_super_rank_median']}), "
                f"{rec['admitted']} admitted")
    finally:
        idx.routed_w = keep
    return recs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m ivfhnsw_tpu_torch.tools.routed_tune",
        description="Probe overlap and marginal ms of routed coarse "
                    "selection over (n_super, cap_factor, w).")
    ap.add_argument("--stage", choices=tuple(STAGES), default="scale2")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("-B", type=int, default=256)
    ap.add_argument("--result-ws", default="",
                    help="comma list of w for the result overlap (none)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="bench.py's BENCH_SMOKE sizes (also BENCH_SMOKE=1)")
    a = ap.parse_args(argv)
    device = scale3.resolve_device(a.device)
    smoke = a.smoke or scale3.smoke()
    S, cache = bench.sizes(smoke), bench.cache_root(smoke)
    os.makedirs(cache, exist_ok=True)
    build, np_key, mc_key = STAGES[a.stage]
    with contextlib.redirect_stdout(sys.stderr):
        idx, queries, _, _ = build(S, device, cache)
    nprobe = S[np_key]
    B = min(a.B, queries.shape[0])
    q = torch.tensor(queries[:B], device=device)
    bench.log(f"stage={a.stage} nc={idx.nc} B={B} nprobe={nprobe}")
    exact_ms = marginal_ms(lambda qq: streaming_topk_l2(
        qq, idx.centroids, nprobe, block=idx._coarse_block_for(B),
        point_sqnorms=idx.centroid_norms)[0], q)
    print(f"exact sweep: {exact_ms:7.3f} ms ({exact_ms * 1e3 / B:6.2f} "
          "us/q)", flush=True)
    recs = sweep(idx, q, nprobe, CONFIGS[:QUICK] if a.quick else CONFIGS,
                 out=lambda m: print(m, flush=True))
    out = {"stage": a.stage, "nc": idx.nc, "B": B, "nprobe": nprobe,
           "device": bench.device_line(device), "exact_ms": exact_ms,
           "structures": recs}
    if a.result_ws:
        idx.enable_routed_coarse(
            generator=torch.Generator(device=device).manual_seed(SEED),
            cache_path=os.path.join(cache, a.stage, "routed.npz"))
        out["result_overlap"] = result_overlaps(
            idx, queries, nprobe, S[mc_key],
            [int(w) for w in a.result_ws.split(",")],
            out=lambda m: print(m, flush=True))
    print(json.dumps(out), flush=True)
    idx.release_device()
    return out


if __name__ == "__main__":
    main()
