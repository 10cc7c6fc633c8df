"""Miss-diagnosis driver on PyTorch. Counterpart of
``ivfhnsw_tpu/drivers/orca_debug.py`` (the reference's
test_ivfhnsw_sift1b_orca, tests/test_ivfhnsw_sift1b_orca.cpp:281-296, and
test_ivfhnsw_grouping_sift1b_orca.cpp:236-308; a grouping index when
-nsubc > 0): build or load the index as the eval drivers do, search every
query with ``trace=True``, append each query's probes and their distances
to ``centroids_hit.log`` / ``centroids_miss.log`` in the working directory
(trace_centroids, IndexIVF_HNSW.cpp:298-326), then, for the first query
whose true nearest neighbour is missed, log
  - the centroid the true answer is assigned to,
  - whether that centroid was probed, at what rank and distance, and
    whether the max_codes budget included it,
  - the exact distance of the true answer beside the returned top-1 ADC
    distance,
  - the ENN self-search (``search_enn``) of the true answer's vector.
The true answer's vector comes from the synthetic corpus or, for a
file-backed one, from ``-path_base``.

Usage: the flags of ``ivfadc_eval`` / ``grouping_eval`` (-device defaults
to cuda; -device cpu runs the kernels' plain versions).
"""

from __future__ import annotations

import numpy as np

from ivfhnsw_tpu_torch.drivers import common as C
from ivfhnsw_tpu_torch.models.grouping import IVFADCGroupingIndex
from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex
from ivfhnsw_tpu_torch.utils import io
from ivfhnsw_tpu_torch.utils.config import SearchParams

HIT_LOG, MISS_LOG = "centroids_hit.log", "centroids_miss.log"


def base_vector(ds, cfg, t: int) -> np.ndarray:
    """Base vector ``t`` [d] f32 of the dataset."""
    if isinstance(ds, C.SyntheticDataset):
        return ds.base[t]
    return io.XvecFile(cfg.path_base, cfg.index.d).gather(np.asarray([t]))[0]


def write_trace_logs(trace: dict, hits: np.ndarray) -> None:
    """One block per query, "query i:" then "c: <centroid> d: <distance>"
    per probe, appended to the hit or the miss log."""
    with open(HIT_LOG, "a") as fh, open(MISS_LOG, "a") as fm:
        for qi in range(hits.shape[0]):
            f = fh if hits[qi] else fm
            f.write(f"query {qi}:\n")
            for c, d in zip(trace["probes"][qi], trace["qc_dists"][qi]):
                f.write(f"c: {c} d: {d}\n")


def main(argv=None) -> dict | None:
    """Returns {"query", "true_nn", "answer_centroid"} of the first miss,
    or None when every query finds its true nearest neighbour."""
    cfg, extras = C.parse_driver_args(("synthetic", "device"), argv)
    device, ds = C.driver_setup(cfg, extras)
    grouping = cfg.index.nsubc > 0
    index = (IVFADCGroupingIndex if grouping else IVFADCIndex)(cfg.index,
                                                               device)
    idxs = C.build_pipeline(index, cfg, ds, grouping=grouping)["assignments"]

    p = cfg.search
    params = SearchParams(k=p.k, nprobe=p.nprobe, max_codes=p.max_codes)
    dists, labels, trace = index.search(ds.queries, params, trace=True)
    true_nn = ds.gt[:, 0]
    hits = (labels == true_nn[:, None]).any(axis=1)
    write_trace_logs(trace, hits)

    if hits.all():
        C.log("no missed queries: nothing to diagnose")
        return None
    qi = int(np.argmax(~hits))
    t = int(true_nn[qi])
    C.log(f"first miss: query {qi}, true NN id {t}")
    ans_centroid = int(idxs[t])
    C.log(f"true answer assigned to centroid {ans_centroid}")
    where = np.nonzero(trace["probes"][qi] == ans_centroid)[0]
    if where.size:
        r = int(where[0])
        C.log(f"centroid WAS probed at rank {r} "
              f"(dist {trace['qc_dists'][qi][r]:.3f}, "
              f"included={bool(trace['included'][qi][r])}): "
              "ADC ranking dropped the answer")
    else:
        C.log(f"centroid NOT probed (nprobe={params.nprobe} too small or "
              "coarse ranking off)")
    x = base_vector(ds, cfg, t)
    exact = float(((x - ds.queries[qi]) ** 2).sum())
    C.log(f"exact distance of true answer: {exact:.3f}; "
          f"returned top-1 ADC dist: {dists[qi, 0]:.3f}")
    _, el = index.search_enn(x[None])
    C.log(f"ENN self-search of true answer: id {int(el[0])} "
          f"(self={'yes' if int(el[0]) == t else 'NO'})")
    return {"query": qi, "true_nn": t, "answer_centroid": ans_centroid}


if __name__ == "__main__":
    main()
