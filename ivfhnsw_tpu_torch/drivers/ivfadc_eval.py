"""IVFADC end-to-end build + eval driver on PyTorch. Counterpart of
``ivfhnsw_tpu/drivers/ivfadc_eval.py`` (the reference's test_ivfhnsw_sift1b
and test_ivfhnsw_deep1b, which differ only in the base file's element type,
read here by its extension). The JAX driver's -orca_obuf branch (add_batch2)
waits for the ORCV format.

Usage (reference ``-flag value`` grammar, plus -synthetic and -device,
which defaults to cuda; -device cpu runs the kernels' plain versions):
    python -m ivfhnsw_tpu_torch.drivers.ivfadc_eval -d 128 -nc 16384 \\
        -path_base b.bvecs -path_learn l.bvecs -path_q q.bvecs \\
        -path_gt gt.ivecs -path_centroids c.fvecs -path_pq x.pq \\
        -path_norm_pq x.norm_pq -path_precomputed_idxs idxs.ivecs \\
        -path_index x.index -nb 1000000000 -nt 10000000 -nq 10000 \\
        -ngt 1000 -nprobe 32 -max_codes 10000 -k 10
    python -m ivfhnsw_tpu_torch.drivers.ivfadc_eval -synthetic 0 \\
        -d 128 -nc 4096 -code_size 16 -nb 2000000 -nt 200000 -nq 8192 \\
        -nprobe 32 -max_codes 10000 -k 10
Every -path_* artifact that exists is loaded; one that does not is computed
and written, so a second run resumes from the first one's files.
"""

from __future__ import annotations

from ivfhnsw_tpu_torch.drivers import common as C
from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex


def build(cfg, extras):
    """The build stages of the IVFADC drivers; returns (index, dataset,
    stage record of ``common.build_pipeline``)."""
    device, ds = C.driver_setup(cfg, extras)
    index = IVFADCIndex(cfg.index, device)
    return index, ds, C.build_pipeline(index, cfg, ds)


def main(argv=None) -> dict:
    """Returns ``common.eval_search``'s record plus "stages" (the build's
    stage record), "index" and "dataset"."""
    cfg, extras = C.parse_driver_args(("synthetic", "device"), argv)
    index, ds, stages = build(cfg, extras)
    return {**C.eval_search(index, cfg, ds), "stages": stages,
            "index": index, "dataset": ds}


if __name__ == "__main__":
    main()
