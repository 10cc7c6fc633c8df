"""Build-only driver with the ORCV export on PyTorch. Counterpart of
``ivfhnsw_tpu/drivers/mkindex.py`` (the reference's tests/mkindex.cpp:187,
195): the grouping build of ``grouping_eval`` (every -path_* artifact that
exists is loaded, the rest computed and written), no query evaluation; the
inter-centroid distances dumped to ``centriods.log`` (the reference's
spelling) in the working directory, and with -orcv_home DIR the ORCV home
dir written there by ``write2``.

Usage (the grouping_eval flags, plus -orcv_home; -device defaults to cuda):
    python -m ivfhnsw_tpu_torch.drivers.mkindex -synthetic 0 -device cpu \\
        -d 32 -nc 32 -code_size 8 -nsubc 8 -nb 8000 -nt 3000 -nq 100 \\
        -orcv_home ORCV
"""

from __future__ import annotations

from ivfhnsw_tpu_torch.drivers import common as C
from ivfhnsw_tpu_torch.drivers.grouping_eval import build

LOG = "centriods.log"


def main(argv=None) -> dict:
    """Returns {"index", "dataset", "stages"} (the build's stage record)."""
    cfg, extras = C.parse_driver_args(("synthetic", "device", "orcv_home"),
                                      argv)
    index, ds, stages = build(cfg, extras)
    index.dump_inter_centroid_dists(LOG)
    C.log(f"wrote {LOG}")
    if "orcv_home" in extras:
        index.write2(extras["orcv_home"], n_vecs=index.store.ntotal)
        C.log(f"ORCV export -> {extras['orcv_home']}")
    return {"index": index, "dataset": ds, "stages": stages}


if __name__ == "__main__":
    main()
