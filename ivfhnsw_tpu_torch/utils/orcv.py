"""ORCV persistent-index home dir (the reference fork's orcv.h:11-22 and
write2, IndexIVF_HNSW.cpp:672-755). Counterpart of
``ivfhnsw_tpu/utils/orcv.py``.

``OrcvHeader`` is the C struct written to hdr.vec: seven uint32 fields, two
floats, one uint8 do_opq flag, padded to the struct's 40 bytes (alignment
4). dmatch=4444.0 / dnear=8888.0 are the defaults of IndexIVF_HNSW.h:90-91.
``IVFADCIndex.write2`` writes a home dir; :func:`load_home_dir` reads one.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np
import torch

_FMT = "<7I2fB3x"  # 7*u32, 2*f32, u8, 3 pad bytes -> 40 bytes
assert struct.calcsize(_FMT) == 40


@dataclass
class OrcvHeader:
    n: int = 0
    nc: int = 0
    code_size: int = 0
    code_bytes: int = 0
    d: int = 0
    M: int = 16
    efConstruction: int = 500
    dmatch: float = 4444.0
    dnear: float = 8888.0
    do_opq: int = 0

    def pack(self) -> bytes:
        return struct.pack(_FMT, self.n, self.nc, self.code_size,
                           self.code_bytes, self.d, self.M,
                           self.efConstruction, self.dmatch, self.dnear,
                           self.do_opq)

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.pack())

    @classmethod
    def read(cls, path: str) -> "OrcvHeader":
        with open(path, "rb") as f:
            vals = struct.unpack(_FMT, f.read(40))
        return cls(*vals)


def load_home_dir(home_dir: str, device, centroids_path: str = ""):
    """An ``IVFADCIndex`` on ``device`` from an ORCV home dir, and its
    header. The dir holds the first nc code / norm-code lists and the
    centroid norms, not the PQ codebooks (separate ``.pq`` files) nor the
    ids: the caller installs centroids (``centroids_path``, the external
    k-means file, or ``set_centroids``) and quantizers, and the ids are the
    insertion order (0 .. n-1 in list order), so a label maps to the
    original index's id through that index's ``store.ids``."""
    from ivfhnsw_tpu_torch.models.ivfadc import IVFADCIndex
    from ivfhnsw_tpu_torch.utils import io
    from ivfhnsw_tpu_torch.utils.config import IndexConfig

    hdr = OrcvHeader.read(os.path.join(home_dir, "hdr.vec"))
    cfg = IndexConfig(d=hdr.d, nc=hdr.nc, code_size=hdr.code_size,
                      do_opq=bool(hdr.do_opq), M=hdr.M,
                      efConstruction=hdr.efConstruction)
    index = IVFADCIndex(cfg, device)
    index.dmatch, index.dnear = hdr.dmatch, hdr.dnear
    if centroids_path:
        index.load_centroids(centroids_path)
    codes, counts, _ = io.read_len_series(
        io.read_file_u8(os.path.join(home_dir, "pq.vec")), 0, hdr.nc, "u1")
    norm_codes, _, _ = io.read_len_series(
        io.read_file_u8(os.path.join(home_dir, "normpq.vec")), 0, hdr.nc,
        "u1")
    with open(os.path.join(home_dir, "cnorms.vec"), "rb") as f:
        cnorms = io.read_len_vector(f, "<f4")
    offsets = np.zeros(hdr.nc + 1, np.int64)
    np.cumsum(counts // cfg.pq_m, out=offsets[1:])
    index._seed_builder(codes.reshape(-1, cfg.pq_m),
                        np.arange(offsets[-1], dtype=np.int32), norm_codes,
                        offsets)
    index.finalize()
    if cnorms.size == hdr.nc:
        index.centroid_norms = torch.tensor(cnorms.copy(), device=index.device)
    return index, hdr
