"""faiss-binary-compatible IO for trained quantizer artifacts. A copy of
``ivfhnsw_tpu/utils/faiss_io.py`` (numpy only), kept in the port so that
``ivfhnsw_tpu_torch`` never imports the JAX package.

The reference loads and saves its quantizers in faiss's on-disk format
(``faiss::read/write_ProductQuantizer``, ``faiss::read/write_VectorTransform``
in its tests/test_ivfhnsw_sift1b.cpp:57-89), so ``.pq``, ``_norm.pq`` and
``_matrix.opq`` artifacts interchange with the reference only in that
format. Byte layout (faiss impl/index_write.cpp):

ProductQuantizer (write_ProductQuantizer):
    u64 d | u64 M | u64 nbits | u64 count | count * f32 centroids
  where count = M * ksub * dsub (ksub = 2^nbits, dsub = d/M) and centroids
  are laid out [M, ksub, dsub] row-major, the codebook layout of
  ``ops/pq.py``. The reference's norm quantizer is ProductQuantizer(1, 1, 8):
  d=M=1, nbits=8, 256 centroids.

VectorTransform (write_VectorTransform), for LinearTransform subclasses
(faiss::OPQMatrix is written as a generic LinearTransform):
    fourcc ("LTra" generic | "rrot" RandomRotation | "PcAm" PCA)
    ["PcAm" only: f32 eigen_power | u8 random_rotation]
    u8 have_bias | u64 countA | countA * f32 A | u64 countB | countB * f32 b
    i32 d_in | i32 d_out | u8 is_trained
  A is row-major [d_out, d_in], applied as y = A @ x, which is
  ``apply_rotation(x, R) = x @ R.T`` with A == R.

All integers little-endian.
"""

from __future__ import annotations

import numpy as np

FOURCC_LTRA = int.from_bytes(b"LTra", "little")
FOURCC_RROT = int.from_bytes(b"rrot", "little")
FOURCC_PCAM = int.from_bytes(b"PcAm", "little")
_VT_FOURCCS = (FOURCC_LTRA, FOURCC_RROT, FOURCC_PCAM)


def write_product_quantizer(path: str, codebooks) -> None:
    """codebooks [M, ksub, dsub] -> faiss write_ProductQuantizer layout."""
    cb = np.asarray(codebooks, "<f4")
    M, ksub, dsub = cb.shape
    nbits = int(ksub).bit_length() - 1
    if 1 << nbits != ksub:
        raise ValueError(f"ksub={ksub} is not a power of two")
    with open(path, "wb") as f:
        np.asarray([M * dsub, M, nbits, cb.size], "<u8").tofile(f)
        cb.tofile(f)


def read_product_quantizer(path: str) -> np.ndarray:
    """Returns codebooks [M, ksub, dsub] float32."""
    buf = np.fromfile(path, np.uint8)
    d, M, nbits, count = (int(v) for v in buf[:32].view("<u8"))
    ksub, dsub = 1 << nbits, d // M
    if count != M * ksub * dsub:
        raise ValueError(
            f"corrupt faiss PQ file: count={count} != M*ksub*dsub="
            f"{M * ksub * dsub}")
    cb = buf[32:32 + 4 * count].view("<f4").reshape(M, ksub, dsub)
    return cb.copy()


def is_faiss_pq(path: str) -> bool:
    """Sniff: faiss PQ starts with u64 d, so for any d < 2^32 the second u32
    is zero, while the legacy format starts [u32 d | u32 M | ...] with
    M > 0."""
    head = np.fromfile(path, "<u4", 2)
    return head.size == 2 and head[1] == 0


def write_linear_transform(path: str, A, b=None,
                           is_trained: bool = True) -> None:
    """A [d_out, d_in] row-major (y = A @ x) -> faiss write_VectorTransform
    (the generic LinearTransform fourcc, which is what faiss::OPQMatrix
    gets)."""
    A = np.asarray(A, "<f4")
    d_out, d_in = A.shape
    b = np.asarray(b, "<f4") if b is not None else np.zeros(0, "<f4")
    with open(path, "wb") as f:
        np.asarray([FOURCC_LTRA], "<u4").tofile(f)
        np.asarray([1 if b.size else 0], "u1").tofile(f)   # have_bias
        np.asarray([A.size], "<u8").tofile(f)
        A.tofile(f)
        np.asarray([b.size], "<u8").tofile(f)
        b.tofile(f)
        np.asarray([d_in, d_out], "<i4").tofile(f)
        np.asarray([1 if is_trained else 0], "u1").tofile(f)


def read_vector_transform(path: str):
    """Returns (A [d_out, d_in] f32, b or None). Accepts the generic
    LinearTransform ("LTra"), RandomRotationMatrix ("rrot") and PCAMatrix
    ("PcAm") records, which all store the same (have_bias, A, b) payload
    after their subclass fields."""
    buf = np.fromfile(path, np.uint8)
    pos = 0

    def take(dtype, count):
        nonlocal pos
        dt = np.dtype(dtype)
        out = buf[pos:pos + dt.itemsize * count].view(dt)
        pos += dt.itemsize * count
        return out

    h = int(take("<u4", 1)[0])
    if h not in _VT_FOURCCS:
        raise ValueError(f"not a faiss VectorTransform file (fourcc={h:#x})")
    if h == FOURCC_PCAM:
        take("<f4", 1)   # eigen_power
        take("u1", 1)    # random_rotation
    have_bias = int(take("u1", 1)[0])
    nA = int(take("<u8", 1)[0])
    A = take("<f4", nA).copy()
    nB = int(take("<u8", 1)[0])
    b = take("<f4", nB).copy() if nB else None
    d_in = int(take("<i4", 1)[0])
    d_out = int(take("<i4", 1)[0])
    take("u1", 1)        # is_trained
    if nA != d_in * d_out:
        raise ValueError(f"corrupt transform: |A|={nA} != {d_in}*{d_out}")
    return A.reshape(d_out, d_in), (b if have_bias else None)


def is_faiss_vector_transform(path: str) -> bool:
    head = np.fromfile(path, "<u4", 1)
    return head.size == 1 and int(head[0]) in _VT_FOURCCS
