"""Host-side data helpers and binary vector-file IO, bit-compatible with the
reference formats. Numpy copies of ``ivfhnsw_tpu/utils/io.py``'s functions,
kept in the port so that ``ivfhnsw_tpu_torch`` never imports the JAX
package. Where that module calls its native C++ helpers, these call the
port's bindings of the same helpers (``utils/native.py``: the xvec decode
of ``read_xvec_fvec``, the series writer and reader of the ``.index``
files), and take the per-record numpy path, with the same bytes, where
the library cannot be built.

The reference (its utils.h:59-127) uses two on-disk layouts:

- **xvec** (``.bvecs``/``.fvecs``/``.ivecs``): every record is
  ``[u32 dim | dim * sizeof(T) payload]``. ``readXvec`` checks that each
  record's dim prefix equals the expected d and exits on a mismatch; the
  readers here raise ``ValueError``.
- **length-prefixed vector** (``read_vector``/``write_vector``):
  ``[u32 count | count * sizeof(T) payload]``, the records of the ``.index``
  file.

``XvecFile`` serves the disk rerank's random-access gathers, ``get_files``
/ ``check_files`` / ``get_index_name`` the incremental-add driver's segment
files, ``random_subset`` and ``prefetch`` the build drivers.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator

import numpy as np

from ivfhnsw_tpu_torch.utils import native

# File extension -> payload dtype, as in the reference.
XVEC_DTYPES = {
    ".bvecs": np.uint8,
    ".fvecs": np.float32,
    ".ivecs": np.int32,
}


def _xvec_dtype(d: int, dtype) -> np.dtype:
    """Structured dtype of one xvec record: [u32 dim | d payload elements]."""
    return np.dtype([("dim", "<u4"), ("vec", np.dtype(dtype), (d,))])


def infer_xvec_dim(path: str, dtype) -> int:
    """The first record's dim prefix."""
    with open(path, "rb") as f:
        raw = f.read(4)
    if len(raw) < 4:
        raise ValueError(f"{path}: too short for an xvec file")
    return int(np.frombuffer(raw, dtype="<u4")[0])


def xvec_count(path: str, d: int, dtype) -> int:
    """Number of records in an xvec file; the file size must be an exact
    multiple of the record size (base_vec_num, reference utils.cpp:204-220)."""
    rec = _xvec_dtype(d, dtype).itemsize
    size = os.path.getsize(path)
    if size % rec != 0:
        raise ValueError(f"{path}: size {size} not a multiple of record "
                         f"size {rec}")
    return size // rec


def read_xvec(path: str, d: int, n: int | None = None, offset: int = 0,
              dtype=None, mmap: bool = False) -> np.ndarray:
    """n records of dimension d from record ``offset`` on (readXvec,
    reference utils.h:85-97): an [n, d] array of the payload dtype, which
    defaults by the file's extension."""
    if dtype is None:
        dtype = XVEC_DTYPES[os.path.splitext(path)[1]]
    rec = _xvec_dtype(d, dtype)
    total = xvec_count(path, d, dtype)
    if n is None:
        n = total - offset
    if offset + n > total:
        raise ValueError(f"{path}: requested records [{offset}, {offset + n}) "
                         f"but file has {total}")
    if mmap:
        m = np.memmap(path, dtype=rec, mode="r", offset=offset * rec.itemsize,
                      shape=(n,))
        dims, vecs = m["dim"], m["vec"]
    else:
        with open(path, "rb") as f:
            f.seek(offset * rec.itemsize)
            data = np.fromfile(f, dtype=rec, count=n)
        dims, vecs = data["dim"], data["vec"]
    if n > 0 and not (dims == d).all():
        bad = int(np.argmax(dims != d))
        raise ValueError(f"{path}: record {offset + bad} has dim {dims[bad]}, "
                         f"expected {d}")
    return vecs


def read_xvec_fvec(path: str, d: int, n: int | None = None, offset: int = 0,
                   dtype=None) -> np.ndarray:
    """readXvecFvec (reference utils.h:112-127): any xvec payload, promoted
    to float32, by the native decoder when it builds, else by numpy."""
    if dtype is None:
        dtype = XVEC_DTYPES[os.path.splitext(path)[1]]
    if n is None:
        n = xvec_count(path, d, dtype) - offset
    out = native.xvec_read_f32(path, d, n, offset, dtype)
    if out is not None:
        return out
    return read_xvec(path, d, n, offset, dtype=dtype).astype(np.float32)


def write_xvec(path_or_file, data: np.ndarray, append: bool = False) -> None:
    """writeXvec (reference utils.h:100-109): an [n, d] array with a u32 dim
    prefix per record."""
    data = np.ascontiguousarray(data)
    n, d = data.shape
    rec = np.empty(n, dtype=_xvec_dtype(d, data.dtype))
    rec["dim"] = d
    rec["vec"] = data
    if isinstance(path_or_file, (str, os.PathLike)):
        with open(path_or_file, "ab" if append else "wb") as f:
            rec.tofile(f)
    else:
        rec.tofile(path_or_file)


def iter_xvec_batches(path: str, d: int, batch: int, dtype=None,
                      limit: int | None = None) -> Iterator[np.ndarray]:
    """Stream an xvec file in batches of ``batch`` records (the add_batch
    loop pattern, test_ivfhnsw_sift1b.cpp:142-153), at most ``limit``
    records in all."""
    if dtype is None:
        dtype = XVEC_DTYPES[os.path.splitext(path)[1]]
    total = xvec_count(path, d, dtype)
    if limit is not None:
        total = min(total, limit)
    for off in range(0, total, batch):
        yield read_xvec(path, d, min(batch, total - off), off, dtype=dtype)


# ---------------------------------------------------------------------------
# Length-prefixed vectors (read_vector/write_vector, reference utils.h:59-81)
# ---------------------------------------------------------------------------

def write_len_vector(f, data: np.ndarray) -> None:
    """[u32 count | payload]; count is the element count, not bytes."""
    data = np.ascontiguousarray(data)
    f.write(np.asarray([data.size], dtype="<u4").tobytes())
    f.write(data.tobytes())


_SERIES_SLAB: np.ndarray | None = None


def _series_slab() -> np.ndarray:
    """The process's reusable interleave scratch (64 MB, touched once)."""
    global _SERIES_SLAB
    if _SERIES_SLAB is None:
        _SERIES_SLAB = np.empty(64 << 20, np.uint8)
    return _SERIES_SLAB


def write_len_series(f, payload: np.ndarray, counts: np.ndarray) -> None:
    """A series of length-prefixed vectors ([u32 count | payload]*) from a
    flat payload (the records concatenated in order) and the element count
    of each record (the reference's write loop, IndexIVF_HNSW.cpp:643-654,
    3 * nc records). The native interleaver fills one reused 64 MB slab
    at a time, as the JAX package's does (a record larger than the slab
    is written directly); without the library, :func:`write_len_records`.
    The bytes are the same either way."""
    flat = np.ascontiguousarray(payload).reshape(-1)
    counts = np.asarray(counts, np.int64)
    if not native.available():
        write_len_records(f, flat, counts)
        return
    esize = flat.dtype.itemsize
    slab = _series_slab()
    byte_cum = np.zeros(counts.size + 1, np.int64)
    np.cumsum(counts * esize + 4, out=byte_cum[1:])
    lo = 0
    while lo < counts.size:
        p_lo = (byte_cum[lo] - 4 * lo) // esize
        if byte_cum[lo + 1] - byte_cum[lo] > slab.size:
            write_len_vector(f, flat[p_lo:p_lo + int(counts[lo])])
            lo += 1
            continue
        hi = int(np.searchsorted(byte_cum, byte_cum[lo] + slab.size,
                                 side="right")) - 1
        p_hi = (byte_cum[hi] - 4 * hi) // esize
        f.write(memoryview(native.lenvec_interleave(
            flat[p_lo:p_hi], counts[lo:hi], esize, out=slab)))
        lo = hi


def write_len_records(f, payload: np.ndarray, counts: np.ndarray) -> None:
    """:func:`write_len_series` in numpy: write_len_vector once per
    record."""
    flat = np.ascontiguousarray(payload).reshape(-1)
    pos = 0
    for c in np.asarray(counts, np.int64):
        write_len_vector(f, flat[pos:pos + int(c)])
        pos += int(c)


def read_len_series(buf: np.ndarray, pos: int, n: int, dtype):
    """Parse n length-prefixed records ([u32 count | count * dtype]) from a
    u8 buffer at ``pos``: (flat payload (a copy), counts [n] int64, end
    position), by the native parser when it builds, else
    :func:`read_len_records`. Raises ValueError when the buffer ends
    inside a record."""
    out = native.lenvec_series(buf, pos, n, dtype)
    if out is not None:
        return out
    return read_len_records(buf, pos, n, dtype)


def read_len_records(buf: np.ndarray, pos: int, n: int, dtype):
    """:func:`read_len_series` in numpy, record by record."""
    dt = np.dtype(dtype)
    counts = np.empty(n, np.int64)
    parts = []
    for i in range(n):
        if pos + 4 > buf.size:
            raise ValueError(f"buffer ends before length-prefixed record {i} "
                             f"of {n}")
        c = int(buf[pos:pos + 4].view("<u4")[0])
        pos += 4
        if pos + c * dt.itemsize > buf.size:
            raise ValueError(f"length-prefixed record {i} of {n} holds {c} "
                             "entries, more than the buffer has left")
        counts[i] = c
        parts.append(buf[pos:pos + c * dt.itemsize])
        pos += c * dt.itemsize
    flat = np.concatenate(parts) if parts else np.empty(0, np.uint8)
    return flat.view(dt).copy(), counts, pos


def write_len_rows(f, rows: np.ndarray) -> None:
    """Each row of a fixed-width 2-D array as a length-prefixed vector:
    since every record has the same width, the interleaved stream is one
    [n, 4 + row_bytes] u8 array built with two assignments."""
    rows = np.ascontiguousarray(rows)
    n, w = rows.shape[0], int(np.prod(rows.shape[1:]))
    row_bytes = w * rows.dtype.itemsize
    out = np.empty((n, 4 + row_bytes), np.uint8)
    out[:, :4] = np.full(n, w, "<u4")[:, None].view(np.uint8)
    out[:, 4:] = rows.reshape(n, -1).view(np.uint8)
    out.tofile(f)


def read_len_rows(buf: np.ndarray, pos: int, n: int, w: int,
                  dtype) -> tuple[np.ndarray, int]:
    """Parse n fixed-width length-prefixed records ([u32 w | w * dtype])
    from a u8 buffer in one reshape; returns ([n, w] array (a copy), end
    position). Raises ValueError unless every count prefix equals w."""
    dt = np.dtype(dtype)
    rec = 4 + w * dt.itemsize
    if buf.size < pos + n * rec:
        raise ValueError("buffer ends inside a fixed-width length-prefixed "
                         "series")
    sect = buf[pos:pos + n * rec].reshape(n, rec)
    counts = sect[:, :4].copy().view("<u4")[:, 0]
    if not (counts == w).all():
        raise ValueError("fixed-width length-prefixed series has ragged "
                         "records")
    return sect[:, 4:].copy().view(dt).reshape(n, w), pos + n * rec


def read_len_vector(f, dtype) -> np.ndarray:
    """One [u32 count | count * dtype] record from an open file."""
    count = int(np.frombuffer(f.read(4), dtype="<u4")[0])
    dt = np.dtype(dtype)
    return np.frombuffer(f.read(count * dt.itemsize), dtype=dt)


def read_file_u8(path: str) -> np.ndarray:
    """Whole-file byte view for the index parser, mmap-backed; the parser
    copies every payload it keeps, so no kept array views the mapping."""
    import mmap
    if os.path.getsize(path) == 0:
        return np.empty(0, np.uint8)
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
    return np.frombuffer(mm, np.uint8)


def write_variable(f, value, dtype) -> None:
    """write_variable (reference utils.h:69-71): one POD value."""
    f.write(np.asarray([value], dtype=dtype).tobytes())


def read_variable(f, dtype):
    dt = np.dtype(dtype)
    return np.frombuffer(f.read(dt.itemsize), dtype=dt)[0]


# ---------------------------------------------------------------------------
# Random-access single-record reads (readBaseVec/readCentroidVec, reference
# utils.cpp:96-139), used by the disk-rerank path.
# ---------------------------------------------------------------------------

class XvecFile:
    """Random-access view over an xvec file for exact-rerank gathers
    (searchDisk, IndexIVF_HNSW_Grouping.cpp:365-395)."""

    def __init__(self, path: str, d: int, dtype=None):
        self.path = path
        self.d = d
        self.dtype = (XVEC_DTYPES[os.path.splitext(path)[1]] if dtype is None
                      else dtype)
        self._rec = _xvec_dtype(d, self.dtype)
        self.n = xvec_count(path, d, self.dtype)
        self._mm = np.memmap(path, dtype=self._rec, mode="r")

    def __len__(self) -> int:
        return self.n

    def gather(self, indices: np.ndarray) -> np.ndarray:
        """Rows by id -> [len(indices), d] float32."""
        rows = self._mm["vec"][np.asarray(indices, dtype=np.int64)]
        return rows.astype(np.float32)


# ---------------------------------------------------------------------------
# Segment-file discovery for the incremental-add pipeline
# (get_files/check_files/get_index_name/base_vec_num, reference
# utils.cpp:204-276)
# ---------------------------------------------------------------------------

def base_vec_num(path: str, d: int, dtype=np.uint8) -> int:
    """Record count of an xvec file whose size is an exact multiple of the
    record size (base_vec_num, reference utils.cpp:204-220)."""
    return xvec_count(path, d, dtype)


def get_files(path_dir: str, file_ext: str) -> list[str]:
    """Sorted filenames in path_dir whose name contains file_ext (and is not
    exactly file_ext): get_files/is_ext_match, reference utils.cpp:222-262."""
    return sorted(f for f in os.listdir(path_dir)
                  if file_ext in f and f != file_ext)


def check_files(file_prefix: str, file_list: list[str]) -> None:
    """Every file must start with file_prefix (check_files, reference
    utils.cpp:264-271)."""
    for f in file_list:
        if not f.startswith(file_prefix):
            raise ValueError(f"segment file {f!r} does not start with "
                             f"prefix {file_prefix!r}")


def get_index_name(path_idx: str, idx: int) -> str:
    """'{path}_NN.index' segment index naming (get_index_name, reference
    utils.cpp:273-275)."""
    return f"{path_idx}_{idx:02d}.index"


# ---------------------------------------------------------------------------
# Driver helpers
# ---------------------------------------------------------------------------

def prefetch(iterable, depth: int = 2):
    """Run a batch iterator in a background thread, keeping up to ``depth``
    items ahead of the consumer, so host-side batch production overlaps the
    device work on the previous batch. Exceptions in the producer propagate
    to the consumer at the point of the failed item; abandoning the
    generator (break / GC) stops the producer thread promptly."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    DONE = object()

    def put_stoppable(item) -> bool:
        """Stop-aware put; returns False if the consumer went away first
        (otherwise a full queue would pin this thread + its buffers forever)."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterable:
                if not put_stoppable(item):
                    return
            put_stoppable(DONE)
        except BaseException as e:  # forwarded, re-raised consumer-side
            put_stoppable(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def random_subset(data: np.ndarray, n_sub: int, seed: int = 1234) -> np.ndarray:
    """random_subset equivalent (utils.cpp:12-20): sample n_sub rows without
    replacement with a fixed default seed of 1234."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(data.shape[0])[:n_sub]
    return np.ascontiguousarray(data[idx])
