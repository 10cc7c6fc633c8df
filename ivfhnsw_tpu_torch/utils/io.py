"""Host-side data helpers and binary vector-file IO, bit-compatible with the
reference formats. Numpy copies of ``ivfhnsw_tpu/utils/io.py``'s functions,
kept in the port so that ``ivfhnsw_tpu_torch`` never imports the JAX
package; where that module calls its native C++ helpers when they are
built, these take its per-record numpy path.

The reference (its utils.h:59-127) uses two on-disk layouts:

- **xvec** (``.bvecs``/``.fvecs``/``.ivecs``): every record is
  ``[u32 dim | dim * sizeof(T) payload]``. ``readXvec`` checks that each
  record's dim prefix equals the expected d and exits on a mismatch; the
  readers here raise ``ValueError``.
- **length-prefixed vector** (``read_vector``/``write_vector``):
  ``[u32 count | count * sizeof(T) payload]``, the records of the ``.index``
  file.

``random_subset`` and ``prefetch`` serve the build drivers.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

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
    to float32."""
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


# ---------------------------------------------------------------------------
# Length-prefixed vectors (read_vector/write_vector, reference utils.h:59-81)
# ---------------------------------------------------------------------------

def write_len_vector(f, data: np.ndarray) -> None:
    """[u32 count | payload]; count is the element count, not bytes."""
    data = np.ascontiguousarray(data)
    f.write(np.asarray([data.size], dtype="<u4").tobytes())
    f.write(data.tobytes())


def write_len_series(f, payload: np.ndarray, counts: np.ndarray) -> None:
    """A series of length-prefixed vectors ([u32 count | payload]*) from a
    flat payload (the records concatenated in order) and the element count
    of each record: write_len_vector once per record."""
    flat = np.ascontiguousarray(payload).reshape(-1)
    pos = 0
    for c in np.asarray(counts, np.int64):
        write_len_vector(f, flat[pos:pos + int(c)])
        pos += int(c)


def read_len_series(buf: np.ndarray, pos: int, n: int, dtype):
    """Parse n length-prefixed records ([u32 count | count * dtype]) from a
    u8 buffer at ``pos``, record by record. Returns (flat payload (a copy),
    counts [n] int64, end position)."""
    dt = np.dtype(dtype)
    counts = np.empty(n, np.int64)
    parts = []
    for i in range(n):
        c = int(buf[pos:pos + 4].view("<u4")[0])
        pos += 4
        counts[i] = c
        parts.append(buf[pos:pos + c * dt.itemsize])
        pos += c * dt.itemsize
    flat = np.concatenate(parts) if parts else np.empty(0, np.uint8)
    return flat.view(dt).copy(), counts, pos


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
