"""Split a base xvec file (and optionally its precomputed-idx file) into
equal segments for ``drivers/vector_add.py -segment_dir``. Counterpart of
the JAX package's ``tools/vector_split.py`` (after the reference's
tools/vector_split.cpp:100-228, which allows 10, 20 or 50 segments,
:258-263; here any count >= 1), with the same output bytes.

Segment i of ``stem.ext`` is ``stem_{i:02d}.ext`` in ``-out_dir`` (default:
the base file's directory); the idx file's entries are written again as one
[u32 n | n x u32] record per segment. Nothing here touches a device.

Usage:
    python -m ivfhnsw_tpu_torch.tools.vector_split -path_base b.bvecs \\
        -d 128 -segments 10 [-path_precomputed_idxs idxs.ivecs] \\
        [-out_dir DIR]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ivfhnsw_tpu_torch.drivers.common import read_assignments
from ivfhnsw_tpu_torch.utils import io


def split(path_base: str, d: int, segments: int, out_dir: str = "",
          path_idxs: str = "") -> list:
    """Write the segments; returns the paths written, base segments first,
    then idx segments."""
    out_dir = out_dir or os.path.dirname(path_base) or "."
    os.makedirs(out_dir, exist_ok=True)
    stem, ext = os.path.splitext(os.path.basename(path_base))
    dtype = io.XVEC_DTYPES[ext]
    total = io.xvec_count(path_base, d, dtype)
    per = -(-total // segments)
    print(f"{total} vectors -> {segments} segments of <= {per}", flush=True)
    bounds = [(off, min(per, total - off))
              for off in range(0, per * segments, per) if total - off > 0]
    written = []
    for i, (off, n) in enumerate(bounds):
        out = os.path.join(out_dir, f"{stem}_{i:02d}{ext}")
        io.write_xvec(out, io.read_xvec(path_base, d, n, off, dtype=dtype))
        print(f"wrote {out} ({n} vectors)", flush=True)
        written.append(out)
    if path_idxs:
        idxs = read_assignments(path_idxs).astype("<u4")
        istem, iext = os.path.splitext(os.path.basename(path_idxs))
        for i, (off, n) in enumerate(bounds):
            blk = idxs[off:off + n]
            out = os.path.join(out_dir, f"{istem}_{i:02d}{iext}")
            with open(out, "wb") as f:
                np.asarray([blk.size], "<u4").tofile(f)
                blk.tofile(f)
            print(f"wrote {out} ({n} idxs)", flush=True)
            written.append(out)
    return written


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("-path_base", required=True)
    ap.add_argument("-path_precomputed_idxs", default="")
    ap.add_argument("-d", type=int, required=True)
    ap.add_argument("-segments", type=int, default=10)
    ap.add_argument("-out_dir", default="")
    args = ap.parse_args(argv)
    return split(args.path_base, args.d, args.segments, args.out_dir,
                 args.path_precomputed_idxs)


if __name__ == "__main__":
    main()
