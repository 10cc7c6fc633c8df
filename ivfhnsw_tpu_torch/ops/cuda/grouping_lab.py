"""The grouping scan lab: the design steps of the grouping scan kernel, each
as a kernel of its own (``csrc/grouping_lab.cu``, instantiations of the
kernel template ``csrc/grouping_scan.cuh``), so that one run on one card
can time them against each other (``tools/grouping_probe.py``).

Every variant computes the function of ``grouping_scan_slots`` (the TPU
kernels K5 / K6, ``ivfhnsw_tpu/ops/pallas/grouping_scan.py:113`` and
``:248``) with the same summation order, so each is ``torch.equal`` to
``grouping_scan_slots_plain``. The search engine runs none of them: it runs
``csrc/grouping_scan.cu``, which is the ``fill_stream_skip`` instantiation.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ivfhnsw_tpu_torch.ops.cuda import grouping_scan as gs

# name -> the variant number that csrc/grouping_lab.cu switches on
VARIANTS = {
    # the kernel as first ported: every lane of every slot through the lane
    # loop, default-policy 4-byte stores, pruned lanes summed in full
    "direct": 0,
    # padding out of the lane loop: runs of empty slots and slot tails are
    # 16-byte fills by all threads
    "fill": 1,
    # ... and every output store streaming (st.global.cs)
    "fill_stream": 2,
    # ... and a lane of a pruned subgroup skips its code row and lookups
    "fill_stream_skip": 3,
    # ... and the block's schedule staged in shared memory
    "staged": 4,
    # the first port with the pruned-lane shortcut alone
    "skip": 5,
    # fill_stream_skip with the runs of empty slots written by the copy
    # engine (TMA bulk copies from 8 KB of +inf in shared memory)
    "bulk": 6,
    # two passes: the tables asked for with asynchronous copies, all
    # padding written while they arrive (one flat loop over staged slot
    # lengths), then the filled lanes of the non-empty slots
    "overlap": 7,
}
ENGINE_VARIANT = "fill_stream_skip"   # what csrc/grouping_scan.cu instantiates
LAUNCHES = {name: 0 for name in VARIANTS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _entry():
    from ivfhnsw_tpu_torch.ops.cuda.build import load_library
    fn = load_library("grouping_lab").ivf_grouping_lab
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def extra_smem_bytes(variant: str, nslots: int) -> int:
    """Shared memory a variant adds to the tables': ``staged`` the schedule
    at 20 B a slot, ``overlap`` the slot lengths and one bit per slot; up
    to 4 B more align them."""
    if variant == "staged":
        return nslots * 20 + 4
    if variant == "overlap":
        return nslots * 4 + -(-nslots // 32) * 4 + 4
    return 0


def grouping_lab_scan(variant: str, lut: torch.Tensor, norm_tab: torch.Tensor,
                      t2: torch.Tensor, codes: torch.Tensor,
                      norm_codes: torch.Tensor, subc: torch.Tensor,
                      start: torch.Tensor, length: torch.Tensor,
                      bias: torch.Tensor, seg: torch.Tensor,
                      gran: int) -> torch.Tensor:
    """Lab variant ``variant`` of the grouping scan: arguments, result and
    device rule of ``grouping_scan.grouping_scan_slots`` (CPU tensors go to
    the plain version; CUDA tensors launch the variant's kernel or raise).
    ``LAUNCHES[variant]`` counts kernel launches."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown grouping lab variant {variant!r}; "
                         f"expected one of {sorted(VARIANTS)}")
    fn = f"grouping_lab_scan[{variant}]"
    args = (lut, norm_tab, t2, codes, norm_codes, subc, start, length, bias,
            seg)
    dims = gs.check_scan_args(
        fn, *args, gran, extra_smem=extra_smem_bytes(variant, start.shape[1]))
    if lut.device.type == "cpu":
        return gs.grouping_scan_slots_plain(*args, gran)
    out = torch.empty((dims[0], dims[1] * gran), dtype=torch.float32,
                      device=lut.device)
    gs.launch_scan(fn, _entry(), args, (out,), dims, gran, VARIANTS[variant])
    LAUNCHES[variant] += 1
    return out
