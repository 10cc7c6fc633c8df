"""Exact assignment's distance epilogue and running minimum around the
hand-written kernel ``csrc/assign_min.cu``.

:func:`top1_update` folds one score block ``ip = queries @ points[s:s+C].T``
into a running top-1: it forms ``(-2 * ip + ||q||^2) + ||p||^2`` in f32,
reduces each row to its minimum (the first index among equal distances) and
keeps it where strictly nearer than the running best, so an earlier block
wins a tie. ``ops/distances.py::streaming_topk_l2`` calls it once per block
at k=1, so every exact top-1 sweep (assignment, the Lloyd passes, the
in-stream ground truth) runs through the kernel on the card.

It replaces no Pallas kernel but XLA's fusion of the JAX package's
``streaming_topk_l2`` step at k=1 (``ivfhnsw_tpu/ops/distances.py:115-136``):
the four passes the port made over every score block (``mul_``, two
``add_``, ``min``) become one read of it. The GEMM stays ``torch.matmul``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ivfhnsw_tpu_torch.ops.cuda.build import check_arg


def top1_update_plain(ip: torch.Tensor, q_sqnorm: torch.Tensor,
                      p_sqnorm: torch.Tensor, best_d: torch.Tensor,
                      best_i: torch.Tensor, offset: int) -> None:
    """Plain-torch version of the kernel: ``d = ip * -2 + q_sqnorm[:, None]
    + p_sqnorm[None, :]`` (each step rounded in f32, in that order), its row
    minimum and first index (``torch.min``), and ``(best_d, best_i) = (d_min,
    offset + j)`` in place where ``d_min < best_d``. ``ip`` is not
    changed."""
    d = ip.mul(-2.0).add_(q_sqnorm[:, None]).add_(p_sqnorm[None, :])
    blk_d, blk_j = d.min(dim=1)
    better = blk_d < best_d
    best_d.copy_(torch.where(better, blk_d, best_d))
    best_i.copy_(torch.where(better, blk_j + offset, best_i))


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of ``csrc/assign_min.cu`` (built at first use):
    5 pointers, B, C, the offset, the stream; returns a CUDA error code."""
    from ivfhnsw_tpu_torch.ops.cuda.build import load_library
    fn = load_library("assign_min").ivf_top1_update
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def top1_update(ip: torch.Tensor, q_sqnorm: torch.Tensor,
                p_sqnorm: torch.Tensor, best_d: torch.Tensor,
                best_i: torch.Tensor, offset: int) -> None:
    """Fold the score block ``ip`` [B, C] f32 (contiguous) into the running
    top-1 ``best_d`` [B] f32 / ``best_i`` [B] int64, in place (see
    :func:`top1_update_plain` for the function); ``q_sqnorm`` [B],
    ``p_sqnorm`` [C] (the block's slice), ``offset`` the block's first
    point id.

    CPU tensors go to the plain version. CUDA tensors launch the kernel on
    the current stream, or raise: there is no fallback. ``launches`` counts
    kernel launches."""
    fn = "top1_update"
    B, C = ip.shape
    dev = ip.device
    check_arg("ip", ip, torch.float32, (B, C), dev, fn)
    check_arg("q_sqnorm", q_sqnorm, torch.float32, (B,), dev, fn)
    check_arg("p_sqnorm", p_sqnorm, torch.float32, (C,), dev, fn)
    check_arg("best_d", best_d, torch.float32, (B,), dev, fn)
    check_arg("best_i", best_i, torch.int64, (B,), dev, fn)
    if max(B, C) >= 2 ** 31:
        raise ValueError(f"{fn}: unsupported sizes B={B} C={C}")
    if dev.type == "cpu":
        return top1_update_plain(ip, q_sqnorm, p_sqnorm, best_d, best_i,
                                 offset)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")
    if B == 0 or C == 0:
        return None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel()(ip.data_ptr(), q_sqnorm.data_ptr(),
                       p_sqnorm.data_ptr(), best_d.data_ptr(),
                       best_i.data_ptr(), B, C, int(offset), stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}")
    top1_update.launches += 1
    return None


top1_update.launches = 0
