"""OPQ rotation training by alternating PQ and Procrustes updates.
Counterpart of ``ivfhnsw_tpu/ops/opq.py`` (itself the stand-in for
faiss::OPQMatrix::train, IndexIVF_HNSW.cpp:548-554).

Convention as faiss LinearTransform and the JAX package: the rotation is
applied as ``y = x @ R.T`` and undone as ``x = y @ R``. Random draws come
from an explicit ``torch.Generator``, so R differs from the JAX package's
for the same seed; the two are compared by reconstruction error.
``save_rotation``/``load_rotation`` speak faiss's ``LinearTransform``
layout (``utils/faiss_io.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ivfhnsw_tpu_torch.ops.pq import ProductQuantizer
from ivfhnsw_tpu_torch.utils import faiss_io


def random_rotation(generator: torch.Generator, d: int) -> torch.Tensor:
    """Random orthogonal [d, d] matrix on the generator's device: QR of a
    Gaussian, column signs fixed by diag(R) so the draw is Haar-distributed."""
    g = torch.randn((d, d), generator=generator, device=generator.device)
    q, r = torch.linalg.qr(g)
    return q * torch.sign(torch.diagonal(r))[None, :]


def apply_rotation(x: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    return x.float() @ R.T


def apply_rotation_transpose(y: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    return y.float() @ R


def train_opq(generator: torch.Generator, data: torch.Tensor, M: int,
              niter: int = 25, niter_pq: int = 4, final_pq_niter: int = 25,
              ksub: int = 256):
    """Train an OPQ rotation and PQ codebooks on data [n, d] (on the device
    that does the work).

    Each of ``niter`` rounds rotates the data, runs ``niter_pq`` Lloyd
    iterations of PQ warm-started from the previous codebooks, and replaces
    R by the orthogonal Procrustes solution against the PQ reconstruction
    (R = U V^T from the SVD of recon^T X). Returns (R [d, d],
    ProductQuantizer trained on x @ R.T)."""
    data = data.float()
    n, d = data.shape
    R = random_rotation(generator, d)
    pq = ProductQuantizer(d, M, ksub)
    init = None
    for _ in range(niter):
        xr = apply_rotation(data, R)
        pq.train(generator, xr, niter=niter_pq, init=init)
        init = pq.codebooks
        recon = pq.decode(pq.encode(xr))             # rotated space
        u, _, vt = torch.linalg.svd(recon.T @ data, full_matrices=False)
        R = u @ vt
    pq.train(generator, apply_rotation(data, R), niter=final_pq_niter,
             init=init)
    return R, pq


def save_rotation(path: str, R: torch.Tensor) -> None:
    """faiss write_VectorTransform layout (the generic LinearTransform
    record that faiss::OPQMatrix serializes to), so ``.opq`` artifacts
    interchange with the reference. A == R, since faiss applies y = A @ x
    and the port x @ R.T."""
    faiss_io.write_linear_transform(path, R.cpu().numpy())


def load_rotation(path: str, device) -> torch.Tensor:
    """R [d, d] f32 on ``device`` from a faiss ``.opq`` file (or the JAX
    package's legacy [u32 d | f32 R] file)."""
    if faiss_io.is_faiss_vector_transform(path):
        A, b = faiss_io.read_vector_transform(path)
        if b is not None:
            raise ValueError("OPQ rotation with bias is not supported")
        return torch.tensor(A, device=device)
    with open(path, "rb") as f:
        d = int(np.fromfile(f, "<u4", 1)[0])
        R = np.fromfile(f, "<f4", d * d).reshape(d, d)
    return torch.tensor(R, device=device)
