"""Flat posting-list storage. Counterpart of ``ivfhnsw_tpu/models/storage.py``.

The reference keeps one std::vector per centroid for ids / PQ codes / norm
codes (IndexIVF_HNSW.h:64-66). Here, as in the JAX package, they are flat
arrays sorted by centroid:

    codes        [N, M]  uint8
    ids          [N]     int32
    norm_codes   [N]     uint8
    list_offsets [nc+1]  int32   list i = rows [off[i], off[i+1])

The canonical arrays are host numpy (the builder sorts there); the search
engines read device tensors of the same arrays, uploaded on first use and
kept until :meth:`PostingListStore.release_device` drops them. The scan
kernel reads ``codes`` and ``norm_codes`` in place, so the store has no
tiled or list-aligned copy (the JAX package's ``tiled()``/``quad()`` are TPU
DMA formats).

The grouping index stores ``nc * nsubc`` lists in (centroid, subcentroid)
order; :meth:`PostingListStore.grouped` gives its group-level view
(:class:`GroupedView`), the counterpart of the subcentroid rows of the JAX
package's ``tiled_grouped``/``quad_grouped`` tiles.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class PostingListStore:
    """Finalized posting lists: host arrays plus their tensors on
    ``device`` (``codes_t``, ``ids_t``, ``norm_codes_t``, ``list_offsets_t``
    int64), each uploaded on first use."""

    codes: np.ndarray         # [N, M] uint8
    ids: np.ndarray           # [N] int32
    norm_codes: np.ndarray    # [N] uint8
    list_offsets: np.ndarray  # [nc+1] int32
    nc: int
    device: torch.device

    def __post_init__(self):
        self.codes = np.ascontiguousarray(self.codes, np.uint8)
        self.ids = np.ascontiguousarray(self.ids, np.int32)
        self.norm_codes = np.ascontiguousarray(self.norm_codes, np.uint8)
        self.list_offsets = np.ascontiguousarray(self.list_offsets, np.int32)
        if self.list_offsets.shape != (self.nc + 1,):
            raise ValueError(f"list_offsets shape {self.list_offsets.shape} "
                             f"!= ({self.nc + 1},)")
        if int(self.list_offsets[-1]) != self.codes.shape[0]:
            raise ValueError("list_offsets[-1] != number of codes")
        self.device = torch.device(self.device)
        self._dev: dict = {}
        self._grouped = None

    def _mirror(self, name: str, dtype=None) -> torch.Tensor:
        if name not in self._dev:
            self._dev[name] = torch.tensor(getattr(self, name), dtype=dtype,
                                           device=self.device)
        return self._dev[name]

    @property
    def codes_t(self) -> torch.Tensor:
        return self._mirror("codes")

    @property
    def ids_t(self) -> torch.Tensor:
        return self._mirror("ids")

    @property
    def norm_codes_t(self) -> torch.Tensor:
        return self._mirror("norm_codes")

    @property
    def list_offsets_t(self) -> torch.Tensor:
        return self._mirror("list_offsets", torch.int64)

    def release_device(self) -> None:
        """Drop every device tensor of the store and its grouped view; the
        host arrays stay, and the next device use uploads them again."""
        self._dev = {}
        self._grouped = None

    @property
    def ntotal(self) -> int:
        return int(self.codes.shape[0])

    @property
    def code_m(self) -> int:
        return int(self.codes.shape[1])

    def list_sizes(self) -> np.ndarray:
        return np.diff(self.list_offsets)

    def max_list_size(self) -> int:
        s = self.list_sizes()
        return int(s.max()) if s.size else 0

    def grouped(self, nsubc: int) -> "GroupedView":
        """The group-level view of a grouping index's store (its lists are
        nc * nsubc subgroups in (centroid, subc) order); built once."""
        view = self._grouped
        if view is None or view.nsubc != nsubc:
            view = self._grouped = GroupedView.of(self, nsubc)
        return view


@dataclass
class GroupedView:
    """A store of nc * nsubc subgroup lists seen as nc groups, each group
    contiguous in the flat arrays with its subgroups in subc order:

        group_offsets_t [nc+1]     int64  group g = rows [off[g], off[g+1])
        sub_sizes_t     [nc, nsubc] int64 codes per subgroup
        subc_t          [N]        uint8  each code's subcentroid index

    ``group_sizes`` is the host array of codes per group. nsubc <= 256, so a
    subcentroid index fits one byte."""

    nsubc: int
    group_sizes: np.ndarray
    group_offsets_t: torch.Tensor
    sub_sizes_t: torch.Tensor
    subc_t: torch.Tensor

    @classmethod
    def of(cls, store: PostingListStore, nsubc: int) -> "GroupedView":
        if not 0 < nsubc <= 256:
            raise ValueError(f"nsubc={nsubc} outside [1, 256]")
        if store.nc % nsubc:
            raise ValueError(f"store of {store.nc} lists is not "
                             f"nc * nsubc with nsubc={nsubc}")
        off = store.list_offsets.astype(np.int64)
        sub_sizes = np.diff(off).reshape(-1, nsubc)
        subc = (np.repeat(np.arange(store.nc), np.diff(off))
                % nsubc).astype(np.uint8)
        dev = store.device
        return cls(nsubc=nsubc, group_sizes=sub_sizes.sum(axis=1),
                   group_offsets_t=torch.tensor(off[::nsubc], device=dev),
                   sub_sizes_t=torch.tensor(sub_sizes, device=dev),
                   subc_t=torch.tensor(subc, device=dev))


class PostingListBuilder:
    """Accumulates (centroid key, id, code, norm code) batches on the host;
    finalize() produces a PostingListStore sorted by key, with a stable sort
    that keeps the reference's push_back order within each list
    (IndexIVF_HNSW.cpp:124-133)."""

    def __init__(self, nc: int, code_m: int):
        self.nc = nc
        self.code_m = code_m
        self._keys: list[np.ndarray] = []
        self._ids: list[np.ndarray] = []
        self._codes: list[np.ndarray] = []
        self._norm_codes: list[np.ndarray] = []

    def add(self, keys, ids, codes, norm_codes) -> None:
        keys = np.asarray(keys, np.int32)
        n = keys.shape[0]
        codes = np.asarray(codes, np.uint8).reshape(n, self.code_m)
        if keys.min(initial=0) < 0 or (n and keys.max() >= self.nc):
            raise ValueError("centroid key out of range")
        self._keys.append(keys)
        self._ids.append(np.asarray(ids, np.int32).reshape(n))
        self._codes.append(codes)
        self._norm_codes.append(np.asarray(norm_codes, np.uint8).reshape(n))

    @property
    def ntotal(self) -> int:
        return sum(k.shape[0] for k in self._keys)

    def finalize(self, device) -> PostingListStore:
        if self._keys:
            keys = np.concatenate(self._keys)
            ids = np.concatenate(self._ids)
            codes = np.concatenate(self._codes)
            ncodes = np.concatenate(self._norm_codes)
        else:
            keys = np.zeros((0,), np.int32)
            ids = np.zeros((0,), np.int32)
            codes = np.zeros((0, self.code_m), np.uint8)
            ncodes = np.zeros((0,), np.uint8)
        order = np.argsort(keys, kind="stable")
        sizes = np.bincount(keys, minlength=self.nc)
        offsets = np.zeros(self.nc + 1, np.int32)
        np.cumsum(sizes, out=offsets[1:])
        return PostingListStore(codes=codes[order], ids=ids[order],
                                norm_codes=ncodes[order],
                                list_offsets=offsets, nc=self.nc,
                                device=device)
