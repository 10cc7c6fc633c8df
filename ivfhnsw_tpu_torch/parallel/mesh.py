"""The shard group: counterpart of the JAX package's 1-D mesh
(``ivfhnsw_tpu/parallel/mesh.py``).

In JAX a sharded step is one function under ``shard_map`` that uses three
collectives: ``axis_index`` (a shard's position), ``all_gather`` and
``psum``. Here a sharded step is written once, as phases of one shard's
work with those collectives between them, and runs under either group:

- :class:`LocalShards` — D shards in one process, shard s on
  ``devices[s]`` (devices may repeat: 8 shards on one card, or on the
  CPU). Each phase runs shard by shard; ``all_gather`` concatenates in
  shard order on the group's home device, ``psum`` adds in shard order.
  One H100 serves every shard of an index this way.
- :class:`DistributedShards` — one shard per rank of the default
  ``torch.distributed`` process group: NCCL for CUDA tensors, gloo for CPU
  tensors, never one in place of the other.

Both have one interface: ``size`` (D), ``ranks`` (the shard positions
this process serves, in order), ``device(rank)``, ``home`` (where
gathered and summed results land), ``all_gather`` and ``psum``. Each
collective takes one tensor per served shard, on that shard's device, of
the same shape on every shard, and raises on a tensor on another device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _on(t: torch.Tensor, device: torch.device, what: str) -> None:
    if t.device != device:
        raise ValueError(f"{what}: tensor on {t.device}, its shard is on "
                         f"{device}")


def _exact(device) -> torch.device:
    """``device`` with its index: a bare "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class LocalShards:
    """D shards in this process; shard s lives on ``devices[s]``."""

    def __init__(self, devices):
        if not devices:
            raise ValueError("a shard group needs at least one device")
        self.devices = tuple(_exact(d) for d in devices)
        self.size = len(self.devices)
        self.ranks = tuple(range(self.size))
        self.home = self.devices[0]

    def device(self, rank: int) -> torch.device:
        return self.devices[rank]

    def _check(self, parts, what: str) -> None:
        if len(parts) != self.size:
            raise ValueError(f"{what}: {len(parts)} parts for {self.size} "
                             "shards")
        for s, p in enumerate(parts):
            _on(p, self.devices[s], what)

    def all_gather(self, parts, dim: int = 0) -> torch.Tensor:
        """The shards' parts concatenated along ``dim`` in shard order."""
        self._check(parts, "all_gather")
        return torch.cat([p.to(self.home) for p in parts], dim=dim)

    def psum(self, parts) -> torch.Tensor:
        """The shards' parts added in shard order."""
        self._check(parts, "psum")
        acc = parts[0].to(self.home)
        for p in parts[1:]:
            acc = acc + p.to(self.home)
        return acc


class DistributedShards:
    """One shard per rank of the default process group, on ``device``:
    a CUDA device needs the NCCL backend, the CPU gloo (ValueError
    otherwise; neither stands in for the other)."""

    def __init__(self, device):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("DistributedShards needs the default process "
                               "group: call pipeline.initialize_distributed "
                               "or torch.distributed.init_process_group")
        device = torch.device(device)
        backend = str(dist.get_backend())
        need = "nccl" if device.type == "cuda" else "gloo"
        if need not in backend:
            raise ValueError(f"a shard on {device} needs the {need} backend; "
                             f"the default process group runs {backend}")
        self.home = _exact(device)
        self.size = dist.get_world_size()
        self.ranks = (dist.get_rank(),)

    def device(self, rank: int) -> torch.device:
        if rank != self.ranks[0]:
            raise ValueError(f"rank {self.ranks[0]} does not serve shard "
                             f"{rank}")
        return self.home

    def _one(self, parts, what: str) -> torch.Tensor:
        if len(parts) != 1:
            raise ValueError(f"{what}: {len(parts)} parts for the one shard "
                             "of this rank")
        _on(parts[0], self.home, what)
        return parts[0].contiguous()

    def all_gather(self, parts, dim: int = 0) -> torch.Tensor:
        """Every rank's part concatenated along ``dim`` in rank order."""
        p = self._one(parts, "all_gather")
        out = torch.empty((self.size * p.shape[0],) + tuple(p.shape[1:]),
                          dtype=p.dtype, device=p.device)
        dist.all_gather_into_tensor(out, p)
        if dim == 0:
            return out
        return torch.cat(out.chunk(self.size), dim=dim)

    def psum(self, parts) -> torch.Tensor:
        """Every rank's part added (all_reduce)."""
        out = self._one(parts, "psum").clone()
        dist.all_reduce(out)
        return out


def make_mesh(n_devices: int | None = None, devices=None) -> LocalShards:
    """A :class:`LocalShards` over ``devices`` (default: every CUDA device
    of this machine), the first ``n_devices`` of them when given; raises
    when fewer devices than that are there. A device may repeat, so
    ``make_mesh(devices=[cuda:0] * 8)`` is 8 shards on one card."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return LocalShards(devices)
