"""The data-parallel process group (port of carla_ppo_tpu/parallel/mesh.py).

The JAX package shards the env batch over a 1-D device `Mesh` inside one
program. Here each card is driven by its own process (a rank), and the
ranks meet in a torch.distributed process group: NCCL between cards, gloo
on the CPU, and gloo with CUDA tensors where several ranks share one card
(NCCL refuses that). `DataParallel` is the small object the training code
asks "how many ranks, which am I, on which device", and through which it
makes its few collectives. It is not a launcher: `cli.train` spawns the
ranks (or joins the group torchrun set up) and calls `init`.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Any, List, Sequence

import torch
import torch.distributed as dist
from torch import Tensor

# A collective that waits longer than this fails instead of hanging.
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in the group: `rank` of `world_size`, its
    `device`, and the group's `backend`."""

    rank: int
    world_size: int
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def shard(self, n: int) -> slice:
        """This rank's contiguous slice of a batch of `n` (n % world_size
        must be 0)."""
        if n % self.world_size:
            raise ValueError(f"a batch of {n} does not divide over {self.world_size} ranks")
        per = n // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

    def mean(self, tensors: Sequence[Tensor]) -> List[Tensor]:
        """The mean over the ranks of each tensor (float32), every rank
        getting the same bits: one all-reduce of the flattened values, then
        a division by the world size (the JAX package's pmean)."""
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
        dist.all_reduce(flat)
        flat = flat / self.world_size
        out, at = [], 0
        for t in tensors:
            out.append(flat[at: at + t.numel()].view(t.shape))
            at += t.numel()
        return out

    def broadcast_(self, tensors: Sequence[Tensor]) -> None:
        """Overwrite each tensor with rank 0's, in place (tensors on the
        CPU are sent through the group's device)."""
        for t in tensors:
            if t.device == self.device or self.backend == "gloo":
                dist.broadcast(t, 0)
            else:
                buf = t.to(self.device)
                dist.broadcast(buf, 0)
                t.copy_(buf)

    def all_gather(self, t: Tensor) -> Tensor:
        """Every rank's `t` (the same shape on each), concatenated along
        dim 0 in rank order. gloo gathers no CUDA tensor, so there it goes
        through the host."""
        src = t.cpu() if self.backend == "gloo" else t
        parts = [torch.empty_like(src) for _ in range(self.world_size)]
        dist.all_gather(parts, src.contiguous())
        return torch.cat(parts).to(t.device)

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's picklable `obj` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, 0)
        return box[0]

    def barrier(self) -> None:
        dist.barrier()


def rank_device(rank: int, device: str | torch.device) -> torch.device:
    """The device of `rank`: card rank % visible cards for "cuda", else
    the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def init(
    rank: int,
    world_size: int,
    init_method: str,
    device: str | torch.device = "cuda",
    backend: str | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> DataParallel:
    """Join the group as `rank` of `world_size` at `init_method`
    ("tcp://host:port", "file://path" or "env://"). The backend is NCCL on
    cards, gloo on the CPU, unless given; NCCL needs a card per rank."""
    dev = rank_device(rank, device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if dev.type != "cuda" or world_size > torch.cuda.device_count():
            raise ValueError(f"NCCL needs one card per rank ({world_size} ranks, "
                             f"{torch.cuda.device_count()} cards); use backend='gloo'")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return DataParallel(rank=rank, world_size=world_size, device=dev, backend=backend)


def init_from_env(device: str | torch.device = "cuda", backend: str | None = None,
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> DataParallel:
    """Join the group a launcher such as torchrun describes in the
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)."""
    return init(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://", device, backend,
                timeout_s)


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on localhost that is free now (for a rendezvous)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
