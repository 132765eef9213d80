"""Process-group bootstrap; port of ``byteps_tpu/comm/mesh.py``.

The JAX package lays its devices out as a ``(dcn, ici)`` mesh under one
controller.  The port uses the process model of the original BytePS: one
process per GPU, each contributing its own tensor, joined by
``torch.distributed`` (NCCL on the card, gloo on the CPU).  The two mesh
levels become two families of process groups built from the same
DMLC/BYTEPS environment:

- **intra** (the ``ici`` axis): the ``local_size`` ranks of one node;
- **inter** (the ``dcn`` axis): the ``num_hosts`` ranks that share a
  local rank, one per node.

Global rank is ``host_id * local_size + local_rank``.  With no
environment the world is one process on ``tcp://127.0.0.1:<free port>``,
so the collective leg is a real collective even on one card.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..common.config import Config
from ..common.logging import get_logger

_log = get_logger()


def free_port() -> int:
    """An OS-assigned free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclasses.dataclass(eq=False)
class CommContext:
    """This process's place in the world and its process groups.

    ``intra_group`` / ``inter_group`` are None where the level spans the
    whole world (torch's default group); a level of size 1 issues no
    collective at all."""

    rank: int
    size: int
    local_rank: int
    local_size: int
    num_nodes: int
    device: torch.device
    backend: str
    intra_group: Any = None
    inter_group: Any = None
    # "host:port" of the rendezvous store (rank 0's) at more than one
    # rank: the engine's root order talks through it
    rendezvous: Optional[str] = None

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def resolve_device(device, local_rank: int = 0) -> torch.device:
    """``"cuda"`` picks this process's card (by local rank); ``"cpu"`` the
    host.  Asking for CUDA where there is none raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "byteps_tpu_torch: device='cuda' but torch.cuda is not "
                "available; pass device='cpu' to run on the host")
        if device.index is None:
            device = torch.device("cuda",
                                  local_rank % torch.cuda.device_count())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def bootstrap(cfg: Config, device: torch.device,
              backend: str = None) -> CommContext:
    """Join (or form) the process group described by ``cfg``.  The
    backend is NCCL on the card and gloo on the host unless ``backend``
    names one: gloo on the card runs its collectives through the host,
    which is how several ranks share one card (NCCL refuses two ranks of
    a communicator on one device)."""
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group is already "
                           "initialized in this process")
    world, rank = cfg.world_size, cfg.rank
    if cfg.num_hosts == 1:
        # one host is a group of one node whatever host_id says: the
        # elastic topology runs each member at DMLC_NUM_WORKER=1 with its
        # member rank in DMLC_WORKER_ID
        rank = cfg.local_rank
    if world > 1:
        if cfg.coordinator_address is None:
            raise RuntimeError("a multi-process run needs DMLC_PS_ROOT_URI "
                               "and DMLC_PS_ROOT_PORT (the rendezvous)")
        init_method = f"tcp://{cfg.coordinator_address}"
    else:
        init_method = f"tcp://127.0.0.1:{free_port()}"
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    L, N = cfg.local_size, cfg.num_hosts
    intra = inter = None
    if L > 1 and N > 1:
        # every rank creates every group, in the same order
        for node in range(N):
            g = dist.new_group([node * L + i for i in range(L)])
            if node == cfg.host_id:
                intra = g
        for lr in range(L):
            g = dist.new_group([n * L + lr for n in range(N)])
            if lr == cfg.local_rank:
                inter = g
    comm = CommContext(rank=rank, size=world, local_rank=cfg.local_rank,
                       local_size=L, num_nodes=N, device=device,
                       backend=backend, intra_group=intra,
                       inter_group=inter,
                       rendezvous=cfg.coordinator_address if world > 1
                       else None)
    _log.info("process group up: rank %d of %d (%d node(s) x %d), %s on %s",
              rank, world, N, L, backend, device)
    return comm
