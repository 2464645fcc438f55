"""The ranks' communicator: a thin wrapper over a torch.distributed group.

Takes the place of the reference's MPI `Comm`/`CubedSphereCommunicator`
(ai2cm/pace util/pace/util/communicator.py) and of the collectives GSPMD
inserts for `pace_tpu`.  The halo exchange sends one buffer per call: the
rows bound for each rank, in rank order, through `all_to_all_single` with
split sizes.

The backend follows one rule, and the choice is logged:

- a CPU device: gloo;
- a CUDA device where each rank has a card of its own (`cuda:LOCAL_RANK`):
  NCCL, on the device buffers;
- a CUDA device where ranks outnumber the host's cards, so that several
  share one (NCCL refuses two ranks on one device): gloo, with the
  exchange buffers staged through pinned host memory.  The compute stays
  on the card.

Nothing switches silently: a backend that fails to start or to exchange
raises.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger("pace_torch.parallel")

_OPS = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "sum": dist.ReduceOp.SUM}


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE",
                              os.environ.get("WORLD_SIZE", 1)))


def shares_a_card() -> bool:
    """True where this host runs more ranks than it has cards."""
    return torch.cuda.device_count() < local_world_size()


def rank_device(device) -> torch.device:
    """The device a rank runs on: "cuda" without an index becomes
    `cuda:LOCAL_RANK`, or the card LOCAL_RANK mod the host's card count
    where ranks outnumber cards; anything else is kept."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    count = torch.cuda.device_count()
    rank = local_rank()
    return torch.device("cuda", rank % count if count else rank)


def backend_for(device) -> str:
    """The process-group backend of the rule above."""
    device = torch.device(device)
    if device.type == "cuda" and not shares_a_card():
        return "nccl"
    return "gloo"


class Comm:
    """Collectives of one rank of a process group, on `device`.

    `exchange` can time itself: after `start_timing()`, each exchange adds
    its bytes sent and (on a card) the milliseconds between CUDA events
    recorded before its pack and after its received buffer is on the
    device, read by `timing()`."""

    def __init__(self, device, group=None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised")
        self.group = group
        self.device = torch.device(device)
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        if self.device.type == "cuda" and self.backend == "nccl":
            self.staging = False
        elif self.device.type == "cuda" and self.backend == "gloo":
            self.staging = True
        elif self.device.type == "cpu" and self.backend == "gloo":
            self.staging = False
        else:
            raise RuntimeError(f"backend {self.backend} cannot exchange "
                               f"{self.device.type} tensors")
        self._events = None
        self.bytes_sent = 0
        self.exchanges = 0

    def describe(self) -> str:
        where = ("gloo, exchange buffers staged through pinned host memory"
                 if self.staging else self.backend)
        return (f"rank {self.rank}/{self.size} on {self.device}: backend "
                f"{where}")

    # -- halo exchange -------------------------------------------------------
    def exchange(self, send: torch.Tensor, send_counts: Sequence[int],
                 recv_counts: Sequence[int]) -> torch.Tensor:
        """Rows `send[sum(send_counts[:r]):...]` go to rank r; returns the
        rows received, from rank 0 first, on `send`'s device."""
        events = self._events
        if events is not None and send.is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        recv = send.new_empty((int(sum(recv_counts)),) + send.shape[1:])
        if self.staging:
            host_send = torch.empty(send.shape, dtype=send.dtype,
                                    pin_memory=True)
            host_send.copy_(send)
            host_recv = torch.empty(recv.shape, dtype=recv.dtype,
                                    pin_memory=True)
            dist.all_to_all_single(host_recv, host_send, list(recv_counts),
                                   list(send_counts), group=self.group)
            recv.copy_(host_recv, non_blocking=True)
        else:
            dist.all_to_all_single(recv, send.contiguous(),
                                   list(recv_counts), list(send_counts),
                                   group=self.group)
        self.exchanges += 1
        self.bytes_sent += send.numel() * send.element_size()
        if events is not None and send.is_cuda:
            stop = torch.cuda.Event(enable_timing=True)
            stop.record()
            events.append((start, stop))
        return recv

    def start_timing(self):
        self._events = []
        self.bytes_sent = 0
        self.exchanges = 0

    def timing(self) -> dict:
        """{"exchanges", "bytes_sent", "ms"} since `start_timing()`; `ms`
        is None off the card."""
        events, self._events = self._events or [], None
        ms = None
        if events:
            torch.cuda.synchronize(self.device)
            ms = sum(a.elapsed_time(b) for a, b in events)
        return dict(exchanges=self.exchanges, bytes_sent=self.bytes_sent,
                    ms=ms)

    # -- reductions and gathers -----------------------------------------------
    def all_reduce(self, value: torch.Tensor, op: str = "max"):
        """`value` reduced over the ranks with "max", "min" or "sum", on
        value's device (staged through the host under gloo)."""
        staged = (value.detach().cpu() if self.backend == "gloo"
                  else value).clone()
        dist.all_reduce(staged, _OPS[op], group=self.group)
        return staged.to(value.device)

    def gather_to_root(self, obj, root: int = 0) -> Optional[list]:
        """Every rank's picklable `obj` (numpy arrays, dicts of them) in
        rank order on `root`; None elsewhere."""
        out = [None] * self.size if self.rank == root else None
        dist.gather_object(obj, out, dst=root, group=self.group)
        return out

    def all_gather(self, obj) -> list:
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def broadcast(self, obj, root: int = 0):
        """`root`'s picklable `obj` on every rank."""
        box = [obj if self.rank == root else None]
        dist.broadcast_object_list(box, src=root, group=self.group)
        return box[0]

    def barrier(self):
        dist.barrier(group=self.group)


def init_process_group(device, init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None) -> Comm:
    """Start the default process group with the backend of the rule (from
    `init_method`, or `env://` as torchrun sets it) unless it is running,
    and return this rank's Comm."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = backend_for(device)
        kwargs = {}
        if init_method is not None:
            kwargs = dict(init_method=init_method, world_size=world_size,
                          rank=rank)
        elif "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "a layout of more than one rank runs under torchrun "
                "(torchrun --nproc_per_node <ranks> -m pace_torch.driver.run "
                "<config.yaml>) or with multihost: true and "
                "coordinator_address, num_processes and process_id")
        if backend == "nccl":
            kwargs["device_id"] = device
        # a rank that fails leaves the others waiting in a collective:
        # they give up after this long
        dist.init_process_group(backend, timeout=timedelta(minutes=10),
                                **kwargs)
    comm = Comm(device)
    logger.info("halo exchange: %s", comm.describe())
    return comm
