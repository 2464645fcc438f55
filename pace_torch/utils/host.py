"""Moving tensors to the host for output.

Every output (a diagnostics record, a restart, a safety check) reads the
device once: the tensors it needs are flattened into one buffer per dtype
on the device, copied to the host in one transfer and split there.  In a
multi-rank run rank 0 assembles the whole cube's arrays from every rank's
blocks one field at a time (`fields_on_root`) and writes each before the
next is assembled: it holds one whole-cube field at a time.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def as_numpy(value) -> np.ndarray:
    """A host numpy array of a tensor on any device, or of an array-like."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def to_host(tensors: Dict[str, object]) -> Dict[str, np.ndarray]:
    """{name: numpy array} of {name: tensor or array-like}, with one
    device-to-host copy per dtype among the tensors."""
    out = {}
    groups: Dict[tuple, list] = {}
    for name, value in tensors.items():
        if isinstance(value, torch.Tensor):
            groups.setdefault((value.device, value.dtype), []).append(name)
        else:
            out[name] = np.asarray(value)
    for names in groups.values():
        parts = [tensors[name].detach() for name in names]
        flat = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
        offset = 0
        for name, part in zip(names, parts):
            size = part.numel()
            out[name] = flat[offset:offset + size].reshape(tuple(part.shape))
            offset += size
    return {name: out[name] for name in tensors}


def fields_on_root(arrays: Dict[str, np.ndarray],
                   ranks) -> Iterator[Tuple[str, np.ndarray]]:
    """(name, the whole cube's array) of each of this rank's {name: its
    block}, one field at a time, on rank 0: a field's blocks reach rank 0
    in rank order (`Comm.gather_blocks`) and are assembled only once the
    field before has been taken, so that rank 0, writing each field before
    it takes the next, holds one whole-cube field (and one block) at a
    time.  The other ranks send each field's block and yield nothing;
    every rank runs the generator to its end.  `ranks`: (Partition, Comm)
    of a multi-rank run, or None for one rank, whose arrays are the
    cube's."""
    if ranks is None:
        yield from arrays.items()
        return
    partition, comm = ranks
    for name, block in arrays.items():
        blocks = comm.gather_blocks(block,
                                    partition.part_shapes(block.shape[3:]))
        if comm.rank == 0:
            yield name, partition.gather(blocks)
        else:
            for _ in blocks:
                pass


def root_layout(arrays: Dict[str, np.ndarray], ranks) -> dict:
    """{name: (shape, dtype)} of the whole-cube arrays `fields_on_root`
    gives rank 0, from this rank's blocks: what a writer that takes the
    fields one at a time needs to know first."""
    if ranks is None:
        return {name: (a.shape, a.dtype) for name, a in arrays.items()}
    partition = ranks[0]
    return {name: (((6,) + a.shape[1:]) if partition.whole_tiles
                   else (6, partition.N, partition.N) + a.shape[3:], a.dtype)
            for name, a in arrays.items()}


def drain(fields) -> None:
    """Run `fields_on_root` to its end (a rank that writes nothing)."""
    for _ in fields:
        pass
