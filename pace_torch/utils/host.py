"""Moving tensors to the host for output.

Every output (a diagnostics record, a restart, a safety check) reads the
device once: the tensors it needs are flattened into one buffer per dtype
on the device, copied to the host in one transfer and split there.  In a
multi-rank run rank 0 assembles the whole cube's arrays from every rank's
(`on_root`) and writes them.
"""

from __future__ import annotations

from typing import Dict, Optional

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


def on_root(arrays: Dict[str, np.ndarray], ranks) -> Optional[dict]:
    """This rank's {name: numpy array} of its tiles -> the whole cube's on
    rank 0 and None on the others (`ranks`: (Partition, Comm) of a
    multi-rank run, or None for one rank, whose arrays are the cube's)."""
    if ranks is None:
        return arrays
    partition, comm = ranks
    parts = comm.gather_to_root(arrays)
    if parts is None:
        return None
    return {name: partition.gather([p[name] for p in parts])
            for name in arrays}
