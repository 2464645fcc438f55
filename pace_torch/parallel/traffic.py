"""Record/replay of halo-exchange traffic: one tile re-run alone.

Port of `pace_tpu.parallel.traffic` (the analogue of the reference's
CachingCommWriter/Reader, ai2cm/pace util/pace/util/caching_comm.py:89-235,
which records MPI receives so one rank of an N-rank run can be re-run
alone).  In record mode a one-rank run of the whole cube stores the full
result of every halo call.  In replay mode each halo call gathers as the
one-rank path does on the tiles the run holds (one tile, `(1, N, N, ...)`
arrays, or the whole cube), and takes the next recorded result only at
the points whose source lies on another tile: a single tile steps alone
on its own values, with its neighbours' halo values read from the
recording, as the reference package writes only the received strips.
The recording holds whole results because the port has no strip
decomposition (the reference package's CopyOps are not ported).

Usage::

    rec = HaloTrafficRecorder.recording()
    with rec:
        out = step_fn(full_state)
    rec.save("traffic.npz")

    rep = HaloTrafficRecorder.load("traffic.npz").replaying(tile=3)
    with rep:
        out3 = step_fn(tile3_state)    # grid and state of tile 3 only
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch


class HaloTrafficRecorder:
    """See the module docstring.  `calls` holds one (kind, lead, result)
    per halo-call output: the kind of its table (e.g. "scalar:center",
    "vector0:y_iface:x_iface"), the number of axes before the tile axis,
    and the result as a numpy array."""

    def __init__(self, mode: Optional[str] = None,
                 calls: Optional[List] = None, tile: Optional[int] = None):
        self.mode = mode
        self.calls = calls if calls is not None else []
        self.cursor = 0
        self.tile = tile

    @classmethod
    def recording(cls) -> "HaloTrafficRecorder":
        return cls(mode="record")

    def replaying(self, tile: Optional[int] = None) -> "HaloTrafficRecorder":
        """A replay view (tile=None replays the whole cube)."""
        return HaloTrafficRecorder(mode="replay", calls=self.calls, tile=tile)

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        meta = json.dumps([[kind, lead] for kind, lead, _ in self.calls])
        arrays = {f"c{i}": result for i, (_, _, result)
                  in enumerate(self.calls)}
        with open(path, "wb") as f:
            np.savez_compressed(f, meta=np.array(meta), **arrays)

    @classmethod
    def load(cls, path: str) -> "HaloTrafficRecorder":
        with np.load(path) as data:
            meta = json.loads(str(data["meta"]))
            calls = [(kind, int(lead), data[f"c{i}"])
                     for i, (kind, lead) in enumerate(meta)]
        return cls(mode=None, calls=calls)

    # -- activation --------------------------------------------------------
    def __enter__(self):
        from pace_torch.parallel import halo

        if self.mode is None:
            raise ValueError(
                "activate a loaded recorder via .replaying(tile=...)")
        if halo._RECORDER is not None:
            raise RuntimeError("a HaloTrafficRecorder is already active")
        halo._RECORDER = self
        self.cursor = 0
        return self

    def __exit__(self, *exc):
        from pace_torch.parallel import halo

        halo._RECORDER = None
        return False

    # -- record ------------------------------------------------------------
    def on_result(self, result: torch.Tensor, kind: str, lead: int = 0):
        """Called by the halo module with each output of a halo call; a
        copy, so the run may go on writing into its result."""
        self.calls.append((kind, lead,
                           result.detach().to("cpu", copy=True).numpy()))

    # -- replay ------------------------------------------------------------
    def substitute(self, spec, inputs, lead: int = 0,
                   apply_sign: bool = True) -> torch.Tensor:
        """The halo call of `spec` (a topology's `HaloSpec`) on `inputs`
        ([q] or [u, v]) with the next recorded result at the points whose
        source tile is not their own: of tile `self.tile` where the inputs
        hold one tile, else of the whole cube."""
        from pace_torch.parallel.halo import gather_one_rank

        if self.cursor >= len(self.calls):
            raise RuntimeError("replay exhausted: more halo updates than "
                               "were recorded")
        want, rec_lead, payload = self.calls[self.cursor]
        self.cursor += 1
        if want != spec.kind or rec_lead != lead:
            raise RuntimeError(
                f"replay mismatch at call {self.cursor - 1}: recorded "
                f"{want!r}, run requested {spec.kind!r}")
        q = inputs[0]
        recorded = torch.as_tensor(payload, dtype=q.dtype, device=q.device)
        t = spec.on(q.device)
        if self.tile is not None and q.shape[lead] == 1:
            t = {k: v[self.tile:self.tile + 1] for k, v in t.items()}
            own = t["t"] == self.tile
            # the held tile is tile 0 of q; where the source lies on
            # another tile the recorded value is taken, whatever is read
            t["t"] = torch.zeros_like(t["t"])
            recorded = recorded.narrow(lead, self.tile, 1)
        else:
            own = t["t"] == torch.arange(
                t["t"].shape[0], device=q.device).reshape(-1, 1, 1)
        out = gather_one_rank(t, inputs, lead, apply_sign)
        own = own.reshape((1,) * lead + own.shape
                          + (1,) * (out.ndim - lead - 3))
        return torch.where(own, out, recorded)
