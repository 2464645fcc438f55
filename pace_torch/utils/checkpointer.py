"""Checkpointer hooks: savepoint-style state capture and validation.

Port of `pace_tpu.utils.checkpointer` (reference ai2cm/pace
util/pace/util/checkpointer/: base.py Checkpointer, snapshots.py
SnapshotCheckpointer, thresholds.py Threshold/SavepointThresholds/
ThresholdCalibrationCheckpointer, validation.py ValidationCheckpointer)
without the xarray dependency: snapshots are in-memory numpy dicts;
thresholds serialize to and from json.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
from typing import Dict, List

import numpy as np

from pace_torch.utils.host import as_numpy

SavepointName = str
VariableName = str


class Checkpointer:
    """Base hook: called as checkpointer(savepoint_name, **arrays) at fixed
    points in the model."""

    def __call__(self, savepoint_name: str, **kwargs) -> None:
        raise NotImplementedError


# --- in-model savepoint hook -------------------------------------------------
#
# The dycore carries named savepoints at the reference's places
# (fv3core/pace/fv3core/stencils/fv_dynamics.py:321-422, dyn_core.py:626-668).
# The step runs eagerly, so `checkpoint()` calls the active checkpointer
# directly; with none active it returns before touching its arguments: no
# copy, no host read, no device work.

_ACTIVE: "Checkpointer | None" = None


def set_checkpointer(cp) -> "Checkpointer | None":
    """Install `cp` as the active in-model checkpointer; returns previous."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = cp
    return prev


@contextlib.contextmanager
def checkpointing(cp: Checkpointer):
    prev = set_checkpointer(cp)
    try:
        yield cp
    finally:
        set_checkpointer(prev)


def checkpoint(savepoint_name: str, domain=None, **arrays) -> None:
    """Record `arrays` at the named savepoint with the active checkpointer.

    `domain` (utils/gridtools.py Domain) restricts capture to the compute
    points it owns, [halo : halo+n+1] in x and y on a whole tile (covers
    staggered edges): padded wedge cells hold values whose run-to-run
    spread under perturbation is unbounded, so they must not enter
    threshold calibration/validation.
    """
    cp = _ACTIVE
    if cp is None:
        return
    if domain is not None:
        si, sj = domain.compute(iface_x=True, iface_y=True)
        arrays = {
            k: v[:, si, sj] if getattr(v, "ndim", 0) >= 3 else v
            for k, v in arrays.items()
        }
    cp(str(savepoint_name), **arrays)


class NullCheckpointer(Checkpointer):
    def __call__(self, savepoint_name: str, **kwargs) -> None:
        pass


class SnapshotCheckpointer(Checkpointer):
    """Stores a copy of every array at every savepoint call, retrievable as
    {savepoint: {variable: [arrays over calls]}}."""

    def __init__(self):
        self._data: Dict[str, Dict[str, List[np.ndarray]]] = (
            collections.defaultdict(lambda: collections.defaultdict(list))
        )

    def __call__(self, savepoint_name: str, **kwargs) -> None:
        for name, arr in kwargs.items():
            self._data[savepoint_name][name].append(as_numpy(arr).copy())

    @property
    def data(self):
        return self._data


@dataclasses.dataclass
class Threshold:
    relative: float
    absolute: float

    def merge(self, other: "Threshold") -> "Threshold":
        return Threshold(
            relative=max(self.relative, other.relative),
            absolute=max(self.absolute, other.absolute),
        )


@dataclasses.dataclass
class SavepointThresholds:
    savepoints: Dict[SavepointName, List[Dict[VariableName, Threshold]]]

    def save(self, path: str):
        payload = {
            sp: [
                {v: dataclasses.asdict(t) for v, t in call.items()}
                for call in calls
            ]
            for sp, calls in self.savepoints.items()
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)

    @classmethod
    def load(cls, path: str) -> "SavepointThresholds":
        with open(path) as f:
            payload = json.load(f)
        return cls(savepoints={
            sp: [
                {v: Threshold(**t) for v, t in call.items()}
                for call in calls
            ]
            for sp, calls in payload.items()
        })


class ThresholdCalibrationCheckpointer(Checkpointer):
    """Derives per-variable validation thresholds from the spread across
    perturbed trials (reference thresholds.py:59-200)."""

    def __init__(self, factor: float = 1.0):
        self._factor = factor
        self._minimums = collections.defaultdict(list)
        self._maximums = collections.defaultdict(list)
        self._sums = collections.defaultdict(list)
        self._n_trials = 0
        self._n_calls = collections.defaultdict(int)

    def __call__(self, savepoint_name: str, **kwargs) -> None:
        i = self._n_calls[savepoint_name]
        for store in (self._minimums, self._maximums, self._sums):
            if len(store[savepoint_name]) < i + 1:
                store[savepoint_name].append({})
        for name, arr in kwargs.items():
            arr = as_numpy(arr)
            mins = self._minimums[savepoint_name][i]
            maxs = self._maximums[savepoint_name][i]
            sums = self._sums[savepoint_name][i]
            mins[name] = np.minimum(mins.get(name, np.inf), arr)
            maxs[name] = np.maximum(maxs.get(name, -np.inf), arr)
            sums[name] = sums.get(name, 0.0) + np.abs(arr)
        self._n_calls[savepoint_name] += 1

    @contextlib.contextmanager
    def trial(self):
        self._n_calls.clear()
        yield
        self._n_trials += 1

    @property
    def thresholds(self) -> SavepointThresholds:
        if self._n_trials == 0:
            raise InsufficientTrialsError("no trials recorded")
        out: Dict[str, List[Dict[str, Threshold]]] = {}
        for sp in self._minimums:
            out[sp] = []
            for i in range(len(self._minimums[sp])):
                call = {}
                for name in self._minimums[sp][i]:
                    mn = self._minimums[sp][i][name]
                    mx = self._maximums[sp][i][name]
                    mean_abs = self._sums[sp][i][name] / self._n_trials
                    # padding cells hold NaN in every trial: no spread
                    finite = np.isfinite(mn) & np.isfinite(mx)
                    with np.errstate(invalid="ignore"):
                        spread = np.where(finite, mx - mn, 0.0)
                    abs_err = float(np.max(spread))
                    with np.errstate(divide="ignore", invalid="ignore"):
                        rel = np.where(finite & (mean_abs > 0),
                                       spread / mean_abs, 0.0)
                    call[name] = Threshold(
                        relative=self._factor * float(np.max(rel)),
                        absolute=self._factor * abs_err,
                    )
                out[sp].append(call)
        return SavepointThresholds(savepoints=out)


class InsufficientTrialsError(RuntimeError):
    pass


class ValidationCheckpointer(Checkpointer):
    """Asserts savepoint data matches reference arrays within thresholds
    (reference validation.py:61-200; reference data as numpy arrays per
    savepoint call instead of netCDF)."""

    def __init__(self, reference: Dict[str, List[Dict[str, np.ndarray]]],
                 thresholds: SavepointThresholds):
        self._reference = reference
        self._thresholds = thresholds
        self._n_calls = collections.defaultdict(int)

    def __call__(self, savepoint_name: str, **kwargs) -> None:
        i = self._n_calls[savepoint_name]
        ref_call = self._reference[savepoint_name][i]
        thr_call = self._thresholds.savepoints[savepoint_name][i]
        for name, arr in kwargs.items():
            arr = as_numpy(arr)
            ref = ref_call[name]
            thr = thr_call[name]
            # cells non-finite in BOTH agree; a finiteness mismatch fails
            both_bad = ~np.isfinite(arr) & ~np.isfinite(ref)
            if (~np.isfinite(arr) ^ ~np.isfinite(ref)).any():
                raise AssertionError(
                    f"{savepoint_name}[{i}].{name}: finiteness pattern "
                    f"differs from reference"
                )
            with np.errstate(divide="ignore", invalid="ignore",
                             over="ignore"):
                abs_err = np.where(both_bad, 0.0, np.abs(arr - ref))
                denom = np.abs(np.where(both_bad, 1.0, ref))
                rel_err = np.where(denom > 0, abs_err / denom, 0.0)
            if float(abs_err.max()) > thr.absolute and \
                    float(rel_err.max()) > thr.relative:
                raise AssertionError(
                    f"{savepoint_name}[{i}].{name}: abs err "
                    f"{float(abs_err.max())} > {thr.absolute} and rel err "
                    f"{float(rel_err.max())} > {thr.relative}"
                )
        self._n_calls[savepoint_name] += 1
