"""The step's savepoint and debug hooks in the port, after
tests/test_checkpoints.py and tests/test_debug_nancheck.py.

The checkpointer flow runs on the port's own C12/79 float32 step (k_split 1,
n_split 1; hord_tr 6, whose plain transport costs half of hord_tr 8's on a
CPU): calibrate thresholds over three round-off-perturbed trials, validate
a fourth trial against a snapshot of the first, and fail validation against
a corrupted reference.  The same runs record the order of the savepoints
and of the finiteness checks, which must be the reference's."""

import dataclasses

import numpy as np
import pytest
import torch

from pace_torch.testing import torch_threads
from pace_torch.utils import debug
from pace_torch.utils.gridtools import Domain

N_, NZ, H = 12, 79, 3

# the reference's savepoints of a k_split = n_split = 1 step, in the order
# pace_tpu/models/fv3/dynamics.py and acoustics.py reach them
SAVEPOINTS = [
    "FVDynamics-In", "C_SW-In", "C_SW-Out", "D_SW-In", "D_SW-Out",
    "Tracer2D1L-In", "Tracer2D1L-Out", "Remapping-In", "Remapping-Out",
    "FVDynamics-Out",
]
NANCHECK_STAGES = ["fv_setup", "acoustic_dynamics", "tracer_advection",
                   "lagrangian_to_eulerian", "cubed_to_latlon"]
SCALE = 1e-7  # round-off for float32


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def setup():
    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.models.fv3.config import DynamicalCoreConfig
    from pace_torch.models.fv3.dynamics import DynamicalCore
    from pace_torch.models.fv3.init.baroclinic import init_baroclinic_state
    from pace_torch.utils.gridtools import GridSizing

    sizing = GridSizing(N_, NZ)
    gd = generate_grid_data(N_, NZ, device="cpu", dtype=torch.float32)
    config = DynamicalCoreConfig(do_sat_adj=False, k_split=1, n_split=1,
                                 hord_tr=6)
    core = DynamicalCore(config, sizing, gd, timestep=225.0)
    return core, init_baroclinic_state(sizing, device="cpu",
                                       dtype=torch.float32)


def _perturbed(state, seed):
    """Multiplicative noise of SCALE on every field, seeded."""
    rng = np.random.RandomState(seed)
    out = {}
    for f in dataclasses.fields(state):
        a = getattr(state, f.name).numpy().astype(np.float64)
        noise = SCALE * np.abs(a) * (2.0 * rng.uniform(size=a.shape) - 1.0)
        out[f.name] = torch.as_tensor(a + noise, dtype=torch.float32)
    return type(state)(**out)


class Both:
    """Calls each checkpointer in turn and records the savepoint names."""

    def __init__(self, *checkpointers):
        self.checkpointers = checkpointers
        self.names = []

    def __call__(self, savepoint_name, **kwargs):
        self.names.append(savepoint_name)
        for cp in self.checkpointers:
            cp(savepoint_name, **kwargs)


def _as_reference(snap):
    return {
        sp: [{name: arrs[i] for name, arrs in snap.data[sp].items()}
             for i in range(len(next(iter(snap.data[sp].values()))))]
        for sp in snap.data
    }


def test_calibrate_then_validate(setup, tmp_path, monkeypatch):
    from pace_torch.utils.checkpointer import (
        SavepointThresholds,
        SnapshotCheckpointer,
        ThresholdCalibrationCheckpointer,
        ValidationCheckpointer,
        checkpointing,
    )

    core, state = setup
    cal = ThresholdCalibrationCheckpointer(factor=20.0)
    snap = SnapshotCheckpointer()
    for seed in range(3):
        # trial 0 is also the validation's reference
        cp = Both(cal, snap) if seed == 0 else Both(cal)
        with checkpointing(cp), cal.trial():
            core.step_dynamics(_perturbed(state, seed))
        assert cp.names == SAVEPOINTS, cp.names
    thresholds = cal.thresholds
    assert list(thresholds.savepoints) == SAVEPOINTS
    assert all(len(calls) == 1 for calls in thresholds.savepoints.values())

    path = str(tmp_path / "fv_dynamics_thresholds.json")
    thresholds.save(path)
    thresholds = SavepointThresholds.load(path)
    reference = _as_reference(snap)

    # a round-off-perturbed run validates within the calibrated thresholds;
    # with the finiteness checks on, each stage's check runs once and passes
    stages = []
    check = debug._host_check
    monkeypatch.setattr(debug, "NANCHECK_ENABLED", True)
    monkeypatch.setattr(debug, "_host_check",
                        lambda stage, *a: (stages.append(stage),
                                           check(stage, *a)))
    seven = SnapshotCheckpointer()
    with checkpointing(Both(ValidationCheckpointer(reference, thresholds),
                            seven)):
        core.step_dynamics(_perturbed(state, seed=7))
    assert stages == NANCHECK_STAGES, stages

    # and the same run against a corrupted reference fails at its savepoint
    bad = {sp: [dict(call) for call in calls]
           for sp, calls in reference.items()}
    bad["D_SW-Out"][0]["pt"] = bad["D_SW-Out"][0]["pt"] + 1.0
    val_bad = ValidationCheckpointer(bad, thresholds)
    with pytest.raises(AssertionError, match="D_SW-Out"):
        for sp, calls in _as_reference(seven).items():
            for call in calls:
                val_bad(sp, **call)


def test_thresholds_need_a_trial():
    from pace_torch.utils.checkpointer import (
        InsufficientTrialsError,
        ThresholdCalibrationCheckpointer,
    )

    with pytest.raises(InsufficientTrialsError):
        ThresholdCalibrationCheckpointer().thresholds


class Untouchable:
    """Raises on any use: a hook that is off must not look at its
    arguments."""

    def __getattr__(self, name):
        raise AssertionError(f"touched: {name}")

    def __getitem__(self, key):
        raise AssertionError("touched: []")


def test_no_checkpointer_touches_nothing():
    from pace_torch.utils import checkpointer

    assert checkpointer._ACTIVE is None
    checkpointer.checkpoint("FVDynamics-In", domain=Domain.whole(N_, H),
                            u=Untouchable())
    with checkpointer.checkpointing(checkpointer.NullCheckpointer()):
        checkpointer.checkpoint("FVDynamics-In", u=Untouchable())
    assert checkpointer._ACTIVE is None


# --- the seven cases of tests/test_debug_nancheck.py ------------------------

def test_host_check_raises_with_stage_and_field():
    good = np.ones((6, 10, 10, 4))
    bad = np.ones((6, 10, 10, 4))
    bad[2, 5, 5, 1] = np.nan
    dom = Domain.whole(4, 3)
    debug._host_check("stage_a", dom, ("x",), good)
    with pytest.raises(debug.NaNDetected, match=r"stage_b.*field 'y'"):
        debug._host_check("stage_b", dom, ("x", "y"), good, bad)


def test_halo_padding_nans_ignored():
    n, h = 4, 3
    dom = Domain.whole(n, h)
    arr = np.ones((6, 16, 16, 2))
    arr[:, 0, 0, :] = np.nan
    arr[:, h + n + 1:, :, :] = np.nan
    debug._host_check("stage", dom, ("f",), arr)
    # and through the hook on a tensor
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(debug, "NANCHECK_ENABLED", True)
        debug.nancheck("stage", dom, f=torch.as_tensor(arr))


def test_nancheck_noop_when_disabled():
    assert not debug.NANCHECK_ENABLED and not debug.STATECHECK_ENABLED
    debug.nancheck("s", Domain.whole(4, 3), x=Untouchable())


def test_nancheck_fires_on_a_tensor(monkeypatch):
    monkeypatch.setattr(debug, "NANCHECK_ENABLED", True)
    n, h = 4, 3
    dom = Domain.whole(n, h)
    x = torch.ones((6, 16, 16))
    y = torch.where(x > 0, torch.nan, x)
    with pytest.raises(debug.NaNDetected, match="poisoned"):
        debug.nancheck("poisoned", dom, y=y)


def test_statecheck_negative_delp(monkeypatch):
    monkeypatch.setattr(debug, "STATECHECK_ENABLED", True)
    n, h = 4, 3
    dom = Domain.whole(n, h)
    good = np.full((6, 16, 16, 2), 10.0)
    bad = good.copy()
    bad[1, h + 1, h + 2, 0] = -1.0
    debug._host_check("stage", dom, ("delp",), good)
    with pytest.raises(debug.NegativeValueDetected,
                       match=r"negative delp.*'delp'"):
        debug.statecheck("stage", dom, delp=torch.as_tensor(bad))
    pad = good.copy()
    pad[:, 0, 0, :] = -5.0
    debug._host_check("stage", dom, ("delp",), pad)


def test_statecheck_negative_tracer(monkeypatch):
    monkeypatch.setattr(debug, "STATECHECK_ENABLED", True)
    n, h = 4, 3
    dom = Domain.whole(n, h)
    roundoff = np.full((6, 16, 16, 2), 1e-6)
    roundoff[2, h, h, 1] = -5e-9
    debug._host_check("s", dom, ("qvapor",), roundoff)
    bad = roundoff.copy()
    bad[2, h, h, 1] = -1e-3
    with pytest.raises(debug.NegativeValueDetected,
                       match=r"negative tracer.*'qvapor'"):
        debug._host_check("s", dom, ("qvapor",), bad)
    debug._host_check("s", dom, ("u",), np.full((6, 16, 16, 2), -40.0))


def test_statecheck_disabled_means_finite_only():
    assert not debug.STATECHECK_ENABLED
    n, h = 4, 3
    dom = Domain.whole(n, h)
    neg = np.full((6, 16, 16, 2), -1.0)
    debug._host_check("s", dom, ("delp", "qvapor"), neg, neg)


def test_nancheck_on_a_split_rank_reads_its_owned_cells(monkeypatch):
    """On the north-east rank of (1, 2, 2) the hook reads the compute cells
    the rank owns: NaN in the block's halo lines and at the tile's
    corner-wedge point (h + n, h + n) passes, NaN in an owned cell
    raises."""
    from pace_torch.parallel.partition import Partition

    monkeypatch.setattr(debug, "NANCHECK_ENABLED", True)
    dom = Partition((1, 2, 2), N_, H).domain(3)
    si, sj = dom.compute()
    arr = torch.ones((6, dom.Ni, dom.Nj, 2))
    arr[:, :si.start] = torch.nan
    arr[:, :, :sj.start] = torch.nan
    arr[:, dom.col(H + N_), dom.row(H + N_)] = torch.nan
    debug.nancheck("stage", dom, f=arr)
    arr[4, si.stop - 1, sj.start] = torch.nan
    with pytest.raises(debug.NaNDetected, match="2 bad points"):
        debug.nancheck("stage", dom, f=arr)
