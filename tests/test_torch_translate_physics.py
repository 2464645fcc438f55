"""The port's physics and coupler translate cases (AtmosPhysDriverStatein,
FillGFS, PrsFV3, PhiFV3, PhysUpdatePressureSurfaceWinds,
PhysUpdateTracers, Microph, GFSPhysicsDriver, FVUpdatePhys,
UpdateDWindsPhys) on the CPU in float64 on the port's own C12/79
baroclinic state and one step of it, each output held at 1e-9 of scale to
the reference package's in tests/golden/c12_translate_digest.json; and
the GFS physics block layouts (C and F order, the k roll, the
microphysics blocks) read and written as the reference package does."""

import numpy as np
import pytest

import pace_tpu.utils.translate as ref_translate
from pace_torch.testing import torch_threads
from pace_torch.utils import translate
from tests.test_torch_translate_cases import (
    PHYSICS,
    check_case_digest,
    port_c12_run,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def port_run():
    return port_c12_run()


def test_every_physics_case_is_here():
    assert len(PHYSICS) == 10


@pytest.mark.parametrize("name", PHYSICS)
def test_physics_case_matches_reference_digest(name, port_run):
    """Microph's wind tendencies are differences of nearly equal winds
    over the step (no cloud forms in the first step, so they are round-off
    of either package): they are held at the scale of what is subtracted,
    max |ua|, |va| over the timestep."""
    sizing, gd, s0, s1 = port_run
    scales = None
    if name == "Microph":
        c = (slice(None), slice(3, 15), slice(3, 15))
        scales = {"udt": np.abs(s1["ua"][c]).max() / 225.0,
                  "vdt": np.abs(s1["va"][c]).max() / 225.0}
    check_case_digest(name, sizing, gd, s0, s1, scales)


_LAYOUTS = [
    (dict(phys_order="C"), (7,)), (dict(phys_order="C"), (7, 3)),
    (dict(phys_order="F"), (7,)), (dict(phys_order="F"), (7, 3)),
    (dict(phys_order="F", roll_zero=True), (7,)),
    (dict(phys_order="C", roll_zero=True), (7, 3)),
    (dict(microph=True), (7,)), (dict(microph=True), ()),
]


@pytest.mark.parametrize("spec,trailing", _LAYOUTS)
def test_physics_blocks_read_and_write_as_the_reference(spec, trailing):
    rng = np.random.RandomState(12)
    cn = 4
    arr = rng.randn(cn, cn, *trailing)
    ours, theirs = translate.VarSpec(**spec), ref_translate.VarSpec(**spec)
    block = translate.TranslateCase._phys_write(arr, ours)
    np.testing.assert_array_equal(
        block, ref_translate.TranslateCase._phys_write(arr, theirs))
    back = translate.TranslateCase._phys_read(block, ours)
    np.testing.assert_array_equal(
        back, ref_translate.TranslateCase._phys_read(block, theirs))
    np.testing.assert_array_equal(back, arr)
