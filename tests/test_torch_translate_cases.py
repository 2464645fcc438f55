"""The port's translate cases (pace_torch.utils.translate_cases and its
grid and physics modules) against the reference package's:

- the registries: the same 88 savepoint names, each with equal VarSpecs,
  write staggers and thresholds;
- tier 1, every case that reads the model state (the dycore operators,
  the halo updates and the initial-state cases; the physics cases are in
  test_torch_translate_physics.py, the grid-metric ones in
  test_torch_translate_grid.py) run on the CPU in float64 on the port's
  own C12/79 baroclinic state and one step of it, its outputs held at 1e-9
  of scale to tests/golden/c12_translate_digest.json, the reference's
  outputs on its own state (tests/golden/make_translate_digest.py; the
  two states differ by the two packages' step, about 1e-13).  The
  whole-step cases FVDynamics, Driver and DynCore are held by the slow
  test only;
- slow: every one of the 88 cases, the reference's case computing the
  outputs from the same numpy inputs and writing the savepoint, the port's
  case reading it, computing on the CPU and validating at its own
  max_error (ten, whose per-point metric magnifies last-place differences,
  on the compute domain at a measured bar: REFERENCE_BOUNDS); the same
  test checks that the reference still computes the committed digest, and
  that the port's case on the reference's state
  reproduces it within 1e-12.
"""

import json

import numpy as np
import pytest
import torch

import pace_torch.utils.translate_cases_grid as grid_cases
import pace_torch.utils.translate_cases_physics as physics_cases
import pace_tpu.utils.translate_cases_grid  # noqa: F401  (registers)
import pace_tpu.utils.translate_cases_physics  # noqa: F401
from pace_torch.testing import c12_dycore_run, torch_threads
from pace_torch.utils.gridtools import GridSizing
from pace_torch.utils.translate_cases import CASES, STATE_FIELDS, state_arrays
from pace_tpu.utils.translate_cases import CASES as REF_CASES
from tests.golden import make_translate_digest as golden

WHOLE_STEP = golden.WHOLE_STEP
GRID_METRIC = sorted(name for name, cls in CASES.items()
                     if issubclass(cls, grid_cases._GridCase))
PHYSICS = sorted(name for name, cls in CASES.items()
                 if cls.__module__ == physics_cases.__name__
                 and name not in WHOLE_STEP)
STATE_CASES = sorted(set(CASES) - set(WHOLE_STEP) - set(GRID_METRIC)
                     - set(PHYSICS))
BAR = 1e-9
# Cases whose compute-domain outputs read halo cells of the one-step state,
# where the two packages' states differ: the cells no step output defines
# (the states agree to 1.2e-12 of scale on the compute domain, and outside
# it w differs by 3.5, pt by 1.9e-5 and delz by 7.8e-3 of scale).  Held at
# about three times the digest error measured on the port's state; on the
# reference package's state the same cases reproduce the digest within
# 1e-12 (the slow test).  ROADMAP Queue 3 records them.
HALO_BARS = {
    "XPPM": 5e-9,          # xflux 1.175e-9
    "XPPM_2": 5e-9,        # xflux 1.011e-9
    "DelnFlux": 5e-9,      # fy 1.913e-9
    "DelnFlux_2": 5e-9,    # fy 1.913e-9
    "Del6VtFlux": 5e-9,    # fy2 1.917e-9
    "Del2Cubed": 3e-8,     # qdel 9.313e-9
    "NH_P_Grad": 3e-4,     # u 7.680e-5 (gz from delz)
}
# Cases whose outputs on identical inputs differ from the reference's in
# the last place (XLA's and the C library's exp/log/pow, summation order,
# multiply-add contraction; the SIM1 solves and the acoustic step amplify
# them), which the per-point metric magnifies where an output is near zero
# (the cube-corner C-grid winds of the steps, surface ws) or lies in halo
# cells no operator defines (FVSubgridZ's pt, SatAdjust3d's q_con): the
# slow test holds each on the compute domain at about ten times the error
# measured there (`TranslateCase.domain_errors`, in brackets), and every
# other case at its own max_error.  ROADMAP Queue 3 records them.
REFERENCE_BOUNDS = {
    "A2B_Ord4": 2e-15,                   # vort 1.791e-16
    "FVSubgridZ": 1e-14,                 # 0 (pt differs only off it)
    "PVarAuxiliaryPressureVars": 3e-14,  # delz 2.664e-15
    "Riem_Solver_C": 2e-14,              # gz 1.353e-15
    "Riem_Solver3": 2e-13,               # ppe 1.620e-14
    "SatAdjust3d": 2e-12,                # qliquid 1.907e-13
    "UpdateDzD": 2e-10,                  # ws 2.265e-11
    "DynCore": 2e-10,                    # wsd 1.848e-11
    "FVDynamics": 1e-9,                  # w 1.199e-12
    "Driver": 1e-9,                      # w 1.199e-12
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torch_threads(1):
        yield


def port_c12_run():
    """(sizing, CPU grid data, state0, state after one step) of the port
    at C12/79 float64, the states as {field: numpy array}."""
    sizing, core, (state0, state1) = c12_dycore_run(torch.float64, 1)
    return (sizing, core.grid_data, state_arrays(state0),
            state_arrays(state1))


def check_case_digest(name, sizing, gd, s0, s1, scales=None):
    """Case `name` on the CPU on s0/s1 against its committed digest at
    BAR, or its HALO_BARS entry, of each output's scale (or of its entry
    in `scales`)."""
    with open(golden.PATH) as f:
        ref = json.load(f)[name]
    case = CASES[name](sizing, gd, device="cpu")
    got = golden.case_digests(case, case.make_inputs(s0, s1, gd))
    assert sorted(got) == sorted(ref)
    failures = golden.digest_failures(got, ref, HALO_BARS.get(name, BAR),
                                      scales)
    assert not failures, failures


@pytest.fixture(scope="module")
def port_run():
    return port_c12_run()


@pytest.mark.parametrize("name", sorted(REF_CASES))
def test_registry_matches_reference(name):
    assert sorted(CASES) == sorted(REF_CASES)
    ours = CASES[name](GridSizing(12, 79), None, device="cpu")
    theirs = REF_CASES[name](GridSizing(12, 79), None)
    for attr in ("in_vars", "out_vars"):
        a, b = getattr(ours, attr), getattr(theirs, attr)
        assert list(a) == list(b), attr
        assert all(vars(a[k]) == vars(b[k]) for k in a), attr
    assert ours.stagger == theirs.stagger
    assert ours.savepoint_name == theirs.savepoint_name == name
    for attr in ("max_error", "near_zero"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert tuple(ours.ignore_near_zero_errors) == tuple(
        theirs.ignore_near_zero_errors)


@pytest.mark.parametrize("name", STATE_CASES)
def test_case_matches_reference_digest(name, port_run):
    check_case_digest(name, *port_run)


# ---------------------------------------------------------------------------
# slow: every case against a savepoint the reference package writes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_run():
    return golden.reference_states()


@pytest.fixture(scope="module")
def committed_digest():
    with open(golden.PATH) as f:
        return json.load(f)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(REF_CASES))
def test_case_validates_against_reference_savepoint(
        name, reference_run, committed_digest, tmp_path):
    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.utils.translate import SavepointDataset
    from pace_tpu.utils.translate import write_savepoint

    sizing, ref_gd, state0, state1 = reference_run
    s0, s1 = ({f: np.asarray(getattr(s, f), np.float64)
               for f in STATE_FIELDS} for s in (state0, state1))
    gd = generate_grid_data(12, 79, device="cpu", dtype=torch.float64)
    ref_case = REF_CASES[name](sizing, ref_gd)
    case = CASES[name](GridSizing(12, 79), gd, device="cpu")
    inputs = case.make_inputs(s0, s1, gd)
    expect = golden.reference_inputs(name, ref_case, sizing, ref_gd, state0,
                                     state1)
    assert sorted(inputs) == sorted(expect)
    for key in expect:
        np.testing.assert_array_equal(np.asarray(inputs[key], np.float64),
                                      np.asarray(expect[key], np.float64),
                                      key)
    blocks = golden.blocks(ref_case, inputs)
    outputs = ref_case.compute(ref_case.assemble(blocks))
    write_savepoint(str(tmp_path), name, blocks,
                    golden.output_blocks(ref_case, outputs))
    dataset = SavepointDataset(str(tmp_path), name)
    if name in REFERENCE_BOUNDS:
        errors, _ = case.domain_errors(dataset)
        assert max(errors.values()) <= REFERENCE_BOUNDS[name], errors
    else:
        errors = case.validate(dataset)
        assert all(err <= case.max_error or np.isnan(err)
                   for err in errors.values()), errors
    if name not in WHOLE_STEP:
        from tests.golden.op_suite import digest

        failures = golden.digest_failures(
            {var: digest(outputs[var]) for var in ref_case.out_vars},
            committed_digest[name], 1e-12)
        assert not failures, failures
        # the port's case on the reference's state: the digest within 1e-12
        failures = golden.digest_failures(
            golden.case_digests(case, inputs), committed_digest[name],
            1e-12)
        assert not failures, failures
