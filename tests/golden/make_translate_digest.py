"""Generate tests/golden/c12_translate_digest.json, the translate cases'
digests.

Every translate case the reference package registers, apart from the three
whole-step ones (FVDynamics, Driver, DynCore), run by the reference package
on its C12/79 float64 baroclinic state and the state after one step: the
case's inputs, made finite and cut into the 6-rank savepoint blocks,
reassembled, computed, and each output digested with
tests/golden/op_suite.py:digest.  tests/test_torch_translate_cases.py holds
the port's cases to this file, and its slow test checks that the
reference still computes it.

Run deliberately after intentional numerics changes:
    python tests/golden/make_translate_digest.py
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

PATH = os.path.join(os.path.dirname(__file__), "c12_translate_digest.json")
WHOLE_STEP = ("FVDynamics", "Driver", "DynCore")
N_, NZ, DT = 12, 79, 225.0


def reference_states():
    """(sizing, grid data, state0, state after one jitted step) of the
    reference package at C12/79 float64 (as conftest's c12_f64_run)."""
    import jax
    import jax.numpy as jnp

    from pace_tpu.grid.generation import generate_grid_data
    from pace_tpu.models.fv3.config import DynamicalCoreConfig
    from pace_tpu.models.fv3.dynamics import DynamicalCore
    from pace_tpu.models.fv3.init.baroclinic import init_baroclinic_state
    from pace_tpu.utils.gridtools import GridSizing

    sizing = GridSizing(N_, NZ)
    gd = generate_grid_data(N_, NZ, dtype=jnp.float64)
    core = DynamicalCore(DynamicalCoreConfig(do_sat_adj=False), sizing, gd,
                         timestep=DT)
    state0 = init_baroclinic_state(sizing, dtype=jnp.float64)
    return sizing, gd, state0, jax.jit(core.step_dynamics)(state0)


def reference_inputs(name, case, sizing, gd, state0, state1):
    """The reference's global inputs of case `name`: its make_inputs, or
    for the cases without one, tests/test_translate_cases.py's builder
    (which builds Driver's as FVDynamics')."""
    from tests.test_translate_cases import _build_inputs

    return _build_inputs("FVDynamics" if name == "Driver" else name, sizing,
                         gd, state0, state1, case=case)


def blocks(case, inputs):
    """tests/test_translate_cases.py:_roundtrip's input blocks: inputs made
    finite and cut into each rank's savepoint block."""
    inputs = {
        k: (np.nan_to_num(v, nan=0.0, posinf=0.0, neginf=0.0)
            if np.ndim(v) else v)
        for k, v in inputs.items()
    }
    per_rank = []
    for rank in range(case.n_ranks):
        rin = {}
        for name, spec in case.in_vars.items():
            if name not in inputs:
                assert spec.optional, name
                continue
            v = inputs[name]
            rin[spec.serialname or name] = (
                np.float64(v) if np.ndim(v) == 0 else case.decompose(
                    name, v, rank, staggered=case.stagger.get(name, (0, 0))))
        per_rank.append(rin)
    return per_rank


def output_blocks(case, outputs):
    """Each rank's output blocks, as tests/test_translate_cases.py writes
    them."""
    return [
        {spec.serialname or name: case.decompose(
            name, outputs[name], rank, spec_map=case.out_vars,
            staggered=case.stagger.get(name, (0, 0)))
         for name, spec in case.out_vars.items()}
        for rank in range(case.n_ranks)
    ]


def case_outputs(case, inputs) -> dict:
    """What `case` computes from the reassembled blocks of `inputs` (either
    package's case)."""
    return case.compute(case.assemble(blocks(case, inputs)))


def case_digests(case, inputs) -> dict:
    from tests.golden.op_suite import digest

    outputs = case_outputs(case, inputs)
    return {var: digest(outputs[var]) for var in case.out_vars}


def digest_failures(got: dict, ref: dict, tol: float,
                    scales: dict = None) -> list:
    """The entries of digest `got` off `ref` by more than tol of the
    output's scale (max |min|, |max|, or its entry in `scales`): the
    statistics absolutely, the samples also relatively
    (tests/test_torch_dycore.py's rule); NaN must meet NaN."""
    failures = []
    for var, r in ref.items():
        g = got[var]
        scale = (scales or {}).get(var) or max(abs(r["max"]), abs(r["min"]),
                                               1e-30)
        if not np.isfinite(scale):
            scale = 1e-30
        for stat in ("mean", "std", "min", "max"):
            a, b = g[stat], r[stat]
            if not (a == b or abs(a - b) <= tol * scale
                    or (np.isnan(a) and np.isnan(b))):
                failures.append(f"{var}.{stat}: {a} != {b}")
        try:
            np.testing.assert_allclose(g["samples"], r["samples"], rtol=tol,
                                       atol=tol * scale)
        except AssertionError as err:
            failures.append(f"{var}.samples: {err}")
    return failures


def reference_digests(sizing, gd, state0, state1) -> dict:
    """{case: {output: digest}} of every case but the whole-step ones."""
    import pace_tpu.utils.translate_cases_grid  # noqa: F401  (registers)
    import pace_tpu.utils.translate_cases_physics  # noqa: F401
    from pace_tpu.utils.translate_cases import CASES

    out = {}
    for name in sorted(set(CASES) - set(WHOLE_STEP)):
        case = CASES[name](sizing, gd)
        out[name] = case_digests(case, reference_inputs(
            name, case, sizing, gd, state0, state1))
    return out


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    golden = reference_digests(*reference_states())
    with open(PATH, "w") as f:
        json.dump(golden, f, indent=1)
    print(f"wrote {PATH} ({len(golden)} cases)")


if __name__ == "__main__":
    main()
