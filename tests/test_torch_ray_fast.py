"""The port's Rayleigh sponge-layer friction (`ops.nh_p_grad.ray_fast`)
against the reference package's, nonhydrostatic and hydrostatic (w left
alone), on seeded inputs at 1e-12; and the `Ray_Fast` translate case
under a hydrostatic config against the outputs the reference's case
writes, at the case's own threshold."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pace_torch.grid import eta
from pace_torch.ops.nh_p_grad import ray_fast
from pace_tpu.ops.nh_p_grad import ray_fast as ref_ray_fast

NZ = 79
DT, RF_CUTOFF, TAU = 112.5, 3000.0, 10.0


def _columns():
    """(dp_ref, pfull, ptop) of the standard 79-level tables."""
    vertical = eta.set_hybrid_pressure_coefficients(NZ)
    ph = np.asarray(vertical.ak) + np.asarray(vertical.bk) * 1.0e5
    dp = ph[1:] - ph[:-1]
    return dp, dp / np.log(ph[1:] / ph[:-1]), float(vertical.ptop)


@pytest.mark.parametrize("hydrostatic", [False, True])
def test_ray_fast_matches_reference(hydrostatic):
    rng = np.random.default_rng(4)
    u, v, w = (rng.standard_normal((2, 7, 6, NZ)) * 20.0 for _ in range(3))
    dp, pfull, ptop = _columns()
    assert (pfull < RF_CUTOFF).sum() > 3  # some levels are damped
    got = ray_fast(*(torch.tensor(a) for a in (u, v, w)), dp, pfull, DT,
                   ptop, RF_CUTOFF, TAU, hydrostatic)
    want = ref_ray_fast(*(jnp.asarray(a) for a in (u, v, w)), dp, pfull,
                        DT, ptop, RF_CUTOFF, TAU, hydrostatic)
    for name, g, r, before in zip("uvw", got, want, (u, v, w)):
        r = np.asarray(r)
        err = np.abs(g.numpy() - r).max() / np.abs(r).max()
        assert err <= 1e-12, (name, err)
        assert not np.array_equal(r, before) or (name == "w" and hydrostatic)
    if hydrostatic:
        assert np.array_equal(got[2].numpy(), w)


def test_ray_fast_case_under_a_hydrostatic_config(tmp_path):
    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.models.fv3.config import DynamicalCoreConfig
    from pace_torch.utils.gridtools import GridSizing
    from pace_torch.utils.translate import SavepointDataset
    from pace_torch.utils.translate_cases import CASES
    from pace_tpu.models.fv3.config import (
        DynamicalCoreConfig as RefConfig,
    )
    from pace_tpu.utils.gridtools import GridSizing as RefSizing
    from pace_tpu.utils.translate import write_savepoint
    from pace_tpu.utils.translate_cases import CASES as REF_CASES
    from tests.golden import make_translate_digest as golden

    gd = generate_grid_data(12, NZ, device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(5)
    shape = tuple(gd.horizontal.area.shape) + (NZ,)
    s1 = {k: rng.standard_normal(shape) * 20.0 for k in "uvw"}
    case = CASES["Ray_Fast"](GridSizing(12, NZ), gd,
                             DynamicalCoreConfig(hydrostatic=True,
                                                 do_sat_adj=False),
                             device="cpu")
    ref_case = REF_CASES["Ray_Fast"](RefSizing(12, NZ), None,
                                     RefConfig(hydrostatic=True,
                                               do_sat_adj=False))
    inputs = case.make_inputs(None, s1, gd)
    blocks = golden.blocks(ref_case, inputs)
    outputs = ref_case.compute(ref_case.assemble(blocks))
    write_savepoint(str(tmp_path), "Ray_Fast", blocks,
                    golden.output_blocks(ref_case, outputs))
    errors = case.validate(SavepointDataset(str(tmp_path), "Ray_Fast"))
    assert all(err <= case.max_error for err in errors.values()), errors
    got = case.compute(case.assemble(blocks))
    assert np.array_equal(np.asarray(got["w"]), np.asarray(outputs["w"]))
    assert not np.array_equal(np.asarray(got["u"]), inputs["u"])
