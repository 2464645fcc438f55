"""The port's MLP microphysics emulator (an `nn.Module`) against the
reference package's on the same numpy inputs and the same weights: the
reference's drawn parameters, with the (zero) output layer replaced by a
seeded non-zero one so that the network does work, are loaded into the
port as numpy.

Bars, of each tendency's scale: computing in float64, 1e-12 (the
arithmetic: normalisation, tanh-GELU, slicing, the conservation fix-up);
in float32, 1e-5 (the two CPU matmuls sum 264 products in different
orders); in bfloat16, 2e-2 (bfloat16 carries 8 bits and the two libraries
round the accumulations at different points)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pace_tpu.models.physics import emulator as ref_em
from pace_tpu.models.physics.microphysics import (
    MicrophysicsState as RefState,
)
from pace_torch.models.physics import emulator as em
from pace_torch.models.physics.microphysics import MicrophysicsState
from pace_torch.testing import microphysics_inputs, torch_threads

NZ = 24
HIDDEN = (64, 48, 32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _weights(ref_model, seed=4, out_scale=0.05):
    params = {k: np.asarray(v) for k, v in ref_model.params.items()}
    last = f"w{len(HIDDEN)}"
    rng = np.random.default_rng(seed)
    params[last] = (out_scale * rng.standard_normal(params[last].shape)
                    ).astype(np.float32)
    params[f"b{len(HIDDEN)}"] = (
        out_scale * rng.standard_normal(params[last].shape[1])
    ).astype(np.float32)
    return params


def _both(compute_dtype, state_dtype=np.float64, conserve_water=True):
    arrays = microphysics_inputs((4, 3, NZ), supersat_k=18)
    kw = dict(hidden_sizes=HIDDEN, compute_dtype=compute_dtype,
              conserve_water=conserve_water)
    ref_model = ref_em.MicrophysicsEmulator(ref_em.MLPEmulatorConfig(**kw),
                                            NZ)
    params = _weights(ref_model)
    ref_model.params = {k: jnp.asarray(v) for k, v in params.items()}
    ref = ref_model(RefState(**{
        k: jnp.asarray(v.astype(state_dtype)) for k, v in arrays.items()}))
    model = em.MicrophysicsEmulator(em.MLPEmulatorConfig(**kw), NZ,
                                    device="cpu")
    model.load_numpy_params(params)
    tdtype = torch.float64 if state_dtype == np.float64 else torch.float32
    got = model(MicrophysicsState.from_numpy(arrays, "cpu", tdtype))
    return arrays, {k: np.asarray(v) for k, v in ref.items()}, \
        {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("compute_dtype, state_dtype, tol", [
    ("float64", np.float64, 1e-12),
    ("float32", np.float64, 1e-5),
    ("float32", np.float32, 1e-5),
    ("bfloat16", np.float32, 2e-2),
])
def test_emulator_matches_reference(compute_dtype, state_dtype, tol):
    arrays, ref, got = _both(compute_dtype, state_dtype)
    assert set(got) == set(ref)
    bad = {}
    for key, r in ref.items():
        assert got[key].dtype == r.dtype, key
        scale = float(np.abs(r).max())
        err = float(np.abs(got[key].astype(np.float64) - r).max())
        if not err <= tol * max(scale, 1e-300):
            bad[key] = (err, scale)
    assert not bad, bad
    assert float(np.abs(ref["pt_dt"]).max()) > 0


@pytest.mark.parametrize("conserve_water", [True, False])
def test_conserve_water(conserve_water):
    arrays, ref, got = _both("float32", conserve_water=conserve_water)
    total = sum(got[k] for k in em.WATER_TENDENCIES)
    column = np.abs((total * arrays["delp"]).sum(-1)).max()
    gross = np.abs(total * arrays["delp"]).sum(-1).max()
    if conserve_water:
        assert column <= 1e-12 * gross
    else:
        assert column > 1e-3 * gross
    np.testing.assert_allclose(
        got["qv_dt"], ref["qv_dt"], rtol=0,
        atol=1e-5 * float(np.abs(ref["qv_dt"]).max()))


def test_untrained_emulator_is_a_noop_in_both():
    arrays = microphysics_inputs((2, 2, NZ))
    ref = ref_em.MicrophysicsEmulator(ref_em.MLPEmulatorConfig(), NZ)(
        RefState(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    got = em.MicrophysicsEmulator(em.MLPEmulatorConfig(), NZ, device="cpu")(
        MicrophysicsState.from_numpy(arrays, "cpu", torch.float64))
    for key in em.OUTPUT_FIELDS + ("udt", "vdt"):
        assert float(np.abs(np.asarray(ref[key])).max()) == 0.0, key
        assert float(got[key].abs().max()) == 0.0, key
    np.testing.assert_array_equal(got["wmp"].numpy(), arrays["wmp"])


def test_config_and_tables_equal_reference():
    assert dataclasses.asdict(em.MLPEmulatorConfig()) == \
        dataclasses.asdict(ref_em.MLPEmulatorConfig())
    assert em.INPUT_FIELDS == ref_em.INPUT_FIELDS
    assert em.OUTPUT_FIELDS == ref_em.OUTPUT_FIELDS
    assert em.WATER_TENDENCIES == ref_em.WATER_TENDENCIES
    assert em._INPUT_SCALE == ref_em._INPUT_SCALE
    assert em._OUTPUT_SCALE == ref_em._OUTPUT_SCALE


def test_init_is_he_seeded_and_a_module():
    cfg = em.MLPEmulatorConfig(hidden_sizes=HIDDEN, seed=7)
    a = em.MicrophysicsEmulator(cfg, NZ, device="cpu")
    b = em.MicrophysicsEmulator(cfg, NZ, device="cpu")
    c = em.MicrophysicsEmulator(dataclasses.replace(cfg, seed=8), NZ,
                                device="cpu")
    assert isinstance(a, nn.Module)
    ref_shapes = {k: v.shape for k, v in ref_em._init_params(
        ref_em.MLPEmulatorConfig(hidden_sizes=HIDDEN), NZ).items()}
    assert {k: tuple(v.shape) for k, v in a.weights.items()} == ref_shapes
    assert sorted(k.split(".")[-1] for k in a.state_dict()) == \
        sorted(ref_shapes)
    for key in ref_shapes:
        assert torch.equal(a.weights[key], b.weights[key])
        assert a.weights[key].dtype == torch.float32
        assert not a.weights[key].requires_grad
    assert not torch.equal(a.weights["w0"], c.weights["w0"])
    n_in = NZ * len(em.INPUT_FIELDS)
    assert abs(float(a.weights["w0"].std()) / np.sqrt(2.0 / n_in) - 1) < 0.05
    assert float(a.weights[f"w{len(HIDDEN)}"].abs().max()) == 0.0
    assert all(float(a.weights[f"b{i}"].abs().max()) == 0.0
               for i in range(len(HIDDEN) + 1))


def test_npz_files_pass_between_the_packages(tmp_path):
    ref_cfg = ref_em.MLPEmulatorConfig(hidden_sizes=HIDDEN)
    params = _weights(ref_em.MicrophysicsEmulator(ref_cfg, NZ))
    ref_path = str(tmp_path / "ref.npz")
    ref_em.save_params({k: jnp.asarray(v) for k, v in params.items()},
                       ref_path)
    model = em.MicrophysicsEmulator(
        em.MLPEmulatorConfig(hidden_sizes=HIDDEN, weights_path=ref_path), NZ,
        device="cpu")
    for key, value in params.items():
        np.testing.assert_array_equal(model.weights[key].numpy(), value)
    port_path = str(tmp_path / "port.npz")
    em.save_params(dict(model.weights), port_path)
    back = ref_em.load_params(port_path)
    assert sorted(back) == sorted(params)
    for key, value in params.items():
        np.testing.assert_array_equal(np.asarray(back[key]), value)
    loaded = em.load_params(port_path)
    assert all(isinstance(v, np.ndarray) for v in loaded.values())


def test_wrong_device_raises():
    model = em.MicrophysicsEmulator(em.MLPEmulatorConfig(), NZ, device="cpu")
    state = MicrophysicsState.from_numpy(microphysics_inputs((2, 2, NZ)),
                                         "meta", torch.float32)
    with pytest.raises(ValueError):
        model(state)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_rows_do_not_depend_on_the_count(compute_dtype):
    """A block of columns gets the results it gets among more columns: the
    products take BLOCK_ROWS rows at a time, whatever the tensor holds."""
    net = em.MicrophysicsEmulator(
        em.MLPEmulatorConfig(hidden_sizes=(32, 32), seed=11,
                             compute_dtype=compute_dtype), 8, device="cpu")
    g = torch.Generator().manual_seed(7)
    for key in list(net.weights):
        net.weights[key].data.copy_(torch.randn(
            net.weights[key].shape, generator=g))
    x = torch.randn(6, 30, 30, 8 * len(em.INPUT_FIELDS), generator=g)
    whole = net._forward(x)
    block = (slice(0, 3), slice(11, 30), slice(13, 30))
    assert torch.equal(net._forward(x[block].contiguous()), whole[block])
