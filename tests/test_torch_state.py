"""`DycoreState.replace` and `DycoreState.tracers` against the reference
package's (`pace_tpu.models.fv3.state`), on one seeded float64 state
built in both: the returned fields are equal bit for bit, the tracer dicts
have the same names in the same order, and `replace` leaves the state it
is called on as it was."""

import dataclasses

import numpy as np
import pytest
import torch

from pace_torch.models.fv3.state import (
    FIELD_METADATA,
    TRACER_NAMES,
    DycoreState,
    zeros_numpy,
)
from pace_torch.utils.gridtools import GridSizing

SIZING = GridSizing(12, 5)


@pytest.fixture(scope="module")
def states():
    import jax.numpy as jnp

    from pace_tpu.models.fv3.state import DycoreState as RefState

    rng = np.random.default_rng(7)
    arrays = {name: rng.standard_normal(a.shape)
              for name, a in zeros_numpy(SIZING).items()}
    return (arrays, DycoreState.from_numpy(arrays, "cpu", torch.float64),
            RefState.from_numpy(arrays, jnp.float64))


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a.view(np.int64),
                                                 b.view(np.int64))


@pytest.mark.parametrize("names", [None, ("qrain", "qvapor"), ()])
def test_tracers_match_the_reference(states, names):
    _, state, ref = states
    kw = {} if names is None else {"names": names}
    got, want = state.tracers(**kw), ref.tracers(**kw)
    assert list(got) == list(want) == list(names if names is not None
                                           else TRACER_NAMES)
    for name in got:
        assert got[name] is getattr(state, name)
        assert _same(got[name].numpy(), want[name]), name


def test_replace_matches_the_reference(states):
    arrays, state, ref = states
    rng = np.random.default_rng(8)
    new = {name: rng.standard_normal(arrays[name].shape)
           for name in ("pt", "qvapor", "phis")}
    got = state.replace(**{k: torch.tensor(v) for k, v in new.items()})
    want = ref.replace(**{k: np.asarray(v) for k, v in new.items()})
    assert type(got) is DycoreState
    for name in FIELD_METADATA:
        assert _same(getattr(got, name).numpy(), getattr(want, name)), name
        if name not in new:
            assert getattr(got, name) is getattr(state, name)
        assert _same(getattr(state, name).numpy(), arrays[name]), name
    with pytest.raises(TypeError):
        state.replace(not_a_field=state.pt)
    assert [f.name for f in dataclasses.fields(got)] == list(FIELD_METADATA)
