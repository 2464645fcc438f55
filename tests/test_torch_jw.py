"""The JW baroclinic-wave validation runs of the port
(pace_torch/validation):

- the day-1 anchor's digest has the committed record's layout, and `check`
  finds a difference where there is one;
- the nine-day run's daily record is taken as scripts/jw_regression.py
  takes it;
- slow tier: the port's C12/79 float64 day on the CPU lies within 1e-7 of
  tests/golden/jw_day1_c12_f64.json, the generator's gate
  (tests/golden/make_jw_day1.py)."""

import json
import os

import numpy as np
import pytest
import torch

from pace_torch.testing import torch_threads
from pace_torch.validation import jw_day1

RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "jw_day1_c12_f64.json")


@pytest.fixture(scope="module")
def record():
    with open(RECORD) as f:
        return json.load(f)


def test_anchor_program_is_the_generators(record):
    """The port runs the program the record was made with."""
    from tests.golden import make_jw_day1

    assert record["config"] == {
        "n": jw_day1.N, "nz": jw_day1.NZ, "dt": jw_day1.DT,
        "steps": jw_day1.STEPS, "k_split": 1, "n_split": 4,
        "dtype": "float64"}
    assert jw_day1.FIELDS == make_jw_day1.FIELDS
    assert jw_day1.RTOL == make_jw_day1.RTOL
    with torch_threads(1):
        core, state = jw_day1.setup("cpu", torch.float64)
    assert (core.config.k_split, core.config.n_split, core.timestep,
            core.config.do_sat_adj) == (1, 4, 450.0, True)
    assert set(jw_day1.digest(state)) == set(record["digest"])


def test_check_finds_a_difference(record):
    digest = record["digest"]
    worst, bad = jw_day1.check(digest, digest)
    assert bad == [] and max(worst.values()) == 0.0
    moved = {k: list(v) for k, v in digest.items()}
    moved["pt"][2] *= 1.0 + 3e-7
    moved["w"][0] = float("nan")
    worst, bad = jw_day1.check(digest, moved)
    assert bad == ["pt", "w"]
    assert 2.9e-7 < worst["pt"] < 3.1e-7


def test_nine_day_record_of_a_day():
    from pace_torch.validation.jw_baroclinic_wave import day_record

    ps = np.full((6, 4, 4), 100000.0)
    ps[2, 1, 3] = 96000.0
    va = np.zeros((6, 4, 4))
    va[5, 0, 0] = -21.5
    lon = np.deg2rad(np.arange(96.0).reshape(6, 4, 4))
    lat = np.deg2rad(np.full((6, 4, 4), 45.0))
    rec = day_record(9, ps, va, lon, lat)
    assert rec == {"day": 9, "ps_min_hpa": 960.0, "ps_max_hpa": 1000.0,
                   "max_abs_va": 21.5, "ps_min_lon_deg": 39.0,
                   "ps_min_lat_deg": 45.0}


@pytest.mark.slow
def test_port_day1_matches_the_anchor(record):
    """192 steps of the port's plain versions on the CPU (several minutes
    a thread)."""
    with torch_threads(4):
        got = jw_day1.run_day1("cpu", torch.float64)
    worst, bad = jw_day1.check(record["digest"], got)
    assert not bad, {k: worst[k] for k in bad}
