"""The port's nine-day Jablonowski & Williamson (2006) baroclinic wave on
the card, held to the published-behaviour bars that
tests/test_jw_regression.py holds the reference's record to (JW06 Figs.
6-8: quiet until ~day 4, explosive deepening to ~960-975 hPa by day 9 at
medium resolution, the cyclone in the northern mid-latitudes downstream of
the 20E perturbation).

`pace_torch/validation/jw_day9_h100.json` is the record of
`python -m pace_torch.validation.jw_baroclinic_wave 9` on an NVIDIA H100
(C24/79 float32, dt=300 s, k_split=1, n_split=4); it names the card and
its power limit.  Regenerate it on the card after a numerics change, never
by hand."""

import json
import os

import pytest

ARTIFACT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "pace_torch", "validation", "jw_day9_h100.json")


@pytest.fixture(scope="module")
def artifact():
    with open(ARTIFACT) as f:
        return json.load(f)


def _day(artifact, d):
    for rec in artifact["days"]:
        if rec["day"] == d:
            return rec
    raise AssertionError(f"day {d} missing from artifact")


def test_record_is_the_cards_nine_days(artifact):
    assert [r["day"] for r in artifact["days"]] == list(range(1, 10))
    assert artifact["config"] == {"n": 24, "nz": 79, "dt": 300.0,
                                  "n_split": 4, "k_split": 1,
                                  "dtype": "float32"}
    assert artifact["platform"] == "gpu"
    assert "H100" in artifact["device"] and "W" in artifact["card"]


def test_early_days_quiescent(artifact):
    for d in (1, 2, 3, 4):
        rec = _day(artifact, d)
        assert 995.0 < rec["ps_min_hpa"] < 1001.0, rec
        assert rec["max_abs_va"] < 10.0, rec


def test_explosive_deepening_by_day9(artifact):
    d8, d9 = _day(artifact, 8), _day(artifact, 9)
    assert d8["ps_min_hpa"] < 990.0, d8
    assert 945.0 < d9["ps_min_hpa"] < 985.0, d9
    assert 15.0 < d9["max_abs_va"] < 60.0, d9
    assert d9["ps_min_hpa"] < d8["ps_min_hpa"], (d8, d9)


def test_monotone_amplification(artifact):
    mins = [_day(artifact, d)["ps_min_hpa"] for d in range(5, 10)]
    assert all(b <= a + 0.5 for a, b in zip(mins, mins[1:])), mins


def test_cyclone_position(artifact):
    d9 = _day(artifact, 9)
    assert 25.0 < d9["ps_min_lat_deg"] < 85.0, d9
    lon = d9["ps_min_lon_deg"] % 360.0
    assert 60.0 < lon < 300.0, d9


def test_pressure_stays_physical(artifact):
    for rec in artifact["days"]:
        assert 900.0 < rec["ps_min_hpa"] <= rec["ps_max_hpa"] < 1080.0
