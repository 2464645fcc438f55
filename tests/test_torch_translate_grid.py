"""The port's grid-metric translate cases (GnomonicGrids, MirrorGrid,
GridAreas, GridGrid, DxDy, AGrid, InitGrid, SetEta, UtilVectors, TrigSg,
AAMCorrection, DerivedTrig, DivgDel6, InitCubedtoLatLon, EdgeFactors,
InitGridUtils): each reads only the port's C12/79 float64 GridData, and
its outputs are held at 1e-9 of scale to the reference package's in
tests/golden/c12_translate_digest.json; each also round-trips through a
54-rank savepoint of its own exactly."""

import pytest
import torch

from pace_torch.testing import torch_threads
from pace_torch.utils.gridtools import GridSizing
from tests.test_torch_translate_cases import GRID_METRIC, check_case_digest


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def grid():
    from pace_torch.grid.generation import generate_grid_data

    return (GridSizing(12, 79),
            generate_grid_data(12, 79, device="cpu", dtype=torch.float64))


def test_every_grid_case_is_here():
    assert len(GRID_METRIC) == 16


@pytest.mark.parametrize("name", GRID_METRIC)
def test_grid_case_matches_reference_digest(name, grid):
    check_case_digest(name, *grid, None, None)


@pytest.mark.parametrize("name", GRID_METRIC)
def test_grid_case_round_trips_a_54_rank_savepoint(name, grid, tmp_path):
    from pace_torch.utils.translate import (
        SavepointDataset,
        write_case_savepoint,
    )
    from pace_torch.utils.translate_cases import CASES

    sizing, gd = grid
    case = CASES[name](sizing, gd, layout=(3, 3), device="cpu")
    write_case_savepoint(case, case.make_inputs(None, None, gd),
                         str(tmp_path))
    errors = case.validate(SavepointDataset(str(tmp_path), name))
    assert all(err == 0.0 for err in errors.values()), errors
