"""A rank builds only its own block of the grid
(`generate_grid_data(..., part=Partition.part(rank))`, the metric terms
evaluated at the block's points and its halo's sources by
`grid/points.py`): for every rank of (1, 2, 2), (2, 2, 2), (1, 2, 4) and
(6, 2, 2) at C12/79 float64, and for a stretched grid (factor 2.5) at
(1, 2, 2), every leaf of the rank's grid equals the whole cube's grid cut
to the rank bit for bit, halo included, and the four area extremes are
the whole cube's.  The pointwise terms, before the grid's clamp of NaN
and infinities, equal the reference package's whole-cube terms at every
storage point (NaN for NaN); the pointwise halo sources equal the
topology's gather maps, and the pointwise gnomonic corners the cube's.
Everything runs in this process, with the whole cube's metric terms made
to raise where a rank builds."""

import dataclasses

import numpy as np
import pytest
import torch

from pace_torch.grid import generation, gnomonic
from pace_torch.grid.generation import (
    EDGE_TABLE_AXIS,
    POINT_TERMS,
    generate_grid_data,
)
from pace_torch.grid.points import PointMetrics
from pace_torch.parallel.partition import Partition
from pace_torch.parallel.topology import get_topology
from pace_torch.testing import torch_threads

N_, NZ = 12, 79
LAYOUTS = [(1, 2, 2), (2, 2, 2), (1, 2, 4), (6, 2, 2)]
STRETCH = dict(stretch_factor=2.5, lon_target=20.0, lat_target=30.0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torch_threads(1):
        yield


def _leaves(grid) -> dict:
    out = {}
    for bundle in ("horizontal", "angle", "damping", "vertical"):
        value = getattr(grid, bundle)
        for f in dataclasses.fields(value):
            out[f"{bundle}.{f.name}"] = getattr(value, f.name)
    return out


def _bitwise_equal(a, b) -> bool:
    """NaN where the other is NaN, elsewhere equal bit for bit (the sign
    of zero included)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return False
    nan = np.isnan(a)
    return np.array_equal(nan, np.isnan(b)) and np.array_equal(
        a[~nan].view(np.int64), b[~nan].view(np.int64))


@pytest.fixture(scope="module")
def whole():
    """The whole cube's float64 grids, unstretched and stretched."""
    return {kind: generate_grid_data(N_, NZ, device="cpu",
                                     dtype=torch.float64, **kw)
            for kind, kw in (("plain", {}), ("stretched", STRETCH))}


def _assert_rank_grids(partition, cube, monkeypatch, **kw):
    def whole_cube(*args, **kwargs):
        raise AssertionError("a rank computed the whole cube's terms")

    with monkeypatch.context() as m:
        m.setattr(generation, "_metric_terms", whole_cube)
        grids = [generate_grid_data(N_, NZ, device="cpu",
                                    dtype=torch.float64,
                                    part=partition.part(rank), **kw)
                 for rank in range(partition.size)]
    for rank, grid in enumerate(grids):
        want = _leaves(cube.scattered(partition.part(rank).cut))
        got = _leaves(grid)
        assert got.keys() == want.keys()
        for name, value in want.items():
            if isinstance(value, torch.Tensor):
                assert _bitwise_equal(got[name].numpy(), value.numpy()), (
                    rank, name)
            else:
                assert got[name] == value, (rank, name)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_every_ranks_grid_is_the_cut_of_the_whole_cube(layout, whole,
                                                       monkeypatch):
    _assert_rank_grids(Partition(layout, N_), whole["plain"], monkeypatch)


def test_a_stretched_ranks_grid_is_the_cut_of_the_whole_cube(whole,
                                                             monkeypatch):
    _assert_rank_grids(Partition((1, 2, 2), N_), whole["stretched"],
                       monkeypatch, **STRETCH)


@pytest.mark.parametrize("n,stretch", [(12, {}), (13, {}), (12, STRETCH)])
def test_pointwise_terms_are_the_references_whole_cube_terms(n, stretch):
    """Every raw term at every storage point against the reference
    package's `_generate_metric_terms`, before the grid's clamp."""
    from pace_tpu.grid.generation import _generate_metric_terms

    ref = _generate_metric_terms(n, 3, **stretch)
    metrics = PointMetrics(n, 3, **stretch)
    N = metrics.N
    t, i, j = np.meshgrid(np.arange(6), np.arange(N), np.arange(N),
                          indexing="ij")
    for bundle, names in POINT_TERMS.items():
        for name in names:
            assert _bitwise_equal(metrics.term(name, t, i, j),
                                  ref[bundle][name]), name
    tt, kk = np.meshgrid(np.arange(6), np.arange(N), indexing="ij")
    for name in EDGE_TABLE_AXIS:
        assert _bitwise_equal(metrics.edge(name, tt, kk),
                              ref["horizontal"][name]), name
    extremes = metrics.area_extremes()
    for name, value in extremes.items():
        assert value == float(ref["damping"][name]), name


def test_a_points_terms_do_not_depend_on_the_points_beside_it():
    """Terms at a few points at a time, each set in a store of its own,
    against the whole cube's."""
    raw = generation._generate_metric_terms(N_, 3)
    rng = np.random.default_rng(11)
    N = PointMetrics(N_).N
    for _ in range(20):
        metrics = PointMetrics(N_)
        t, i, j = (rng.integers(0, hi, 3) for hi in (6, N, N))
        for bundle, names in POINT_TERMS.items():
            for name in names:
                assert _bitwise_equal(metrics.term(name, t, i, j),
                                      raw[bundle][name][t, i, j]), name


def test_pointwise_halo_sources_are_the_gather_maps():
    topo = get_topology(N_, 3)
    N = topo.N
    t, i, j = np.meshgrid(np.arange(6), np.arange(N), np.arange(N),
                          indexing="ij")
    for stagger in ("center", "corner"):
        spec = topo.scalar_spec(stagger)
        got = topo.scalar_source_at(stagger, t, i, j)
        for a, b in zip(got, (spec.src_tile, spec.src_i, spec.src_j)):
            assert np.array_equal(a, b), stagger
    for pair in (("y_iface", "x_iface"), ("x_iface", "y_iface"),
                 ("center", "center")):
        for comp, spec in enumerate(topo.vector_spec(*pair)):
            got = topo.vector_source_at(*pair, comp, t, i, j)
            for a, b in zip(got, (spec.src_tile, spec.src_i, spec.src_j,
                                  spec.src_comp, spec.sign)):
                assert np.array_equal(a, b), (pair, comp)


@pytest.mark.parametrize("n", [12, 13])
def test_pointwise_corners_are_the_references_cube(n):
    """The gnomonic corners, point by point and a few at a time, against
    the reference package's whole cube."""
    from pace_tpu.grid import gnomonic as ref

    lon, lat = ref.cube_corners_lonlat(n)
    xyz = ref.cube_corners(n)
    assert _bitwise_equal(gnomonic.cube_corners(n), xyz)
    got = gnomonic.cube_corners_lonlat(n)
    assert _bitwise_equal(got[0], lon) and _bitwise_equal(got[1], lat)
    rng = np.random.default_rng(n)
    for _ in range(10):
        t, a, b = (rng.integers(0, hi, 2) for hi in (6, n + 1, n + 1))
        got = gnomonic.corner_lonlat_at(n, t, a, b)
        assert _bitwise_equal(got[0], lon[t, a, b])
        assert _bitwise_equal(got[1], lat[t, a, b])
        assert _bitwise_equal(gnomonic.corner_xyz_at(n, t, a, b),
                              xyz[t, a, b])
