"""Rank 0 writes a multi-rank run's output one field at a time
(`utils/host.fields_on_root`): four gloo processes of layout (1, 2, 2) at
C12/79 each hold their block of one seeded float32 state and their block
of the grid, and write a restart (npy and NetCDF) and diagnostics (npz,
NetCDF and zarr, with the grid) through the port's writers; the same
writers in this process write the whole state as one rank does.  Every
file equals the one-process run's: byte for byte, but for the .npz
archives (whose members carry the time they were written), whose arrays
are compared.  On rank 0 each whole-cube array `Partition.gather`
assembles is tracked: when it assembles the next, none of the earlier is
alive (but in the NetCDF time series, whose monitor keeps whole records).
The NetCDF writer, which writes the header first and then each variable
in turn, also writes the bytes of scipy's writer.

The ranks run with `jax` made unimportable."""

import datetime
import json
import os
import pathlib
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
N_, NZ = 12, 79
LAYOUT = (1, 2, 2)
TIME = datetime.datetime(2016, 8, 1, 0, 15)
DIAGNOSTICS = dict(names=["pt", "ps", "qvapor", "u", "v"],
                   derived_names=["column_integrated_qvapor"],
                   z_select=[(3, ["pt"])])

_RANK = r"""
import sys
sys.modules["jax"] = None
from tests.test_torch_root_writes import rank_main
rank_main(*sys.argv[1:])
"""


def _whole_state() -> dict:
    """Seeded float32 values at every storage point of every field."""
    from pace_torch.models.fv3.state import zeros_numpy
    from pace_torch.utils.gridtools import GridSizing

    rng = np.random.default_rng(12)
    return {name: rng.standard_normal(a.shape, dtype=np.float32)
            for name, a in zeros_numpy(GridSizing(N_, NZ)).items()}


class _Alive:
    """The whole-cube arrays `Partition.gather` returned that are still
    alive when it is called again (the most seen, per writer)."""

    def __init__(self):
        self.refs, self.most, self.on = [], {}, None

    def install(self):
        from pace_torch.parallel.partition import Partition

        gather = Partition.gather

        def tracked(partition, parts):
            if self.on is not None:
                # no reference cycle holds a field: reference counting
                # frees one as soon as the writer drops it
                alive = sum(r() is not None for r in self.refs)
                self.most[self.on] = max(self.most.get(self.on, 0), alive)
            out = gather(partition, parts)
            self.refs.append(weakref.ref(out))
            return out

        Partition.gather = tracked

    def writer(self, name):
        self.on, self.refs = name, []


def write_all(root: str, state, grid, ranks, alive=None) -> None:
    """The restarts and the three diagnostics formats of `state` (two
    records) and `grid` under `root`."""
    from pace_torch.driver.diagnostics import DiagnosticsConfig, ZSelect
    from pace_torch.driver.restart import write_restart
    from pace_torch.utils.gridtools import GridSizing

    def on(name):
        if alive is not None:
            alive.writer(name)

    for fmt in ("npz", "netcdf"):
        on(f"restart {fmt}")
        write_restart(state, TIME, os.path.join(root, f"restart_{fmt}"), fmt,
                      ranks)
    for fmt in ("npz", "zarr", "netcdf"):
        on(f"diagnostics {fmt}")
        diag = DiagnosticsConfig(path=os.path.join(root, f"diag_{fmt}"),
                                 output_format=fmt, **dict(
                                     DIAGNOSTICS, z_select=[
                                         ZSelect(*z) for z in
                                         DIAGNOSTICS["z_select"]])
                                 ).diagnostics_factory(GridSizing(N_, NZ),
                                                       ranks)
        diag.store_grid(grid)
        if fmt == "netcdf":
            on(None)  # the time series keeps whole records
        for k in range(2):
            diag.store(TIME + datetime.timedelta(minutes=k), state)
        diag.cleanup()


def rank_main(rank, workdir):
    rank = int(rank)
    torch.set_num_threads(1)
    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.models.fv3.state import DycoreState
    from pace_torch.parallel.comm import init_process_group
    from pace_torch.parallel.partition import Partition

    partition = Partition(LAYOUT, N_)
    comm = init_process_group("cpu", f"file://{workdir}/group",
                              partition.size, rank)
    part = partition.part(rank)
    state = DycoreState.from_numpy(
        {k: part.cut(v) for k, v in _whole_state().items()}, "cpu",
        torch.float32)
    grid = generate_grid_data(N_, NZ, device="cpu", dtype=torch.float32,
                              part=part)
    alive = _Alive() if rank == 0 else None
    if alive is not None:
        alive.install()
    write_all(os.path.join(workdir, "ranks"), state, grid,
              (partition, comm), alive)
    if alive is not None:
        with open(os.path.join(workdir, "alive.json"), "w") as f:
            json.dump(alive.most, f)
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax",
                                                            "pace_tpu")]
    assert loaded == ["jax"] and sys.modules["jax"] is None, loaded
    import torch.distributed as dist

    dist.destroy_process_group()


def _files(root):
    return sorted(str(p.relative_to(root)) for p in pathlib.Path(
        root).rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(one-process root, ranks root, work directory): the four ranks run
    in their processes while this one writes the whole state."""
    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.models.fv3.state import DycoreState

    work = tmp_path_factory.mktemp("root_writes")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(rank), str(work)], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(int(np.prod(LAYOUT)))]
    torch.set_num_threads(1)
    try:
        state = DycoreState.from_numpy(_whole_state(), "cpu",
                                       torch.float32)
        grid = generate_grid_data(N_, NZ, device="cpu", dtype=torch.float32)
        write_all(str(work / "one"), state, grid, None)
    finally:
        errors = []
        for proc in procs:
            try:
                _, err = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                for p in procs:
                    p.kill()
                raise
            if proc.returncode:
                errors.append(err[-3000:])
    assert not errors, errors[0]
    return work / "one", work / "ranks", work


def test_the_ranks_files_are_the_one_process_files(runs):
    one, ranks, _ = runs
    files = _files(one)
    assert files == _files(ranks)
    assert {f.split("/")[0] for f in files} == {
        "restart_npz", "restart_netcdf", "diag_npz", "diag_zarr",
        "diag_netcdf"}
    for name in files:
        a, b = (root / name for root in (one, ranks))
        if name.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                assert x.files == y.files, name
                for k in x.files:
                    assert np.array_equal(x[k], y[k], equal_nan=(
                        x[k].dtype.kind == "f")), (name, k)
        else:
            assert a.read_bytes() == b.read_bytes(), name


def test_rank_0_holds_one_whole_cube_field_at_a_time(runs):
    alive = json.loads((runs[2] / "alive.json").read_text())
    assert set(alive) == {"restart npz", "restart netcdf",
                          "diagnostics npz", "diagnostics zarr",
                          "diagnostics netcdf"}
    assert all(v == 0 for v in alive.values()), alive


def test_the_restart_is_todays_writers(runs, tmp_path):
    """The one-process restart against the writers it replaced: the
    threaded .npy writer and scipy's NetCDF writer."""
    from scipy.io import netcdf_file

    from pace_torch._native.fastpack import write_state_npys

    one = runs[0]
    arrays = _whole_state()
    write_state_npys(str(tmp_path / "npy"), arrays)
    for name in arrays:
        assert (tmp_path / "npy" / f"{name}.npy").read_bytes() == (
            one / "restart_npz" / "dycore_state" / f"{name}.npy"
        ).read_bytes(), name
    path = str(tmp_path / "scipy.nc")
    f = netcdf_file(path, "w", version=2)
    f.time = str(TIME)
    for name, a in arrays.items():
        dims = ("tile", f"x_{name}", f"y_{name}", f"z_{name}")[:a.ndim]
        for d, size in zip(dims, a.shape):
            if d not in f.dimensions:
                f.createDimension(d, size)
        f.createVariable(name, "f", dims)[:] = a
    f.close()
    assert pathlib.Path(path).read_bytes() == (
        one / "restart_netcdf" / "dycore_state.nc").read_bytes()
