"""The port's multi-rank step against its one-process step (the
counterpart of tests/test_sharded_step.py for `pace_torch`).

Each rank is a real process: the ranks start a gloo group from a file
under tmp_path (so parallel test workers never share a port), run one
torch thread each, build a `Driver` of the given `mesh.layout` and step
it; rank 0 gathers the state after every step (each rank's owned box).
The ranks run with `jax` made unimportable.  Every operator is the
one-process operator restricted to a rank's block (utils/gridtools.py
`Domain`: tile-edge forms where the block holds the tile's edge lines)
and the halo exchange moves values without arithmetic, so the gathered
state must equal the one-process state bit for bit (NaNs at the same
places), halo and padding points included; the step-1 state also lies
within 1e-9 of tests/golden/c12_dycore_digest.json.

Tier 1 runs the C12/79 float64 dycore at `(2, 1, 1)` (ranks of whole
tiles) and `(1, 2, 2)` (ranks of quarter tiles) for two steps, the ranks of
both layouts started together, beside the one-process run; the slow tier
adds `(3, 1, 1)`, `(6, 1, 1)`, `(2, 2, 2)` and `(1, 2, 4)`, the coupled
step and the dynamic tracer subcycle (whose trip count is a maximum over
ranks) at `(2, 1, 1)` and `(1, 2, 2)`, and `baroclinic_c12.yaml` at
`[2, 1, 1]` and `[1, 2, 2]` through `torchrun -m pace_torch.driver.run`,
whose diagnostics and restart files must be those of the one-rank run.

Also here: the plain transport on a rank's 1 or 3 tiles equals the same
tiles of its six-tile result."""

import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
N_, NZ, DT = 12, 79, 225.0

DYCORE = dict(nx_tile=N_, nz=NZ, dt_atmos=DT, dtype="float64",
              initialization={"type": "baroclinic"}, dycore_only=True,
              dycore_config={"do_sat_adj": False})
COUPLED = dict(nx_tile=N_, nz=NZ, dt_atmos=DT, dtype="float64",
               initialization={"type": "baroclinic"},
               dycore_config={"do_sat_adj": True, "fv_sg_adj": 3600,
                              "n_sponge": 48},
               physics_config={"dt_atmos": DT, "mp_time": DT})
SUBCYCLE = dict(DYCORE, dycore_config={"do_sat_adj": False,
                                       "dynamic_tracer_subcycle": True})

# what each rank process runs: jax made unimportable first
_RANK = r"""
import sys
sys.modules["jax"] = None
from tests.test_torch_sharded_step import rank_main
rank_main(*sys.argv[1:])
"""


def rank_main(rank, layout, workdir, config_json, steps):
    """One rank: join the gloo group of the ranks of `layout` ("t,x,y"),
    step a Driver of that layout `steps` times, and on rank 0 save the
    gathered state after each step as state_<step>.npz in `workdir`."""
    layout = [int(v) for v in layout.split(",")]
    rank, size, steps = int(rank), int(np.prod(layout)), int(steps)
    torch.set_num_threads(1)
    from pace_torch.driver import Driver
    from pace_torch.parallel.comm import init_process_group

    # the Driver joins the group started here
    comm = init_process_group("cpu", f"file://{workdir}/group", size, rank)
    config = dict(json.loads(config_json), mesh={"layout": layout})
    driver = Driver.from_dict(config, device="cpu")
    assert driver.comm.size == size
    assert comm.broadcast(rank) == 0
    assert float(comm.all_reduce(torch.tensor(rank + 1.0), "sum")) == (
        size * (size + 1) / 2)
    assert driver.partition.tiles(rank) == range(
        rank // (size // layout[0]) * 6 // layout[0],
        (rank // (size // layout[0]) + 1) * 6 // layout[0])
    assert driver.dycore.domain == driver.partition.domain(rank)
    for step in range(1, steps + 1):
        driver.step()
        state = driver.state.dycore_state
        parts = comm.gather_to_root({
            f.name: getattr(state, f.name).numpy()
            for f in dataclasses.fields(state)})
        if rank == 0:
            np.savez(os.path.join(workdir, f"state_{step}.npz"), **{
                name: driver.partition.gather([p[name] for p in parts])
                for name in parts[0]})
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax",
                                                            "pace_tpu")]
    assert loaded == ["jax"] and sys.modules["jax"] is None, loaded
    import torch.distributed as dist

    dist.destroy_process_group()


def _start_ranks(workdir, layout, config, steps):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(rank),
         ",".join(map(str, layout)), str(workdir), json.dumps(config),
         str(steps)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(int(np.prod(layout)))]


def _wait(procs, timeout=900):
    for proc in procs:
        try:
            _, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        assert proc.returncode == 0, err[-4000:]


# the one-process states of each (config, steps) this module has run: the
# layouts of one config are held to the same run
_ONE_RANK = {}


def _one_rank(config, steps):
    """The one-process Driver's state after each step, as numpy."""
    key = (json.dumps(config, sort_keys=True), steps)
    if key not in _ONE_RANK:
        _ONE_RANK[key] = _step_one_rank(config, steps)
    return _ONE_RANK[key]


def _step_one_rank(config, steps):
    from pace_torch.driver import Driver

    driver = Driver.from_dict(config, device="cpu")
    out = []
    for _ in range(steps):
        driver.step()
        state = driver.state.dycore_state
        out.append({f.name: getattr(state, f.name).numpy().copy()
                    for f in dataclasses.fields(state)})
    return out


def _run_and_compare(tmp_path, layout, config, steps):
    """Start the ranks, run the one-process steps beside them (or take
    them from an earlier layout's run), and hold every field of every step
    to bit-for-bit equality."""
    return _compare(tmp_path, _start_ranks(tmp_path, layout, config, steps),
                    config, steps)


def _compare(tmp_path, procs, config, steps):
    """_run_and_compare with the ranks started already."""
    from pace_torch.testing import torch_threads

    try:
        # two threads: the one process does twice a rank's work beside the
        # ranks (tests/test_torch_dycore.py's steps take two as well)
        with torch_threads(2):
            want = _one_rank(config, steps)
    finally:
        _wait(procs)
    for step, ref in enumerate(want, start=1):
        got = np.load(tmp_path / f"state_{step}.npz")
        for name, value in ref.items():
            assert np.array_equal(got[name], value, equal_nan=True), (
                f"step {step} {name}: max diff "
                f"{np.nanmax(np.abs(got[name] - value))}")
    return want


TIER1 = [(2, 1, 1), (1, 2, 2)]


@pytest.fixture(scope="module")
def tier1_ranks(tmp_path_factory):
    """The rank processes of both tier-1 layouts, started together when
    the first of their tests starts: {layout: (workdir, processes)}."""
    started = {}
    for layout in TIER1:
        workdir = tmp_path_factory.mktemp("x".join(map(str, layout)))
        started[layout] = workdir, _start_ranks(workdir, layout, DYCORE, 2)
    yield started
    for _, procs in started.values():
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.mark.parametrize("layout", TIER1,
                         ids=lambda s: "x".join(map(str, s)))
def test_two_ranks_equal_one_process_and_the_digest(tier1_ranks, layout):
    """C12/79 float64, two steps at (2, 1, 1) and at (1, 2, 2): bit for bit
    against the one process, and step 1 within 1e-9 of the reference's
    digest."""
    from pace_torch.models.fv3.state import DycoreState
    from pace_torch.utils.gridtools import GridSizing
    from tests.golden.make_golden import state_digest

    workdir, procs = tier1_ranks[layout]
    _compare(workdir, procs, DYCORE, 2)
    with open(REPO / "tests" / "golden" / "c12_dycore_digest.json") as f:
        golden = json.load(f)["step1"]
    step1 = np.load(workdir / "state_1.npz")
    state = DycoreState.from_numpy(step1, "cpu", torch.float64)
    got = state_digest(state, GridSizing(N_, NZ))
    for name, ref in golden.items():
        scale = max(abs(ref["max"]), abs(ref["min"]), 1e-30)
        for stat in ("mean", "std", "min", "max"):
            assert abs(got[name][stat] - ref[stat]) <= 1e-9 * scale, (
                name, stat)


@pytest.mark.slow
@pytest.mark.parametrize("layout, config", [
    ((3, 1, 1), DYCORE), ((6, 1, 1), DYCORE), ((2, 2, 2), DYCORE),
    ((1, 2, 4), DYCORE), ((2, 1, 1), COUPLED), ((1, 2, 2), COUPLED),
    ((2, 1, 1), SUBCYCLE), ((1, 2, 2), SUBCYCLE)],
    ids=["3x1x1", "6x1x1", "2x2x2", "1x2x4", "coupled", "coupled-1x2x2",
         "subcycle", "subcycle-1x2x2"])
def test_more_layouts_and_branches_equal_one_process(tmp_path, layout,
                                                     config):
    _run_and_compare(tmp_path, layout, config, 2)


@pytest.mark.slow
@pytest.mark.parametrize("layout", [[2, 1, 1], [1, 2, 2]],
                         ids=lambda s: "x".join(map(str, s)))
def test_the_yaml_run_under_torchrun_writes_the_one_rank_files(tmp_path,
                                                               layout):
    """baroclinic_c12.yaml (four coupled steps, diagnostics, restart,
    safety checks) at mesh layout [2, 1, 1] and [1, 2, 2] through
    torchrun, jax made unimportable in the ranks: its files equal those of
    the one-rank run."""
    import yaml

    src = REPO / "examples" / "configs" / "baroclinic_c12.yaml"
    with open(src) as f:
        config = yaml.safe_load(f)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    wrapper = tmp_path / "run_no_jax.py"
    wrapper.write_text("import sys\nsys.modules['jax'] = None\n"
                       "from pace_torch.driver.run import main\n"
                       "sys.exit(main())\n")
    for name, mesh in (("one", [1, 1, 1]), ("two", layout)):
        run_dir = tmp_path / name
        run_dir.mkdir()
        with open(run_dir / "config.yaml", "w") as f:
            yaml.safe_dump(dict(config, mesh={"layout": mesh}), f)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={int(np.prod(mesh))}", str(wrapper),
               "config.yaml",
               "--device", "cpu", "--log-level", "WARNING"]
        proc = subprocess.run(cmd, cwd=run_dir, env=env,
                              capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-4000:]
    one, two = tmp_path / "one", tmp_path / "two"
    files = sorted(str(p.relative_to(one)) for p in one.rglob("*")
                   if p.is_file() and p.suffix in (".npy", ".npz", ".json")
                   and not p.name.endswith("_perf.json")
                   and p.name != "config.yaml")
    assert len(files) > 30
    for name in files:
        a, b = one / name, two / name
        if a.read_bytes() == b.read_bytes():
            continue
        # ranks that split tiles: the same values and NaNs at the same
        # places, but a NaN's sign and payload follow the order in which
        # the CPU's vector and scalar loops met it, which the block's
        # extents change
        assert layout[1:] != [1, 1] and name.endswith(".npy"), name
        assert np.array_equal(np.load(a), np.load(b), equal_nan=True), name
    shutil.rmtree(one)
    shutil.rmtree(two)


@pytest.mark.parametrize("hord", [6, 8])
def test_plain_transport_on_a_ranks_tiles(hord):
    """The plain transport of T=3 fields on tiles [0, 1), [3, 6) equals
    the same tiles of the six-tile result, bit for bit (NaNs, which these
    inputs make in the outer halo, at the same places)."""
    from pace_torch.ops.fvtp2d import transport_batched
    from pace_torch.testing import TRANSPORT_KEYS, transport_inputs
    from pace_torch.utils.gridtools import Domain

    inputs = transport_inputs(N_, 8, 3)
    full = {k: torch.tensor(inputs[k]) for k in TRANSPORT_KEYS}
    dom = Domain.whole(N_, 3)
    fx, fy = transport_batched(*full.values(), dom, hord)
    for start, stop in ((0, 1), (3, 6)):
        part = {k: (v[:, start:stop] if k in ("q_y", "q_x")
                    else v[start:stop]) for k, v in full.items()}
        gx, gy = transport_batched(*part.values(), dom, hord)
        for got, want in ((gx, fx), (gy, fy)):
            assert np.array_equal(got.numpy(), want[:, start:stop].numpy(),
                                  equal_nan=True)
