"""The port's savepoint ("translate") harness, pace_torch.utils.translate,
against the reference package's:

- savepoints of every block layout the harness knows (halo-inclusive and
  compute-domain blocks, (i, k, j) kaxis blocks, j-collapsed blocks,
  columns, scalars, the GFS physics blocks in C and F order with the k
  roll, the microphysics blocks) written by either package's
  write_savepoint are the same bytes, and read and assemble into equal
  arrays in the other package, for a 6-rank and a 54-rank (3x3 a tile)
  layout;
- threshold overrides parse alike;
- validate passes on a savepoint of the case itself, catches a mismatch
  planted in one rank's block, and an override loosens it; the
  compute-domain comparison sees a mismatch planted inside the compute
  domain and not one planted in a halo cell;
- a layout that does not divide the tile raises.
"""


import numpy as np
import pytest
import torch

import pace_tpu.utils.translate as ref_translate
from pace_torch.testing import torch_threads
from pace_torch.utils import translate
from pace_torch.utils.gridtools import GridSizing
from tests.golden.make_translate_digest import blocks as ref_blocks

N_, NZ, H = 12, 5, 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torch_threads(1):
        yield


# name -> (VarSpec fields, write stagger, trailing shape after (6, N, N))
LAYOUTS = {
    "q": ({}, (0, 0), (NZ,)),
    "u": ({}, (0, 1), (NZ,)),
    "crx": ({"istart": H}, (1, 0), (NZ,)),
    "mfx": ({"serialname": "mfxd", "istart": H, "jstart": H}, (1, 0),
            (NZ,)),
    "pe": ({"istart": H - 1, "jstart": H - 1, "kaxis": 1}, (0, 0),
           (NZ + 1,)),
    "peln": ({"istart": H, "jstart": H, "kaxis": 1}, (0, 0), (NZ + 1,)),
    "vort_c": ({"istart": H - 1, "jstart": H - 1}, (3, 3), (NZ,)),
    "ps": ({}, (0, 0), ()),
    "prsi": ({"serialname": "IPD_prsi", "phys_order": "F"}, (0, 0),
             (NZ + 1,)),
    "tgrs": ({"serialname": "IPD_tgrs", "phys_order": "F",
              "roll_zero": True}, (0, 0), (NZ,)),
    "qgrs": ({"serialname": "IPD_qgrs", "phys_order": "C"}, (0, 0),
             (NZ, 4)),
    "mph_pt": ({"microph": True}, (0, 0), (NZ,)),
    "mph_land": ({"microph": True}, (0, 0), ()),
}
NO_J = {"dp2": ({"istart": H, "no_j": True}, (NZ,)),
        "gz1d": ({"no_j": True}, ())}
COLUMNS = {"ak": NZ + 1, "damp_c": NZ}


def _case(module, sizing, layout):
    case = module.TranslateCase(sizing, layout=layout)
    case.in_vars = {name: module.VarSpec(**spec)
                    for name, (spec, _, _) in LAYOUTS.items()}
    case.in_vars.update({name: module.VarSpec(**spec)
                         for name, (spec, _) in NO_J.items()})
    case.in_vars.update({name: module.VarSpec(column=True)
                         for name in COLUMNS})
    case.out_vars = dict(case.in_vars)
    case.in_vars["dt"] = module.VarSpec()
    case.stagger = {name: stagger
                    for name, (_, stagger, _) in LAYOUTS.items()}
    return case


def _inputs(sizing, seed=11):
    rng = np.random.RandomState(seed)
    N = sizing.N
    out = {name: rng.randn(6, N, N, *shape)
           for name, (_, _, shape) in LAYOUTS.items()}
    out.update({name: rng.randn(6, N, *shape)
                for name, (_, shape) in NO_J.items()})
    out.update({name: rng.randn(size) for name, size in COLUMNS.items()})
    out["dt"] = 112.5
    return out


@pytest.mark.parametrize("layout", [(1, 1), (3, 3)])
def test_savepoints_read_alike_in_both_packages(layout, tmp_path):
    sizing = GridSizing(N_, NZ, H)
    inputs = _inputs(sizing)
    ours = _case(translate, sizing, layout)
    theirs = _case(ref_translate, sizing, layout)
    assert ours.n_ranks == 6 * layout[0] * layout[1]
    port_blocks = ours.input_blocks(inputs)
    translate.write_savepoint(str(tmp_path / "port"), "Layouts",
                              port_blocks, port_blocks)
    ref_translate.write_savepoint(str(tmp_path / "ref"), "Layouts",
                                  ref_blocks(theirs, inputs),
                                  ref_blocks(theirs, inputs))
    for suffix in ("In", "Out"):
        with open(tmp_path / "port" / f"Layouts-{suffix}.nc", "rb") as a, \
                open(tmp_path / "ref" / f"Layouts-{suffix}.nc", "rb") as b:
            assert a.read() == b.read(), suffix
    assert translate.discover_savepoints(str(tmp_path / "ref")) == [
        "Layouts"]
    ds = translate.SavepointDataset(str(tmp_path / "ref"), "Layouts")
    ref_ds = ref_translate.SavepointDataset(str(tmp_path / "port"),
                                            "Layouts")
    assert ds.n_ranks == ref_ds.n_ranks == ours.n_ranks
    assert ds.n_calls == ref_ds.n_calls == 1
    got = ours.assemble([ds.inputs(r) for r in range(ours.n_ranks)])
    expect = theirs.assemble([ref_ds.inputs(r)
                              for r in range(ours.n_ranks)])
    assert sorted(got) == sorted(expect)
    for name in expect:
        np.testing.assert_array_equal(got[name], expect[name], name)
    # every cell a block covers holds the input (the compute domain of
    # each halo-inclusive field at least)
    c = (slice(None), slice(H, H + N_), slice(H, H + N_))
    np.testing.assert_array_equal(got["q"][c], inputs["q"][c])
    np.testing.assert_array_equal(got["ak"], inputs["ak"])
    assert got["dt"] == 112.5
    for rank in range(ours.n_ranks):
        for name, spec in ours.out_vars.items():
            sname = spec.serialname or name
            np.testing.assert_array_equal(
                ours.slice_output(name, got[name], ds.outputs(rank)[sname],
                                  rank),
                theirs.slice_output(name, expect[name],
                                    ref_ds.outputs(rank)[sname], rank))


def test_threshold_overrides_parse_alike(tmp_path):
    path = tmp_path / "overrides.yaml"
    path.write_text(
        "Del2Cubed:\n"
        "  - backend: all\n"
        "    max_error: 1e-3\n"
        "    near_zero: 1e-10\n"
        "    ignore_near_zero_errors: [qdel]\n"
        "Remapping:\n"
        "  backend: all\n"
        "  max_error: 3e-8\n"
        "FvTp2d:\n"
        "  - backend: numpy\n"
        "    max_error: 1.0\n"
        "  - max_error: 2e-13\n")
    ours = translate.load_threshold_overrides(str(path))
    assert ours == ref_translate.load_threshold_overrides(str(path))
    assert ours["Del2Cubed"] == {"max_error": 1e-3, "near_zero": 1e-10,
                                 "ignore_near_zero_errors": ["qdel"]}
    assert ours["FvTp2d"]["max_error"] == 2e-13
    assert translate.load_threshold_overrides(None) == {}
    # entries for this package's backends apply here only
    path.write_text("XPPM:\n  - backend: cuda\n    max_error: 1e-9\n")
    assert translate.load_threshold_overrides(str(path)) == {
        "XPPM": {"max_error": 1e-9, "near_zero": 1e-18,
                 "ignore_near_zero_errors": []}}
    assert ref_translate.load_threshold_overrides(str(path)) == {}


@pytest.fixture(scope="module")
def hyperdiffusion_savepoint(tmp_path_factory):
    """The Del2Cubed case on a C12 grid with 3 levels and a seeded field,
    its savepoint written by the case itself."""
    from pace_torch.grid.generation import generate_grid_data
    from pace_torch.utils.translate_cases import CASES

    sizing = GridSizing(N_, 3, H)
    gd = generate_grid_data(N_, 79, device="cpu", dtype=torch.float64)
    case = CASES["Del2Cubed"](sizing, gd, device="cpu")
    qdel = np.random.RandomState(3).randn(6, sizing.N, sizing.N, 3)
    data_dir = str(tmp_path_factory.mktemp("savepoints"))
    translate.write_case_savepoint(
        case, {"qdel": qdel, "nmax": 2, "cd": 0.2 * gd.damping.da_min},
        data_dir)
    return case, data_dir


def test_validate_catches_a_planted_mismatch(hyperdiffusion_savepoint,
                                             tmp_path):
    case, data_dir = hyperdiffusion_savepoint
    ds = translate.SavepointDataset(data_dir, "Del2Cubed")
    assert case.validate(ds) == {"qdel": 0.0}
    ins = [ds.inputs(r) for r in range(6)]
    bad = [{"qdel": ds.outputs(r)["qdel"] * (1.0 + 1e-6 * (r == 3))}
           for r in range(6)]
    translate.write_savepoint(str(tmp_path), "Del2Cubed", ins, bad)
    planted = translate.SavepointDataset(str(tmp_path), "Del2Cubed")
    with pytest.raises(AssertionError, match="rank 3"):
        case.validate(planted)
    errors = case.validate(planted, overrides={"max_error": 1e-3})
    assert 1e-7 < errors["qdel"] < 1e-5


def test_domain_errors_see_the_compute_domain_only(hyperdiffusion_savepoint,
                                                  tmp_path):
    case, data_dir = hyperdiffusion_savepoint
    ds = translate.SavepointDataset(data_dir, "Del2Cubed")
    assert case.domain_errors(ds) == ({"qdel": 0.0}, {"qdel": 0.0})
    ins = [ds.inputs(r) for r in range(6)]
    for where, (i, j) in (("halo", (1, 1)), ("domain", (H + 2, H + 5))):
        outs = [ds.outputs(r) for r in range(6)]
        outs[4]["qdel"] = outs[4]["qdel"].copy()
        outs[4]["qdel"][i, j, 1] *= 1.0 + 1e-6
        translate.write_savepoint(str(tmp_path / where), "Del2Cubed", ins,
                                  outs)
        planted = translate.SavepointDataset(str(tmp_path / where),
                                             "Del2Cubed")
        domain, metric = case.domain_errors(planted)
        assert 1e-7 < metric["qdel"] < 2e-6
        assert (domain["qdel"] > 0.0) == (where == "domain"), where


def test_a_layout_that_does_not_divide_the_tile_raises():
    from pace_torch.utils.translate_cases import CASES

    with pytest.raises(ValueError, match="layout"):
        CASES["XPPM"](GridSizing(12, 79), None, layout=(5, 1), device="cpu")
    case = CASES["XPPM"](GridSizing(12, 79), None, layout=(2, 3),
                         device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        case.assemble([{}] * 6)
