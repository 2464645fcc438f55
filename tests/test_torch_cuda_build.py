"""The kernel library's build: one nvcc process a source, all started
together, then one link (pace_torch/ops/_cuda.py `compile_library`).

The CPU has no nvcc, so a stand-in records when each compile starts and
ends, writes its object, and links by concatenating the objects.
"""

from __future__ import annotations

import json
import os
import stat
import sys

import pytest

from pace_torch.ops import _cuda

FAKE_NVCC = """#!{python}
import json, os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-c" in args:
    src = args[-1]
    start = time.time()
    time.sleep(0.3)
    if "bad" in os.path.basename(src):
        print("error: " + src)
        sys.exit(2)
    with open(out, "w") as f:
        f.write(os.path.basename(src) + "\\n")
    with open(os.path.join({log!r}, os.path.basename(src) + ".json"),
              "w") as f:
        json.dump([start, time.time(), args], f)
    print("ptxas info    : Used 32 registers, compiling " + src)
else:
    with open(out, "w") as f:
        for obj in args[args.index("-o") + 2:]:
            f.write(open(obj).read())
    with open(os.path.join({log!r}, "link.json"), "w") as f:
        json.dump(args, f)
"""


@pytest.fixture
def nvcc(tmp_path):
    log = tmp_path / "log"
    log.mkdir()
    path = tmp_path / "nvcc"
    path.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path), log


def _sources(tmp_path, names):
    paths = []
    for name in names:
        (tmp_path / name).write_text("// " + name)
        paths.append(tmp_path / name)
    return paths


def test_every_source_compiles_at_once_then_links(tmp_path, nvcc):
    path, log = nvcc
    names = ["errors.cu", "fillz.cu", "fvtp2d.cu", "sim1.cu"]
    lib = tmp_path / "out" / "libk.so"
    lib.parent.mkdir()
    report = _cuda.compile_library(_sources(tmp_path, names), lib,
                                   nvcc=path)
    runs = [json.loads((log / f"{name}.json").read_text()) for name in names]
    # every compile began before any of them ended
    assert max(start for start, _, _ in runs) < min(end for _, end, _ in runs)
    for _, _, args in runs:
        assert args[:len(_cuda.NVCC_FLAGS)] == list(_cuda.NVCC_FLAGS)
        assert "-c" in args and "-shared" not in args
    link = json.loads((log / "link.json").read_text())
    assert "-shared" in link and link[link.index("-o") + 1] == str(lib)
    assert lib.read_text().split() == names
    assert os.listdir(lib.parent) == ["libk.so"]  # no object left behind
    assert report.count("ptxas info") == len(names)


def test_a_source_that_fails_names_itself_and_links_nothing(tmp_path, nvcc):
    path, log = nvcc
    lib = tmp_path / "out" / "libk.so"
    lib.parent.mkdir()
    with pytest.raises(RuntimeError, match="bad.cu"):
        _cuda.compile_library(_sources(tmp_path, ["bad.cu", "good.cu"]),
                              lib, nvcc=path)
    assert not (log / "link.json").exists()
    assert os.listdir(lib.parent) == []
