"""Memory and cost of one model step.

Port of `pace_tpu.driver.tools` (ai2cm/pace driver/pace/driver/tools.py
and dsl/dace/utils.py memory_static_analysis, kernel_theoretical_timing).
Where the reference reads XLA's memory and cost analyses of the compiled
step, this builds the port's Driver from the yaml, takes one
`Driver.step()` and reports what the device did:

- memory: `argument_size_in_bytes`, the bytes of the state's tensors;
  `output_size_in_bytes`, those of the state after the step;
  `temp_size_in_bytes`, the peak of `torch.cuda.max_memory_allocated()`
  over the step less what was allocated before it, and
  `peak_size_in_bytes`, that peak itself (both null on the CPU: they are
  not estimated); `generated_code_size_in_bytes`, the size of the built
  kernel library (null on the CPU, where none is built);
- cost: the step under a dispatch mode that counts `launches` (dispatched
  ops; views, allocations, host-device copies and host scalars written
  into tensors left out), `bytes
  accessed` (the input and output bytes of each op) and `flops` (one per
  output element of an elementwise op and per input element of a
  reduction or scan), with each call of the hand-written kernels K-T, K-S
  and K-F counted once, as that kernel, with the bytes and operations of
  its bound model (`ops/bounds.py`), on the CPU as on the card;
  `optimal_seconds` is the larger of bytes / 3.35 TB/s and flops /
  67 TFLOP/s.

Usage (on the card unless --device cpu):
  python -m pace_torch.driver.tools memory <config.yaml> [--device cuda|cpu]
  python -m pace_torch.driver.tools cost   <config.yaml> [--device cuda|cpu]
The last line printed is the report as one JSON object.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from pace_torch.ops import bounds

# ops that allocate or wrap host data and launch nothing
_NOT_COUNTED = ("empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided", "lift_fresh", "lift_fresh_copy",
                "detach", "alias", "_local_scalar_dense")
_SCANS = ("cumsum", "cumprod")


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched under it (see the module docstring); the
    kernel wrappers report their calls through `bounds.kernel_call`."""

    def __init__(self):
        super().__init__()
        self.suspended = 0
        self.launches = 0
        self.bytes = 0
        self.flops = 0
        self.kernels = {name: dict(launches=0, bytes=0, flops=0)
                        for name in bounds.KERNELS}
        self.by_op = collections.Counter()

    def __enter__(self):
        self._outer, bounds.COUNTER = bounds.COUNTER, self
        return super().__enter__()

    def __exit__(self, *exc):
        bounds.COUNTER = self._outer
        return super().__exit__(*exc)

    def add_kernel(self, name, moved, ops):
        k = self.kernels[name]
        k["launches"] += 1
        k["bytes"] += moved
        k["flops"] += ops
        self.launches += 1
        self.bytes += moved
        self.flops += ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.suspended:
            self._count(func, args, kwargs or {}, out)
        return out

    def _count(self, func, args, kwargs, out):
        name = func.overloadpacket.__name__
        if func.is_view or name in _NOT_COUNTED:
            return
        inputs = [t for t in tree_flatten((args, kwargs))[0]
                  if isinstance(t, torch.Tensor)]
        outputs = [t for t in tree_flatten(out)[0]
                   if isinstance(t, torch.Tensor)]
        if name in ("_to_copy", "copy_") and (
                len({t.device for t in inputs + outputs}) > 1
                or (inputs[-1].dim() == 0
                    and inputs[-1].device.type == "cpu")):
            # a copy between host and device, or a host scalar written
            # into a tensor (`m[i, j] = True`), which on the card is one
            return
        self.launches += 1
        self.by_op[name] += 1
        self.bytes += bounds.nbytes(inputs + outputs)
        if torch.Tag.pointwise in func.tags or name in _SCANS:
            self.flops += max((t.numel() for t in outputs), default=0)
        elif torch.Tag.reduction in func.tags and inputs:
            self.flops += inputs[0].numel()


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def build_driver(config_path: str, device="cuda"):
    from pace_torch.driver.driver import Driver, DriverConfig

    return Driver(DriverConfig.from_yaml(config_path), device=device)


def _state_bytes(state) -> int:
    return bounds.nbytes([getattr(state, f.name)
                          for f in dataclasses.fields(state)])


def step_report(driver, count: bool) -> dict:
    """One Driver.step(): the memory report, and with `count` the cost
    report taken on the same step."""
    device = driver.device
    report = {"device": str(device),
              "argument_size_in_bytes": _state_bytes(
                  driver.state.dycore_state)}
    cuda = device.type == "cuda"
    if cuda:
        from pace_torch.ops import _cuda

        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
    counter = OpCounter() if count else None
    if counter is not None:
        with counter:
            driver.step()
    else:
        driver.step()
    if cuda:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    report["output_size_in_bytes"] = _state_bytes(driver.state.dycore_state)
    report["temp_size_in_bytes"] = peak - before if cuda else None
    report["peak_size_in_bytes"] = peak if cuda else None
    report["generated_code_size_in_bytes"] = (
        os.path.getsize(_cuda.build().path) if cuda else None)
    if counter is not None:
        report.update({
            "launches": counter.launches,
            "bytes accessed": counter.bytes,
            "flops": counter.flops,
            "optimal_seconds": bounds.optimal_seconds(counter.bytes,
                                                      counter.flops),
            "kernels": counter.kernels,
            "ops": dict(counter.by_op.most_common()),
        })
    return report


def memory_static_analysis(config_path: str, device="cuda") -> dict:
    report = step_report(build_driver(config_path, device), count=False)
    return {k: report[k] for k in (
        "device", "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "peak_size_in_bytes",
        "generated_code_size_in_bytes")}


def kernel_theoretical_timing(config_path: str, device="cuda") -> dict:
    report = step_report(build_driver(config_path, device), count=True)
    return {k: report[k] for k in (
        "device", "launches", "bytes accessed", "flops", "optimal_seconds",
        "kernels", "ops")}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m pace_torch.driver.tools")
    parser.add_argument("action", choices=["memory", "cost"])
    parser.add_argument("config_path")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.action == "memory":
        report = memory_static_analysis(args.config_path, args.device)
        for k, v in report.items():
            print(f"{k}: {v / 1024**2:.2f} MiB"
                  if "bytes" in k and v is not None else f"{k}: {v}")
    else:
        report = kernel_theoretical_timing(args.config_path, args.device)
        for k in ("launches", "bytes accessed", "flops", "optimal_seconds"):
            print(f"{k}: {report[k]:.6g}")
        for name, k in report["kernels"].items():
            print(f"{name}: {k['launches']} launches, {k['bytes']} bytes, "
                  f"{k['flops']} flops")
    if torch.device(args.device).type == "cuda":
        print(f"card: {card_line()}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
