"""ML microphysics emulator: a column MLP drop-in for the GFDL scheme.

Port of `pace_tpu.models.physics.emulator`: a per-column MLP whose forward
pass is a handful of large batched matrix products, emitting the same
tendency dict as `Microphysics.__call__`, so it is interchangeable in the
physics driver and in the coupled step.

- each layer is one (..., features) @ (features, hidden) product over the
  column features with the (tile, x, y) batch dims kept intact; the
  columns go through it in blocks of a fixed row count (`BLOCK_ROWS`), so
  that a column's result does not depend on how many columns a rank holds;
- the compute dtype is configurable: bfloat16 halves the traffic of the
  weights and activations; the conservation fix-up is always applied in the
  state dtype;
- optional exact column-water conservation: the raw network output is
  projected onto the zero-column-moisture-tendency subspace (mass weighted
  by delp), so the emulator cannot create or destroy water whatever its
  weights are: the invariant the GFDL scheme holds to round-off.

Weights load from an npz (`MLPEmulatorConfig.weights_path`, keys `w{i}` and
`b{i}`); without a file the network is He-initialized from `seed` through a
`torch.Generator`, with a zero output layer, making the untrained emulator
an exact no-op (zero tendencies).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# column profile features fed to the network, in order
INPUT_FIELDS = (
    "pt", "qvapor", "qliquid", "qrain", "qice", "qsnow", "qgraupel",
    "qcld", "delp", "dz", "wmp",
)
# tendencies produced, in order (matches Microphysics' return dict)
OUTPUT_FIELDS = (
    "qv_dt", "ql_dt", "qr_dt", "qi_dt", "qs_dt", "qg_dt", "qa_dt",
    "pt_dt",
)
# water-species tendencies subject to the conservation projection
WATER_TENDENCIES = ("qv_dt", "ql_dt", "qr_dt", "qi_dt", "qs_dt", "qg_dt")

# Rows of every matrix product.  cuBLAS, like a CPU BLAS, picks its kernel
# from the product's shape, and kernels sum a row's products in different
# orders: an NVIDIA H100 ran a rank's 9,075 columns and one process's
# 64,896 (C96) to bfloat16 results apart.  A fixed row count gives every
# column the same kernel, whatever the tensor's size.
BLOCK_ROWS = 4096

# fixed per-field normalization scales (typical magnitudes; the network
# sees O(1) inputs)
_INPUT_SCALE = {
    "pt": 300.0, "qvapor": 2e-2, "qliquid": 1e-3, "qrain": 1e-3,
    "qice": 1e-3, "qsnow": 1e-3, "qgraupel": 1e-3, "qcld": 1.0,
    "delp": 5e3, "dz": 1e3, "wmp": 1.0,
}
_OUTPUT_SCALE = {
    "qv_dt": 1e-6, "ql_dt": 1e-6, "qr_dt": 1e-6, "qi_dt": 1e-6,
    "qs_dt": 1e-6, "qg_dt": 1e-6, "qa_dt": 1e-4, "pt_dt": 1e-3,
}


@dataclasses.dataclass(frozen=True)
class MLPEmulatorConfig:
    """Configuration for the MLP microphysics emulator."""

    hidden_sizes: Tuple[int, ...] = (256, 256)
    weights_path: Optional[str] = None
    compute_dtype: str = "bfloat16"  # matmul dtype: bfloat16 | float32
    conserve_water: bool = True
    seed: int = 0


def _init_params(config: MLPEmulatorConfig, nz: int) -> dict:
    """He init drawn from a generator seeded with `config.seed`; output
    layer zeros (no-op tendencies)."""
    n_in = nz * len(INPUT_FIELDS)
    n_out = nz * len(OUTPUT_FIELDS)
    sizes = (n_in,) + tuple(config.hidden_sizes) + (n_out,)
    generator = torch.Generator().manual_seed(config.seed)
    params = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        last = i == len(sizes) - 2
        params[f"w{i}"] = (
            torch.zeros(a, b) if last
            else torch.randn(a, b, generator=generator) * math.sqrt(2.0 / a)
        )
        params[f"b{i}"] = torch.zeros(b)
    return params


def load_params(path: str) -> dict:
    with np.load(path) as f:
        return {k: np.asarray(f[k]) for k in f.files}


def save_params(params: dict, path: str) -> None:
    np.savez(path, **{
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
        else np.asarray(v)
        for k, v in params.items()
    })


class MicrophysicsEmulator(nn.Module):
    """Drop-in for `Microphysics` on `device` (the card unless the caller
    asks for the CPU): same call signature (a MicrophysicsState), same
    tendency-dict return.  The parameters are `w{i}` of shape (in, out) and
    `b{i}`, as in the reference package's npz files, kept in the dtype they
    come in (float32 when drawn here) and cast to the compute dtype in the
    forward pass."""

    def __init__(self, config: MLPEmulatorConfig, nz: int, device="cuda"):
        super().__init__()
        self.config = config
        self.nz = nz
        self._n_layers = len(config.hidden_sizes) + 1
        self._compute_dtype = getattr(torch, config.compute_dtype)
        self.weights = nn.ParameterDict()
        self.load_numpy_params(
            load_params(config.weights_path) if config.weights_path
            else _init_params(config, nz), device=device,
        )

    def load_numpy_params(self, params: dict, device=None) -> None:
        """Take `params` (numpy arrays or tensors keyed `w{i}`/`b{i}`, the
        reference package's layout) as the network's weights."""
        device = device if device is not None else self.device
        for i in range(self._n_layers):
            for key in (f"w{i}", f"b{i}"):
                self.weights[key] = nn.Parameter(
                    torch.tensor(np.asarray(params[key]), device=device),
                    requires_grad=False,
                )

    @property
    def device(self) -> torch.device:
        return self.weights["w0"].device

    def _layers(self, h):
        for i in range(self._n_layers):
            w = self.weights[f"w{i}"].to(self._compute_dtype)
            b = self.weights[f"b{i}"].to(self._compute_dtype)
            h = torch.matmul(h, w) + b
            if i < self._n_layers - 1:
                h = F.gelu(h, approximate="tanh")
        return h

    def _forward(self, x):
        """x: (..., nz*F) normalized features -> (..., nz*T) normalized
        tendencies; leading dims are kept intact.  The rows go through the
        layers BLOCK_ROWS at a time, the last block padded with zeros."""
        h = x.to(self._compute_dtype)
        rows = h.reshape(-1, h.shape[-1])
        count = rows.shape[0]
        padded = rows.new_zeros((-(-count // BLOCK_ROWS) * BLOCK_ROWS,
                                 rows.shape[1]))
        padded[:count] = rows
        out = torch.cat([self._layers(block)
                         for block in padded.split(BLOCK_ROWS)])
        return out[:count].reshape(h.shape[:-1] + out.shape[-1:])

    @torch.no_grad()
    def forward(self, state) -> dict:
        nz = self.nz
        dtype = state.pt.dtype
        if state.pt.device.type != self.device.type:
            raise ValueError(
                f"state on {state.pt.device}, emulator on {self.device}")
        profiles = [
            getattr(state, name) / _INPUT_SCALE[name]
            for name in INPUT_FIELDS
        ]
        x = torch.cat(profiles, dim=-1)  # (..., nz*F)
        y = self._forward(x).to(dtype)   # (..., nz*T)
        tend = {
            name: y[..., i * nz:(i + 1) * nz] * _OUTPUT_SCALE[name]
            for i, name in enumerate(OUTPUT_FIELDS)
        }

        if self.config.conserve_water:
            # project onto zero net column-moisture tendency: remove the
            # delp-weighted column mean of the total-water tendency from
            # qv_dt (vapor is the reservoir; mirrors how the GFDL scheme
            # balances its source/sink pairs)
            delp = state.delp
            total = sum(tend[k] for k in WATER_TENDENCIES)
            col = torch.sum(total * delp, -1, keepdim=True)
            mass = torch.sum(delp, -1, keepdim=True)
            tend["qv_dt"] = tend["qv_dt"] - col / mass

        tend["udt"] = torch.zeros_like(state.ua)
        tend["vdt"] = torch.zeros_like(state.va)
        tend["wmp"] = state.wmp
        return tend
