"""Fortran namelist configuration.

The port's own copy of `pace_tpu.utils.namelist` (reference ai2cm/pace
util/pace/util/namelist.py: `Namelist`, `NamelistDefaults`,
`Namelist.from_f90nml`), with a self-contained parser for the f90nml
subset that FV3 input.nml files use: &group / key = value / arrays /
logicals / d-exponents / ! comments.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

_LOGICALS = {
    ".true.": True, ".t.": True, "t": True, "true": True,
    ".false.": False, ".f.": False, "f": False, "false": False,
}


def _parse_value(tok: str) -> Any:
    tok = tok.strip()
    low = tok.lower()
    if low in _LOGICALS:
        return _LOGICALS[low]
    if (tok.startswith("'") and tok.endswith("'")) or (
            tok.startswith('"') and tok.endswith('"')):
        return tok[1:-1]
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        # Fortran d/D exponents
        return float(re.sub(r"[dD]", "e", tok))
    except ValueError:
        return tok


def _split_values(rhs: str):
    """Split on commas outside quotes."""
    parts, cur, quote = [], "", None
    for ch in rhs:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch == ",":
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        parts.append(cur)
    return [p for p in (s.strip() for s in parts) if p]


def parse_namelist(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse f90 namelist text -> {group: {key: value}}."""
    groups: Dict[str, Dict[str, Any]] = {}
    current: Optional[str] = None
    pending_key: Optional[str] = None
    for raw_line in text.splitlines():
        line = raw_line.split("!", 1)[0].strip()
        if not line:
            continue
        if line.startswith("&"):
            current = line[1:].strip().lower()
            groups.setdefault(current, {})
            pending_key = None
            continue
        if line in ("/", "&end", "$end"):
            current = None
            pending_key = None
            continue
        if current is None:
            continue
        if "=" in line:
            key, rhs = line.split("=", 1)
            key = key.strip().lower()
            # strip any (i) array index syntax
            key = re.sub(r"\(.*\)$", "", key).strip()
            vals = [_parse_value(v) for v in _split_values(rhs)]
            groups[current][key] = vals[0] if len(vals) == 1 else vals
            pending_key = key
        elif pending_key is not None:
            # continuation line of an array
            vals = [_parse_value(v) for v in _split_values(line)]
            prev = groups[current][pending_key]
            if not isinstance(prev, list):
                prev = [prev]
            groups[current][pending_key] = prev + vals
    return groups


def read_namelist(path: str) -> Dict[str, Dict[str, Any]]:
    with open(path) as f:
        return parse_namelist(f.read())


@dataclasses.dataclass(frozen=True)
class Namelist:
    """Flattened FV3 namelist (reference namelist.py:119-479): the union of
    the fv_core_nml / gfdl_cloud_microphysics_nml / coupler_nml groups with
    GFS defaults.  Unknown keys are ignored, matching f90nml usage."""

    layout: Tuple[int, int] = (1, 1)
    npx: int = 13
    npy: int = 13
    npz: int = 79
    ntiles: int = 6
    nwat: int = 6
    dt_atmos: float = 225.0
    grid_type: int = 0
    hydrostatic: bool = False
    z_tracer: bool = True
    do_qa: bool = True
    k_split: int = 1
    n_split: int = 1
    fv_sg_adj: int = -1
    n_sponge: int = 48
    nord: int = 3
    dddmp: float = 0.5
    d4_bg: float = 0.15
    d2_bg: float = 0.0
    d2_bg_k1: float = 0.2
    d2_bg_k2: float = 0.1
    d_con: float = 1.0
    d_ext: float = 0.0
    delt_max: float = 0.002
    do_sat_adj: bool = True
    do_vort_damp: bool = True
    hord_dp: int = 6
    hord_mt: int = 6
    hord_tm: int = 6
    hord_tr: int = 8
    hord_vt: int = 6
    kord_mt: int = 9
    kord_tm: int = -9
    kord_tr: int = 9
    kord_wz: int = 9
    p_fac: float = 0.05
    rf_cutoff: float = 3000.0
    rf_fast: bool = True
    tau: float = 10.0
    vtdm4: float = 0.06
    consv_te: float = 0.0
    fill: bool = True
    n_zfilter: int = 0
    days: int = 0
    hours: int = 0
    minutes: int = 0
    seconds: int = 0

    @classmethod
    def from_f90nml(cls, groups: Dict[str, Dict[str, Any]]) -> "Namelist":
        """Flatten parsed namelist groups into a Namelist, last group wins
        (as the reference's dict union does)."""
        flat: Dict[str, Any] = {}
        for group in groups.values():
            flat.update(group)
        valid = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in flat.items():
            if k in valid:
                if isinstance(v, list):
                    v = tuple(v)
                kwargs[k] = v
        return cls(**kwargs)

    @classmethod
    def from_file(cls, path: str) -> "Namelist":
        return cls.from_f90nml(read_namelist(path))

    def dycore_config_kwargs(self) -> dict:
        """Keys accepted by DynamicalCoreConfig."""
        from pace_torch.models.fv3.config import DynamicalCoreConfig

        valid = {f.name for f in dataclasses.fields(DynamicalCoreConfig)}
        return {
            k: getattr(self, k)
            for k in valid
            if hasattr(self, k)
        }
