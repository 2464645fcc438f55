"""Strict dict -> dataclass hydration.

The port's own copy of `pace_tpu.driver._from_dict` (which replaces the
reference's dacite dependency: driver/pace/driver/driver.py uses
dacite.from_dict with strict=True): recursively builds nested dataclasses
from plain dicts, rejecting unknown keys and missing required fields.
"""

from __future__ import annotations

import dataclasses
import typing


class ConfigError(ValueError):
    pass


def from_dict(cls, data: dict, path: str = ""):
    if not dataclasses.is_dataclass(cls):
        return data
    if not isinstance(data, dict):
        raise ConfigError(f"{path or cls.__name__}: expected mapping, "
                          f"got {type(data).__name__}")
    # NOTE: custom cls.from_dict hooks are honored only for NESTED
    # dataclasses (see _convert) — dispatching here would recurse when a
    # class implements from_dict by delegating to this function.
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ConfigError(
            f"{path or cls.__name__}: unknown keys {sorted(unknown)}; "
            f"allowed: {sorted(fields)}"
        )
    kwargs = {}
    hints = typing.get_type_hints(cls)
    for name, f in fields.items():
        sub_path = f"{path}.{name}" if path else name
        if name in data:
            kwargs[name] = _convert(hints.get(name, f.type), data[name],
                                    sub_path)
        elif (f.default is dataclasses.MISSING
              and f.default_factory is dataclasses.MISSING):
            raise ConfigError(f"{sub_path}: required key missing")
    return cls(**kwargs)


def _convert(tp, value, path):
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if value is None:
            return None
        return _convert(args[0], value, path) if len(args) == 1 else value
    if dataclasses.is_dataclass(tp) and isinstance(value, dict):
        custom = getattr(tp, "from_dict", None)
        if custom is not None and getattr(custom, "__self__", None) is tp:
            return custom(value)
        return from_dict(tp, value, path)
    if origin in (list, tuple) and isinstance(value, (list, tuple)):
        args = typing.get_args(tp)
        elem = args[0] if args else None
        out = [
            _convert(elem, v, f"{path}[{i}]") if elem else v
            for i, v in enumerate(value)
        ]
        return tuple(out) if origin is tuple else out
    if tp is float and isinstance(value, int):
        return float(value)
    if tp in (int, float, str, bool) and not isinstance(value, tp):
        raise ConfigError(
            f"{path}: expected {tp.__name__}, got {type(value).__name__}"
        )
    return value
