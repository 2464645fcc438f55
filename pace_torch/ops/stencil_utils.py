"""Helpers for writing FV3 stencils as whole-tensor torch expressions.

Stencils are plain functions over full (6, N, N[, nz]) tensors, exactly as
in `pace_tpu.ops.stencil_utils`.  `shift(q, di, dj)` gives the
whole-array shifted view, zero-filled at the array bounds (always outside
any region a stencil writes), so whole arrays compare between the two
packages.  The region writes (`upd_*`, `set_region`, `region_add`) return
a new tensor with a slice overwritten and leave their inputs untouched; on
a rank's block (a `Domain` of a split tile) the shifts zero-fill at the
block's bounds, the halo's width past a side that borders another rank.
"""

from __future__ import annotations

import torch

# Largest |d| used anywhere (a2b_ord4 extrapolation rows).
_H = 4


def _shift_axis(q: torch.Tensor, d: int, axis: int) -> torch.Tensor:
    """out[i] = q[i+d] along `axis` where in bounds, 0 elsewhere."""
    if abs(d) > _H:
        raise ValueError(f"shift offset {d} exceeds fixed halo {_H}")
    out = torch.empty_like(q)
    size = q.shape[axis] - abs(d)
    if d > 0:
        out.narrow(axis, 0, size).copy_(q.narrow(axis, d, size))
        out.narrow(axis, size, d).zero_()
    else:
        out.narrow(axis, -d, size).copy_(q.narrow(axis, 0, size))
        out.narrow(axis, 0, -d).zero_()
    return out


def shift(q: torch.Tensor, di: int = 0, dj: int = 0, dk: int = 0):
    """out[..., i, j, k] = q[..., i+di, j+dj, k+dk], zero-filled at the
    array bounds (axes 1, 2 are i, j; axis 3 if present is k)."""
    out = q
    if di:
        out = _shift_axis(out, di, 1)
    if dj:
        out = _shift_axis(out, dj, 2)
    if dk:
        out = _shift_axis(out, dk, 3)
    return out


def _put(dest: torch.Tensor, expr: torch.Tensor, index) -> torch.Tensor:
    """A copy of dest with dest[index] = expr[index] (expr broadcasts)."""
    out = dest.clone()
    out[index] = expr.expand_as(dest)[index]
    return out


# The region writes take the tile's storage indices (ints or slices) and
# the operator's `Domain` (utils/gridtools.py), which maps them into the
# block the tensor holds; a line or region the block does not hold is not
# written.

def upd_cols(dom, dest, expr, *cols):
    """dest[:, i] = expr[:, i] for static columns i (int or slice)."""
    out = dest.clone()
    full = expr.expand_as(dest)
    for i in cols:
        i = dom.col(i)
        if i is not None:
            out[:, i] = full[:, i]
    return out


def upd_rows(dom, dest, expr, *rows):
    """dest[:, :, j] = expr[:, :, j] for static rows j (int or slice)."""
    out = dest.clone()
    full = expr.expand_as(dest)
    for j in rows:
        j = dom.row(j)
        if j is not None:
            out[:, :, j] = full[:, :, j]
    return out


def upd_point(dom, dest, expr, i, j):
    """dest[:, i, j] = expr[:, i, j] for static int-or-slice (i, j)."""
    i, j = dom.col(i), dom.row(j)
    if i is None or j is None:
        return dest
    return _put(dest, expr, (slice(None), i, j))


def set_region(dom, dest, sx: slice, sy: slice, expr):
    """dest[:, sx, sy] = expr[:, sx, sy] (expr is a whole-array expression)."""
    return upd_point(dom, dest, expr, sx, sy)


def region_add(dom, dest, sx, sy, expr):
    """dest[:, sx, sy] += expr[:, sx, sy]."""
    sx, sy = dom.col(sx), dom.row(sy)
    if sx is None or sy is None:
        return dest
    out = dest.clone()
    out[:, sx, sy] += expr.expand_as(dest)[:, sx, sy]
    return out


def upd_k(dest, expr, *ks):
    """dest[..., k] = expr[..., k] for static levels k."""
    out = dest.clone()
    full = expr.expand_as(dest)
    for k in ks:
        out[..., k] = full[..., k]
    return out


def sign(a, b):
    """|a| with the sign of b (Fortran SIGN; b == 0 counts as negative, as
    in the reference `sign`, which tests b > 0)."""
    return torch.where(b > 0, torch.abs(a), -torch.abs(a))


def maximum(a, b):
    """Elementwise maximum where either argument may be a Python number
    (NaN propagates from the tensor, as in `torch.maximum`)."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if isinstance(b, torch.Tensor):
        return torch.maximum(a, b)
    return torch.clamp(a, min=b)


def minimum(a, b):
    """Elementwise minimum where either argument may be a Python number."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if isinstance(b, torch.Tensor):
        return torch.minimum(a, b)
    return torch.clamp(a, max=b)


def dim(a, b):
    """Fortran DIM: max(a - b, 0)."""
    return torch.clamp(a - b, min=0.0)


def cumsum_k(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum along the last axis (k), summed in order from the
    first level in every column of a tensor of two or more columns,
    whatever its size.

    On the card the scan runs along the outer axis of a (k, columns) copy:
    PyTorch's outer-axis scan (ATen `tensor_kernel_scan_outer_dim`) has one
    thread add a column's levels one after another.  Its scan along the
    last axis instead splits a row over threads in a number chosen from
    the row count, so a rank holding one C192 tile rounded differently
    from the whole cube (7.6e-6 apart in float32 on random input, NVIDIA
    H100, PyTorch 2.11).  On the card the result is a view of the
    (k, columns) sums: x's shape, not its strides."""
    if not x.is_cuda:
        return torch.cumsum(x, -1)
    return torch.cumsum(x.movedim(-1, 0), 0).movedim(0, -1)


def reverse_cumsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., k] = sum of x[..., k:]."""
    return torch.flip(cumsum_k(torch.flip(x, (-1,))), (-1,))


def levels(a: torch.Tensor):
    """A (..., nz) tensor as a tuple of its nz levels, each contiguous: what
    a Python loop along k reads."""
    return a.movedim(-1, 0).contiguous().unbind(0)


def column(values, like: torch.Tensor) -> torch.Tensor:
    """A (nz,) numpy/list column as a (1, 1, 1, nz) tensor broadcasting
    against `like` (same device and dtype)."""
    return torch.as_tensor(values, dtype=like.dtype,
                           device=like.device).reshape(1, 1, 1, -1)


def level_mask(values, like: torch.Tensor) -> torch.Tensor:
    """A (nz,) boolean column as a (1, 1, 1, nz) mask on like's device."""
    return torch.as_tensor(values, dtype=torch.bool,
                           device=like.device).reshape(1, 1, 1, -1)
