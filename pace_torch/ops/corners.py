"""Cube-corner wedge fills.

At each cube corner only three tiles meet, so the diagonal "wedge" of halo
points beyond a tile corner has no unique source tile; FV3 stencils instead
fill the wedge from the tile's own edge-halo data, rotated 90 degrees about
the corner, in the direction the next stencil will difference.

Port of `pace_tpu.ops.corners` (reference ai2cm/pace
stencils/pace/stencils/corners.py).  The index tables are the numpy tables
of the reference package, unchanged, in the tile's storage coordinates;
each fill is one whole-array gather (plus a masked select for the signed
variants) with the tables moved to the tensor's device once.  On a rank's
block (`Domain`, utils/gridtools.py) a table keeps the points whose target
and source the block holds, in its local indices: only a rank whose block
holds a tile corner fills it.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _corner_anchors(n: int, h: int):
    """Anchor indices in storage coordinates: first/last compute cell and
    first/last interface index."""
    isc = h           # first compute cell
    iec = h + n - 1   # last compute cell (inclusive)
    ise = h + n       # last interface index
    return isc, iec, ise


def _as_index_arrays(pairs):
    tgt = np.array([p[0] for p in pairs], dtype=np.int32)
    src = np.array([p[1] for p in pairs], dtype=np.int32)
    return tgt[:, 0], tgt[:, 1], src[:, 0], src[:, 1]


@functools.lru_cache(maxsize=None)
def _copy_corners_table(n: int, h: int, direction: str):
    """Index table for the Fortran copy_corners_x/y used by FvTp2d: fill the
    four wedges with edge-halo data rotated so the field can be differenced
    along `direction` across tile edges."""
    isc, iec, _ = _corner_anchors(n, h)
    jsc, jec = isc, iec
    pairs = []
    for di in range(1, h + 1):
        for dj in range(1, h + 1):
            if direction == "x":
                # sw: (isc-di, jsc-dj) <- (isc-dj, jsc+di-1)
                pairs.append(((isc - di, jsc - dj), (isc - dj, jsc + di - 1)))
                # se: (iec+di, jsc-dj) <- (iec+dj, jsc+di-1)
                pairs.append(((iec + di, jsc - dj), (iec + dj, jsc + di - 1)))
                # nw: (isc-di, jec+dj) <- (isc-dj, jec-di+1)
                pairs.append(((isc - di, jec + dj), (isc - dj, jec - di + 1)))
                # ne: (iec+di, jec+dj) <- (iec+dj, jec-di+1)
                pairs.append(((iec + di, jec + dj), (iec + dj, jec - di + 1)))
            else:
                # mirror of the x-direction table across the diagonal
                pairs.append(((isc - dj, jsc - di), (isc + di - 1, jsc - dj)))
                pairs.append(((iec + dj, jsc - di), (iec - di + 1, jsc - dj)))
                pairs.append(((isc - dj, jec + di), (isc + di - 1, jec + dj)))
                pairs.append(((iec + dj, jec + di), (iec - di + 1, jec + dj)))
    return _as_index_arrays(pairs)


def _restrict(dom, ti, tj, si, sj, *extra):
    """The entries of a (target <- source) table whose target and source
    `dom`'s block holds, in its local indices.  A rank whose box holds a
    tile corner holds every entry of that corner (each source lies within
    the halo's width of it); a target held without its source lies at the
    block's margin, as far from the box as the held halo is deep."""
    ti, tj = ti - dom.i0, tj - dom.j0
    si, sj = si - dom.i0, sj - dom.j0
    keep = ((ti >= 0) & (ti < dom.Ni) & (tj >= 0) & (tj < dom.Nj)
            & (si >= 0) & (si < dom.Ni) & (sj >= 0) & (sj < dom.Nj))
    return (ti[keep], tj[keep], si[keep], sj[keep]) + tuple(
        e[keep] for e in extra)


def _identity(dom):
    SI, SJ = np.meshgrid(
        np.arange(dom.Ni, dtype=np.int32), np.arange(dom.Nj, dtype=np.int32),
        indexing="ij",
    )
    return SI.copy(), SJ.copy()


def _as_permutation(dom, table):
    """Expand a sparse (target <- source) table into full (Ni, Nj) gather
    maps of `dom`'s block (identity outside the wedges)."""
    ti, tj, si, sj = _restrict(dom, *table)
    SI, SJ = _identity(dom)
    SI[ti, tj] = si
    SJ[ti, tj] = sj
    return SI, SJ


@functools.lru_cache(maxsize=None)
def copy_corners_perm(dom, direction: str):
    """Full (Ni, Nj) permutation maps of `dom`'s block for copy_corners
    (also composed with the halo-exchange gathers, on the whole tile)."""
    return _as_permutation(dom, _copy_corners_table(dom.n, dom.h, direction))


@functools.lru_cache(maxsize=None)
def _fill_corners_2d_table(n: int, h: int, gridtype: str, direction: str):
    """Tables for reference fill_corners_2d (A- or B-grid scalars)."""
    isc, iec, ise = _corner_anchors(n, h)
    jsc, jec, jse = isc, iec, ise
    pairs = []
    for di in range(1, h + 1):
        for dj in range(1, h + 1):
            i, j = di, dj
            if gridtype == "B":
                if direction == "x":
                    pairs.append(((isc - i, jsc - j), (isc - j, jsc + i)))
                    pairs.append(((isc - i, jse + j), (isc - j, jse - i)))
                    pairs.append(((ise + i, jsc - j), (ise + j, jsc + i)))
                    pairs.append(((ise + i, jse + j), (ise + j, jse - i)))
                else:
                    pairs.append(((isc - j, jsc - i), (isc + i, jsc - j)))
                    pairs.append(((isc - j, jse + i), (isc + i, jse + j)))
                    pairs.append(((ise + j, jsc - i), (ise - i, jsc - j)))
                    pairs.append(((ise + i, jse + j), (ise - i, jse + j)))
            else:  # A-grid
                if direction == "x":
                    pairs.append(((isc - i, jsc - j), (isc - j, jsc + i - 1)))
                    pairs.append(((isc - i, jec + j), (isc - j, jec - i + 1)))
                    pairs.append(((iec + i, jsc - j), (iec + j, jsc + i - 1)))
                    pairs.append(((iec + i, jec + j), (iec + j, jec - i + 1)))
                else:
                    pairs.append(((isc - j, jsc - i), (isc + i - 1, jsc - j)))
                    pairs.append(((isc - j, jec + i), (isc + i - 1, jec + j)))
                    pairs.append(((iec + j, jsc - i), (iec - i + 1, jsc - j)))
                    pairs.append(((iec + j, jec + i), (iec - i + 1, jec + j)))
    return _as_index_arrays(pairs)


@functools.lru_cache(maxsize=None)
def _fill_corners_2d_perm(dom, gridtype: str, direction: str):
    return _as_permutation(
        dom, _fill_corners_2d_table(dom.n, dom.h, gridtype, direction))


@functools.lru_cache(maxsize=None)
def _fill_corners_vector_tables(n: int, h: int, grid: str):
    """Tables for vector-pair corner fills on the A, C or D grid.

    Each entry: (target array 0=x/1=y, tgt_idx, source array, src_idx, sign_is_mysign)
    where sign_is_mysign marks entries multiplied by -1 for true vectors.
    """
    isc, iec, ise = _corner_anchors(n, h)
    jsc, jec, jse = isc, iec, ise
    # each pair: (tgt_arr, (ti,tj), src_arr, (si,sj), use_mysign: bool)
    entries = []
    for i in range(1, h + 1):
        for j in range(1, h + 1):
            if grid == "A":
                entries += [
                    (0, (isc - i, jsc - j), 1, (isc - j, jsc - 1 + i), True),
                    (1, (isc - j, jsc - i), 0, (isc - 1 + i, jsc - j), True),
                    (0, (isc - i, jec + j), 1, (isc - j, jec - i + 1), False),
                    (1, (isc - j, jec + i), 0, (isc - 1 + i, jec + j), False),
                    (0, (iec + i, jsc - j), 1, (iec + j, jsc - 1 + i), False),
                    (1, (iec + j, jsc - i), 0, (iec - i + 1, jsc - j), False),
                    (0, (iec + i, jec + j), 1, (iec + j, jec - i + 1), True),
                    (1, (iec + j, jec + i), 0, (iec - i + 1, jec + j), True),
                ]
            elif grid == "D":
                # x is (X_DIM, Y_INTERFACE), y is (X_INTERFACE, Y_DIM)
                entries += [
                    (0, (isc - i, jsc - j), 1, (isc - j, jsc + i - 1), True),
                    (1, (isc - i, jsc - j), 0, (isc + j - 1, jsc - i), True),
                    (0, (isc - i, jse + j), 1, (isc - j, jse - i), False),
                    (1, (isc - i, jec + j), 0, (isc + j - 1, jse + i), False),
                    (0, (iec + i, jsc - j), 1, (ise + j, jsc + i - 1), False),
                    (1, (ise + i, jsc - j), 0, (iec - j + 1, jsc - i), False),
                    (0, (iec + i, jse + j), 1, (ise + j, jse - i), True),
                    (1, (ise + i, jec + j), 0, (iec - j + 1, jse + i), True),
                ]
            elif grid == "C":
                # x is (X_INTERFACE, Y_DIM), y is (X_DIM, Y_INTERFACE)
                entries += [
                    (0, (isc - i, jsc - j), 1, (isc + j - 1, jsc - i), False),
                    (1, (isc - i, jsc - j), 0, (isc - j, jsc + i - 1), False),
                    (0, (isc - i, jec + j), 1, (isc + j - 1, jse + i), True),
                    (1, (isc - i, jse + j), 0, (isc - j, jse - i), True),
                    (0, (ise + i, jsc - j), 1, (ise - j, jsc - i), True),
                    (1, (iec + i, jsc - j), 0, (ise + j, jsc + i - 1), True),
                    (0, (ise + i, jec + j), 1, (ise - j, jse + i), False),
                    (1, (iec + i, jse + j), 0, (ise + j, jse - i), False),
                ]
            else:
                raise ValueError(grid)
    by_target = {0: [], 1: []}
    for tgt_arr, tgt, src_arr, src, use_sign in entries:
        by_target[tgt_arr].append((tgt, src, src_arr, use_sign))
    tables = {}
    for tgt_arr, rows in by_target.items():
        ti = np.array([r[0][0] for r in rows], np.int32)
        tj = np.array([r[0][1] for r in rows], np.int32)
        si = np.array([r[1][0] for r in rows], np.int32)
        sj = np.array([r[1][1] for r in rows], np.int32)
        sa = np.array([r[2] for r in rows], np.int32)
        sg = np.array([r[3] for r in rows], np.int32)
        tables[tgt_arr] = (ti, tj, si, sj, sa, sg)
    return tables


@functools.lru_cache(maxsize=None)
def _fill_corners_vector_perm(dom, grid: str):
    """Full (Ni, Nj) gather maps for fill_corners_vector: per target array,
    (SI, SJ) source indices (identity outside wedges), SA source-component
    selector, SG sign flag, and the wedge mask."""
    tables = _fill_corners_vector_tables(dom.n, dom.h, grid)
    out = {}
    for tgt_arr, table in tables.items():
        ti, tj, si, sj, sa, sg = _restrict(dom, *table)
        SI, SJ = _identity(dom)
        SA = np.zeros((dom.Ni, dom.Nj), np.int32)
        SG = np.zeros((dom.Ni, dom.Nj), np.int32)
        MASK = np.zeros((dom.Ni, dom.Nj), bool)
        SI[ti, tj] = si
        SJ[ti, tj] = sj
        SA[ti, tj] = sa
        SG[ti, tj] = sg
        MASK[ti, tj] = True
        out[tgt_arr] = (SI, SJ, SA, SG, MASK)
    return out


@functools.lru_cache(maxsize=None)
def _fill_corners_cells_table(n: int, h: int, direction: str, ncells: int):
    """Index/sign tables for the reference fill_corners_{2,3}cells_mult_{x,y}
    (stencils/corners.py:130-310): fill `ncells` halo cells beyond each tile
    corner along `direction` from a companion field, with per-corner sign."""
    isc, iec, _ = _corner_anchors(n, h)
    jsc, jec = isc, iec
    rows = []  # (tgt, src, corner_id) corner ids: 0=sw 1=se 2=nw 3=ne
    for d in range(1, ncells + 1):
        if direction == "x":
            rows.append((((isc - d, jsc - 1), (isc - 1, jsc + d - 1), 0)))
            rows.append((((iec + d, jsc - 1), (iec + 1, jsc + d - 1), 1)))
            rows.append((((isc - d, jec + 1), (isc - 1, jec - d + 1), 2)))
            rows.append((((iec + d, jec + 1), (iec + 1, jec - d + 1), 3)))
        else:
            rows.append((((isc - 1, jsc - d), (isc + d - 1, jsc - 1), 0)))
            rows.append((((iec + 1, jsc - d), (iec - d + 1, jsc - 1), 1)))
            rows.append((((isc - 1, jec + d), (isc + d - 1, jec + 1), 2)))
            rows.append((((iec + 1, jec + d), (iec - d + 1, jec + 1), 3)))
    ti = np.array([r[0][0] for r in rows], np.int32)
    tj = np.array([r[0][1] for r in rows], np.int32)
    si = np.array([r[1][0] for r in rows], np.int32)
    sj = np.array([r[1][1] for r in rows], np.int32)
    cid = np.array([r[2] for r in rows], np.int32)
    return ti, tj, si, sj, cid


@functools.lru_cache(maxsize=None)
def _fill_corners_cells_perm(dom, direction: str, ncells: int):
    ti, tj, si, sj, cid = _restrict(dom, *_fill_corners_cells_table(
        dom.n, dom.h, direction, ncells))
    SI, SJ = _identity(dom)
    CID = np.full((dom.Ni, dom.Nj), -1, np.int32)
    SI[ti, tj] = si
    SJ[ti, tj] = sj
    CID[ti, tj] = cid
    return SI, SJ, CID


@functools.lru_cache(maxsize=None)
def _on_device(key, device: torch.device):
    """Device copies of a cached numpy table set (tables are immutable)."""
    kind, args = key
    tables = _TABLE_BUILDERS[kind](*args)
    if isinstance(tables, dict):
        return {k: tuple(map(_to_device_array, v, [device] * len(v)))
                for k, v in tables.items()}
    return tuple(_to_device_array(a, device) for a in tables)


def _to_device_array(a, device):
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return torch.as_tensor(a, device=device)


def copy_corners(q: torch.Tensor, dom, direction: str):
    """Fortran copy_corners_x / copy_corners_y on a (tiles, Ni, Nj, ...)
    field."""
    SI, SJ = _on_device(("copy", (dom, direction)), q.device)
    return q[:, SI, SJ]


def fill_corners_2d(q, dom, gridtype: str, direction: str = "x"):
    SI, SJ = _on_device(("2d", (dom, gridtype, direction)), q.device)
    return q[:, SI, SJ]


def fill_corners_vector(x, y, dom, grid: str,
                        vector: bool = True) -> Tuple[torch.Tensor, ...]:
    """Fill corner wedges of a staggered vector pair (A/C/D grid).

    With vector=True, entries crossing an odd number of reflections get a
    sign flip (reference `mysign=-1`); vector=False is used for unsigned
    metric pairs like (dx, dy)."""
    perms = _on_device(("vector", (dom, grid)), x.device)
    mysign = -1.0 if vector else 1.0
    extra = (1,) * (x.ndim - 3)
    outs = []
    for tgt_arr, arr in ((0, x), (1, y)):
        SI, SJ, SA, SG, MASK = perms[tgt_arr]
        vals = torch.where((SA == 0).reshape((1,) + SA.shape + extra),
                           x[:, SI, SJ], y[:, SI, SJ])
        sign = torch.where(
            (SG == 1).reshape((1,) + SG.shape + extra),
            torch.tensor(mysign, dtype=arr.dtype, device=arr.device),
            torch.tensor(1.0, dtype=arr.dtype, device=arr.device),
        )
        outs.append(torch.where(MASK.reshape((1,) + MASK.shape + extra),
                                sign * vals, arr))
    return outs[0], outs[1]


def fill_corners_cells(q, q_corner, dom, direction: str,
                       ncells: int, sw_mult=1.0, se_mult=1.0, nw_mult=1.0,
                       ne_mult=1.0):
    """fill_corners_{2,3}cells_mult_{x,y}: write rotated companion-field data
    into `ncells` corner halo cells of q."""
    SI, SJ, CID = _on_device(("cells", (dom, direction, ncells)), q.device)
    extra = (1,) * (q.ndim - 3)
    mult = torch.ones(CID.shape, dtype=q.dtype, device=q.device)
    for c, m in enumerate((sw_mult, se_mult, nw_mult, ne_mult)):
        mult = torch.where(CID == c, torch.tensor(m, dtype=q.dtype,
                                                  device=q.device), mult)
    mask = (CID >= 0).reshape((1,) + CID.shape + extra)
    mm = mult.reshape((1,) + mult.shape + extra)
    return torch.where(mask, mm * q_corner[:, SI, SJ], q)


def fill_corners_dgrid(x, y, dom, vector=True):
    return fill_corners_vector(x, y, dom, "D", vector)


_TABLE_BUILDERS = {
    "copy": copy_corners_perm,
    "2d": _fill_corners_2d_perm,
    "vector": _fill_corners_vector_perm,
    "cells": _fill_corners_cells_perm,
}
