"""Grid sizing and index bookkeeping for the global-view cubed-sphere layout.

Unlike the reference's per-rank `GridSizer`/`GridIndexing`
(ai2cm/pace util/pace/util/initialization/sizer.py, dsl/pace/dsl/stencil.py:542),
this framework keeps each full cube face on-array: every field is a global
array of shape ``(6, N, N, ...)`` where ``N = n + 2*halo + 1``.  Cell centers
``i in [0, n)`` live at array index ``i + halo``; interface index ``i`` lives
at ``i + halo``.  All six tiles share identical index geometry, so tile-edge
specializations are static slices, not masks.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from pace_torch.utils import constants


@dataclasses.dataclass(frozen=True)
class GridSizing:
    """Static description of the per-tile index space.

    Attributes:
        n: number of cells along each horizontal tile axis (e.g. 48 for C48).
        nz: number of vertical levels (cell centers).
        halo: halo width in cells.
    """

    n: int
    nz: int
    halo: int = constants.N_HALO_DEFAULT

    @property
    def npx(self) -> int:
        """Number of interface points along x on the tile (n+1)."""
        return self.n + 1

    @property
    def npy(self) -> int:
        return self.n + 1

    @property
    def npz(self) -> int:
        return self.nz

    # --- storage shape ---------------------------------------------------
    @property
    def N(self) -> int:
        """Padded horizontal array size: n + 2*halo + 1 (room for interfaces)
        rounded up to a multiple of 8, the reference package's layout."""
        return -(-(self.n + 2 * self.halo + 1) // 8) * 8

    @property
    def shape2d(self) -> Tuple[int, int, int]:
        return (constants.N_TILES, self.N, self.N)

    @property
    def shape3d(self) -> Tuple[int, int, int, int]:
        return (constants.N_TILES, self.N, self.N, self.nz)

    @property
    def shape3d_kiface(self) -> Tuple[int, int, int, int]:
        return (constants.N_TILES, self.N, self.N, self.nz + 1)

    # --- compute-domain bounds -------------------------------------------
    @property
    def isc(self) -> int:
        """First compute cell index in storage coordinates."""
        return self.halo

    @property
    def iec(self) -> int:
        """One-past-last compute cell index (python slice convention)."""
        return self.halo + self.n

    # alias names for readability in stencil code
    @property
    def jsc(self) -> int:
        return self.halo

    @property
    def jec(self) -> int:
        return self.halo + self.n

    @property
    def ise(self) -> int:
        """One-past-last interface index (== halo + n + 1)."""
        return self.halo + self.n + 1

    def slice_compute(self, iface_x: bool = False, iface_y: bool = False):
        """(i, j) slices covering the compute domain."""
        sx = slice(self.halo, self.halo + self.n + (1 if iface_x else 0))
        sy = slice(self.halo, self.halo + self.n + (1 if iface_y else 0))
        return sx, sy

    def domain_shape(self, iface_x: bool = False, iface_y: bool = False):
        return (
            constants.N_TILES,
            self.n + (1 if iface_x else 0),
            self.n + (1 if iface_y else 0),
        )
