"""Composable Virtual Data Centers on a TPU pod grid.

The paper's disaggregated resource pool is the 16×16 chip grid; a VDC is a
rectangular submesh tile composed just-in-time for one task and released
(or re-composed — see elastic.py) when the task finishes. Allocation is a
buddy scheme over power-of-two tiles so every VDC is a contiguous ICI
rectangle (collectives stay on-torus).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch import hardware as hw

MIN_VDC_CHIPS = 4


def is_valid_vdc_size(chips: int) -> bool:
    """The single source of truth for composable VDC sizes: a power of
    two of at least MIN_VDC_CHIPS (shared by PodGrid.compose and the
    placement plan validation)."""
    return chips >= MIN_VDC_CHIPS and not (chips & (chips - 1))


@dataclasses.dataclass(frozen=True)
class Tile:
    x: int
    y: int
    w: int
    h: int

    @property
    def chips(self) -> int:
        return self.w * self.h


@dataclasses.dataclass
class VDC:
    """A composed virtual data center: tile + DVFS operating point + job."""
    vdc_id: int
    tile: Tile
    dvfs_f: float
    task_id: int

    @property
    def chips(self) -> int:
        return self.tile.chips


class PodGrid:
    """Buddy allocator over the pod's chip grid (power-of-two tiles)."""

    def __init__(self, width: int = hw.POD_X, height: int = hw.POD_Y):
        self.width, self.height = width, height
        self.free: List[Tile] = [Tile(0, 0, width, height)]
        self.used: Dict[int, VDC] = {}
        self._next_id = 0

    @property
    def total_chips(self) -> int:
        return self.width * self.height

    @property
    def free_chips(self) -> int:
        return sum(t.chips for t in self.free)

    @property
    def used_chips(self) -> int:
        return self.total_chips - self.free_chips

    def _split_to(self, tile: Tile, chips: int) -> Tile:
        """Split `tile` (in the free list context) until it has `chips`."""
        while tile.chips > chips:
            if tile.w >= tile.h:  # split along x
                half = tile.w // 2
                a = Tile(tile.x, tile.y, half, tile.h)
                b = Tile(tile.x + half, tile.y, tile.w - half, tile.h)
            else:
                half = tile.h // 2
                a = Tile(tile.x, tile.y, tile.w, half)
                b = Tile(tile.x, tile.y + half, tile.w, tile.h - half)
            self.free.append(b)
            tile = a
        return tile

    def compose(self, chips: int, dvfs_f: float, task_id: int
                ) -> Optional[VDC]:
        """Compose a VDC of `chips` (power of two ≥4); None if fragmented."""
        if not is_valid_vdc_size(chips):
            raise ValueError(f"VDC sizes must be powers of two >= "
                             f"{MIN_VDC_CHIPS}, got {chips}")
        candidates = sorted([t for t in self.free if t.chips >= chips],
                            key=lambda t: t.chips)
        if not candidates:
            return None
        tile = candidates[0]
        self.free.remove(tile)
        tile = self._split_to(tile, chips)
        vdc = VDC(self._next_id, tile, dvfs_f, task_id)
        self._next_id += 1
        self.used[vdc.vdc_id] = vdc
        return vdc

    def release(self, vdc: VDC) -> None:
        del self.used[vdc.vdc_id]
        self.free.append(vdc.tile)
        self._coalesce()

    def _coalesce(self) -> None:
        """Merge free BUDDIES only (strict buddy scheme: a merge must
        reconstruct the exact parent tile of the split that created the
        pair, alignment included) so every free tile keeps a power-of-two
        area and splits always land exactly on the requested size."""
        merged = True
        while merged:
            merged = False
            self.free.sort(key=lambda t: (t.y, t.x))
            for i, a in enumerate(self.free):
                for j in range(i + 1, len(self.free)):
                    b = self.free[j]
                    if a.w != b.w or a.h != b.h:
                        continue
                    # (w == h) was produced by a y-split of (w, 2h)
                    if (a.w == a.h and a.x == b.x and b.y == a.y + a.h
                            and a.y % (2 * a.h) == 0):
                        self.free[i] = Tile(a.x, a.y, a.w, 2 * a.h)
                        del self.free[j]
                        merged = True
                        break
                    # (h == 2w) was produced by an x-split of (2w, h)
                    if (a.h == 2 * a.w and a.y == b.y and b.x == a.x + a.w
                            and a.x % (2 * a.w) == 0):
                        self.free[i] = Tile(a.x, a.y, 2 * a.w, a.h)
                        del self.free[j]
                        merged = True
                        break
                if merged:
                    break

    def power_w(self, cost_model) -> float:
        """Current power draw of all composed VDCs (idle chips draw static)."""
        p = sum(cost_model.power_w(v.chips, v.dvfs_f)
                for v in self.used.values())
        p += self.free_chips * hw.CHIP_STATIC_W
        return p
