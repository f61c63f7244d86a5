"""Active-site capacities of the radar backbone: the per-stage table sizes.

The host precompute (``data/``) sizes its rulebooks with them and the
backbone (``models/``) sizes its site tables with them, so both read them
from here and neither layer imports the other.
"""

from __future__ import annotations

from typing import Tuple

DEFAULT_CAPS = (65536, 49152, 32768, 24576)


def stage_caps(caps, hw: Tuple[int, int]) -> Tuple[int, ...]:
    """Per-stage active-site capacities, clipped to each stage's grid area."""
    h, w = hw
    return tuple(min(int(c), (h // s) * (w // s)) for c, s in zip(caps, (1, 2, 4, 8)))


def as_caps(bk_cfg, grid_size) -> Tuple[int, ...]:
    """The backbone config's capacities (``MAX_ACTIVE``) for a (nx, ny) grid."""
    nx, ny = grid_size
    return stage_caps(bk_cfg.get("MAX_ACTIVE", DEFAULT_CAPS), (ny, nx))
