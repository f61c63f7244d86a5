"""What the host precompute and the models both read off a backbone config.

The active-site capacities of a backbone: the host precompute (``data/``)
sizes its rulebooks with them and the backbone (``models/``) sizes its site
tables with them. And whether a backbone takes the sparse pillar table (an
active-site one, or the table-input S2D teacher): the host builds that table,
the detector wires it. Both layers read these from here and neither imports
the other.
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


def is_as(bk_cfg) -> bool:
    """An active-site backbone, fed by the VFE's pillar table."""
    return bk_cfg.get("NAME", "PillarRes18BackBone8x").endswith("_AS")


def is_table_s2d(bk_cfg) -> bool:
    """The space-to-depth teacher backbone fed by the VFE's pillar table."""
    return "_S2D" in bk_cfg.get("NAME", "") and bool(bk_cfg.get("TABLE_INPUT", False))
