"""Production meshes (port of ``repro/launch/mesh.py``).

The reference's meshes are JAX device meshes of TPU chips.  The port's are
descriptions: axis names and sizes, no devices, so the dry-run can place a
cell on 256 or 512 devices from one host (or none).  They are what
:mod:`repro_torch.sharding.rules`' logical rule table and
:mod:`repro_torch.launch.specs` read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh with no devices: ``dims`` along ``axis_names``."""

    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, as a JAX mesh's ``.shape`` gives it."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The reference's production meshes: 16×16 ("data", "model") and, over
    two pods, 2×16×16 ("pod", "data", "model")."""
    if multi_pod:
        return MeshSpec((2, 16, 16), ("pod", "data", "model"))
    return MeshSpec((16, 16), ("data", "model"))

