"""Material model: the reference's 7-field jade material.

Mirrors the Material struct (PathTrace.cpp:38-46, PathTrace.cu:293-301)
and its mode constants (PathTrace.cpp:29-36, PathTrace.cu:41-47). Emission
doubles as the light flag: a triangle is a light when any emissive channel
exceeds 1.5e-4 (PathTrace.cpp:1106-1111, PathTrace.cu:1597).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

# reflex_mode (PathTrace.cu:41-42)
DIFFUSE = 0
MIRROR = 1

# refract_mode (PathTrace.cu:44-45; DIR_REFRACT appears as the `else`
# branch of refract handling, PathTrace.cu:1180)
NO_REFRACT = 0
SUB_SURFACE = 1
DIR_REFRACT = 2

EMISSIVE_THRESHOLD = 1.5e-4  # light-registry test (PathTrace.cu:1597)


def _v3(x) -> Tuple[float, float, float]:
    if isinstance(x, (int, float)):
        return (float(x),) * 3
    t = tuple(float(v) for v in x)
    assert len(t) == 3
    return t


@dataclasses.dataclass(frozen=True)
class Material:
    """Per-object surface description (uniform per OBJ, like readObj)."""

    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    brdf: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    reflex_mode: int = DIFFUSE
    refract_mode: int = NO_REFRACT
    refract_rate: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    refract_albedo: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    refract_index: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "emissive", _v3(self.emissive))
        object.__setattr__(self, "brdf", _v3(self.brdf))
        object.__setattr__(self, "refract_rate", _v3(self.refract_rate))
        object.__setattr__(self, "refract_albedo", _v3(self.refract_albedo))

    @property
    def is_emissive(self) -> bool:
        return any(c > EMISSIVE_THRESHOLD for c in self.emissive)


# The hero material: jade Buddha (PathTrace.cpp:981-989).
JADE = Material(
    brdf=(0.02, 0.02, 0.02),
    reflex_mode=MIRROR,
    refract_mode=SUB_SURFACE,
    refract_rate=(0.1, 0.1, 0.1),
    refract_albedo=(0.3, 0.3, 0.3),
    refract_index=2.66,
)

# The demo light quad (PathTrace.cpp:1004-1008).
LIGHT_1000 = Material(
    emissive=(1000.0, 1000.0, 1000.0),
    brdf=(0.3, 0.3, 0.3),
    reflex_mode=DIFFUSE,
    refract_mode=NO_REFRACT,
    refract_index=1.1,
)

# The mirror floor slab (PathTrace.cpp:1030-1035).
MIRROR_FLOOR = Material(
    brdf=(0.3, 0.3, 0.3),
    reflex_mode=MIRROR,
    refract_mode=NO_REFRACT,
    refract_rate=(0.7, 0.7, 0.7),
    refract_index=1.1,
)


def material_to_list(m: Material) -> Sequence[float]:
    """Flatten in render_args.txt field order (PathTrace.cpp:906-912)."""
    return (
        list(m.emissive)
        + list(m.brdf)
        + [m.reflex_mode, m.refract_mode]
        + list(m.refract_rate)
        + list(m.refract_albedo)
        + [m.refract_index]
    )
