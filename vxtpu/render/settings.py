"""Static render configuration. The reference passed a ``settings_buffer`` of
runtime toggles into its OpenCL kernel (SURVEY.md §6 "Config / flag system");
here toggles are *static* jit arguments so XLA specializes and dead-code
eliminates per variant — a shadow-less render compiles to a shadow-less
kernel, not a branchy one.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Hashable — used as a static argnum / closed over at trace time.

    shading:    'flat'    — albedo * per-face brightness (config 1)
                'lambert' — diffuse point lights + ambient (config 2)
                'full'    — diffuse + Blinn-Phong specular (+ shadows/fog if on)
    shadows:     march a shadow ray toward each light from the hit point.
    fog:         exponential distance fog toward sky color.
    max_steps:   DDA step budget; None -> derived from grid dims (X+Y+Z+2:
                 a ray can cross at most dimX+dimY+dimZ cell boundaries).
    pyramid_levels: number of coarse occupancy levels used for empty-space
                 skipping (0 = plain fine DDA; 2-level skip per config 3).
    step_chunk:  batch kernels march this many steps between early-exit
                 checks (amortizes the any(active) sync).
    ambient:     ambient light floor for lit modes.
    specular_exp / specular_k: Blinn-Phong parameters.
    fog_density: exp fog coefficient (per world unit of ray distance).
    sky_top / sky_horizon: miss-shade gradient endpoints (RGB).
    """

    shading: str = "lambert"
    shadows: bool = False
    fog: bool = False
    max_steps: int | None = None
    pyramid_levels: int = 0
    step_chunk: int = 32
    ambient: float = 0.15
    specular_exp: float = 32.0
    specular_k: float = 0.35
    fog_density: float = 0.004
    sky_top: tuple[float, float, float] = (0.35, 0.55, 0.85)
    sky_horizon: tuple[float, float, float] = (0.80, 0.88, 0.95)

    def resolve_max_steps(self, dims: tuple[int, int, int]) -> int:
        if self.max_steps is not None:
            return self.max_steps
        return dims[0] + dims[1] + dims[2] + 2

    # Named presets: the five capability configs from BASELINE.json:7-11.
    @staticmethod
    def flat() -> "RenderSettings":
        return RenderSettings(shading="flat")

    @staticmethod
    def lit() -> "RenderSettings":
        return RenderSettings(shading="lambert")

    @staticmethod
    def full(pyramid_levels: int = 2) -> "RenderSettings":
        return RenderSettings(
            shading="full", shadows=True, fog=True, pyramid_levels=pyramid_levels
        )
