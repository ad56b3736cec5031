"""vxtpu — a differentiable voxel ray-marching framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the *capabilities* of the reference
renderer ``MitchellHansen/voxel-raycaster`` (a C++/OpenCL real-time voxel
ray-caster; see /root/repo/SURVEY.md for the full component inventory).
This is not a port: the per-pixel OpenCL march becomes a per-ray Pallas
kernel over blocks of rays (plus a masked lock-step XLA march); the
sparse-voxel-octree acceleration structure becomes a dense occupancy
pyramid or a Chebyshev distance field; the interactive SFML loop
becomes scripted camera paths and jitted frame steps; and — beyond the
reference — rendering is differentiable (soft volumetric mode with a custom
VJP) and distributed (rays sharded over a device mesh via ``shard_map``).

Layer map (reference -> here, per SURVEY.md section 2):
  OpenCL kernel        -> render/ (kernel_ref oracle, kernel_triton, kernel_xla)
  CLCaster harness     -> engine/ (platform, renderer, sharding)
  Old_Map / Octree     -> world/ (grid, pyramid, procgen)
  Camera / viewport    -> camera/ (camera, rays, paths)
  LightController      -> world/lights
  Pub_Sub / Input      -> app/schedule (declarative animation schedules)
  Logger / fps_counter -> obs/ (log, metrics)
  main.cpp loop        -> app/run CLI
"""

__version__ = "0.1.0"

from vxtpu.world.grid import VoxelGrid
from vxtpu.world.lights import Lights
from vxtpu.camera.camera import Camera
from vxtpu.render.settings import RenderSettings

__all__ = [
    "VoxelGrid",
    "Lights",
    "Camera",
    "RenderSettings",
    "__version__",
]
