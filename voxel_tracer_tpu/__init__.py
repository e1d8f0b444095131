"""voxel_tracer_tpu — a differentiable voxel ray tracer in JAX.

A brand-new JAX / XLA / Pallas framework with the capabilities of the
`mxcop/voxel-tracer` reference (a C++20 AVX2 CPU voxel tracer): pinhole ray
generation, ray-box slab tests, two-level (brickmap) Amanatides-Woo DDA
through dense voxel grids, MagicaVoxel `.vox` scenes, multi-object scenes
with rigid transforms, Whitted-style shading (diffuse / sun / ambient /
sphere area lights, mirror, glass), soft shadows, HDR skydome, blue-noise
sampling, temporal reprojection, tonemapping and dynamic voxel edits —
re-designed for accelerators: batched mask-based traversal under `jit`, a
Pallas (Triton) kernel for the hot march on the GPU, differentiable per-voxel parameters with a
replay-based custom VJP, and scale-out over a `jax.sharding.Mesh`.

This is not a port: the reference informs *what* is built (see SURVEY.md),
not *how*.
"""

__version__ = "0.1.0"

from voxel_tracer_tpu.models.camera import Camera
from voxel_tracer_tpu.models.volume import VoxelVolume
from voxel_tracer_tpu.models.scene import Scene
from voxel_tracer_tpu.models.vox import load_vox
from voxel_tracer_tpu.renderer import Renderer, RenderConfig

__all__ = [
    "Camera",
    "VoxelVolume",
    "Scene",
    "load_vox",
    "Renderer",
    "RenderConfig",
]
