"""Profiling harness (src/dev/profile.h analog) and the benchmark scenes.

The reference's PROFILING build renders a deterministic 8x8x8 grid of 512
crate volumes with a canned camera on one pinned core (profile.h:10-37,
camera_profiling.bin).  Here the same scene is built from the seeded crate
assets (models/assets.py), optionally baked into one merged grid, with a
fixed camera pose.  `default_scene` is the reference's default frame.
The main path's scenes and training problem (`frame_scenes`,
`training_problem`) are built here for `chip_smoke.py`, the benchmarks and
`tools/trace_main_path.py`.

`trace()` wraps `jax.profiler` for device-level traces (the analog of the
reference's FPS/frame-time overlay + step-count heatmaps, which live on as
the EMA timer in utils/timer.py and the steps AOV).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler device trace around a code block.

    View with `tensorboard --logdir <logdir>` or xprof.  Usage:

        with profiling.trace("chiprun_out/trace"):
            out = render(...); jax.block_until_ready(out)
    """
    import jax

    jax.profiler.start_trace(logdir, create_perfetto_trace=False)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named sub-region inside a trace (jax.profiler.TraceAnnotation)."""
    import jax

    return jax.profiler.TraceAnnotation(name)

from voxel_tracer_tpu.models.camera import Camera
from voxel_tracer_tpu.models.volume import VoxelVolume
from voxel_tracer_tpu.models.vox import load_vox

VOXEL = 1.0 / 20.0  # reference VOXEL scale (common.h:18, vpu 20)


def profiling_volumes(count_per_axis: int = 8):
    """The 512-crate scene (profile.h:23-36): crate models alternating by
    z layer, spaced VOXEL * 32 apart."""
    from voxel_tracer_tpu.models.assets import asset_path

    models = []
    for name in ("crate-16.vox", "crate-10.vox"):
        m = load_vox(asset_path(name))
        models.append((m.grid, m.palette_f32))

    vols = []
    spacing = VOXEL * 32.0
    n = count_per_axis
    for z in range(n):
        grid, pal = models[z % 2]
        for y in range(n):
            for x in range(n):
                vols.append(VoxelVolume(
                    grid, pal, pos=(spacing * x, spacing * y, spacing * z),
                    vpu=20.0))
    return vols


def default_scene_volumes():
    """The reference's default frame content (scene.cpp:5-31): the glass
    test box at the origin plus 4 enemy drones in a row above it."""
    from voxel_tracer_tpu.models.assets import asset_path

    vols = [VoxelVolume.from_vox(asset_path("testing/glass-box.vox"))]
    for i in range(4):
        vols.append(VoxelVolume.from_vox(asset_path("enemy-drone.vox"),
                                         pos=(float(i), 2.0, 0.0)))
    return vols


def default_scene():
    """Glass box + 4 drones with a procedural sky and one sphere light.
    Returns (Scene, center) with ``center`` the world center of the
    volumes' bounds (the orbit target of the benchmark camera)."""
    from voxel_tracer_tpu.models.scene import Scene
    from voxel_tracer_tpu.models.skydome import SkyDome

    vols = default_scene_volumes()
    scene = Scene(volumes=vols, skydome=SkyDome.procedural(64, 32))
    scene.add_light((2.0, 3.5, -1.5), 0.15, (1.0, 0.9, 0.8), 40.0)
    bounds = np.array([v.get_aabb() for v in vols])
    center = (bounds[:, 0].min(axis=0) + bounds[:, 1].max(axis=0)) * 0.5
    return scene, center.astype(np.float32)


def default_camera(center, aspect: float, theta: float = 0.0) -> Camera:
    """Orbit pose around the default scene (3.2 units out, 1.2 up)."""
    pos = (center[0] + 3.2 * np.cos(theta), center[1] + 1.2,
           center[2] + 3.2 * np.sin(theta))
    return Camera.create(pos, center, aspect)


def profiling_camera(aspect: float, count_per_axis: int = 8) -> Camera:
    """Fixed profiling pose (camera_profiling.bin analog): outside the
    crate field, looking into its center."""
    span = VOXEL * 32.0 * count_per_axis
    center = np.array([span, span, span]) * 0.5
    pos = center + np.array([-span * 0.7, span * 0.45, -span * 0.8])
    return Camera.create(pos, center, aspect)


def noise_volume():
    """The dense 64^3 noise volume of the lambert and flat frames."""
    return VoxelVolume.noise_filled((64, 64, 64), pos=(0, 0, 0), vpu=20.0)


def noise_camera(aspect: float) -> Camera:
    return Camera.create((2.0, 1.4, -2.4), (0.0, 0.0, 0.0), aspect)


def frame_scenes(lambert_hw=(1088, 1920), full_hw=(768, 1280),
                 traversal=None):
    """The two main-path frame scenes as (name, RenderConfig, SceneData,
    Camera): lambert frames of the noise volume, and full-material frames
    of the default scene at 3 bounces / 2 glass reflections."""
    from voxel_tracer_tpu.models.scene import Scene
    from voxel_tracer_tpu.models.skydome import SkyDome
    from voxel_tracer_tpu.renderer import RenderConfig

    h, w = lambert_hw
    noise = Scene(volumes=[noise_volume()],
                  skydome=SkyDome.procedural(64, 32)).data()
    lam = RenderConfig(width=w, height=h, shading="lambert",
                       traversal=traversal)
    scene, center = default_scene()
    hf, wf = full_hw
    full = RenderConfig(width=wf, height=hf, shading="full", max_bounces=3,
                        glass_reflections=2, traversal=traversal)
    return [
        ("lambert_noise64", lam, noise, noise_camera(w / h)),
        ("full_default_scene", full, scene.data(),
         default_camera(center, wf / hf)),
    ]


@dataclasses.dataclass(frozen=True)
class TrainShape:
    """The `inverse_128_32views` trainer shape: a grid^3 density + albedo
    grid fitted from `views` posed view_px^2 images, `rays` rays a step."""

    grid: int = 128
    views: int = 32
    view_px: int = 64
    rays: int = 131072


def training_problem(grid_n, n_views, px, march_steps, seed=0):
    """Posed target views of a seeded colored blob, as flat ray arrays in
    the grid's local frame (unit cube, vpu = grid_n).  Returns
    (vpu, origins, dirs, colors)."""
    import jax.numpy as jnp
    from voxel_tracer_tpu.models.camera import rays_for_image
    from voxel_tracer_tpu.ops import diff

    rng = np.random.RandomState(seed)
    z, y, x = np.meshgrid(*[np.arange(grid_n)] * 3, indexing="ij")
    c = (grid_n - 1) / 2
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
    sigma = np.where(r < grid_n * 0.35, 8.0, 0.0).astype(np.float32)
    sigma *= rng.uniform(0.5, 1.5, sigma.shape).astype(np.float32)
    albedo = np.stack([x / grid_n, y / grid_n, 1.0 - x / grid_n],
                      axis=-1).astype(np.float32)
    vpu = float(grid_n)
    pivot = np.full(3, 0.5, np.float32)
    os_, ds, cs = [], [], []
    for v in range(n_views):
        ang = 2 * np.pi * v / n_views
        el = 0.35 * np.sin(ang * 2 + 1.0)
        pos = 1.6 * np.array([np.cos(ang) * np.cos(el), np.sin(el),
                              np.sin(ang) * np.cos(el)])
        o, d = rays_for_image(Camera.create(pos, (0, 0, 0), 1.0), px, px)
        out = diff.render_density(jnp.asarray(sigma), jnp.asarray(albedo),
                                  o + pivot, d, vpu, march_steps)
        os_.append(np.asarray(o) + pivot)
        ds.append(np.asarray(d))
        cs.append(np.asarray(out["color"]))
    return vpu, np.concatenate(os_), np.concatenate(ds), np.concatenate(cs)


def profiling_scene_merged():
    """The 512-crate scene baked into one grid (about 256^3)."""
    from voxel_tracer_tpu.models.volume import bake_aligned_scene

    return bake_aligned_scene(profiling_volumes())


jax_trace = trace
