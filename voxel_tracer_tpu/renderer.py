"""Renderer: jitted end-to-end frame rendering.

Analog of src/graphics/renderer.{h,cpp}, re-designed as a pure function
pipeline: ray-gen -> scene intersect (wavefront DDA) -> shading -> tonemap,
all under one `jit`.  The per-pixel OpenMP loop (renderer.cpp:199-223)
becomes a flat ray wavefront; display modes (dev/dev.h:36-46) become AOV
outputs returned alongside the image.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from voxel_tracer_tpu.models.camera import Camera, rays_for_image
from voxel_tracer_tpu.models.scene import SceneData
from voxel_tracer_tpu.models.skydome import sample_sky
from voxel_tracer_tpu.ops import composite, tonemap
from voxel_tracer_tpu.ops.math3d import BIG_F32


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (replaces the reference's compile-time defines,
    template/common.h:6-30)."""

    width: int = 1280
    height: int = 720
    shading: str = "full"        # flat | lambert | full
    max_steps: int = 256         # vv.cpp:7 MAX_STEPS
    max_candidates: int = 4      # per-ray candidate objects (BVH front size)
    max_bounces: int = 8         # materials.cpp:16 recursion cap
    glass_reflections: int = 4   # glass internal-reflection cap (reference
                                 # MAX_REFLECTIONS = 8, materials.cpp:128;
                                 # 4 covers the dominant paths at half cost)
    tonemapper: str = "aces"     # aces | reinhard | uncharted2 | none
    ambient: float = 0.2         # flat ambient for lambert mode
    accumulate: bool = False     # temporal reprojection (renderer.cpp:273)
    compact: bool = False        # live-ray compaction in shade_full: run
                                 # each heavy stage on a dense gather of
                                 # its live subset (ops/compact.py)
    compact_fracs: tuple = (1 / 64, 1 / 16, 1 / 2)  # capacity buckets
    traversal: str | None = None  # ops.dda.IMPLS; None = the Triton
                                  # kernel on a GPU, XLA elsewhere

    @property
    def aspect(self) -> float:
        return self.width / self.height


class Renderer:
    """Owns config; `render` is jit-compiled per (config, scene structure).

    With ``config.accumulate`` the renderer carries the temporal
    accumulator + previous-frame view pyramid across `render` calls (the
    ping-pong accu/prev_frame buffers and `camera.prev_pyramid` of the
    reference, renderer.cpp:240-244, camera.cpp:3-16) and blends 95%
    history with depth rejection (renderer.cpp:273-329)."""

    def __init__(self, config: RenderConfig = RenderConfig()):
        self.config = config
        self.frame = 0
        self._accu = None          # (H, W, 4) irradiance + depth history
        self._prev_planes = None   # (4, 4) previous-frame pyramid planes
        self._render = jax.jit(
            functools.partial(_render_impl, config=config))

    def camera(self, pos, target) -> Camera:
        return Camera.create(pos, target, self.config.aspect)

    def reset_history(self):
        self._accu = None
        self._prev_planes = None

    def render(self, scene: SceneData, camera: Camera, frame: int | None = None,
               depth_delta: float = 0.0):
        """Render one frame; returns dict with 'image' (H, W, 3) f32 in [0,1]
        plus AOVs: albedo, irradiance, depth, normal, steps.

        depth_delta: camera forward motion since the previous frame
        (player.cpp:7-53 output), compensates the depth rejection."""
        if frame is None:
            frame = self.frame
            self.frame = (self.frame + 1) % 120  # renderer.cpp:161-162
        if not self.config.accumulate:
            return self._render(scene, camera, jnp.int32(frame), None, None,
                                jnp.float32(0.0))
        if self._accu is None:
            # depth = BIG so frame 0 rejects all history
            h, w = self.config.height, self.config.width
            self._accu = jnp.concatenate(
                [jnp.zeros((h, w, 3), jnp.float32),
                 jnp.full((h, w, 1), BIG_F32, jnp.float32)], axis=-1)
            self._prev_planes = camera.planes
        out = self._render(scene, camera, jnp.int32(frame), self._accu,
                           self._prev_planes, jnp.float32(depth_delta))
        self._accu = out["accu"]
        self._prev_planes = camera.planes  # Camera::tick prev_pyramid save
        return out


def _render_impl(scene: SceneData, camera: Camera, frame, prev_accu=None,
                 prev_planes=None, depth_delta=0.0, *, config: RenderConfig):
    w, h = config.width, config.height
    origins, dirs = rays_for_image(camera, w, h)
    return render_rays(scene, origins, dirs, frame, config=config,
                       prev_accu=prev_accu, prev_planes=prev_planes,
                       depth_delta=depth_delta)


def render_rays(scene: SceneData, origins, dirs, frame, *,
                config: RenderConfig, prev_accu=None, prev_planes=None,
                depth_delta=0.0):
    """Render a pre-generated ray wavefront (ray-gen split out so callers —
    e.g. parallel/sharding.py — can place sharding constraints on the rays).
    """
    w, h = config.width, config.height

    hit = composite.intersect_scene(
        scene, origins, dirs, config.max_candidates, config.max_steps,
        impl=config.traversal)
    missed = hit.t >= BIG_F32

    sky = sample_sky(scene.sky, dirs)
    albedo = jnp.where(missed[:, None], sky, hit.albedo)

    if config.shading == "flat":
        irradiance = jnp.ones_like(albedo)
    elif config.shading == "lambert":
        from voxel_tracer_tpu.ops.shading import lambert_irradiance
        irradiance = lambert_irradiance(scene, origins, dirs, hit, config)
    else:
        from voxel_tracer_tpu.ops.shading import shade_full
        albedo, irradiance = shade_full(
            scene, origins, dirs, hit, frame, config)
        albedo = jnp.where(missed[:, None], sky, albedo)

    irradiance = jnp.where(missed[:, None], 1.0, jnp.maximum(irradiance, 0.0))

    out = {}
    if config.accumulate and prev_accu is not None:
        # Temporal reprojection of IRRADIANCE (renderer.cpp:205-221: albedo
        # stays crisp, the noisy lighting term is history-blended).
        from voxel_tracer_tpu.ops.reproject import reproject_accumulate
        hit_points = origins + dirs * hit.t[:, None]
        irradiance, new_accu = reproject_accumulate(
            irradiance, hit.t, hit_points, prev_accu, prev_planes, w, h,
            depth_delta=depth_delta, reproject_mask=~missed)
        out["accu"] = new_accu
    color = albedo * irradiance

    tm = {"aces": tonemap.aces_approx, "reinhard": tonemap.reinhard,
          "uncharted2": tonemap.uncharted2, "none": lambda x: x}[config.tonemapper]
    image = tm(color)

    shp = (h, w)
    out.update(
        image=image.reshape(h, w, 3),
        albedo=albedo.reshape(h, w, 3),
        irradiance=irradiance.reshape(h, w, 3),
        color=color.reshape(h, w, 3),
        depth=hit.t.reshape(shp),
        normal=hit.normal.reshape(h, w, 3),
        steps=hit.steps.reshape(shp),
        material=hit.mat.reshape(shp),
    )
    return out
