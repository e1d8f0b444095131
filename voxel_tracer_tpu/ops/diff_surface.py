"""Differentiable SURFACE rendering: gradients through the Lambert shading
of the discrete voxel hit (BASELINE config 2, "512^2 diff. Lambertian").

The traversal itself is discrete (which voxel a ray hits is not a
continuous function of appearance parameters), so its outputs — hit mask,
material id, normal, depth — are treated as non-differentiable constants
(`stop_gradient`), exactly like the reference's fixed geometry.  What IS
differentiable is the appearance model evaluated on those hits:

    color = palette[mat] * (sun_light * max(n . sun_dir, 0) * vis + ambient)
            + miss * sky

with parameters (palette, sun_light, ambient, sky).  Gradients flow through
the palette gather (jnp.take -> scatter-add in the backward pass) and the
shading arithmetic; the shadow visibility `vis` is a traversal output and
stays constant.  Geometry gradients are the job of the volumetric path
(ops/diff.py `render_density`, replay-VJP): the two compose — optimize
shape with the density model, appearance with this one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from voxel_tracer_tpu.models.scene import SceneData
from voxel_tracer_tpu.models.skydome import sample_sky
from voxel_tracer_tpu.ops import composite
from voxel_tracer_tpu.ops.math3d import BIG_F32, dot


def render_lambert_surface(palette, scene: SceneData, origins, dirs,
                           sun_light=None, ambient=0.2,
                           max_candidates: int = 4, max_steps: int = 256,
                           impl: str | None = None):
    """Lambert surface render differentiable w.r.t. `palette` (256, 3)
    (and optionally `sun_light` (3,)); scene geometry gives the hits.

    Returns dict(color (N, 3), hit (N,), mat (N,)).  The scene's own
    palette is ignored for shading — `palette` is the parameter being
    optimized (single-volume appearance fitting; multi-object scenes can
    stack palettes and offset by `hit.obj`).  ``impl`` picks the traversal
    (`ops.dda.IMPLS`; None = the backend's default).
    """
    sl = scene.sun_light if sun_light is None else sun_light

    hit = composite.intersect_scene(scene, origins, dirs, max_candidates,
                                    max_steps, impl=impl)
    t = jax.lax.stop_gradient(hit.t)
    mat = jax.lax.stop_gradient(hit.mat)
    normal = jax.lax.stop_gradient(hit.normal)
    missed = t >= BIG_F32

    p = origins + dirs * t[:, None] + normal * 1e-4
    incidence = dot(normal, scene.sun_dir)
    occluded, _ = composite.is_occluded(
        scene, p, jnp.broadcast_to(scene.sun_dir, p.shape), BIG_F32,
        max_candidates, shadow_seed=None, impl=impl)
    vis = jax.lax.stop_gradient(
        ((incidence > 0.0) & ~occluded).astype(jnp.float32))

    albedo = jnp.take(palette, jnp.clip(mat, 0, 255), axis=0)
    irr = sl * (jnp.maximum(incidence, 0.0) * vis)[:, None] + ambient
    sky = sample_sky(scene.sky, dirs)
    color = jnp.where(missed[:, None], sky, albedo * irr)
    return {"color": color, "hit": ~missed, "mat": mat}


def palette_fit_loss(palette, scene: SceneData, origins, dirs, target,
                     **kw):
    """MSE appearance-fitting loss — `jax.grad` of this w.r.t. palette is
    the config-2 backward pass."""
    out = render_lambert_surface(palette, scene, origins, dirs, **kw)
    return jnp.mean((out["color"] - target) ** 2)
