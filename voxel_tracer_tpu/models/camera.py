"""Pinhole camera + view pyramid (reprojection support).

Analog of the reference camera (src/graphics/camera.{h,cpp}) and Pyramid
(src/graphics/rays/pyramid.cpp), re-designed as an immutable pytree: the
basis (tl/tr/bl) is derived from pos/target exactly like Camera::tick
(camera.cpp:3-16), primary rays are generated for whole pixel grids at once,
and the view pyramid's four plane equations support the temporal
reprojection UV projection (pyramid.cpp:52-66).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from voxel_tracer_tpu.ops import math3d as m3

UP = np.array([0.0, 1.0, 0.0], np.float32)


class Camera(NamedTuple):
    """Immutable camera state. All fields are (3,) f32 unless noted."""

    pos: jnp.ndarray
    target: jnp.ndarray
    tl: jnp.ndarray
    tr: jnp.ndarray
    bl: jnp.ndarray
    # View pyramid: 4 plane equations (nx, ny, nz, d) — left/right/top/bottom
    planes: jnp.ndarray     # (4, 4) f32
    forward: jnp.ndarray    # (4,) f32 forward plane equation

    @staticmethod
    def create(pos, target, aspect: float = 16.0 / 9.0) -> "Camera":
        """Build a camera looking from ``pos`` to ``target``.

        Camera::tick semantics (camera.cpp:3-16): focal distance 2, frustum
        half-extent (aspect, 1).
        """
        pos = jnp.asarray(pos, jnp.float32)
        target = jnp.asarray(target, jnp.float32)
        return Camera(pos, target, *(_basis_and_pyramid(pos, target, aspect)))

    def look_at(self, pos, target, aspect: float = 16.0 / 9.0) -> "Camera":
        return Camera.create(pos, target, aspect)


def _basis_and_pyramid(pos, target, aspect):
    ahead = m3.normalize(target - pos)
    right = m3.normalize(jnp.cross(jnp.asarray(UP), ahead))
    up = m3.normalize(jnp.cross(ahead, right))
    tl = pos + 2.0 * ahead - aspect * right + up
    tr = pos + 2.0 * ahead + aspect * right + up
    bl = pos + 2.0 * ahead - aspect * right - up

    # Pyramid plane equations (pyramid.cpp:5-40); corner dirs relative to pos
    ctl, ctr, cbl = tl - pos, tr - pos, bl - pos
    cbr = ctr - (ctl - cbl)

    def plane(a, b):
        n = m3.normalize(jnp.cross(a, b))
        return jnp.concatenate([n, -jnp.dot(n, pos)[None]])

    planes = jnp.stack([
        plane(cbl, ctl),   # left
        plane(ctr, cbr),   # right
        plane(ctl, ctr),   # top
        plane(cbr, cbl),   # bottom
    ])
    fwd = jnp.concatenate([ahead, -jnp.dot(ahead, pos)[None]])
    return tl, tr, bl, planes, fwd


def primary_rays(cam: Camera, xs, ys, width, height):
    """Primary rays for pixel coordinates (camera.h:32-37 semantics).

    xs, ys: any matching shapes; returns (origins, dirs) with trailing dim 3.
    """
    u = (jnp.asarray(xs, jnp.float32) / width)[..., None]
    v = (jnp.asarray(ys, jnp.float32) / height)[..., None]
    end = cam.tl + u * (cam.tr - cam.tl) + v * (cam.bl - cam.tl)
    d = m3.normalize(end - cam.pos)
    o = jnp.broadcast_to(cam.pos, d.shape)
    return o, d


def rays_for_image(cam: Camera, width: int, height: int, jitter=None):
    """All primary rays for a width x height image, flattened row-major.

    jitter: optional (H, W, 2) sub-pixel offsets in [0, 1).
    Returns (origins (H*W, 3), dirs (H*W, 3)).
    """
    ys, xs = jnp.meshgrid(
        jnp.arange(height, dtype=jnp.float32),
        jnp.arange(width, dtype=jnp.float32),
        indexing="ij",
    )
    if jitter is not None:
        xs = xs + jitter[..., 0]
        ys = ys + jitter[..., 1]
    o, d = primary_rays(cam, xs, ys, width, height)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def pyramid_project(planes, points):
    """Project world points to the pyramid's [0,1]^2 UV (pyramid.cpp:52-66)."""
    p4 = jnp.concatenate([points, jnp.ones_like(points[..., :1])], axis=-1)
    d = m3.mm(p4, planes.T)                    # (..., 4): left,right,top,bottom
    u = d[..., 0] / (d[..., 0] + d[..., 1])
    v = d[..., 2] / (d[..., 2] + d[..., 3])
    return jnp.stack([u, v], axis=-1)


def freecam_update(cam: Camera, move, look, dt: float, boost: bool = False):
    """Headless freecam (camera.cpp:18-54 semantics, no GLFW).

    move: (3,) strafe/up/forward in {-1,0,1}; look: (2,) yaw/pitch deltas.
    Returns (new Camera, forward_depth_delta) — the depth delta feeds the
    temporal reprojection depth compensation (renderer.cpp:318).
    """
    speed = 1.5 * dt * (4.0 if boost else 1.0)
    ahead = m3.normalize(cam.target - cam.pos)
    right = m3.normalize(jnp.cross(jnp.asarray(UP), ahead))
    up = m3.normalize(jnp.cross(ahead, right))

    target = cam.target + 0.025 * dt * (right * look[0] - up * look[1])
    ahead = m3.normalize(target - cam.pos)
    right = m3.normalize(jnp.cross(jnp.asarray(UP), ahead))
    up = m3.normalize(jnp.cross(ahead, right))

    pos = cam.pos + speed * (right * move[0] + up * move[1] + ahead * move[2])
    depth_delta = speed * move[2]
    new = Camera.create(pos, pos + ahead)
    return new, depth_delta
