"""Analytic traceable primitives: spheres and capsules.

Batched analogs of the reference's non-voxel traceables
(src/graphics/primitives/basic/sphere.{h,cpp}, .../capsule.{h,cpp}):
batched quadratic-solve intersectors over stacked primitive arrays,
min-combined with the voxel-volume hits in ops/composite.py.  The
reference uses capsules for the 8 laser-beam segments (material 0xFF,
albedo (50, 0, 0) — the emissive "laser hack", capsule.cpp:56-70,
materials.cpp:30) and spheres for testing (normal-as-color albedo hack,
sphere.cpp:30-31).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from voxel_tracer_tpu.ops.math3d import BIG_F32, mm

LASER_MAT = 0xFF                       # materials.cpp:30
LASER_ALBEDO = (50.0, 0.0, 0.0)        # capsule.cpp:68 (emissive red)


class PrimsData(NamedTuple):
    """Stacked analytic primitives (device pytree; zero-length = none)."""

    sph_origin: jnp.ndarray   # (S, 3)
    sph_radius: jnp.ndarray   # (S,)
    sph_mat: jnp.ndarray      # (S,) int32
    sph_albedo: jnp.ndarray   # (S, 3); NaN row = normal-as-color hack
    cap_a: jnp.ndarray        # (C, 3)
    cap_b: jnp.ndarray        # (C, 3)
    cap_radius: jnp.ndarray   # (C,)
    cap_mat: jnp.ndarray      # (C,) int32
    cap_albedo: jnp.ndarray   # (C, 3)

    @staticmethod
    def empty() -> "PrimsData":
        z3 = jnp.zeros((0, 3), jnp.float32)
        z1 = jnp.zeros((0,), jnp.float32)
        zi = jnp.zeros((0,), jnp.int32)
        return PrimsData(z3, z1, zi, z3, z3, z3, z1, zi, z3)

    @property
    def count(self):
        return self.sph_origin.shape[0] + self.cap_a.shape[0]


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def intersect_spheres(prims: PrimsData, origins, dirs):
    """Nearest sphere hit per ray (Sphere::intersect, sphere.cpp:7-34).

    Returns (t, mat, normal, albedo) with t = BIG_F32 on miss."""
    n = origins.shape[0]
    t_best = jnp.full((n,), BIG_F32, jnp.float32)
    mat = jnp.zeros((n,), jnp.int32)
    normal = jnp.zeros((n, 3), jnp.float32)
    albedo = jnp.zeros((n, 3), jnp.float32)
    for i in range(prims.sph_origin.shape[0]):
        oc = origins - prims.sph_origin[i]
        b = _dot(oc, dirs)
        c = _dot(oc, oc) - prims.sph_radius[i] ** 2
        h = b * b - c
        sq = jnp.sqrt(jnp.maximum(h, 0.0))
        t = -b - sq
        t = jnp.where((h >= 0.0) & (t > 1e-5), t, BIG_F32)
        better = t < t_best
        p = origins + dirs * t[:, None]
        nrm = (p - prims.sph_origin[i]) / prims.sph_radius[i]
        # normal-as-color albedo hack (sphere.cpp:30-31) when albedo is NaN
        alb_i = jnp.where(jnp.isnan(prims.sph_albedo[i, 0]),
                          nrm * 0.5 + 0.5, prims.sph_albedo[i])
        t_best = jnp.where(better, t, t_best)
        mat = jnp.where(better, prims.sph_mat[i], mat)
        normal = jnp.where(better[:, None], nrm, normal)
        albedo = jnp.where(better[:, None], alb_i, albedo)
    return t_best, mat, normal, albedo


def intersect_capsules(prims: PrimsData, origins, dirs):
    """Nearest capsule hit per ray (cap_intersect, capsule.cpp:13-47,
    Inigo Quilez's analytic capsule; normal per capsule.cpp:49-54)."""
    n = origins.shape[0]
    t_best = jnp.full((n,), BIG_F32, jnp.float32)
    mat = jnp.zeros((n,), jnp.int32)
    normal = jnp.zeros((n, 3), jnp.float32)
    albedo = jnp.zeros((n, 3), jnp.float32)
    for i in range(prims.cap_a.shape[0]):
        pa, pb = prims.cap_a[i], prims.cap_b[i]
        r = prims.cap_radius[i]
        ba = pb - pa
        oa = origins - pa
        baba = jnp.sum(ba * ba)
        bard = mm(dirs, ba)
        baoa = mm(oa, ba)
        rdoa = _dot(dirs, oa)
        oaoa = _dot(oa, oa)
        a = baba - bard * bard
        b = baba * rdoa - baoa * bard
        c = baba * oaoa - baoa * baoa - r * r * baba
        h = b * b - a * c
        sq = jnp.sqrt(jnp.maximum(h, 0.0))
        t_body = (-b - sq) / jnp.where(jnp.abs(a) < 1e-20, 1e-20, a)
        y = baoa + t_body * bard
        body_ok = (h >= 0.0) & (y > 0.0) & (y < baba) & (t_body > 1e-5)
        # caps
        oc = jnp.where((y <= 0.0)[:, None], oa, origins - pb)
        b2 = _dot(dirs, oc)
        c2 = _dot(oc, oc) - r * r
        h2 = b2 * b2 - c2
        t_cap = -b2 - jnp.sqrt(jnp.maximum(h2, 0.0))
        cap_ok = (h2 > 0.0) & (t_cap > 1e-5)
        t = jnp.where(body_ok, t_body,
                      jnp.where(cap_ok, t_cap, BIG_F32))
        better = t < t_best
        p = origins + dirs * t[:, None]
        h01 = jnp.clip(mm(p - pa, ba) / baba, 0.0, 1.0)
        nrm = (p - pa - h01[:, None] * ba) / r
        t_best = jnp.where(better, t, t_best)
        mat = jnp.where(better, prims.cap_mat[i], mat)
        normal = jnp.where(better[:, None], nrm, normal)
        albedo = jnp.where(better[:, None], prims.cap_albedo[i], albedo)
    return t_best, mat, normal, albedo


def intersect_prims(prims: PrimsData, origins, dirs):
    """Nearest analytic-primitive hit (None if the scene has none)."""
    if prims.sph_origin.shape[0] == 0 and prims.cap_a.shape[0] == 0:
        return None
    t1, m1, n1, a1 = intersect_spheres(prims, origins, dirs)
    t2, m2, n2, a2 = intersect_capsules(prims, origins, dirs)
    take2 = t2 < t1
    return (jnp.where(take2, t2, t1),
            jnp.where(take2, m2, m1),
            jnp.where(take2[:, None], n2, n1),
            jnp.where(take2[:, None], a2, a1))


def build_prims(spheres=(), capsules=()) -> PrimsData:
    """Host-side packing.

    spheres: iterable of (origin, radius, mat, albedo-or-None);
    capsules: iterable of (a, b, radius, mat, albedo)."""
    if not spheres and not capsules:
        return PrimsData.empty()

    def stack3(xs):
        return (jnp.asarray(np.stack(xs).astype(np.float32))
                if xs else jnp.zeros((0, 3), jnp.float32))

    so, sr, sm, sa = [], [], [], []
    for (o, r, m, alb) in spheres:
        so.append(np.asarray(o, np.float32))
        sr.append(float(r))
        sm.append(int(m))
        sa.append(np.full(3, np.nan, np.float32) if alb is None
                  else np.asarray(alb, np.float32))
    ca, cb, cr, cm, calb = [], [], [], [], []
    for (a, b, r, m, alb) in capsules:
        ca.append(np.asarray(a, np.float32))
        cb.append(np.asarray(b, np.float32))
        cr.append(float(r))
        cm.append(int(m))
        calb.append(np.asarray(alb, np.float32))
    return PrimsData(
        sph_origin=stack3(so),
        sph_radius=jnp.asarray(np.array(sr, np.float32)),
        sph_mat=jnp.asarray(np.array(sm, np.int32)),
        sph_albedo=stack3(sa),
        cap_a=stack3(ca),
        cap_b=stack3(cb),
        cap_radius=jnp.asarray(np.array(cr, np.float32)),
        cap_mat=jnp.asarray(np.array(cm, np.int32)),
        cap_albedo=stack3(calb),
    )
