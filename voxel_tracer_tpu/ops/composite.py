"""Scene composition: nearest-hit across many voxel objects.

Batched replacement for the reference's per-frame BVH rebuild + ordered
stack traversal (src/graphics/bvh.cpp:187-269): a vectorized slab-test
prepass over all objects selects the K nearest candidate boxes per ray
(a per-ray "BVH front"), then K masked DDA passes trace only those
candidates through the stacked grids.  The prepass runs as a `lax.scan`
over objects so memory stays O(N * K) regardless of object count (the
512-volume profiling scene, src/dev/profile.h:23-36, works unchanged).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from voxel_tracer_tpu.models.scene import SceneData
from voxel_tracer_tpu.models.volume import VolumeData
from voxel_tracer_tpu.ops import dda
from voxel_tracer_tpu.ops.math3d import BIG_F32


class HitResult(NamedTuple):
    """Wavefront hit record (HitInfo analog, src/graphics/rays/hit.h:4-13)."""

    t: jnp.ndarray        # (N,) f32; BIG_F32 = miss
    mat: jnp.ndarray      # (N,) int32 material id (0 = none)
    normal: jnp.ndarray   # (N, 3) f32 world-space normal
    albedo: jnp.ndarray   # (N, 3) f32 palette albedo
    steps: jnp.ndarray    # (N,) int32 traversal cost (debug/profiling)
    obj: jnp.ndarray      # (N,) int32 global object index (-1 miss, -2 prim)

    @staticmethod
    def miss(n):
        return HitResult(
            t=jnp.full((n,), BIG_F32, jnp.float32),
            mat=jnp.zeros((n,), jnp.int32),
            normal=jnp.zeros((n, 3), jnp.float32),
            albedo=jnp.zeros((n, 3), jnp.float32),
            steps=jnp.zeros((n,), jnp.int32),
            obj=jnp.full((n,), -1, jnp.int32),
        )

    def nearer(self, other: "HitResult") -> "HitResult":
        take = other.t < self.t
        return HitResult(
            t=jnp.where(take, other.t, self.t),
            mat=jnp.where(take, other.mat, self.mat),
            normal=jnp.where(take[:, None], other.normal, self.normal),
            albedo=jnp.where(take[:, None], other.albedo, self.albedo),
            steps=self.steps + other.steps,
            obj=jnp.where(take, other.obj, self.obj),
        )


def _mat3_t_apply(rot, v):
    """R^T @ v via elementwise ops — full f32 on every backend (a (3,3)
    matmul may run at reduced precision, e.g. TF32 on a GPU, and add
    ~1e-3 depth noise)."""
    return jnp.stack([
        rot[..., 0, 0] * v[..., 0] + rot[..., 1, 0] * v[..., 1] + rot[..., 2, 0] * v[..., 2],
        rot[..., 0, 1] * v[..., 0] + rot[..., 1, 1] * v[..., 1] + rot[..., 2, 1] * v[..., 2],
        rot[..., 0, 2] * v[..., 0] + rot[..., 1, 2] * v[..., 1] + rot[..., 2, 2] * v[..., 2],
    ], axis=-1)


def _to_local(rot, pos, pivot, origins, dirs):
    """World -> volume-local rays (OBB::world_to_local, obb.cpp:128-134)."""
    o_l = _mat3_t_apply(rot, origins - pos) + pivot
    d_l = _mat3_t_apply(rot, dirs)
    return o_l, d_l


def _trace_one(group: VolumeData, oid_static: int, origins, dirs, max_steps,
               obj_base: int = 0, **dda_kw):
    """Trace all rays against one object of a group (no candidate select)."""
    rot = group.rot[oid_static]
    o_l, d_l = _to_local(rot, group.pos[oid_static], group.pivot[oid_static],
                         origins, dirs)
    res = dda.intersect_volume_local(
        group.grid[oid_static], group.brick_occ[oid_static], o_l, d_l,
        group.vpu[oid_static], max_steps=max_steps, **dda_kw)
    hit = res["t"] < BIG_F32
    normal = dda.normal_from_axis(res["axis"], res["step_sign"], rot)
    albedo = jnp.take(group.palette[oid_static], res["mat"], axis=0, mode="clip")
    return HitResult(
        t=res["t"],
        mat=jnp.where(hit, res["mat"], 0),
        normal=jnp.where(hit[:, None], normal, 0.0),
        albedo=jnp.where(hit[:, None], albedo, 0.0),
        steps=res["steps"],
        obj=jnp.where(hit, obj_base + oid_static, -1),
    )


def _slab_prepass_topk(group: VolumeData, origins, dirs, k: int):
    """Per-ray K nearest candidate objects by slab entry t (lax.scan)."""
    n = origins.shape[0]
    gz, gy, gx = group.grid.shape[-3:]
    vsize = jnp.array([gx, gy, gz], jnp.float32)

    def scan_body(carry, vol):
        tk, idk = carry
        rot, pos, pivot, vpu, oid = vol
        o_l, d_l = _to_local(rot, pos, pivot, origins, dirs)
        tmin, tmax, _, ok = dda.slab_test(o_l, d_l, vsize / vpu)
        t = jnp.where(ok, tmin, BIG_F32)
        o = jnp.full((n,), oid, jnp.int32)
        # bubble-insert into the sorted K-list (K is tiny)
        for j in range(k):
            cur_t, cur_i = tk[:, j], idk[:, j]
            take = t < cur_t
            tk = tk.at[:, j].set(jnp.where(take, t, cur_t))
            idk = idk.at[:, j].set(jnp.where(take, o, cur_i))
            t = jnp.where(take, cur_t, t)
            o = jnp.where(take, cur_i, o)
        return (tk, idk), None

    o_count = group.grid.shape[0]
    init = (jnp.full((n, k), BIG_F32, jnp.float32),
            jnp.zeros((n, k), jnp.int32))
    vols = (group.rot, group.pos, group.pivot, group.vpu,
            jnp.arange(o_count, dtype=jnp.int32))
    (tk, idk), _ = jax.lax.scan(scan_body, init, vols)
    return tk, idk


def intersect_group(group: VolumeData, origins, dirs, max_candidates: int = 4,
                    max_steps: int = dda.MAX_STEPS, obj_base: int = 0,
                    **dda_kw) -> HitResult:
    """Nearest hit against one shape-homogeneous group of volumes."""
    n = origins.shape[0]
    o_count = group.grid.shape[0]
    if o_count == 1:
        return _trace_one(group, 0, origins, dirs, max_steps, obj_base,
                          **dda_kw)

    k = min(max_candidates, o_count)
    cand_t, cand_id = _slab_prepass_topk(group, origins, dirs, k)

    best = HitResult.miss(n)
    for slot in range(k):
        oid = cand_id[:, slot]
        live = cand_t[:, slot] < BIG_F32
        # Early-out: a candidate can't beat an existing nearer hit
        live = live & (cand_t[:, slot] < best.t)
        rot = jnp.take(group.rot, oid, axis=0)
        pos = jnp.take(group.pos, oid, axis=0)
        pivot = jnp.take(group.pivot, oid, axis=0)
        vpu = jnp.take(group.vpu, oid, axis=0)
        o_l, d_l = _to_local(rot, pos, pivot, origins, dirs)
        res = dda.intersect_volume_local(
            group.grid, group.brick_occ, o_l, d_l, vpu, oid=oid,
            max_steps=max_steps, **dda_kw)
        hit = live & (res["t"] < BIG_F32)
        normal = dda.normal_from_axis(res["axis"], res["step_sign"], rot)
        pal_flat = group.palette.reshape(-1, 3)
        albedo = jnp.take(pal_flat, oid * 256 + jnp.clip(res["mat"], 0, 255),
                          axis=0)
        cand = HitResult(
            t=jnp.where(hit, res["t"], BIG_F32),
            mat=jnp.where(hit, res["mat"], 0),
            normal=jnp.where(hit[:, None], normal, 0.0),
            albedo=jnp.where(hit[:, None], albedo, 0.0),
            steps=jnp.where(live, res["steps"], 0),
            obj=jnp.where(hit, obj_base + oid, -1),
        )
        best = best.nearer(cand)
    return best


def intersect_scene(scene: SceneData, origins, dirs, max_candidates: int = 4,
                    max_steps: int = dda.MAX_STEPS,
                    ignore=None, shadow_seed=None,
                    shadow: bool = False, impl: str | None = None
                    ) -> HitResult:
    """Nearest hit across all volume groups and analytic primitives
    (Scene::intersect analog, scene.cpp:49-54 — sky fallback is applied
    by the shader).

    ``ignore`` (per-ray material id, 0 = off) threads the scan-ray
    pass-through and ``shadow_seed``/``shadow`` the stochastic shadow
    semantics down to every volume traversal (ray.h:40-42 flags).
    ``impl`` picks the traversal (`dda.IMPLS`; None = `dda.default_impl`)."""
    from voxel_tracer_tpu.ops.prims import intersect_prims

    dda_kw = {"impl": impl}
    if ignore is not None:
        dda_kw["ignore"] = ignore
    if shadow:
        dda_kw["shadow"] = True
        dda_kw["shadow_seed"] = shadow_seed

    best = HitResult.miss(origins.shape[0])
    obj_base = 0
    for group in scene.groups:
        best = best.nearer(
            intersect_group(group, origins, dirs, max_candidates, max_steps,
                            obj_base, **dda_kw))
        obj_base += group.grid.shape[0]
    prim = intersect_prims(scene.prims, origins, dirs)
    if prim is not None:
        t, mat, normal, albedo = prim
        best = best.nearer(HitResult(
            t=t, mat=mat, normal=normal, albedo=albedo,
            steps=jnp.zeros_like(mat),
            obj=jnp.where(t < BIG_F32, -2, -1)))
    return best


def march_interior(scene: SceneData, obj, origins, dirs, medium,
                   max_steps: int = dda.MAX_STEPS,
                   impl: str | None = None) -> HitResult:
    """Interior exit march for rays inside a medium (glass).

    Traces each ray ONLY against the object it refracted into (per-ray
    global index ``obj`` from a previous HitResult) with `medium` semantics
    — the analog of the reference marching an interior ray through
    `scene.intersect` (materials.cpp:133-135 -> vv.cpp:166-232).  Deviation:
    the reference sends interior rays through the whole scene, where any
    OTHER volume immediately reports a depth-0 air exit (vv.cpp:228-232),
    corrupting multi-object glass; scoping the march to the entered object
    is the evident intent.  Interior rays never miss: they exit at the
    first non-medium voxel, an empty brick, or the OBB exit plane.
    """
    n = origins.shape[0]
    out = HitResult.miss(n)
    obj_base = 0
    for group in scene.groups:
        o_count = group.grid.shape[0]
        oid = jnp.clip(obj - obj_base, 0, o_count - 1)
        in_group = (obj >= obj_base) & (obj < obj_base + o_count)
        rot = jnp.take(group.rot, oid, axis=0)
        pos = jnp.take(group.pos, oid, axis=0)
        pivot = jnp.take(group.pivot, oid, axis=0)
        vpu = jnp.take(group.vpu, oid, axis=0)
        o_l, d_l = _to_local(rot, pos, pivot, origins, dirs)
        res = dda.intersect_volume_local(
            group.grid, group.brick_occ, o_l, d_l, vpu,
            oid=oid if o_count > 1 else None,
            max_steps=max_steps, medium=medium, impl=impl)
        normal = dda.normal_from_axis(res["axis"], res["step_sign"], rot)
        pal_flat = group.palette.reshape(-1, 3)
        albedo = jnp.take(pal_flat, oid * 256 + jnp.clip(res["mat"], 0, 255),
                          axis=0)
        sel = in_group
        out = HitResult(
            t=jnp.where(sel, res["t"], out.t),
            mat=jnp.where(sel, res["mat"], out.mat),
            normal=jnp.where(sel[:, None], normal, out.normal),
            albedo=jnp.where(sel[:, None], albedo, out.albedo),
            steps=jnp.where(sel, res["steps"], out.steps),
            obj=jnp.where(sel, obj, out.obj),
        )
        obj_base += o_count
    return out


def is_occluded(scene: SceneData, origins, dirs, tmax,
                max_candidates: int = 4,
                max_steps: int = dda.MAX_STEPS,
                shadow_seed=None, impl: str | None = None) -> jnp.ndarray:
    """Shadow-ray test (Scene::is_occluded analog, scene.cpp:66-71).

    With ``shadow_seed`` (per-ray uint32), volume traversals use shadow-ray
    semantics: ids > 16 occlude, glass/mirror rows occlude stochastically
    with p = 0.15 per voxel (vv.cpp:314-327).  Without a seed the test is
    deterministic (every solid voxel occludes) — used by the lambert
    benchmark pipeline.
    """
    hit = intersect_scene(scene, origins, dirs, max_candidates, max_steps,
                          shadow_seed=shadow_seed,
                          shadow=shadow_seed is not None, impl=impl)
    return hit.t < tmax, hit
