"""Batched two-level (brickmap) Amanatides-Woo DDA traversal in JAX.

Re-design of the reference single-ray recursive traversal
(src/graphics/primitives/vv.cpp:127-369) as a masked state machine: each
step performs one brick-level or fine-level DDA step per ray with
`jnp.where` selects (no data-dependent control flow, static shapes).  Two
implementations run the same state machine, `march`:

- ``"xla"``: a wavefront — all rays advance in lock-step under one
  `lax.while_loop`, per-ray state a struct of (N,)-shaped arrays.
- ``"triton"``: a Pallas kernel on the Triton route
  (`ops/pallas/dda_gpu.py`) that keeps each ray's state in registers
  (``"interpret"`` runs it in Pallas interpret mode, for tests).

`intersect_volume_local` takes ``impl=None`` as `default_impl()`: the kernel
when JAX's default backend is the GPU and the wavefront otherwise.  Callers
that choose pass ``impl`` down explicitly (`RenderConfig.traversal`).

Semantics match `voxel_tracer_tpu.ops.oracle` exactly (shared step budget
`MAX_STEPS = 256` across both levels, vv.cpp:7; entry-voxel hits keep the
slab entry normal, vv.cpp:159).

Glass infrastructure (the reference Ray's `medium_id` / `ignore_medium`
state, ray.h:40-41, and shadow-ray stochastic absorption, vv.cpp:314-327):

- ``medium``: per-ray material id the ray currently travels inside.  While
  set, the march is an *interior exit* march (vv.cpp:297-310): the first
  voxel whose id differs from the medium is the exit hit (material may be 0
  = air), an empty brick exits at its entry plane (vv.cpp:166-175), and
  leaving the grid exits at the OBB exit distance — the `exit_t` analog of
  obb.cpp:82-106, which here is simply the slab tmax (vv.cpp:206-225).
  Interior rays therefore never miss.
- ``ignore``: material id to pass through until the ray has seen at least
  one air voxel ("scan rays" leaving a glass medium, vv.cpp:328-335).
  Deviation: the reference's `exited` flag is local to one brick traversal
  (reset at every brick), which re-ignores the medium after any brick
  crossing; here it persists for the whole volume traversal (the evident
  intent).  The no-op sentinel is 0 (air), not the reference's 0xFF, which
  collides with the laser material id.
- ``shadow_seed`` (+ static ``shadow=True``): shadow-ray semantics —
  material ids > 16 always occlude, ids <= 16 (glass/mirror rows) occlude
  stochastically with probability 0.15 per encountered voxel
  (vv.cpp:314-327).  The RandomFloat() call is replaced by a counting hash
  of (per-ray seed, voxel cell) so the result is deterministic and
  reproducible across shardings; the oracle implements the same hash.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from voxel_tracer_tpu.ops.math3d import BIG_F32, sign_dir

MAX_STEPS = 256
BRICK = 8

IMPLS = ("xla", "triton", "interpret")


def default_impl() -> str:
    """The traversal kernel on a GPU, the XLA wavefront elsewhere."""
    return "triton" if jax.default_backend() == "gpu" else "xla"


# Ray state machine modes
_MISS = 0      # terminated without a hit
_BRICK = 1     # about to test the brick at bcell
_FINE = 2      # about to test the voxel at fcell inside bcell
_HIT = 3       # terminated with a hit


def slab_test(origin_l, dir_l, size):
    """Batched slab entry test vs the local AABB [0, size].

    Vectorized analog of OBB::intersect (obb.cpp:48-80): tmin clamped >= 0,
    hit iff tmax - 1e-4 >= tmin.  Returns (tmin, tmax, entry_axis, hitmask).
    """
    rcp = 1.0 / dir_l                                   # +-inf where dir == 0
    t1 = (0.0 - origin_l) * rcp
    t2 = (size - origin_l) * rcp
    tn = jnp.minimum(t1, t2)
    tf = jnp.maximum(t1, t2)
    # NaN guard: 0 * inf when the origin sits exactly on a slab plane.
    tn = jnp.where(jnp.isnan(tn), -BIG_F32, tn)
    tf = jnp.where(jnp.isnan(tf), BIG_F32, tf)
    tn = jnp.concatenate([jnp.zeros_like(tn[..., :1]), tn], axis=-1)  # clamp >= 0
    entry_axis = jnp.argmax(tn, axis=-1)                # 0 => clamped at origin
    tmin = jnp.max(tn, axis=-1)
    tmax = jnp.min(tf, axis=-1)
    hit = tmax - 1e-4 >= tmin
    entry_axis = jnp.maximum(entry_axis - 1, 0)         # fold origin-clamp into axis 0
    return tmin, tmax, entry_axis.astype(jnp.int32), hit


def hash_shadow(seed, x, y, z):
    """Counting hash -> uniform [0,1) per (ray seed, voxel cell x, y, z).

    Deterministic stand-in for the reference's global-xorshift RandomFloat()
    in the shadow-ray stochastic absorption (vv.cpp:322, tmpl8math.cpp:40-58).
    lowbias32-style avalanche over the seed xor a spatial key.
    """
    seed = seed.astype(jnp.uint32)
    x, y, z = (c.astype(jnp.uint32) for c in (x, y, z))
    h = seed ^ (x * jnp.uint32(0x9E3779B1)) ^ (y * jnp.uint32(0x85EBCA77)) \
        ^ (z * jnp.uint32(0xC2B2AE3D))
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x7FEB352D)
    h = h ^ (h >> 15)
    h = h * jnp.uint32(0x846CA68B)
    h = h ^ (h >> 16)
    return h.astype(jnp.float32) * jnp.float32(1.0 / 4294967296.0)


def _ladder_axis(tx, ty, tz):
    """Axis the next A&W step takes — the reference tmax comparison ladder
    (vv.cpp:176-219): if (tx < ty) { tx < tz ? x : z } else
    { ty < tz ? y : z }."""
    use_x = (tx < ty) & (tx < tz)
    use_y = (~(tx < ty)) & (ty < tz)
    return jnp.where(use_x, 0, jnp.where(use_y, 1, 2)).astype(jnp.int32)


def _aw_step(cell, tm, step, delta, lim):
    """One Amanatides-Woo step on per-component (x, y, z) arrays.
    Returns (cell, tm, t, axis, oob)."""
    axis = _ladder_axis(*tm)
    sel = [axis == k for k in range(3)]
    pick = lambda v: jnp.where(sel[0], v[0], jnp.where(sel[1], v[1], v[2]))
    t = pick(tm)
    cell = tuple(jnp.where(sel[k], cell[k] + step[k], cell[k])
                 for k in range(3))
    tm = tuple(jnp.where(sel[k], tm[k] + delta[k], tm[k]) for k in range(3))
    moved = pick(cell)
    oob = (moved < 0) | (moved >= pick(lim))
    return cell, tm, t, axis, oob


def _load(table, cell, dims, base):
    """table[base + z*Y*X + y*X + x] of a flat table (an array, or a Pallas
    ref inside the kernel); out-of-range cells read 0."""
    gx, gy, gz = dims
    x, y, z = cell
    inb = (x >= 0) & (x < gx) & (y >= 0) & (y < gy) & (z >= 0) & (z < gz)
    flat = (jnp.clip(z, 0, gz - 1) * (gy * gx) + jnp.clip(y, 0, gy - 1) * gx
            + jnp.clip(x, 0, gx - 1))
    if base is not None:
        flat = flat + base
    return jnp.where(inb, table[flat].astype(jnp.int32), 0)


class DdaState(NamedTuple):
    """Per-ray state; (x, y, z) fields are 3-tuples of per-ray arrays."""

    mode: jnp.ndarray          # int32
    bcell: tuple               # int32 brick cell
    btmax: tuple               # f32 brick-level crossing t's (brick units)
    bt: jnp.ndarray            # f32 brick-level t (brick units)
    fcell: tuple               # int32 fine cell in [0, 8)
    ftmax: tuple               # f32 fine-level crossing t's (voxel units)
    ft: jnp.ndarray            # f32 fine t (voxel units)
    brick_entry_t: jnp.ndarray  # f32 world-units t of current brick entry
    axis: jnp.ndarray          # int32 axis of last DDA step
    steps: jnp.ndarray         # int32 shared step counter
    hit_t: jnp.ndarray         # f32
    hit_mat: jnp.ndarray       # int32
    hit_entry: jnp.ndarray     # bool — hit at entry voxel (steps == 0)
    exited: jnp.ndarray        # bool — scan ray has seen an air voxel


def march(o, d, vpu, tmin, tmax, entry_axis, mode0, grid_tab, occ_tab,
          vdims, bdims, *, max_steps, oid=None, medium=None, ignore=None,
          shadow_seed=None, shadow=False):
    """The traversal state machine, one `lax.while_loop` over a batch of
    rays until every ray is done.

    The XLA wavefront runs it over all rays; the Triton kernel
    (`ops/pallas/dda_gpu.py`) over one block of rays held in registers.

    Args:
      o, d:      3-tuples (x, y, z) of per-ray f32 local origins/directions.
      vpu:       voxels per world unit, scalar or per ray.
      tmin, tmax, entry_axis, mode0: slab test results and initial mode.
      grid_tab:  flat material table (uint8 or int32), read as table[i].
      occ_tab:   flat per-brick table, > 0 = occupied.
      vdims, bdims: static (X, Y, Z) voxel and brick counts of one object.
      oid, medium, ignore, shadow_seed: optional per-ray inputs, as in
                 `intersect_volume_local`.
    Returns (t, mat, axis, steps).
    """
    vbase = bbase = None
    if oid is not None:
        vbase = oid * (vdims[0] * vdims[1] * vdims[2])
        bbase = oid * (bdims[0] * bdims[1] * bdims[2])
    medium_on = None if medium is None else medium > 0

    bpu = vpu / BRICK
    rbpu = 1.0 / bpu
    stepf = [sign_dir(dk) for dk in d]
    stepi = [s.astype(jnp.int32) for s in stepf]
    rdir = [1.0 / dk for dk in d]
    # clamp inf (axis-parallel rays) so tmax += delta never hits 0*inf
    delta = [jnp.minimum(jnp.abs(r), BIG_F32) for r in rdir]
    fine_lim = (BRICK, BRICK, BRICK)

    def cross_t(cell, entry, k):
        tk = ((cell.astype(jnp.float32) - entry) + jnp.maximum(stepf[k], 0.0)) \
            * rdir[k]
        tk = jnp.where(jnp.isnan(tk), BIG_F32, tk)
        return jnp.minimum(tk, BIG_F32)

    bcell, btmax = [], []
    for k in range(3):
        entry = (o[k] + d[k] * tmin) * bpu
        c = jnp.clip(jnp.floor(entry).astype(jnp.int32), 0, bdims[k] - 1)
        bcell.append(c)
        btmax.append(cross_t(c, entry, k))

    zf = jnp.zeros_like(tmin)
    zi = jnp.zeros_like(mode0)
    zb = zi != 0
    state = DdaState(
        mode=mode0, bcell=tuple(bcell), btmax=tuple(btmax), bt=zf,
        fcell=(zi, zi, zi), ftmax=(zf, zf, zf), ft=zf, brick_entry_t=zf,
        axis=entry_axis, steps=zi,
        hit_t=jnp.where(mode0 == _HIT, 0.0, BIG_F32).astype(jnp.float32),
        hit_mat=zi, hit_entry=zb, exited=zb)

    def active(mode):
        return (mode == _BRICK) | (mode == _FINE)

    def cond(carry):
        s, it = carry
        live = (active(s.mode) & (s.steps < max_steps)).astype(jnp.int32)
        # a max, not jnp.any: the Triton route has no lowering for `any`
        return (jnp.max(live, initial=0) > 0) & (it < 2 * max_steps)

    def body(carry):
        s, it = carry
        bc, fc = s.bcell, s.fcell
        in_budget = s.steps < max_steps
        is_brick = (s.mode == _BRICK) & in_budget
        is_fine = (s.mode == _FINE) & in_budget
        # Budget exhausted -> miss (vv.cpp loop bound); interior rays exit
        # at the OBB exit distance instead (vv.cpp:206-225: the post-loop
        # medium branch fires on exhaustion too, axis from the brick tmax).
        exhausted = active(s.mode) & ~in_budget
        mode = jnp.where(exhausted, _MISS, s.mode)
        hit_t, hit_mat, hit_entry = s.hit_t, s.hit_mat, s.hit_entry
        if medium is not None:
            exh_med = exhausted & medium_on
            mode = jnp.where(exh_med, _HIT, mode)
            hit_t = jnp.where(exh_med, tmax, hit_t)
            hit_mat = jnp.where(exh_med, 0, hit_mat)

        # ---- brick phase: test occupancy ----------------------------------
        occ = _load(occ_tab, bc, bdims, bbase) > 0
        enter_fine = is_brick & occ
        brick_step = is_brick & ~occ
        if medium is not None:
            # Empty brick while inside a medium: exit at the brick entry
            # plane (vv.cpp:166-175).
            med_brick_exit = brick_step & medium_on
            brick_step = brick_step & ~medium_on

        # fine setup for rays entering an occupied brick (vv.cpp:237-251)
        brick_entry_t = tmin + s.bt * rbpu
        fc_new, ftm_new = [], []
        for k in range(3):
            bmin = bc[k].astype(jnp.float32) * rbpu
            fentry = (o[k] + d[k] * brick_entry_t - bmin) * vpu
            c = jnp.clip(jnp.floor(fentry).astype(jnp.int32), 0, BRICK - 1)
            fc_new.append(c)
            ftm_new.append(cross_t(c, fentry, k))

        # ---- fine phase: test voxel ---------------------------------------
        vc = [bc[k] * BRICK + fc[k] for k in range(3)]
        voxel = _load(grid_tab, vc, vdims, vbase)
        solid = voxel != 0
        if shadow:
            # Shadow semantics: ids > 16 occlude; glass/mirror rows occlude
            # stochastically with p = 0.15 per voxel (vv.cpp:314-327).
            rnd = hash_shadow(shadow_seed, *vc)
            hit_vox = solid & ((voxel > 16) | (rnd > 0.85))
        elif ignore is not None:
            # Scan-ray pass-through until air is seen (vv.cpp:328-335).
            hit_vox = solid & (s.exited | (voxel != ignore))
        else:
            hit_vox = solid
        if medium is not None:
            # Interior exit: first voxel that differs from the medium,
            # material may be air (vv.cpp:297-310).
            hit_vox = jnp.where(medium_on, voxel != medium, hit_vox)
        fine_hit = is_fine & hit_vox

        # fine step for non-hit fine rays; leaving the brick turns into a
        # brick step in the same iteration
        nfc, nftm, nft, nfaxis, f_oob = _aw_step(fc, s.ftmax, stepi, delta,
                                                 fine_lim)
        fine_step = is_fine & ~fine_hit
        fine_exit = fine_step & f_oob
        fine_move = fine_step & ~fine_exit

        # brick step for empty-brick rays and fine-exit rays (shared unit)
        do_bstep = brick_step | fine_exit
        nbc, nbtm, nbt, nbaxis, b_oob = _aw_step(bc, s.btmax, stepi, delta,
                                                 bdims)

        # ---- merge ---------------------------------------------------------
        mode = jnp.where(fine_hit, _HIT, mode)
        mode = jnp.where(do_bstep & b_oob, _MISS, mode)
        mode = jnp.where(enter_fine, _FINE, mode)
        mode = jnp.where(fine_exit & ~b_oob, _BRICK, mode)
        if medium is not None:
            # Interior grid exit: exit at the OBB exit distance = slab tmax
            # (vv.cpp:206-225, the exit_t analog of obb.cpp:82-106), normal
            # along the attempted step axis (nbaxis, merged below).
            med_grid_exit = do_bstep & b_oob & medium_on
            mode = jnp.where(med_brick_exit | med_grid_exit, _HIT, mode)

        sel3 = lambda c, a, b: tuple(jnp.where(c, a[k], b[k])
                                     for k in range(3))
        axis = jnp.where(do_bstep, nbaxis,
                         jnp.where(fine_move, nfaxis, s.axis))
        hit_t = jnp.where(fine_hit, s.brick_entry_t + s.ft / vpu, hit_t)
        hit_mat = jnp.where(fine_hit, voxel, hit_mat)
        hit_entry = jnp.where(fine_hit, s.steps == 0, hit_entry)
        exited = s.exited
        if ignore is not None:
            saw_air = (is_fine & ~solid) | brick_step
            exited = exited | (saw_air & (ignore > 0))
        if medium is not None:
            hit_t = jnp.where(med_brick_exit, brick_entry_t, hit_t)
            hit_t = jnp.where(med_grid_exit, tmax, hit_t)
            hit_mat = jnp.where(med_brick_exit | med_grid_exit, 0, hit_mat)
            hit_entry = jnp.where(med_brick_exit, s.steps == 0, hit_entry)
            axis = jnp.where(exh_med, _ladder_axis(*s.btmax), axis)

        new = DdaState(
            mode=mode,
            bcell=sel3(do_bstep, nbc, bc),
            btmax=sel3(do_bstep, nbtm, s.btmax),
            bt=jnp.where(do_bstep, nbt, s.bt),
            fcell=sel3(enter_fine, fc_new, sel3(fine_move, nfc, fc)),
            ftmax=sel3(enter_fine, ftm_new, sel3(fine_move, nftm, s.ftmax)),
            ft=jnp.where(enter_fine, 0.0, jnp.where(fine_move, nft, s.ft)),
            brick_entry_t=jnp.where(enter_fine, brick_entry_t,
                                    s.brick_entry_t),
            axis=axis,
            steps=s.steps + (do_bstep | fine_move).astype(jnp.int32),
            hit_t=hit_t, hit_mat=hit_mat, hit_entry=hit_entry, exited=exited)
        return new, it + 1

    s, _ = jax.lax.while_loop(cond, body, (state, jnp.int32(0)))

    # The loop stops once no ray is active within budget, so rays that ran
    # out of budget on the last iteration may still be marked active:
    # resolve them here (a miss, or the medium exit at the slab tmax), which
    # makes each ray's result independent of the other rays in the batch.
    mode, hit_t, hit_mat, axis = s.mode, s.hit_t, s.hit_mat, s.axis
    if medium is not None:
        exh_med = active(mode) & (s.steps >= max_steps) & medium_on
        mode = jnp.where(exh_med, _HIT, mode)
        hit_t = jnp.where(exh_med, tmax, hit_t)
        hit_mat = jnp.where(exh_med, 0, hit_mat)
        axis = jnp.where(exh_med, _ladder_axis(*s.btmax), axis)

    hit = mode == _HIT
    # Entry-voxel hits keep the slab entry axis/normal (vv.cpp:159)
    return (jnp.where(hit, hit_t, BIG_F32), jnp.where(hit, hit_mat, 0),
            jnp.where(s.hit_entry, entry_axis, axis), s.steps)


def intersect_volume_local(grid, brick_occ, origin_l, dir_l, vpu,
                           oid=None, max_steps: int = MAX_STEPS,
                           medium=None, ignore=None, shadow_seed=None,
                           shadow: bool = False, impl: str | None = None):
    """Two-level DDA of N local-space rays through one voxel volume.

    Args:
      grid:      (Z, Y, X) int32 material ids, 0 = air — or (O, Z, Y, X)
                 stacked multi-object grids with per-ray indices ``oid``.
      brick_occ: (BZ, BY, BX) or (O, BZ, BY, BX) int32 per-brick solid count.
      origin_l:  (N, 3) f32 ray origins in volume-local space.
      dir_l:     (N, 3) f32 unit ray directions in local space.
      vpu:       voxels per world unit — scalar or per-ray (N,).
      oid:       optional (N,) int32 object index per ray.
      medium:    optional (N,) int32 medium id; nonzero = interior exit march
                 (Ray::medium_id, vv.cpp:166-175,206-232,297-310).
      ignore:    optional (N,) int32 material to pass until air is seen
                 (Ray::ignore_medium scan semantics, vv.cpp:328-335; 0 = off).
      shadow_seed: (N,) uint32 per-ray seeds; with ``shadow=True`` enables
                 the stochastic <=16 pass-through (vv.cpp:314-327).
      impl:      one of `IMPLS`; None = `default_impl()`.

    Returns dict of (N,) arrays: t (BIG_F32 = miss), mat, axis (last step
    axis), step_sign (N,3), steps, valid (slab hit mask).
    """
    impl = default_impl() if impl is None else impl
    assert impl in IMPLS, impl
    return _intersect(grid, brick_occ, origin_l, dir_l, vpu, oid, medium,
                      ignore, shadow_seed, max_steps=max_steps, shadow=shadow,
                      impl=impl)


@functools.partial(jax.jit, static_argnames=("max_steps", "shadow", "impl"))
def _intersect(grid, brick_occ, origin_l, dir_l, vpu, oid, medium, ignore,
               shadow_seed, *, max_steps, shadow, impl):
    gz, gy, gx = grid.shape[-3:]
    bz, by, bx = brick_occ.shape[-3:]
    vpu = jnp.asarray(vpu, jnp.float32)
    vpu_c = vpu[..., None] if vpu.ndim == 1 else vpu  # broadcasts over (N, 3)
    size_l = jnp.array([gx, gy, gz], jnp.float32) / vpu_c
    tmin, tmax, entry_axis, slab_hit = slab_test(origin_l, dir_l, size_l)
    mode0 = jnp.where(slab_hit, _BRICK, _MISS).astype(jnp.int32)
    if medium is not None:
        # Slab miss while inside a medium: exit immediately at t = 0 with
        # material air (vv.cpp:228-232).
        mode0 = jnp.where(~slab_hit & (medium > 0), _HIT, mode0)

    if impl == "xla":
        t, mat, axis, steps = march(
            tuple(origin_l[:, k] for k in range(3)),
            tuple(dir_l[:, k] for k in range(3)), vpu, tmin, tmax,
            entry_axis, mode0, grid.reshape(-1), brick_occ.reshape(-1),
            (gx, gy, gz), (bx, by, bz), max_steps=max_steps, oid=oid,
            medium=medium, ignore=ignore, shadow_seed=shadow_seed,
            shadow=shadow)
    else:
        from voxel_tracer_tpu.ops.pallas import dda_gpu
        t, mat, axis, steps = dda_gpu.trace(
            grid, brick_occ, origin_l, dir_l, vpu, tmin, tmax, entry_axis,
            mode0, oid, medium, ignore, shadow_seed, max_steps=max_steps,
            shadow=shadow, interpret=impl == "interpret")
    return dict(
        t=t,
        mat=mat,
        axis=axis,
        step_sign=sign_dir(dir_l),
        steps=steps,
        valid=slab_hit,
        slab_tmin=tmin,
        slab_tmax=tmax,
    )


def normal_from_axis(axis, step_sign, rot3):
    """World-space hit normal from the last DDA step axis (vv.cpp:161-163).

    The local normal is -sign * e_axis, so the world normal is just the
    (negated, sign-flipped) `axis` column of the rotation — selected exactly
    instead of via matmul (keeps full f32 precision where f32 matmuls may
    run at reduced precision, e.g. TF32).
    """
    sign_k = jnp.take_along_axis(step_sign, axis[..., None], axis=-1)[..., 0]
    if rot3.ndim == 2:
        cols = jnp.take(rot3.T, axis, axis=0)             # (N, 3)
    else:
        cols = jnp.take_along_axis(
            jnp.swapaxes(rot3, -1, -2), axis[..., None, None], axis=-2
        )[..., 0, :]
    n_w = -sign_k[..., None] * cols
    n_len = jnp.sqrt(jnp.sum(n_w * n_w, axis=-1, keepdims=True))
    return n_w / jnp.maximum(n_len, 1e-20)
