"""Per-ray two-level DDA as one Pallas kernel on the Triton route.

The XLA form of `ops.dda.intersect_volume_local` is a wavefront: one
`lax.while_loop` over ALL rays that reads and rewrites every ray's whole
state (about 136 B) on each iteration and runs until the slowest ray of
the frame is done.  Here each program owns a block of `BLOCK` rays, keeps
their state in registers, and loops only until its own rays are done.  Its
only memory traffic inside the loop is two byte gathers per ray and step
(brick occupancy, then material), which stay in L2 for grids up to ~40 MB.

The loop is `ops.dda.march`, the same function the wavefront runs, with
the tables read through Pallas refs, so results agree with the wavefront
except where the compiler contracts a multiply-add differently and a
crossing-t tie flips (bounds in `chip_smoke.py`).  128 rays and 4 warps
per program tied for the fastest block shape tried on the H100 (PERF.md).

The route is named (``backend="triton"``) because the default Pallas GPU
route in this JAX is Mosaic GPU.  The kernel carries no gradient;
`ops/diff.py` has its own march.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from voxel_tracer_tpu.ops import dda

BLOCK = 128        # rays per program (a power of two)
NUM_WARPS = 4


def _kernel(*refs, vdims, bdims, max_steps, has_oid, has_medium, has_ignore,
            shadow):
    it = iter(refs)
    o = tuple(next(it)[...] for _ in range(3))
    d = tuple(next(it)[...] for _ in range(3))
    vpu, tmin, tmax, entry_axis, mode0 = (next(it)[...] for _ in range(5))
    oid, medium, ignore, seed = (next(it)[...] if on else None for on in
                                 (has_oid, has_medium, has_ignore, shadow))
    grid_ref, occ_ref = next(it), next(it)
    res = dda.march(o, d, vpu, tmin, tmax, entry_axis, mode0, grid_ref,
                    occ_ref, vdims, bdims, max_steps=max_steps, oid=oid,
                    medium=medium, ignore=ignore, shadow_seed=seed,
                    shadow=shadow)
    for out_ref, value in zip(it, res):
        out_ref[...] = value


@functools.partial(jax.jit, static_argnames=("max_steps", "shadow",
                                             "interpret"))
def trace(grid, brick_occ, origin_l, dir_l, vpu, tmin, tmax, entry_axis,
          mode0, oid=None, medium=None, ignore=None, shadow_seed=None, *,
          max_steps: int, shadow: bool = False, interpret: bool = False):
    """Run the traversal kernel over N rays.

    The slab test and the initial mode come from the caller
    (`ops.dda.intersect_volume_local`), as do the optional per-ray
    ``oid``/``medium``/``ignore``/``shadow_seed`` inputs.  Returns
    (t, mat, axis, steps), each (N,).
    """
    n = origin_l.shape[0]
    n_pad = max(-(-n // BLOCK), 1) * BLOCK
    gz, gy, gx = grid.shape[-3:]
    bz, by, bx = brick_occ.shape[-3:]

    def ray(x, dtype, fill=0):
        x = jnp.broadcast_to(jnp.asarray(x, dtype), (n,))
        return jnp.pad(x, (0, n_pad - n), constant_values=fill)

    # padded rows: unit direction, mode MISS -> never active
    ins = [ray(origin_l[:, k], jnp.float32) for k in range(3)]
    ins += [ray(dir_l[:, k], jnp.float32, 1.0) for k in range(3)]
    ins += [ray(vpu, jnp.float32, 1.0), ray(tmin, jnp.float32),
            ray(tmax, jnp.float32), ray(entry_axis, jnp.int32),
            ray(mode0, jnp.int32, dda._MISS)]
    for opt, dt in ((oid, jnp.int32), (medium, jnp.int32),
                    (ignore, jnp.int32)):
        if opt is not None:
            ins.append(ray(opt, dt))
    if shadow:
        ins.append(ray(shadow_seed, jnp.uint32))
    n_ray_ins = len(ins)
    # material ids are < 256 and only occupancy > 0 matters: one byte each
    ins.append(grid.astype(jnp.uint8).reshape(-1))
    ins.append((brick_occ > 0).astype(jnp.uint8).reshape(-1))

    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    in_specs = [ray_spec] * n_ray_ins + [
        pl.BlockSpec((t.shape[0],), lambda i: (0,)) for t in ins[n_ray_ins:]]
    out_shape = [jax.ShapeDtypeStruct((n_pad,), jnp.float32)] + [
        jax.ShapeDtypeStruct((n_pad,), jnp.int32)] * 3
    kernel = functools.partial(
        _kernel, vdims=(gx, gy, gz), bdims=(bx, by, bz), max_steps=max_steps,
        has_oid=oid is not None, has_medium=medium is not None,
        has_ignore=ignore is not None, shadow=shadow)
    t, mat, axis, steps = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(n_pad // BLOCK,),
        in_specs=in_specs,
        out_specs=[ray_spec] * 4,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="dda_traverse",
    )(*ins)
    return t[:n], mat[:n], axis[:n], steps[:n]
