"""Sharded trace and train steps (`shard_map` over the ray axis).

Forward tracing is embarrassingly parallel over rays: each device traces its
ray shard against a replicated scene — zero collectives in the hot loop.
The traversal runs inside `shard_map`, so the Triton kernel (a custom call
the SPMD partitioner cannot split) only ever sees its local shard.
Training all-reduces voxel-parameter gradients with `psum` over the mesh
(NVLink between GPUs), the analog of the reference's missing gradient path (SURVEY.md §2.4).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
import warnings

with warnings.catch_warnings():
    # jax.shard_map (new API) renames check_rep; keep the stable legacy
    # entry point until the new one is the only option
    warnings.simplefilter("ignore", DeprecationWarning)
    from jax.experimental.shard_map import shard_map

from voxel_tracer_tpu.parallel.mesh import RAYS
from voxel_tracer_tpu.ops import composite, diff
from voxel_tracer_tpu.renderer import RenderConfig


def shard_rays(mesh: Mesh, origins, dirs):
    """Place ray arrays with the rays axis sharded over the mesh."""
    from jax.sharding import NamedSharding

    sh = NamedSharding(mesh, P(RAYS))
    return jax.device_put(origins, sh), jax.device_put(dirs, sh)


def make_sharded_trace(mesh: Mesh, config: RenderConfig):
    """shard_map'd scene intersection: rays sharded, scene replicated."""

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(RAYS), P(RAYS)),
        out_specs=composite.HitResult(
            t=P(RAYS), mat=P(RAYS), normal=P(RAYS), albedo=P(RAYS),
            steps=P(RAYS), obj=P(RAYS)),
        check_rep=False,
    )
    def trace_shard(scene, o, d):
        return composite.intersect_scene(
            scene, o, d, config.max_candidates, config.max_steps,
            impl=config.traversal)

    return jax.jit(trace_shard)


def _grad_pmean(axis):
    """Identity whose BACKWARD is a pmean over ``axis``: attaching it to
    a parameter slice places that slice's gradient all-reduce at the
    exact point in the backward pass where the slice's VJP completes —
    the overlap primitive for psum-during-backward."""

    @jax.custom_vjp
    def f(x):
        return x

    def fwd(x):
        return x, None

    def bwd(_, ct):
        return (jax.lax.pmean(ct, axis),)

    f.defvjp(fwd, bwd)
    return f


def make_train_step(mesh: Mesh, optimizer, vpu: float, max_steps: int = 192,
                    background=None, sync_grads: bool = True,
                    overlap_slabs: int = 1, slab_max_steps: int | None = None):
    """Sharded inverse-rendering train step (BASELINE config 5).

    params = {"sigma": (Z,Y,X), "albedo": (Z,Y,X,3)} — replicated.
    Rays + target pixels sharded over the mesh; grads all-reduced over the mesh.
    Returns step(params, opt_state, o_l, d_l, target) -> (params, opt_state, loss).

    sync_grads=False skips the gradient/loss pmean: training would
    diverge per-shard, but the step does identical local compute — the
    scaling harness times both to isolate pure collective overhead.

    overlap_slabs=S > 1 overlaps the gradient all-reduce with the
    backward march (SURVEY §2.4 "psum overlapped with backward"): the
    loss decomposes into S independent z-slab renders composed affinely
    (grid_train.compose_slabs — exact, see test_grid_train), and each
    slab's grad pmean is attached via `_grad_pmean` so it issues as soon
    as that slab's backward replay finishes, hiding under the remaining
    slabs' VJPs.  Same math, same total collective volume — S smaller
    reduces instead of one big one at the end.
    """
    bg = background if background is not None else jnp.zeros((3,), jnp.float32)
    sync1 = _grad_pmean(RAYS)

    if overlap_slabs == 1:
        def local_loss(params, o_l, d_l, target):
            out = diff.render_density(params["sigma"], params["albedo"],
                                      o_l, d_l, vpu, max_steps)
            color = out["color"] + out["trans"][:, None] * bg
            return jnp.mean((color - target) ** 2)
    else:
        from voxel_tracer_tpu.parallel.grid_train import compose_slabs
        S = overlap_slabs
        slab_steps = slab_max_steps if slab_max_steps is not None \
            else max_steps

        def local_loss(params, o_l, d_l, target):
            sigma, albedo = params["sigma"], params["albedo"]
            zs = sigma.shape[0] // S
            assert zs * S == sigma.shape[0], \
                f"Z={sigma.shape[0]} not divisible by overlap_slabs={S}"
            Ts, Cs, Ds = [], [], []
            for s in range(S):
                sig = sigma[s * zs:(s + 1) * zs]
                alb = albedo[s * zs:(s + 1) * zs]
                if sync_grads:
                    sig, alb = sync1(sig), sync1(alb)
                o_s = o_l - jnp.array([0.0, 0.0, 1.0], jnp.float32) \
                    * (s * zs / vpu)
                out = diff.render_density(sig, alb, o_s, d_l, vpu,
                                          slab_steps)
                Ts.append(out["trans"])
                Cs.append(out["color"])
                Ds.append(out["depth"])
            color, trans, _ = compose_slabs(
                jnp.stack(Ts), jnp.stack(Cs), jnp.stack(Ds), d_l[:, 2])
            color = color + trans[:, None] * bg
            return jnp.mean((color - target) ** 2)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(RAYS), P(RAYS), P(RAYS)),
        out_specs=(P(), P(), P()),
        check_rep=False,
    )
    def step(params, opt_state, o_l, d_l, target):
        loss, grads = jax.value_and_grad(local_loss)(params, o_l, d_l, target)
        if sync_grads:
            if overlap_slabs == 1:
                # gradient all-reduce over the mesh (mean over ray shards)
                grads = jax.lax.pmean(grads, RAYS)
            # overlap_slabs > 1: grads were pmean'd slab-by-slab inside
            # the backward pass (see _grad_pmean above)
            loss = jax.lax.pmean(loss, RAYS)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        import optax
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return jax.jit(step)
