"""Live-ray compaction: run a wavefront stage on only its live subset.

The reference's recursive `eval_material` (materials.cpp:15-48) does zero
work for terminated rays; a batched wavefront pays full list size at every
stage unless the live set is gathered into a dense short list first.
`masked_apply` is that gather/scatter harness:

  - `jnp.nonzero(mask, size=cap)` compacts live indices to a static
    capacity (XLA cumsum+scatter — no host sync),
  - the stage function runs on the gathered per-ray arguments at `cap`,
  - outputs scatter back to full size (`.at[idx].set(..., mode='drop')`
    — padding indices fall off the end).

Because the live count is dynamic but XLA shapes are static, capacity is
picked at runtime from a bucket ladder via `lax.switch`: the smallest
bucket that fits the live count wins; the last bucket is the full size
(identity fallback — no gather), so correctness never depends on an
occupancy guess.  Each bucket traces/compiles its own kernel shapes once
(persistent-cached).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _round_up(n, m):
    return -(-n // m) * m


def bucket_caps(n, fracs=(1 / 16, 1 / 4), multiple=1024):
    """Ascending capacity ladder ending in the full size n."""
    caps = sorted({min(_round_up(int(n * f), multiple), n) for f in fracs})
    if not caps or caps[-1] != n:
        caps.append(n)
    return tuple(caps)


def live_indices(mask, cap):
    """Indices of True rows, compacted to ``cap`` slots, padded with n.

    cumsum + scatter-invert (no sort).  Requires sum(mask) <= cap; rows
    past the cap would be silently dropped (callers guarantee fit via
    buckets)."""
    n = mask.shape[0]
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    slots = jnp.where(mask, pos, cap)          # cap = out of bounds -> drop
    return jnp.full((cap,), n, jnp.int32).at[slots].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")


def masked_apply(mask, fn, args, out_fill, caps, fill=None):
    """Run ``fn`` on the mask-compacted rows of ``args``.

    mask:     (n,) bool — rows to process.
    fn:       (live_mask, idx, *gathered_args) -> pytree of (cap, ...)
              outputs.  `live_mask` marks real rows (padding rows are
              False); `idx` is each row's ORIGINAL index (n on padding)
              so fn can compute per-ray values — noise samples, seeds —
              directly at compacted size instead of gathering full-size
              precomputes.  fn must produce DON'T-CARE values on padding
              rows (they are dropped at scatter).
    args:     sequence of (n, ...) arrays gathered per bucket.
    out_fill: pytree of (n, ...) arrays giving each output's value on
              rows where mask is False (also the value on ALL rows that
              fn's outputs overwrite only when mask is True).
    caps:     ascending bucket ladder from `bucket_caps` (last == n).
    fill:     optional per-arg gather fill values (defaults to 0) — e.g.
              park padding ray origins at 1e6 so the slab rejects them.

    Returns the out_fill pytree with fn's outputs scattered into masked
    rows.  The final bucket (cap == n) skips gather/scatter entirely.
    """
    n = mask.shape[0]
    assert caps[-1] == n, f"last bucket {caps[-1]} must equal n={n}"
    if fill is None:
        fill = [None] * len(args)

    count = jnp.sum(mask.astype(jnp.int32))

    def bucket_branch(cap):
        def run(operands):
            mask_, args_, out_ = operands
            if cap == n:
                res = fn(mask_, jnp.arange(n, dtype=jnp.int32), *args_)
                return jax.tree_util.tree_map(
                    lambda o, r: jnp.where(
                        mask_.reshape((n,) + (1,) * (r.ndim - 1)), r, o),
                    out_, res)
            idx = live_indices(mask_, cap)
            live = idx < n
            ga = [jnp.take(a, idx, axis=0, mode="fill", fill_value=f)
                  for a, f in zip(args_, fill)]
            res = fn(live, idx, *ga)
            # padding rows carry idx == n -> dropped by the scatter
            return jax.tree_util.tree_map(
                lambda o, r: o.at[idx].set(r, mode="drop"), out_, res)
        return run

    if len(caps) == 1:
        return bucket_branch(n)((mask, tuple(args), out_fill))

    caps_arr = jnp.asarray(caps, jnp.int32)
    which = jnp.searchsorted(caps_arr, count)
    return jax.lax.switch(which, [bucket_branch(c) for c in caps],
                          (mask, tuple(args), out_fill))
