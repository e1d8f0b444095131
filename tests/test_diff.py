"""Differentiable rendering: custom-VJP replay vs finite differences and
vs JAX autodiff through the scan (BASELINE.json config 2)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from voxel_tracer_tpu.ops import diff


def _setup(n_grid=8, n_rays=32, seed=0):
    rng = np.random.RandomState(seed)
    sigma = jnp.asarray(rng.rand(n_grid, n_grid, n_grid).astype(np.float32) * 4.0)
    albedo = jnp.asarray(rng.rand(n_grid, n_grid, n_grid, 3).astype(np.float32))
    vpu = 8.0  # volume spans [0,1]^3
    o = rng.rand(n_rays, 3).astype(np.float32) * 0.2 - np.array([0.4, 0.0, 0.6])
    d = rng.randn(n_rays, 3).astype(np.float32) + np.array([1.0, 0.2, 1.5])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return sigma, albedo, jnp.asarray(o), jnp.asarray(d), vpu


def test_forward_bounded():
    sigma, albedo, o, d, vpu = _setup()
    out = diff.render_density(sigma, albedo, o, d, vpu, 64)
    c, t = np.asarray(out["color"]), np.asarray(out["trans"])
    assert np.isfinite(c).all() and np.isfinite(t).all()
    assert (t >= 0).all() and (t <= 1.0 + 1e-6).all()
    assert (c >= -1e-6).all()


def test_transmittance_matches_integral():
    """A single fully-dense column: T = exp(-sigma * pathlen)."""
    n = 8
    sigma = jnp.full((n, n, n), 2.0, jnp.float32)
    albedo = jnp.ones((n, n, n, 3), jnp.float32)
    vpu = float(n)  # unit cube
    o = jnp.array([[0.5, 0.5, -1.0]], jnp.float32)
    d = jnp.array([[0.0, 0.0, 1.0]], jnp.float32)
    out = diff.render_density(sigma, albedo, o, d, vpu, 64)
    np.testing.assert_allclose(
        np.asarray(out["trans"])[0], np.exp(-2.0 * 1.0), rtol=1e-4)


@pytest.mark.parametrize("wrt", ["sigma", "albedo"])
def test_grad_matches_finite_difference(wrt):
    sigma, albedo, o, d, vpu = _setup(n_grid=6, n_rays=16, seed=3)
    key_pix = np.random.RandomState(1)

    def loss(sig, alb):
        out = diff.render_density(sig, alb, o, d, vpu, 48)
        return jnp.sum(out["color"] ** 2) + jnp.sum(out["trans"])

    g_sig, g_alb = jax.grad(loss, argnums=(0, 1))(sigma, albedo)
    g = np.asarray(g_sig if wrt == "sigma" else g_alb)

    base = float(loss(sigma, albedo))
    eps = 1e-2
    # probe the highest-|grad| entries + a few random ones
    flat = np.abs(g).reshape(-1)
    idxs = list(np.argsort(flat)[-5:]) + list(
        key_pix.randint(0, flat.size, 3))
    arr = np.asarray(sigma if wrt == "sigma" else albedo)
    checked = 0
    for fi in idxs:
        if flat[fi] < 1e-4:
            continue
        pert = arr.copy().reshape(-1)
        pert[fi] += eps
        pert = jnp.asarray(pert.reshape(arr.shape))
        if wrt == "sigma":
            hi = float(loss(pert, albedo))
        else:
            hi = float(loss(sigma, pert))
        fd = (hi - base) / eps
        an = g.reshape(-1)[fi]
        assert np.isclose(fd, an, rtol=0.08, atol=1e-3), (
            f"{wrt}[{fi}]: fd={fd} vs analytic={an}")
        checked += 1
    assert checked >= 3


def test_grad_matches_autodiff_through_scan():
    """The replay VJP must equal plain autodiff through the forward scan."""
    sigma, albedo, o, d, vpu = _setup(n_grid=6, n_rays=24, seed=7)

    def loss_custom(sig, alb):
        out = diff.render_density(sig, alb, o, d, vpu, 48)
        return jnp.sum(out["color"] * jnp.array([0.2, 0.5, 0.3])) + 0.7 * jnp.sum(out["trans"]) + 0.1 * jnp.sum(out["depth"])

    def loss_plain(sig, alb):
        c, t, dep = diff._render_fwd_only(sig, alb, o, d, vpu, 48)
        return jnp.sum(c * jnp.array([0.2, 0.5, 0.3])) + 0.7 * jnp.sum(t) + 0.1 * jnp.sum(dep)

    gc = jax.grad(loss_custom, argnums=(0, 1))(sigma, albedo)
    gp = jax.grad(loss_plain, argnums=(0, 1))(sigma, albedo)
    np.testing.assert_allclose(np.asarray(gc[0]), np.asarray(gp[0]),
                               rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(np.asarray(gc[1]), np.asarray(gp[1]),
                               rtol=2e-3, atol=2e-5)


def _fd_check(loss, sigma, albedo, wrt, eps=1e-2, n_probe=6, seed=0):
    """Finite differences vs the replay VJP on the largest-|grad| entries
    plus a few random ones (float64 host arithmetic for the difference)."""
    g = jax.grad(loss, argnums=(0, 1))(sigma, albedo)
    g = np.asarray(g[0] if wrt == "sigma" else g[1]).reshape(-1)
    arr = np.asarray(sigma if wrt == "sigma" else albedo)
    base = float(loss(sigma, albedo))
    rng = np.random.RandomState(seed)
    idxs = list(np.argsort(np.abs(g))[-n_probe:]) + list(
        rng.randint(0, g.size, 3))
    checked = 0
    for fi in idxs:
        if abs(g[fi]) < 1e-4:
            continue
        pert = arr.copy().reshape(-1)
        pert[fi] += eps
        pert = jnp.asarray(pert.reshape(arr.shape))
        hi = float(loss(pert, albedo) if wrt == "sigma" else loss(sigma, pert))
        fd = (hi - base) / eps
        assert np.isclose(fd, g[fi], rtol=0.08, atol=1e-3), (
            f"{wrt}[{fi}]: fd={fd} vs analytic={g[fi]}")
        checked += 1
    assert checked >= 3


def _sparse_field(n=8, seed=5):
    """Mostly empty density (exact zeros) with a few solid cells."""
    rng = np.random.RandomState(seed)
    sigma = np.where(rng.rand(n, n, n) < 0.25,
                     rng.rand(n, n, n) * 6.0, 0.0).astype(np.float32)
    albedo = rng.rand(n, n, n, 3).astype(np.float32)
    return jnp.asarray(sigma), jnp.asarray(albedo)


@pytest.mark.parametrize("field", ["sparse", "dense_constant"])
@pytest.mark.parametrize("wrt", ["sigma", "albedo"])
def test_grad_fields_match_finite_difference(field, wrt):
    _, _, o, d, vpu = _setup(n_grid=8, n_rays=24, seed=11)
    if field == "sparse":
        sigma, albedo = _sparse_field()
    else:
        sigma = jnp.full((8, 8, 8), 1.5, jnp.float32)
        albedo = jnp.asarray(np.random.RandomState(2).rand(8, 8, 8, 3),
                             jnp.float32)

    def loss(sig, alb):
        out = diff.render_density(sig, alb, o, d, vpu, 64)
        return jnp.sum(out["color"] ** 2) + jnp.sum(out["trans"])

    _fd_check(loss, sigma, albedo, wrt)


def test_grad_axis_parallel_rays():
    """Rays with zero direction components (infinite reciprocal) march and
    differentiate like any other ray."""
    sigma, albedo, _, _, vpu = _setup(n_grid=8, seed=13)
    o = jnp.asarray([[0.31, 0.52, -0.5], [-0.5, 0.27, 0.61],
                     [0.44, 1.5, 0.38], [0.12, 0.83, -0.3]], jnp.float32)
    d = jnp.asarray([[0, 0, 1], [1, 0, 0], [0, -1, 0],
                     [0, 0.6, 0.8]], jnp.float32)

    def loss(sig, alb):
        out = diff.render_density(sig, alb, o, d, vpu, 64)
        return jnp.sum(out["color"]) + jnp.sum(out["trans"])

    g_sig, g_alb = jax.grad(loss, argnums=(0, 1))(sigma, albedo)
    assert np.isfinite(np.asarray(g_sig)).all()
    assert np.isfinite(np.asarray(g_alb)).all()
    _fd_check(loss, sigma, albedo, "sigma")


def test_padded_batch_leaves_grads_unchanged():
    """Padding a batch with rays that miss the grid adds nothing: the
    sum-loss gradient of the padded batch equals the unpadded one."""
    sigma, albedo, o, d, vpu = _setup(n_grid=8, n_rays=20, seed=17)
    pad_o = jnp.full((12, 3), 5.0, jnp.float32)        # far outside
    pad_d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (12, 1))

    def grads(o_, d_):
        def loss(sig, alb):
            out = diff.render_density(sig, alb, o_, d_, vpu, 64)
            return jnp.sum(out["color"]) + jnp.sum(out["depth"])
        return jax.grad(loss, argnums=(0, 1))(sigma, albedo)

    a = grads(o, d)
    b = grads(jnp.concatenate([o, pad_o]), jnp.concatenate([d, pad_d]))
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), rtol=1e-6,
                                   atol=1e-7)


def test_grads_add_over_batch_halves():
    """The scatter-add backward is linear in the batch: grads of a sum
    over a batch equal the sum of the grads over its halves."""
    sigma, albedo, o, d, vpu = _setup(n_grid=8, n_rays=32, seed=19)

    def grads(o_, d_):
        def loss(sig, alb):
            return jnp.sum(diff.render_density(sig, alb, o_, d_, vpu,
                                               64)["color"])
        return jax.grad(loss, argnums=(0, 1))(sigma, albedo)

    full = grads(o, d)
    h1, h2 = grads(o[:16], d[:16]), grads(o[16:], d[16:])
    for f, a, b in zip(full, h1, h2):
        np.testing.assert_allclose(np.asarray(f), np.asarray(a) + np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_zero_density_gives_finite_grads():
    _, albedo, o, d, vpu = _setup(n_grid=8, seed=23)
    sigma = jnp.zeros((8, 8, 8), jnp.float32)

    def loss(sig, alb):
        out = diff.render_density(sig, alb, o, d, vpu, 64)
        return jnp.sum(out["trans"]) + jnp.sum(out["color"])

    g_sig, g_alb = jax.grad(loss, argnums=(0, 1))(sigma, albedo)
    assert np.isfinite(np.asarray(g_sig)).all()
    np.testing.assert_array_equal(np.asarray(g_alb), 0.0)   # no weight
