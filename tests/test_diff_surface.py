"""Differentiable Lambert surface path (BASELINE config 2): palette
gradients vs finite differences, and an appearance-fit convergence check."""

import numpy as np

import jax
import jax.numpy as jnp

from voxel_tracer_tpu.models.camera import Camera, rays_for_image
from voxel_tracer_tpu.models.scene import Scene
from voxel_tracer_tpu.models.skydome import SkyDome
from voxel_tracer_tpu.models.volume import VoxelVolume
from voxel_tracer_tpu.ops.diff_surface import (palette_fit_loss,
                                               render_lambert_surface)


def _setup():
    z, y, x = np.meshgrid(*[np.arange(24)] * 3, indexing="ij")
    c = 11.5
    d = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
    grid = np.where(d < 10, np.where(y > c, 40, 41), 0).astype(np.uint8)
    vol = VoxelVolume(grid, vpu=20.0)
    scene = Scene(volumes=[vol],
                  skydome=SkyDome.constant((0.2, 0.3, 0.4))).data()
    cam = Camera.create((1.3, 1.0, -1.6), (0, 0, 0), 1.0)
    o, d_ = rays_for_image(cam, 24, 24)
    return scene, o, d_


def test_palette_grad_matches_fd():
    scene, o, d = _setup()
    rng = np.random.RandomState(0)
    pal = jnp.asarray(rng.rand(256, 3).astype(np.float32))
    tgt = jnp.asarray(rng.rand(o.shape[0], 3).astype(np.float32))

    loss = jax.jit(lambda p: palette_fit_loss(p, scene, o, d, tgt))
    g = jax.jit(jax.grad(lambda p: palette_fit_loss(p, scene, o, d, tgt)))(pal)
    g = np.asarray(g)

    # FD on the two materials present + one absent entry
    eps = 1e-3
    for m, c in [(40, 0), (41, 2), (7, 1)]:
        pp = pal.at[m, c].add(eps)
        pm = pal.at[m, c].add(-eps)
        fd = (float(loss(pp)) - float(loss(pm))) / (2 * eps)
        np.testing.assert_allclose(g[m, c], fd, rtol=2e-2, atol=1e-5)
    # gradients land only on hit materials
    assert abs(g[7, 1]) < 1e-12
    assert abs(g[40]).sum() > 0 and abs(g[41]).sum() > 0


def test_sun_light_grad_matches_fd():
    scene, o, d = _setup()
    rng = np.random.RandomState(1)
    pal = jnp.asarray(rng.rand(256, 3).astype(np.float32))
    tgt = jnp.asarray(rng.rand(o.shape[0], 3).astype(np.float32))

    def loss_sun(sl):
        out = render_lambert_surface(pal, scene, o, d, sun_light=sl)
        return jnp.mean((out["color"] - tgt) ** 2)

    sl0 = jnp.asarray([0.9, 0.85, 0.8])
    g = np.asarray(jax.jit(jax.grad(loss_sun))(sl0))
    eps = 1e-3
    for c in range(3):
        fd = (float(loss_sun(sl0.at[c].add(eps)))
              - float(loss_sun(sl0.at[c].add(-eps)))) / (2 * eps)
        np.testing.assert_allclose(g[c], fd, rtol=2e-2, atol=1e-6)


def test_palette_fit_converges():
    """Recover a target palette from renders (appearance inverse problem)."""
    scene, o, d = _setup()
    rng = np.random.RandomState(2)
    pal_true = jnp.asarray(rng.rand(256, 3).astype(np.float32))
    target = render_lambert_surface(pal_true, scene, o, d)["color"]
    target = jax.lax.stop_gradient(target)

    pal = jnp.full((256, 3), 0.5, jnp.float32)
    vg = jax.jit(jax.value_and_grad(
        lambda p: palette_fit_loss(p, scene, o, d, target)))
    l0 = None
    for _ in range(250):
        l, g = vg(pal)
        if l0 is None:
            l0 = float(l)
        pal = pal - 4.0 * g
    assert float(l) < l0 * 0.05, (l0, float(l))
    # the two visible materials recovered to ~the true albedo
    hitmats = render_lambert_surface(pal_true, scene, o, d)["mat"]
    for m in np.unique(np.asarray(hitmats)):
        if m == 0:
            continue
        np.testing.assert_allclose(np.asarray(pal)[m],
                                   np.asarray(pal_true)[m], atol=0.08)
