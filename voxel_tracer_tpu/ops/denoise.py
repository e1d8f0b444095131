"""Denoise filters: two-pass box blur + separable Gaussian.

Analog of the reference's optional `DENOISE` post pass (renderer.h:16,
renderer.cpp:226-238) and its kernel helpers (src/graphics/noise/
gaussian.h:88-112).  The reference runs two box-blur passes over the
accumulator before tonemapping; here both the box and a true separable
Gaussian are jittable XLA ops over (H, W, C) images, expressed as
depthwise convolutions so XLA lowers them onto fused device kernels instead of a
scalar loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from voxel_tracer_tpu.ops.math3d import mm


def _sep_filter(img, kernel_1d):
    """Apply a 1D filter along H then W (separable 2D convolution).

    img: (H, W, C) f32. Edges use edge-replication, matching the clamped
    window of the reference's box blur.
    """
    k = jnp.asarray(kernel_1d, jnp.float32)
    r = k.shape[0] // 2
    # (H, W, C) -> NCHW with C folded into batch: depthwise via feature dim 1
    x = jnp.moveaxis(img, -1, 0)[:, None, :, :]          # (C, 1, H, W)
    x = jnp.pad(x, ((0, 0), (0, 0), (r, r), (r, r)), mode="edge")
    kv = k.reshape(1, 1, -1, 1)
    kh = k.reshape(1, 1, 1, -1)
    dn = jax.lax.conv_dimension_numbers(x.shape, kv.shape,
                                        ("NCHW", "OIHW", "NCHW"))
    x = jax.lax.conv_general_dilated(x, kv, (1, 1), "VALID",
                                     dimension_numbers=dn)
    x = jax.lax.conv_general_dilated(x, kh, (1, 1), "VALID",
                                     dimension_numbers=dn)
    return jnp.moveaxis(x[:, 0, :, :], 0, -1)


@functools.partial(jax.jit, static_argnames=("radius", "passes"))
def box_blur(img, radius: int = 1, passes: int = 2):
    """Two-pass box blur (renderer.cpp:226-238 semantics).

    Each pass is a (2r+1)^2 normalized box; two passes approximate a
    triangle filter (and three a Gaussian, by central limit).
    """
    img = jnp.asarray(img, jnp.float32)
    n = 2 * radius + 1
    k = jnp.full((n,), 1.0 / n, jnp.float32)
    for _ in range(passes):
        img = _sep_filter(img, k)
    return img


def gaussian_kernel_1d(sigma: float, radius: int | None = None) -> np.ndarray:
    """Normalized 1D Gaussian taps (gaussian.h:88-112 analog)."""
    if radius is None:
        radius = max(1, int(np.ceil(3.0 * sigma)))
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("sigma", "radius"))
def gaussian_blur(img, sigma: float = 1.0, radius: int | None = None):
    """Separable Gaussian blur over a (H, W, C) image."""
    return _sep_filter(jnp.asarray(img, jnp.float32),
                       gaussian_kernel_1d(sigma, radius))


@jax.jit
def fxaa(img, edge_threshold: float = 1.0 / 8.0,
         edge_threshold_min: float = 1.0 / 24.0,
         subpix_cap: float = 0.75):
    """FXAA-style edge anti-aliasing over a (H, W, 3) LDR image.

    Analog of the reference's embedded FXAA 3.11 display shader
    (template/template.cpp:199-320: FXAA_LUMINANCE, FXAA_EDGE_THRESHOLD
    = 1/8, FXAA_EDGE_THRESHOLD_MIN = 1/24), expressed as the
    console-lite variant in pure elementwise XLA: luma edge detection on
    the 3x3 neighborhood, sub-pixel blend toward the cross lowpass
    clamped by the local contrast — vectorized shifts instead of texture
    taps, no data-dependent branches.

    Apply AFTER tonemapping (like the reference's display pass).
    """
    img = jnp.asarray(img, jnp.float32)
    luma_w = jnp.asarray([0.299, 0.587, 0.114], jnp.float32)
    luma = mm(img, luma_w)

    def sh(x, dy, dx):
        # edge-replicated neighbor fetch via roll + boundary overwrite
        y = jnp.roll(x, (-dy, -dx), axis=(0, 1))
        if dy == 1:
            y = y.at[-1].set(x[-1])
        if dy == -1:
            y = y.at[0].set(x[0])
        if dx == 1:
            y = y.at[:, -1].set(x[:, -1])
        if dx == -1:
            y = y.at[:, 0].set(x[:, 0])
        return y

    n = sh(luma, -1, 0)
    s = sh(luma, 1, 0)
    e = sh(luma, 0, 1)
    w = sh(luma, 0, -1)
    l_min = jnp.minimum(luma, jnp.minimum(jnp.minimum(n, s),
                                          jnp.minimum(e, w)))
    l_max = jnp.maximum(luma, jnp.maximum(jnp.maximum(n, s),
                                          jnp.maximum(e, w)))
    rng = l_max - l_min
    edge = rng >= jnp.maximum(edge_threshold_min, l_max * edge_threshold)

    # sub-pixel blend amount from the cross average's deviation
    l_avg = (n + s + e + w) * 0.25
    sub = jnp.clip(jnp.abs(l_avg - luma) / jnp.maximum(rng, 1e-6),
                   0.0, 1.0)
    blend = jnp.where(edge, jnp.minimum(sub * sub * subpix_cap,
                                        subpix_cap), 0.0)

    img_n = sh(img, -1, 0)
    img_s = sh(img, 1, 0)
    img_e = sh(img, 0, 1)
    img_w = sh(img, 0, -1)
    lowpass = (img_n + img_s + img_e + img_w) * 0.25
    return img + blend[..., None] * (lowpass - img)
