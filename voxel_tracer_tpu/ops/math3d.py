"""Small 3D math library (vectors, quaternions, rigid transforms).

Batched analog of the reference template math layer
(`template/tmpl8math.h`: `float3`, `mat4` at :641, `quat` at :888-1030,
`TransformPosition/Vector` at :1118-1121).  Everything here is functional and
works on batched `jnp` arrays with a trailing axis of size 3; rigid
transforms are kept as (3,3) rotation + (3,) translation instead of a 4x4
matrix — that is all a rigid voxel-volume transform needs and it keeps XLA
layouts simple.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

BIG_F32 = 1e30  # reference: template/types.h:19


def mm(a, b):
    """float32 matmul at full precision: on a GPU a plain `@` may run in
    TF32 (about three decimal digits), too coarse for hit points, normals
    and pixel indices."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def dot(a, b):
    """Batched 3D dot product over the trailing axis."""
    return jnp.sum(a * b, axis=-1)


def norm(v):
    return jnp.sqrt(dot(v, v))


def normalize(v, eps=0.0):
    n = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
    if eps:
        n = jnp.maximum(n, eps)
    return v / n


def cross(a, b):
    return jnp.cross(a, b)


def reflect(d, n):
    """Mirror reflection of direction ``d`` about unit normal ``n``."""
    return d - 2.0 * dot(d, n)[..., None] * n


def sign_dir(d):
    """Per-axis ray-direction sign (+1 / -1), positive for +0.

    Matches the reference bit-trick semantics (src/graphics/rays/ray.h:80-97):
    the sign bit alone decides, so d >= +0 -> +1, d < 0 (incl. -0) -> -1.
    """
    return jnp.where(jnp.signbit(d), -1.0, 1.0)


def safe_rcp(d):
    """1/d with the IEEE inf behavior the slab/DDA math relies on."""
    return 1.0 / d


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z) — analog of template/tmpl8math.h:888-1030.
# ---------------------------------------------------------------------------

def quat_identity():
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=jnp.float32)


def quat_from_axis_angle(axis, angle):
    """Unit quaternion rotating by ``angle`` radians about ``axis``."""
    axis = jnp.asarray(axis, dtype=jnp.float32)
    axis = axis / jnp.linalg.norm(axis)
    half = angle * 0.5
    s = jnp.sin(half)
    return jnp.concatenate([jnp.cos(half)[None], axis * s], axis=0)


def quat_mul(q1, q2):
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_to_mat3(q):
    """(…,4) quaternion -> (…,3,3) rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_rotate(q, v):
    """Rotate vector(s) ``v`` by quaternion ``q``."""
    return mm(quat_to_mat3(q), v[..., None])[..., 0]


# ---------------------------------------------------------------------------
# Rigid transforms: world = R @ (local - pivot) + pos
# (analog of OBB model = T(pos) * R * T(-pivot), obb.cpp:26-35)
# ---------------------------------------------------------------------------

def rigid_forward(rot3, pos, pivot, p_local):
    """local -> world points."""
    return mm(rot3, (p_local - pivot)[..., None])[..., 0] + pos


def rigid_inverse_point(rot3, pos, pivot, p_world):
    """world -> local points (rot3 orthonormal, so inverse = transpose)."""
    return mm(jnp.swapaxes(rot3, -1, -2), (p_world - pos)[..., None])[..., 0] + pivot


def rigid_forward_vec(rot3, v_local):
    """local -> world directions."""
    return mm(rot3, v_local[..., None])[..., 0]


def rigid_inverse_vec(rot3, v_world):
    """world -> local directions."""
    return mm(jnp.swapaxes(rot3, -1, -2), v_world[..., None])[..., 0]


# ---------------------------------------------------------------------------
# Perlin-style value noise — analog of template/tmpl8math.cpp:60-112 noise3D,
# used by the procedurally filled volume constructor (vv.cpp:88-117).
# ---------------------------------------------------------------------------

_PERLIN_PERM = np.random.RandomState(1234).permutation(256)
_PERLIN_PERM = np.concatenate([_PERLIN_PERM, _PERLIN_PERM]).astype(np.int32)

_GRAD3 = np.array(
    [
        [1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0],
        [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
        [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1],
    ],
    dtype=np.float32,
)


def noise3d(x, y, z):
    """Deterministic gradient noise in [-1, 1]; numpy, host-side scene setup."""
    x, y, z = np.asarray(x, np.float32), np.asarray(y, np.float32), np.asarray(z, np.float32)
    xi, yi, zi = np.floor(x).astype(np.int32) & 255, np.floor(y).astype(np.int32) & 255, np.floor(z).astype(np.int32) & 255
    xf, yf, zf = x - np.floor(x), y - np.floor(y), z - np.floor(z)

    def fade(t):
        return t * t * t * (t * (t * 6 - 15) + 10)

    u, v, w = fade(xf), fade(yf), fade(zf)
    perm = _PERLIN_PERM

    def grad_at(ix, iy, iz, fx, fy, fz):
        h = perm[perm[perm[ix] + iy] + iz] % 12
        g = _GRAD3[h]
        return g[..., 0] * fx + g[..., 1] * fy + g[..., 2] * fz

    n000 = grad_at(xi, yi, zi, xf, yf, zf)
    n100 = grad_at(xi + 1, yi, zi, xf - 1, yf, zf)
    n010 = grad_at(xi, yi + 1, zi, xf, yf - 1, zf)
    n110 = grad_at(xi + 1, yi + 1, zi, xf - 1, yf - 1, zf)
    n001 = grad_at(xi, yi, zi + 1, xf, yf, zf - 1)
    n101 = grad_at(xi + 1, yi, zi + 1, xf - 1, yf, zf - 1)
    n011 = grad_at(xi, yi + 1, zi + 1, xf, yf - 1, zf - 1)
    n111 = grad_at(xi + 1, yi + 1, zi + 1, xf - 1, yf - 1, zf - 1)

    def lerp(a, b, t):
        return a + t * (b - a)

    nx00 = lerp(n000, n100, u)
    nx10 = lerp(n010, n110, u)
    nx01 = lerp(n001, n101, u)
    nx11 = lerp(n011, n111, u)
    nxy0 = lerp(nx00, nx10, v)
    nxy1 = lerp(nx01, nx11, v)
    return lerp(nxy0, nxy1, w)
