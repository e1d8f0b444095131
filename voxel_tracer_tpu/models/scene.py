"""Scene: a set of traceable voxel volumes + lights + sky.

Analog of the reference Scene (src/graphics/scene.{h,cpp}), re-designed for
batched devices: instead of a per-frame BVH rebuild over `Traceable*` polymorphism
(scene.cpp:40-43), the scene is a pytree of stacked arrays; nearest-hit
composition across objects is a vectorized slab-test prepass + masked min
(idiomatic for tens of objects; see ops/composite.py for the top-K candidate
scheme used for hundreds of objects).

Default sun direction/color match scene.h:22-23.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from voxel_tracer_tpu.models.volume import VolumeData, VoxelVolume
from voxel_tracer_tpu.models.skydome import SkyDome, SkyDomeData

SUN_DIR = np.array([-0.619501, 0.465931, -0.631765], np.float32)  # scene.h:22
SUN_LIGHT = np.array([0.95, 0.93, 0.875], np.float32)             # scene.h:23


class SphereLightData(NamedTuple):
    """Stacked spherical area lights (sphere-light.{h,cpp} analog)."""

    origin: jnp.ndarray   # (L, 3)
    radius: jnp.ndarray   # (L,)
    color: jnp.ndarray    # (L, 3)
    power: jnp.ndarray    # (L,)
    aoe_sqr: jnp.ndarray  # (L,) area-of-effect dist^2 = power / (4 pi)


class SceneData(NamedTuple):
    """Device-side scene pytree. Volumes grouped by identical grid shape:
    each group is a VolumeData whose arrays carry a leading object axis."""

    groups: Tuple[VolumeData, ...]
    sun_dir: jnp.ndarray
    sun_light: jnp.ndarray
    lights: SphereLightData
    sky: SkyDomeData
    prims: "PrimsData"        # analytic spheres/capsules (ops/prims.py)


@dataclass
class SphereLight:
    origin: np.ndarray
    radius: float
    color: np.ndarray
    power: float


@dataclass
class Scene:
    """Host-side scene container."""

    volumes: List[VoxelVolume] = field(default_factory=list)
    lights: List[SphereLight] = field(default_factory=list)
    sun_dir: np.ndarray = field(default_factory=lambda: SUN_DIR.copy())
    sun_light: np.ndarray = field(default_factory=lambda: SUN_LIGHT.copy())
    skydome: Optional[SkyDome] = None
    spheres: List[tuple] = field(default_factory=list)
    capsules: List[tuple] = field(default_factory=list)

    def add(self, volume: VoxelVolume) -> "Scene":
        self.volumes.append(volume)
        return self

    def add_light(self, origin, radius, color, power) -> "Scene":
        self.lights.append(SphereLight(
            np.asarray(origin, np.float32), float(radius),
            np.asarray(color, np.float32), float(power)))
        return self

    def add_sphere(self, origin, radius, mat=17, albedo=None) -> "Scene":
        """Analytic sphere (sphere.cpp; albedo=None = normal-as-color)."""
        self.spheres.append((origin, radius, mat, albedo))
        return self

    def add_capsule(self, a, b, radius, mat=None, albedo=None) -> "Scene":
        """Analytic capsule; defaults are the laser-beam hack
        (capsule.cpp:56-70: material 0xFF, emissive red)."""
        from voxel_tracer_tpu.ops.prims import LASER_ALBEDO, LASER_MAT
        self.capsules.append((a, b, radius,
                              LASER_MAT if mat is None else mat,
                              LASER_ALBEDO if albedo is None else albedo))
        return self

    def set_laser(self, path, radius=0.01) -> "Scene":
        """Replace the laser capsule chain from a polyline (game.cpp:76-83:
        the Renderer::path output becomes <= 8 renderable segments)."""
        self.capsules = [c for c in self.capsules
                         if c[3] != 0xFF]  # drop old laser segments
        for a, b in zip(path[:-1], path[1:]):
            self.add_capsule(a, b, radius)
        return self

    def data(self) -> SceneData:
        """Upload: group volumes by grid shape and stack each group."""
        by_shape = {}
        for v in self.volumes:
            by_shape.setdefault(v.grid.shape, []).append(v)
        groups = []
        for shape, vols in sorted(by_shape.items()):
            datas = [v.data() for v in vols]
            groups.append(VolumeData(
                grid=jnp.stack([d.grid for d in datas]),
                brick_occ=jnp.stack([d.brick_occ for d in datas]),
                palette=jnp.stack([d.palette for d in datas]),
                rot=jnp.stack([d.rot for d in datas]),
                pos=jnp.stack([d.pos for d in datas]),
                pivot=jnp.stack([d.pivot for d in datas]),
                vpu=jnp.stack([d.vpu for d in datas]),
            ))

        if self.lights:
            lo = jnp.asarray(np.stack([l.origin for l in self.lights]))
            lr = jnp.asarray(np.array([l.radius for l in self.lights], np.float32))
            lc = jnp.asarray(np.stack([l.color for l in self.lights]))
            lp = jnp.asarray(np.array([l.power for l in self.lights], np.float32))
        else:
            lo = jnp.zeros((0, 3), jnp.float32)
            lr = jnp.zeros((0,), jnp.float32)
            lc = jnp.zeros((0, 3), jnp.float32)
            lp = jnp.zeros((0,), jnp.float32)
        lights = SphereLightData(
            origin=lo, radius=lr, color=lc, power=lp,
            aoe_sqr=lp / (4.0 * np.pi),  # sphere-light.h aprox_aoe_sqr
        )

        from voxel_tracer_tpu.ops.prims import build_prims
        prims = build_prims(self.spheres, self.capsules)

        sky = (self.skydome or SkyDome.black()).data()
        return SceneData(
            groups=tuple(groups),
            prims=prims,
            sun_dir=jnp.asarray(self.sun_dir),
            sun_light=jnp.asarray(self.sun_light),
            lights=lights,
            sky=sky,
        )
