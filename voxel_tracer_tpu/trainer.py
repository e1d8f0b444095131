"""Inverse rendering: optimize a density/albedo grid from posed images.

Optimizes a 128^3-class density+albedo grid from posed target images (full
backward path under jit).  The training step is ray-sharded over the device
mesh with a gradient all-reduce (parallel/sharding.py); checkpoint/resume
via utils/checkpoint.py.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from voxel_tracer_tpu.models.camera import Camera, rays_for_image
from voxel_tracer_tpu.ops import diff
from voxel_tracer_tpu.parallel import mesh as pmesh
from voxel_tracer_tpu.parallel.sharding import make_train_step
from voxel_tracer_tpu.utils.checkpoint import CheckpointManager


@dataclasses.dataclass
class TrainConfig:
    grid_size: tuple = (64, 64, 64)        # (Z, Y, X)
    vpu: float = 64.0                      # grid spans [0, ~1]^3
    lr: float = 0.15
    steps: int = 200
    rays_per_batch: int = 8192
    march_steps: int = 192
    sigma_init: float = 0.1
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    metrics_path: Optional[str] = None     # JSONL metrics stream


def init_params(cfg: TrainConfig):
    z, y, x = cfg.grid_size
    return {
        "sigma": jnp.full((z, y, x), cfg.sigma_init, jnp.float32),
        "albedo": jnp.full((z, y, x, 3), 0.5, jnp.float32),
    }


def make_dataset(views, width: int, height: int, vpu: float, grid_size):
    """Posed images -> flat arrays of (local-space origins, dirs, pixels).

    views: list of (Camera, image (H,W,3)).  Rays are pre-transformed into
    the grid's local frame (identity rotation, grid centered at origin).
    """
    gz, gy, gx = grid_size
    pivot = np.array([gx, gy, gz], np.float32) / (2.0 * vpu)
    all_o, all_d, all_c = [], [], []
    for cam, img in views:
        o, d = rays_for_image(cam, width, height)
        o = np.asarray(o) + pivot             # world->local: translate only
        d = np.asarray(d)
        c = np.asarray(img).reshape(-1, 3)
        all_o.append(o)
        all_d.append(d)
        all_c.append(c)
    return (np.concatenate(all_o), np.concatenate(all_d),
            np.concatenate(all_c))


class Trainer:
    def __init__(self, cfg: TrainConfig, mesh=None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else pmesh.make_ray_mesh()
        self.optimizer = optax.adam(cfg.lr)
        self.step_fn = make_train_step(
            self.mesh, self.optimizer, cfg.vpu, cfg.march_steps)
        self.params = init_params(cfg)
        self.opt_state = self.optimizer.init(self.params)
        self.step = 0
        self.ckpt = (CheckpointManager(cfg.checkpoint_dir)
                     if cfg.checkpoint_dir else None)
        from voxel_tracer_tpu.utils.logging import MetricsLogger
        self.metrics = MetricsLogger(cfg.metrics_path) \
            if cfg.metrics_path else None

    def maybe_restore(self) -> bool:
        if self.ckpt is None:
            return False
        restored = self.ckpt.restore()
        if restored is None:
            return False
        self.step, state = restored
        self.params = jax.tree.map(jnp.asarray, state["params"])
        self.opt_state = jax.tree.map(jnp.asarray, state["opt_state"])
        return True

    def fit(self, origins, dirs, targets, log_every: int = 50,
            log_fn: Callable = print):
        """Run cfg.steps optimization steps over a ray dataset."""
        cfg = self.cfg
        n_dev = self.mesh.devices.size
        batch = pmesh.pad_to_multiple(cfg.rays_per_batch, n_dev)
        n = origins.shape[0]
        rng = np.random.RandomState(0)
        losses = []
        while self.step < cfg.steps:
            idx = rng.randint(0, n, batch)
            o = jnp.asarray(origins[idx], jnp.float32)
            d = jnp.asarray(dirs[idx], jnp.float32)
            c = jnp.asarray(targets[idx], jnp.float32)
            self.params, self.opt_state, loss = self.step_fn(
                self.params, self.opt_state, o, d, c)
            self.step += 1
            if self.step % log_every == 0:
                losses.append(float(loss))
                log_fn(f"step {self.step}: loss {float(loss):.6f}")
                if self.metrics is not None:
                    self.metrics.log(step=self.step, loss=float(loss),
                                     rays=batch)
            if (self.ckpt is not None
                    and self.step % cfg.checkpoint_every == 0):
                self.ckpt.save(self.step, {
                    "params": self.params, "opt_state": self.opt_state})
        return losses

    def render(self, camera: Camera, width: int, height: int, background=None):
        gz, gy, gx = self.cfg.grid_size
        pivot = jnp.array([gx, gy, gz], jnp.float32) / (2.0 * self.cfg.vpu)
        o, d = rays_for_image(camera, width, height)
        out = diff.render_density(
            self.params["sigma"], self.params["albedo"],
            o + pivot, d, self.cfg.vpu, self.cfg.march_steps)
        color = out["color"]
        if background is not None:
            color = color + out["trans"][:, None] * jnp.asarray(background)
        return np.asarray(color).reshape(height, width, 3)
