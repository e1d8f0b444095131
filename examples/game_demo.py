"""Headless arcade-game demo, rendered every frame through `Renderer`.

The reference's deliverable is a playable game (src/game/game.cpp:28-98):
drones steer and ROTATE each tick, the laser carves voxels out of them,
kills respawn the model.  This demo runs that loop headless with the
full-material `Renderer`:

  - per-frame drone motion/rotation and carved voxels reach the device
    through `Scene.data()` each frame; the shapes stay fixed, so the
    jitted frame never recompiles (scene.cpp:40-43, enemy.cpp:10-43,
    vv.cpp:377-432);
  - the laser beam renders as up to 8 analytic capsule segments
    (scene.cpp:21-24, capsule.cpp:56-70);
  - every traversal (primary, shadows, mirror/glass bounces) goes through
    `ops/dda.py`, which takes the Triton kernel on a GPU.

Writes frames and prints a JSON summary (wall fps, render ms/frame).

Usage: python examples/game_demo.py [--frames 60] [--size 1280x768]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--size", default="1280x768")
    ap.add_argument("--render-every", type=int, default=1)
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--out-prefix", default="game_frame")
    ap.add_argument("--bounces", type=int, default=2)
    args = ap.parse_args()

    from voxel_tracer_tpu.utils import compile_cache

    compile_cache.enable()
    import jax

    from voxel_tracer_tpu.game.enemy import Enemy
    from voxel_tracer_tpu.game.game import Game, GameState
    from voxel_tracer_tpu.game.player import Input
    from voxel_tracer_tpu.models.assets import asset_path
    from voxel_tracer_tpu.models.scene import Scene
    from voxel_tracer_tpu.models.skydome import SkyDome
    from voxel_tracer_tpu.models.volume import VoxelVolume
    from voxel_tracer_tpu.models.vox import load_vox
    from voxel_tracer_tpu.ops import oracle
    from voxel_tracer_tpu.renderer import RenderConfig, Renderer
    from voxel_tracer_tpu.utils.framebuffer import Surface

    w, h = (int(v) for v in args.size.split("x"))
    rng = np.random.RandomState(3)

    # glass test box (static scenery, scene.cpp:11-13) + 4 drones (dynamic)
    box = VoxelVolume.from_vox(asset_path("testing/glass-box.vox"),
                               pos=(0.0, -0.6, -6.5))
    model = load_vox(asset_path("enemy-drone.vox"))
    grid, pal = model.grid, model.palette_f32

    enemies, vols = [], []
    for i in range(4):
        vol = VoxelVolume(grid.copy(), pal, pos=(float(i), 2.0, 0.0),
                          vpu=20.0)
        base = grid.copy()
        enemies.append(Enemy(vol, rng,
                             reload_fn=lambda m, b=base: np.copyto(m.grid, b)))
        vols.append(vol)

    all_vols = [box] + vols
    scene = Scene(volumes=all_vols, skydome=SkyDome.procedural(64, 32))
    scene.add_light((0.5, 2.5, -4.0), 0.15, (1.0, 0.9, 0.8), 40.0)
    renderer = Renderer(RenderConfig(width=w, height=h, shading="full",
                                     max_bounces=args.bounces,
                                     glass_reflections=2))

    def intersect(o, d, medium=0):
        """Host-side laser ray against every volume (scalar oracle)."""
        best = (1e30, 0, np.zeros(3, np.float32))
        for v in all_vols:
            hh = oracle.intersect_volume(oracle.OracleVolume(
                grid=v.grid, vpu=v.vpu, pos=v.pos, rot=v.rot), o, d,
                medium=medium)
            if medium and hh.depth <= 0.0 and hh.material == 0:
                continue
            if hh.depth < best[0]:
                best = (hh.depth, hh.material, hh.normal)
        return best

    game = Game(scene, enemies, intersect_fn=intersect, aspect=w / h)
    game.start()
    for i, e in enumerate(enemies):
        e.pos = np.array([(i - 1.5) * 1.2, 0.1 * i, -5.0 - i])
        e.velocity = np.zeros(3)
        e.model.set_position(e.pos)

    def frame_state():
        # laser capsules from this frame's path (game.cpp:76-83); idle
        # slots are parked far away so the capsule count never changes
        pts = game.laser_path
        far = np.array([1e5, 1e5, 1e5], np.float32)
        scene.capsules = []
        for si in range(8):
            if pts is not None and si + 1 < len(pts):
                scene.add_capsule(np.asarray(pts[si], np.float32),
                                  np.asarray(pts[si + 1], np.float32), 0.02)
            else:
                scene.add_capsule(far, far + np.array([0, 0, 0.01],
                                                      np.float32), 0.02)
        return scene.data(), game.player.camera(w / h)

    carved0 = sum((v.grid != 0).sum() for v in all_vols)
    t_sim = t_render = 0.0
    rendered = 0
    t_wall0 = time.perf_counter()
    for frame in range(args.frames):
        t0 = time.perf_counter()
        tgt = min(enemies,
                  key=lambda e: np.linalg.norm(e.pos - game.player.pos))
        d = tgt.pos - game.player.pos
        d = d / max(np.linalg.norm(d), 1e-9)
        game.player.yaw = float(np.arctan2(-d[0], -d[2]))
        game.player.pitch = float(np.clip(np.arcsin(d[1]), -1.5, 0.4))
        game.tick(1 / 60, Input(fire=(frame % 2 == 0)))
        if game.state == GameState.GAME_OVER:
            game.start()
        t_sim += time.perf_counter() - t0

        if frame % args.render_every == 0:
            t0 = time.perf_counter()
            sd, cam = frame_state()
            img = jax.block_until_ready(renderer.render(sd, cam)["image"])
            t_render += time.perf_counter() - t0
            rendered += 1
            if frame % args.save_every == 0:
                surf = Surface(w, h).from_float(np.asarray(img))
                from voxel_tracer_tpu.game.gui import GameGui, draw_game_gui
                draw_game_gui(surf, game, GameGui())
                surf.save_png(f"{args.out_prefix}_{frame:04d}.png")
    wall = time.perf_counter() - t_wall0

    carved1 = sum((v.grid != 0).sum() for v in all_vols)
    dev = jax.devices()[0]
    result = {
        "resolution": f"{w}x{h}",
        "device": f"{dev.platform} {dev.device_kind}",
        "frames_simulated": args.frames,
        "frames_rendered": rendered,
        "wall_fps": args.frames / wall,
        "render_ms_per_frame": t_render / max(rendered, 1) * 1e3,
        "sim_ms_per_frame": t_sim / args.frames * 1e3,
        "voxels_carved": int(carved0 - carved1),
        "score": game.score,
        "volumes": len(all_vols),
        "config": {"bounces": args.bounces, "glass_reflections": 2,
                   "shading": "full", "dynamic_rotating_volumes": 4},
    }
    print(json.dumps(result, indent=1))
    return 0 if (carved0 - carved1) > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
