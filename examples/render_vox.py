"""Render a MagicaVoxel scene to PNG — end-to-end smoke example.

Usage:
    python examples/render_vox.py [--vox PATH] [--out out.png] [--size WxH]
                                  [--mode flat|lambert|full] [--aov final|albedo|normals|depth|steps]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from voxel_tracer_tpu import Renderer, RenderConfig, Scene, VoxelVolume
from voxel_tracer_tpu.models.assets import asset_path
from voxel_tracer_tpu.models.skydome import SkyDome
from voxel_tracer_tpu.utils import compile_cache
from voxel_tracer_tpu.utils.aov import display
from voxel_tracer_tpu.utils.framebuffer import write_png


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vox", default=None,
                    help=".vox file (default: the seeded crate asset)")
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--size", default="320x240")
    ap.add_argument("--mode", default="lambert",
                    choices=["flat", "lambert", "full"])
    ap.add_argument("--aov", default="final")
    ap.add_argument("--cam", default="1.2,1.0,-1.6", help="camera position")
    ap.add_argument("--target", default="0,0,0")
    args = ap.parse_args()
    compile_cache.enable()

    w, h = (int(v) for v in args.size.split("x"))
    cfg = RenderConfig(width=w, height=h, shading=args.mode)
    renderer = Renderer(cfg)

    vol = VoxelVolume.from_vox(args.vox or asset_path("crate-16.vox"),
                               pos=(0, 0, 0))
    scene = Scene(volumes=[vol], skydome=SkyDome.procedural())
    sdata = scene.data()

    cam_pos = tuple(float(v) for v in args.cam.split(","))
    target = tuple(float(v) for v in args.target.split(","))
    camera = renderer.camera(cam_pos, target)

    t0 = time.perf_counter()
    aovs = renderer.render(sdata, camera)
    img = np.asarray(aovs["image"])
    t1 = time.perf_counter()

    out = display(aovs, args.aov)
    write_png(args.out, out)
    n_rays = w * h
    hit_frac = float((np.asarray(aovs['depth']) < 1e29).mean())
    print(f"rendered {w}x{h} ({n_rays} rays) in {t1 - t0:.2f}s "
          f"(incl. compile), hit fraction {hit_frac:.3f}")
    print(f"wrote {args.out}")
    assert np.isfinite(img).all(), "non-finite pixels!"
    return 0


if __name__ == "__main__":
    sys.exit(main())
