"""Benchmark: primary rays/s of flat frames at 1080p on one GPU.

Scene: the dense 64^3 noise volume (`utils/profiling.py:noise_volume`),
rendered by `Renderer` (flat shading: raygen, traversal, palette, sky,
tonemap).  Times a steady window of frames after warm-up; the window ends
in `jax.block_until_ready`.  Fails when JAX finds no GPU.

Prints ONE JSON line:
    {"metric": "primary_rays_per_s_1080p", "value": N, "unit": "rays/s",
     "frames_per_s": F, "platform": ..., "device_kind": ...,
     "device_count": ..., "power_limit": ...}
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

FRAMES = 50


def main():
    from voxel_tracer_tpu.utils import compile_cache

    compile_cache.enable()
    from voxel_tracer_tpu.models.scene import Scene
    from voxel_tracer_tpu.models.skydome import SkyDome
    from voxel_tracer_tpu.renderer import RenderConfig, Renderer
    from voxel_tracer_tpu.utils.device import device_record, require_gpu
    from voxel_tracer_tpu.utils.profiling import noise_camera, noise_volume
    from voxel_tracer_tpu.utils.timer import device_time

    require_gpu()
    width, height = 1920, 1088
    sd = Scene(volumes=[noise_volume()],
               skydome=SkyDome.procedural(64, 32)).data()
    cam = noise_camera(width / height)
    r = Renderer(RenderConfig(width=width, height=height, shading="flat"))
    dt, _ = device_time(lambda: r.render(sd, cam, frame=0), iters=FRAMES)
    print(json.dumps({
        "metric": "primary_rays_per_s_1080p",
        "value": width * height / dt,
        "unit": "rays/s",
        "frames_per_s": 1.0 / dt,
        **device_record(),
    }))


if __name__ == "__main__":
    main()
