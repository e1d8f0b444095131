"""Shading: lights, shadows and material evaluation (wavefront style).

Analog of src/graphics/lighting/materials.{h,cpp} and sphere-light.cpp,
re-structured for batched devices: the reference's recursive Whitted evaluation
(materials.cpp:15-48, <= 8 bounces) becomes a bounded wavefront loop with
masked per-ray state — every bounce intersects the whole wavefront once and
updates throughput/irradiance with `where` selects.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from voxel_tracer_tpu.models.scene import SceneData
from voxel_tracer_tpu.models.skydome import sample_sky
from voxel_tracer_tpu.ops import composite
from voxel_tracer_tpu.ops.math3d import BIG_F32, dot, normalize, reflect
from voxel_tracer_tpu.ops.tonemap import clamp_color

INVPI = 1.0 / jnp.pi
FOURPI = 4.0 * jnp.pi
MIN_REFLECT = 0.01  # materials.h MIN_REFLECT


def hit_point(origins, dirs, t, normal):
    """Offset intersection point (ray.h:51-53: + normal * 1e-4)."""
    return origins + dirs * t[:, None] + normal * 1e-4


def sun_light(scene: SceneData, p, n, jitter3=None, max_candidates=4,
              shadow_seed=None, impl=None):
    """Sun contribution with shadow ray (materials.cpp:226-244).  With
    ``shadow_seed`` the shadow ray uses stochastic glass/mirror
    pass-through (vv.cpp:314-327)."""
    sun_dir = scene.sun_dir
    if jitter3 is not None:
        intensity = 6.0 / 16.0
        sun_dir = normalize(sun_dir + jitter3 * intensity - intensity * 0.5)
    else:
        sun_dir = jnp.broadcast_to(sun_dir, p.shape)
    incidence = dot(n, sun_dir)
    lit = incidence > 0.0
    occluded, shadow_hit = composite.is_occluded(
        scene, p, sun_dir, BIG_F32, max_candidates, shadow_seed=shadow_seed,
        impl=impl)
    vis = lit & ~occluded
    return jnp.where(vis[:, None], scene.sun_light * incidence[:, None], 0.0)


def cos_diffuse_reflect(n, r1, r2):
    """Cosine-weighted hemisphere direction around normal n."""
    theta = jnp.arccos(jnp.sqrt(jnp.clip(1.0 - r1, 0.0, 1.0)))
    phi = 2.0 * jnp.pi * r2
    xs = jnp.sin(theta) * jnp.cos(phi)
    ys = jnp.cos(theta)
    zs = jnp.sin(theta) * jnp.sin(phi)
    # build a tangent frame: pick the axis least aligned with n
    h = jnp.where(
        (jnp.abs(n[..., 0:1]) <= jnp.abs(n[..., 1:2]))
        & (jnp.abs(n[..., 0:1]) <= jnp.abs(n[..., 2:3])),
        jnp.array([1.0, 0.0, 0.0]),
        jnp.where(
            jnp.abs(n[..., 1:2]) <= jnp.abs(n[..., 2:3]),
            jnp.array([0.0, 1.0, 0.0]),
            jnp.array([0.0, 0.0, 1.0]),
        ),
    ) + n * 0.0
    x = normalize(jnp.cross(h + n * 0.0 + 0.0, n) + 1e-12)
    z = normalize(jnp.cross(x, n))
    return normalize(xs[..., None] * x + ys[..., None] * n + zs[..., None] * z)


def ambient_light(scene: SceneData, p, n, r2pair, max_candidates=4,
                  shadow_seed=None, impl=None):
    """Ambient sky term: cosine-weighted ray, occlusion within 1 unit,
    sky sample / pdf, clamped (materials.cpp:249-269)."""
    amb_dir = cos_diffuse_reflect(n, r2pair[..., 0], r2pair[..., 1])
    occluded, _ = composite.is_occluded(scene, p, amb_dir, 1.0,
                                        max_candidates,
                                        shadow_seed=shadow_seed, impl=impl)
    pdf = jnp.maximum(dot(amb_dir, n) * INVPI, 1e-6)
    sky = sample_sky(scene.sky, amb_dir) * 0.25
    contrib = clamp_color(sky / pdf[:, None], 8.0)
    return jnp.where(occluded[:, None], 0.0, contrib)


def sphere_lights(scene: SceneData, p, n, sample3, max_candidates=4,
                  shadow_seed=None, live=None, impl=None):
    """Monte-Carlo spherical area lights (sphere-light.cpp:8-37).

    ``live`` (optional bool mask) parks dead rows' shadow rays: the
    shadow ray starts at the LIGHT's sampled point, so a parked surface
    point alone doesn't stop the traversal from doing real work."""
    lights = scene.lights
    num = lights.origin.shape[0]
    total = jnp.zeros_like(p)
    for li in range(num):
        origin = lights.origin[li]
        radius = lights.radius[li]
        diameter = radius * 2.0
        sample_point = origin + (sample3 * diameter - radius)
        ext = sample_point - p
        dist_sqr = dot(ext, ext)
        in_aoe = dist_sqr <= lights.aoe_sqr[li]
        dist = jnp.sqrt(jnp.maximum(dist_sqr, 1e-12))
        sdir = ext / dist[:, None]
        incidence = dot(n, sdir)
        facing = incidence > 0.0
        # shadow ray from the sampled light point back toward the surface
        # (sphere-light.cpp:20-24); sample_point is already per-ray (N, 3)
        so, sdd = sample_point, -sdir
        if live is not None:
            so = jnp.where(live[:, None], so, 1e6)
            sdd = jnp.where(live[:, None], sdd,
                            jnp.asarray([0.0, 0.0, 1.0], jnp.float32))
        occluded, _ = composite.is_occluded(
            scene, so, sdd,
            dist - 0.01, max_candidates, shadow_seed=shadow_seed, impl=impl)
        pdf = FOURPI * diameter
        intensity = lights.power[li] / (FOURPI * jnp.maximum(dist_sqr, 1e-12))
        contrib = lights.color[li] * (intensity * incidence * pdf)[:, None]
        ok = in_aoe & facing & ~occluded
        total = total + jnp.where(ok[:, None], contrib, 0.0)
    return total


def diffuse_irradiance(scene, p, n, noise3, noise2, config, shadow_seed=None,
                       live=None):
    """Sphere lights + sun + ambient (materials.cpp:194-221)."""
    irr = jnp.zeros_like(p)
    salt = None if shadow_seed is None else shadow_seed
    if scene.lights.origin.shape[0] > 0:
        irr = irr + sphere_lights(scene, p, n, noise3, config.max_candidates,
                                  shadow_seed=salt, live=live,
                                  impl=config.traversal)
    irr = irr + sun_light(scene, p, n, noise3, config.max_candidates,
                          shadow_seed=None if salt is None
                          else salt ^ jnp.uint32(0xA511E9B3),
                          impl=config.traversal)
    irr = irr + ambient_light(scene, p, n, noise2, config.max_candidates,
                              shadow_seed=None if salt is None
                              else salt ^ jnp.uint32(0x63D83595),
                              impl=config.traversal)
    return irr


def lambert_irradiance(scene: SceneData, origins, dirs, hit, config):
    """Deterministic Lambertian shading: sun + shadow ray + flat ambient.
    (config-2 benchmark shading; a simplification of diffuse_light)."""
    p = hit_point(origins, dirs, hit.t, hit.normal)
    sun = sun_light(scene, p, hit.normal, None, config.max_candidates,
                    impl=config.traversal)
    return sun + config.ambient


def fresnel_reflect_prob(n1, n2, n, incident):
    """Schlick reflect probability with reflectivity floor
    (materials.cpp:271-289)."""
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    cos_x = -dot(n, incident)
    nd = n1 / n2
    sin_t2 = nd * nd * (1.0 - cos_x * cos_x)
    tir = sin_t2 > 1.0
    cos_x = jnp.where(n1 > n2, jnp.sqrt(jnp.clip(1.0 - sin_t2, 0.0, 1.0)), cos_x)
    x = 1.0 - cos_x
    ret = r0 + (1.0 - r0) * x ** 5
    ret = MIN_REFLECT + (1.0 - MIN_REFLECT) * ret
    return jnp.where((n1 > n2) & tir, 1.0, ret)


def refract(n, incident, eta):
    """Refraction direction; 0 on total internal reflection
    (materials.cpp:291-298)."""
    d = dot(n, incident)
    k = 1.0 - eta * eta * (1.0 - d * d)
    out = eta * incident - (eta * d + jnp.sqrt(jnp.clip(k, 0.0, None)))[..., None] * n
    out = normalize(out + 1e-20)
    return jnp.where((k < 0.0)[..., None], 0.0, out)


def material_row(mat):
    """Material id -> row (materials.h:8-14): row = floor((id-1)/8);
    0 glass, 1 mirror, 15 unlit; ids are 1..255 when hit."""
    return jnp.floor((mat.astype(jnp.float32) - 1.0) / 8.0).astype(jnp.int32)


def eval_glass_wavefront(scene, cur_o, cur_d, cur_hit, is_glass, config):
    """Glass evaluation: bounded internal-reflection loop with Beer
    absorption and Fresnel splits (materials.cpp:119-189 semantics).

    Per iteration: march the interior to the exit (medium-aware DDA,
    vv.cpp:166-232), accumulate Beer's law over the total interior length,
    compute the Schlick reflect/refract split, and either (a) emit a
    refracted "scan" ray or (b) reflect internally and continue.  The FIRST
    emitted scan ray becomes the wavefront continuation (the reference
    recurses `eval_material` on every scan ray; a wavefront has one ray slot,
    so later scans are evaluated terminally here: sky on miss, albedo x
    (shadowless sun Lambert + ambient) on hit — a documented approximation
    of the recursive tail, whose weight decays as `mul *= reflect_mul`).

    Returns (cont_o, cont_d, cont_w, emitted, alb_acc, irr_acc):
    the continuation ray + weight (applied to BOTH albedo and irradiance
    throughput — the reference scales `eval.albedo` and `eval.irradiance`
    by the same factor and the final color is their product), and the
    terminal accumulations from internal reflections past the first exit.
    """
    n = cur_o.shape[0]
    p = hit_point(cur_o, cur_d, cur_hit.t, cur_hit.normal)
    entry_dir = refract(cur_hit.normal, cur_d, 1.0 / 1.5)
    # Nudge into the medium so the first tested voxel is the glass itself.
    # (The reference starts the interior ray at `ray.intersection(hit)` —
    # 1e-4 OUTSIDE the surface, materials.cpp:126 — which only works when
    # the glass face coincides with the volume's OBB boundary; the forward
    # nudge also supports glass surfaces interior to the grid.)
    i_o = p + entry_dir * 1e-3
    i_d = entry_dir
    g_medium = jnp.where(is_glass, cur_hit.mat, 0)
    absorption = -(1.0 - cur_hit.albedo)          # materials.cpp:130
    mul = jnp.ones((n,), jnp.float32)
    absorb_t = jnp.zeros((n,), jnp.float32)
    g_live = is_glass
    emitted = jnp.zeros((n,), bool)
    cont_o, cont_d = p, cur_d
    cont_w = jnp.ones((n, 3), jnp.float32)
    alb_acc = jnp.zeros((n, 3), jnp.float32)
    irr_acc = jnp.zeros((n, 3), jnp.float32)

    for i in range(config.glass_reflections):
        i_hit = composite.march_interior(
            scene, cur_hit.obj, i_o, i_d, g_medium, config.max_steps,
            impl=config.traversal)
        exit_p = i_o + i_d * i_hit.t[:, None]
        absorb_t = absorb_t + jnp.where(g_live, i_hit.t, 0.0)
        absorb = jnp.exp(absorption * 2.0 * absorb_t[:, None])
        refl = fresnel_reflect_prob(1.5, 1.0, i_d, i_hit.normal)
        refr = 1.0 - refl
        do_refract = refr >= 0.2                   # materials.cpp:148
        scan_d = refract(i_hit.normal, i_d, 1.5)
        scan_o = exit_p + i_hit.normal * 1e-4      # materials.cpp:159
        w = absorb * (refr * mul)[:, None]

        first = g_live & do_refract & ~emitted
        cont_o = jnp.where(first[:, None], scan_o, cont_o)
        cont_d = jnp.where(first[:, None], scan_d, cont_d)
        cont_w = jnp.where(first[:, None], w, cont_w)
        emitted = emitted | first

        if i > 0:
            later = g_live & do_refract & ~first
            s_hit = composite.intersect_scene(
                scene, scan_o, scan_d, config.max_candidates,
                config.max_steps, ignore=g_medium, impl=config.traversal)
            s_miss = s_hit.t >= BIG_F32
            s_sky = sample_sky(scene.sky, scan_d)
            s_sun = jnp.maximum(dot(s_hit.normal, scene.sun_dir), 0.0)
            s_unlit = (material_row(s_hit.mat) == 15) | (s_hit.mat == 255)
            approx_irr = jnp.where(
                s_unlit[:, None], 1.0,
                scene.sun_light * s_sun[:, None] + config.ambient)
            t_alb = jnp.where(s_miss[:, None], s_sky, s_hit.albedo)
            t_irr = jnp.where(s_miss[:, None], 1.0, approx_irr)
            alb_acc = alb_acc + jnp.where(later[:, None], t_alb * w, 0.0)
            irr_acc = irr_acc + jnp.where(later[:, None], t_irr * w, 0.0)

        # Stop after a scan unless both split weights stay significant
        # (materials.cpp:163-181); TIR-ish rays (refr < 0.2) reflect
        # internally and continue without touching `mul`.
        stop = do_refract & ((refl < 0.2) | (mul < 0.1))
        mul = jnp.where(g_live & do_refract, mul * refl, mul)
        g_live = g_live & ~stop
        int_d = reflect(i_d, i_hit.normal)
        i_o = jnp.where(g_live[:, None], exit_p + int_d * 1e-3, i_o)
        i_d = jnp.where(g_live[:, None], int_d, i_d)

    return cont_o, cont_d, cont_w, emitted, alb_acc, irr_acc


def shade_full(scene: SceneData, origins, dirs, hit, frame, config):
    """Full Whitted-style wavefront shading (materials.cpp:15-48 analog).

    The recursive mirror/glass evaluation is restructured as a bounded loop:
    each bounce intersects the wavefront once; mirror rays multiply the
    albedo throughput and continue (materials.cpp:95-114); glass rays run
    the internal-reflection sub-loop (`eval_glass_wavefront`) and continue
    along their first refracted exit with the Beer/Fresnel weight applied
    to BOTH throughputs (MatEval accumulates albedo and irradiance
    separately and the final color is their product).  Diffuse rays
    terminate with sphere-light + sun + ambient irradiance; shadow rays use
    the stochastic glass pass-through (vv.cpp:314-327) seeded per
    (ray, frame, bounce).  The glass sub-loop runs under `lax.cond` so
    scenes without glass pixels skip its cost at runtime.

    Live-ray compaction (config.compact): the WHOLE body first compacts
    to the rays that hit anything (miss pixels take the sky in
    render_rays and need no shading at all — a few % of a frame may
    survive), then each heavy stage inside — diffuse light queries, the
    glass sub-loop, the continuation trace — re-compacts to its own
    masked subset at the already-small size, where index construction
    is nearly free (the single full-size compaction is the only full-size
    index construction).  Per-row math is unchanged —
    noise/seed streams key on each ray's ORIGINAL index — so results
    are bit-equal on per-ray-independent backends.
    """
    n = origins.shape[0]
    use_compact = bool(getattr(config, "compact", False))
    full_idx = jnp.arange(n, dtype=jnp.int32)
    if not use_compact:
        return _shade_full_body(scene, origins, dirs, hit, frame, config,
                                full_idx)

    from voxel_tracer_tpu.ops.compact import bucket_caps, masked_apply

    caps = bucket_caps(n, getattr(config, "compact_fracs",
                                  (1 / 64, 1 / 16, 1 / 2)))
    unit_z = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
    mask0 = hit.t < BIG_F32

    def fn(lv, idx, o_g, d_g, t_g, nrm_g, mat_g, alb_g, obj_g):
        o_p = jnp.where(lv[:, None], o_g, 1e6)
        d_p = jnp.where(lv[:, None], d_g, unit_z)
        hit_g = composite.HitResult(
            t=jnp.where(lv, t_g, BIG_F32), mat=mat_g, normal=nrm_g,
            albedo=alb_g, steps=jnp.zeros_like(mat_g), obj=obj_g)
        return _shade_full_body(scene, o_p, d_p, hit_g, frame, config,
                                idx)

    return masked_apply(
        mask0, fn,
        (origins, dirs, hit.t, hit.normal, hit.mat, hit.albedo, hit.obj),
        (jnp.zeros((n, 3), jnp.float32), jnp.zeros((n, 3), jnp.float32)),
        caps)


def _shade_full_body(scene, origins, dirs, hit, frame, config, ray_idx):
    """shade_full's bounce loop at any wavefront size; ``ray_idx`` maps
    each row to its ORIGINAL ray index (n-sentinel on padding rows) so
    noise/seed streams are invariant under compaction."""
    n = origins.shape[0]
    use_compact = bool(getattr(config, "compact", False))
    if use_compact:
        from voxel_tracer_tpu.ops.compact import bucket_caps, masked_apply
        caps = bucket_caps(n, getattr(config, "compact_fracs",
                                      (1 / 64, 1 / 16, 1 / 2)))
    unit_z = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
    from voxel_tracer_tpu.ops.noise import _TEX_SIZE, sample_2d, sample_3d

    def gidx(idx):
        # local row -> original ray index (padding rows are don't-care)
        return jnp.take(ray_idx, idx, mode="clip")

    def noise3_at(idx):
        return sample_3d(idx % _TEX_SIZE, idx // _TEX_SIZE, frame)

    def noise2_at(idx):
        return sample_2d(idx % _TEX_SIZE, idx // _TEX_SIZE, frame)

    def seed_at(idx, bounce):
        return (idx.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
                + jnp.asarray(frame).astype(jnp.uint32)
                * jnp.uint32(2654435761)) \
            ^ jnp.uint32((0x85EBCA77 * (bounce + 1)) & 0xFFFFFFFF)

    if not use_compact:
        # full-wavefront samples, computed once for every bounce
        noise3 = noise3_at(ray_idx)
        noise2 = noise2_at(ray_idx)

    albedo_out = jnp.zeros((n, 3), jnp.float32)
    irr_out = jnp.zeros((n, 3), jnp.float32)
    thr_a = jnp.ones((n, 3), jnp.float32)   # albedo-side throughput
    thr_i = jnp.ones((n, 3), jnp.float32)   # irradiance-side throughput
    cur_o, cur_d = origins, dirs
    cur_hit = hit
    live = hit.t < BIG_F32

    for bounce in range(config.max_bounces):
        row = material_row(cur_hit.mat)
        is_unlit = (row == 15) | (cur_hit.mat == 255)
        is_glass = live & (row == 0) & ~is_unlit
        is_mirror = live & (row == 1) & ~is_unlit
        is_diffuse = live & ~(is_glass | is_mirror | is_unlit)

        p = hit_point(cur_o, cur_d, cur_hit.t, cur_hit.normal)

        # --- diffuse terminate ---------------------------------------------
        if use_compact:
            def _diff_fn(lv, idx, p_g, nrm_g):
                gi = gidx(idx)
                p_p = jnp.where(lv[:, None], p_g, 1e6)
                nrm_p = jnp.where(lv[:, None], nrm_g, unit_z)
                return diffuse_irradiance(
                    scene, p_p, nrm_p, noise3_at(gi), noise2_at(gi),
                    config, shadow_seed=seed_at(gi, bounce),
                    live=lv)

            irr = masked_apply(
                is_diffuse, _diff_fn, (p, cur_hit.normal),
                jnp.zeros((n, 3), jnp.float32), caps)
        else:
            irr = diffuse_irradiance(scene, p, cur_hit.normal, noise3,
                                     noise2, config,
                                     shadow_seed=seed_at(ray_idx, bounce))
        albedo_out = albedo_out + jnp.where(
            is_diffuse[:, None], thr_a * cur_hit.albedo, 0.0)
        irr_out = irr_out + jnp.where(is_diffuse[:, None], thr_i * irr, 0.0)

        # --- unlit terminate (laser/unlit rows, materials.cpp:23-27,39-42) -
        unlit_mask = live & is_unlit
        albedo_out = albedo_out + jnp.where(
            unlit_mask[:, None], thr_a * cur_hit.albedo, 0.0)
        irr_out = irr_out + jnp.where(unlit_mask[:, None], thr_i, 0.0)

        live = is_mirror | is_glass
        if bounce == config.max_bounces - 1:
            break

        # --- mirror bounce (materials.cpp:95-114) ---------------------------
        mir_d = reflect(cur_d, cur_hit.normal)

        # --- glass sub-loop, skipped at runtime when no glass pixel exists --
        def _glass(args):
            o, d, h_t, h_normal, h_mat, h_albedo, h_obj, g_mask = args

            def run(lv, _idx, o_g, d_g, t_g, nrm_g, mat_g, alb_g, obj_g):
                o_p = jnp.where(lv[:, None], o_g, 1e6)
                d_p = jnp.where(lv[:, None], d_g, unit_z)
                ghit = composite.HitResult(
                    t=t_g, mat=mat_g, normal=nrm_g, albedo=alb_g,
                    steps=jnp.zeros_like(mat_g), obj=obj_g)
                return eval_glass_wavefront(scene, o_p, d_p, ghit, lv,
                                            config)

            if not use_compact:
                return run(g_mask, None, o, d, h_t, h_normal, h_mat,
                           h_albedo, h_obj)
            out_fill = (o, d, jnp.ones((n, 3), jnp.float32),
                        jnp.zeros((n,), bool),
                        jnp.zeros((n, 3), jnp.float32),
                        jnp.zeros((n, 3), jnp.float32))
            return masked_apply(
                g_mask, run,
                (o, d, h_t, h_normal, h_mat, h_albedo, h_obj),
                out_fill, caps)

        def _no_glass(args):
            o, d, h_t, h_normal, h_mat, h_albedo, h_obj, g_mask = args
            return (o, d, jnp.ones((n, 3), jnp.float32),
                    jnp.zeros((n,), bool),
                    jnp.zeros((n, 3), jnp.float32),
                    jnp.zeros((n, 3), jnp.float32))

        cont_o, cont_d, cont_w, emitted, g_alb, g_irr = jax.lax.cond(
            jnp.any(is_glass), _glass, _no_glass,
            (cur_o, cur_d, cur_hit.t, cur_hit.normal, cur_hit.mat,
             cur_hit.albedo, cur_hit.obj, is_glass))

        # terminal contributions from internal reflections past the 1st exit
        albedo_out = albedo_out + thr_a * g_alb
        irr_out = irr_out + thr_i * g_irr

        # continuation ray + throughput updates
        next_o = jnp.where(is_glass[:, None], cont_o, p)
        next_d = jnp.where(is_glass[:, None], cont_d, mir_d)
        thr_a = jnp.where(is_mirror[:, None], thr_a * cur_hit.albedo, thr_a)
        thr_a = jnp.where(is_glass[:, None], thr_a * cont_w, thr_a)
        thr_i = jnp.where(is_glass[:, None], thr_i * cont_w, thr_i)
        live = is_mirror | (is_glass & emitted)

        # scan rays ignore their own medium until they see air
        ign = jnp.where(is_glass, cur_hit.mat, 0)
        cur_o, cur_d = next_o, next_d
        if use_compact:
            # the continuation's sky term rides inside the compacted fn
            # too, so only live rays sample the sky
            def _cont_fn(lv, _idx, o_g, d_g, ign_g, ta_g, ti_g):
                o_p = jnp.where(lv[:, None], o_g, 1e6)
                d_p = jnp.where(lv[:, None], d_g, unit_z)
                h = composite.intersect_scene(
                    scene, o_p, d_p, config.max_candidates,
                    config.max_steps, ignore=ign_g, impl=config.traversal)
                sky_g = sample_sky(scene.sky, d_p)
                m_g = (lv & (h.t >= BIG_F32))[:, None]
                return (h.t, h.mat, h.normal, h.albedo, h.steps, h.obj,
                        jnp.where(m_g, ta_g * sky_g, 0.0),
                        jnp.where(m_g, ti_g, 0.0))

            miss_fill = (jnp.full((n,), BIG_F32), jnp.zeros((n,), jnp.int32),
                         jnp.zeros((n, 3), jnp.float32),
                         jnp.zeros((n, 3), jnp.float32),
                         jnp.zeros((n,), jnp.int32),
                         jnp.full((n,), -1, jnp.int32),
                         jnp.zeros((n, 3), jnp.float32),
                         jnp.zeros((n, 3), jnp.float32))
            h_t, h_mat, h_nrm, h_alb, h_st, h_obj, sky_alb, sky_irr = \
                masked_apply(live, _cont_fn,
                             (cur_o, cur_d, ign, thr_a, thr_i), miss_fill,
                             caps)
            cur_hit = composite.HitResult(
                t=h_t, mat=h_mat, normal=h_nrm, albedo=h_alb, steps=h_st,
                obj=h_obj)
            albedo_out = albedo_out + sky_alb
            irr_out = irr_out + sky_irr
            live = live & (cur_hit.t < BIG_F32)
        else:
            cur_hit = composite.intersect_scene(
                scene, cur_o, cur_d, config.max_candidates,
                config.max_steps, ignore=ign, impl=config.traversal)
            sky = sample_sky(scene.sky, cur_d)
            missed = cur_hit.t >= BIG_F32
            albedo_out = albedo_out + jnp.where(
                (live & missed)[:, None], thr_a * sky, 0.0)
            irr_out = irr_out + jnp.where(
                (live & missed)[:, None], thr_i, 0.0)
            live = live & ~missed

    return albedo_out, irr_out
