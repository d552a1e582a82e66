"""Demo CLI: render a test scene to a PNG.

    python -m renderer_jax.demo --scene box --size 256 --out /tmp/box.png

The app-layer stand-in for the reference's winit window + game loop
(src/main.rs): the renderer runs headless, so frames are
written to disk (or streamed by the interactive runtime in
renderer_jax.runtime).
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np


def build_scene(name: str):
    import jax.numpy as jnp

    from renderer_jax import mathx
    from renderer_jax.scene import SceneBuilder, SceneLimits, primitives

    b = SceneBuilder(SceneLimits())
    if name == "box":
        box = b.add_mesh(primitives.box())
        red = b.add_material(base_color=(0.8, 0.25, 0.2, 1.0))
        b.add_instance(
            box, red,
            rotation=np.asarray(mathx.quat_from_axis_angle(jnp.array([0.0, 1.0, 0.0]), 0.6)),
        )
    elif name == "spheres":
        sph = b.add_mesh(primitives.uv_sphere(rings=24, sectors=48))
        plane = b.add_mesh(primitives.plane(size=20.0))
        floor = b.add_material(base_color=(0.6, 0.6, 0.62, 1.0))
        b.add_instance(plane, floor, translation=(0, -0.6, 0))
        for i in range(5):
            for j in range(5):
                m = b.add_material(
                    base_color=(0.2 + 0.2 * i, 0.25, 0.95 - 0.2 * j, 1.0),
                    roughness=0.1 + 0.2 * i,
                    metallic=0.25 * j,
                )
                b.add_instance(sph, m, translation=(i - 2.0, 0.0, j - 2.0), scale=0.45)
    elif name == "mixed":
        box = b.add_mesh(primitives.box())
        sph = b.add_mesh(primitives.uv_sphere(rings=16, sectors=24))
        tor = b.add_mesh(primitives.torus())
        plane = b.add_mesh(primitives.plane(size=12.0))
        b.add_instance(plane, b.add_material(base_color=(0.55, 0.55, 0.6, 1)), translation=(0, -0.8, 0))
        b.add_instance(box, b.add_material(base_color=(0.8, 0.3, 0.2, 1)), translation=(-1.4, 0, 0))
        b.add_instance(sph, b.add_material(base_color=(0.2, 0.5, 0.9, 1)), translation=(0, 0, 0), scale=0.8)
        b.add_instance(tor, b.add_material(base_color=(0.3, 0.8, 0.3, 1)), translation=(1.5, -0.2, 0), scale=0.7)
    elif name == "textured":
        plane = b.add_mesh(primitives.plane(size=16.0))
        sph = b.add_mesh(primitives.uv_sphere(rings=24, sectors=48))
        box = b.add_mesh(primitives.box())
        checker = b.add_texture(primitives.checkerboard_texture(256, squares=16))
        checker2 = b.add_texture(
            primitives.checkerboard_texture(256, squares=6, c0=(230, 120, 60), c1=(250, 235, 220))
        )
        floor = b.add_material(base_color=(1, 1, 1, 1), roughness=0.6, base_color_tex=checker)
        shiny = b.add_material(base_color=(1, 1, 1, 1), roughness=0.25, metallic=0.1, base_color_tex=checker2)
        metal = b.add_material(base_color=(0.95, 0.64, 0.54, 1), roughness=0.3, metallic=1.0)
        b.add_instance(plane, floor, translation=(0, -0.6, 0))
        b.add_instance(sph, shiny, translation=(-0.9, 0, 0), scale=1.1)
        b.add_instance(sph, metal, translation=(0.9, 0, 0), scale=1.1)
        b.add_instance(box, shiny, translation=(0, -0.1, -1.6))
    elif name == "skinned":
        from renderer_jax.models.scenes import skinned_scene

        return skinned_scene()
    elif name == "colonnade":
        # the committed GLB asset, through the from-scratch parser (its
        # procedural twin is models.scenes.colonnade_scene)
        import os

        from renderer_jax.models.scenes import _colonnade_lights
        from renderer_jax.scene.gltf import load_gltf

        path = os.path.join(os.path.dirname(__file__), "..", "assets",
                            "colonnade.glb")
        bb = load_gltf(path, SceneBuilder(SceneLimits()))
        _colonnade_lights(bb)
        return bb.build()
    elif name == "city":
        from renderer_jax.models.scenes import city_scene

        return city_scene()
    elif name.startswith("glb:"):
        from renderer_jax.models.scenes import _colonnade_lights
        from renderer_jax.scene.gltf import load_gltf

        bb = load_gltf(name[4:], SceneBuilder(SceneLimits()))
        _colonnade_lights(bb)  # default lights; GLB carries no lights
        return bb.build()
    else:
        raise SystemExit(
            f"unknown scene {name!r} (try: box, spheres, mixed, textured, "
            "skinned, colonnade, city, glb:<path>)"
        )
    b.add_light(position=(3.0, 5.0, 4.0), intensity=30.0)
    b.add_light(position=(-0.5, -1.0, -0.3), directional=True, intensity=0.35, shadow_slot=0)
    return b.build()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", default="box")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", default="render.png")
    ap.add_argument("--orbit", type=float, default=0.5, help="camera orbit angle (rad)")
    ap.add_argument("--frames", type=int, default=1, help="render N orbit frames (timing)")
    ap.add_argument("--debug-aabbs", action="store_true", help="draw culling AABBs")
    ap.add_argument("--freeze-culling", action="store_true")
    ap.add_argument("--pallas", action="store_true", help="use the Pallas tile rasterizer")
    ap.add_argument("--shadows", action="store_true", help="shadow-mapped directional light")
    ap.add_argument("--occlusion", action="store_true", help="two-pass occlusion culling")
    ap.add_argument("--rt", action="store_true", help="ray-traced shadows (small scenes)")
    ap.add_argument(
        "--reference-image", action="store_true",
        help="composite a low-res XLA-reference diff heatmap over the frame "
        "(ref: the reference_rt A/B blit)",
    )
    ap.add_argument("--ssaa", type=int, default=1, help="supersampling factor (MSAA parity)")
    ap.add_argument(
        "--shade-rate", default="full",
        choices=("full", "checkerboard", "quarter"),
        help="shade sample rate: checkerboard shades the (x+y)-even "
        "half-lattice exactly and reconstructs the rest from same-triangle "
        "neighbors (quality knob; ~20%% faster frames at the bench)",
    )
    ap.add_argument(
        "--no-shade-fix", action="store_true",
        help="disable the checkerboard edge fix (exact sparse re-shade of "
        "the worst reconstructed pixels; on by default)",
    )
    ap.add_argument("--hud", action="store_true", help="print the stats HUD")
    ap.add_argument(
        "--dump-graphs", action="store_true",
        help="write the frame graph + active plan as .dot to diagnostics/ "
        "(ref: diagnostics/ + live-diagnostics/ dumps)",
    )
    ap.add_argument(
        "--watch", action="store_true",
        help="hot-reload kernel modules between frames (ref: shader_reload)",
    )
    ap.add_argument(
        "--spmd", type=int, default=0, metavar="N",
        help="render over an N-device mesh (same frame graph under "
        "shard_map; on the CPU use JAX_PLATFORMS=cpu XLA_FLAGS="
        "--xla_force_host_platform_device_count=N; needs --pallas and "
        "size %% (N*16) == 0)",
    )
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from renderer_jax import mathx
    from renderer_jax.mathx.camera import Camera
    from renderer_jax.passes.pipeline import PipelineConfig
    from renderer_jax.runtime import Renderer
    from renderer_jax.utils.image import srgb_encode, write_png

    scene = build_scene(args.scene)
    spmd_mesh = None
    if args.spmd > 1:
        from renderer_jax.parallel import make_mesh

        devices = jax.devices()[: args.spmd]
        if len(devices) < args.spmd:
            raise SystemExit(
                f"--spmd {args.spmd}: only {len(devices)} devices visible "
                "(on the CPU: JAX_PLATFORMS=cpu XLA_FLAGS="
                f"--xla_force_host_platform_device_count={args.spmd})"
            )
        spmd_mesh = make_mesh(devices)
    # heavy scenes need a bigger post-cull budget than the demo default
    # (the city canyon holds ~127k frustum-visible triangles; a 16k cap
    # silently truncates to the first buildings in instance order)
    tri_capacity = 1 << 18 if args.scene == "city" else 16384
    renderer = Renderer(
        scene,
        PipelineConfig(
            width=args.size, height=args.size, tri_capacity=tri_capacity,
            use_pallas=args.pallas, skinning=(args.scene == "skinned"),
            ssaa=args.ssaa,
            shade_rate=args.shade_rate,
            shade_fix=not args.no_shade_fix,
            spmd_devices=max(args.spmd, 1),
        ),
        outputs=("image", "vis", "soup", "prepared") if args.hud else ("image", "vis"),
        spmd_mesh=spmd_mesh,
    )
    renderer.set_config(
        debug_aabbs=args.debug_aabbs, freeze_culling=args.freeze_culling,
        shadows=args.shadows, occlusion_culling=args.occlusion, rt=args.rt,
        reference_image=args.reference_image,
    )
    renderer.apply_config_now()  # apply immediately for the CLI

    if args.dump_graphs:
        from renderer_jax.graph.dot import dump

        plan = renderer.plans.plan(renderer.config.as_dict())
        paths = dump(renderer.graph, [plan], directory="diagnostics")
        print("wrote " + ", ".join(paths))

    def make_camera(angle):
        if args.scene == "city":
            # street-level canyon walk (the occlusion design point), not
            # the small-scene orbit
            pos = jnp.array([0.0, 2.0, 70.0 - 20.0 * angle], jnp.float32)
            rot = mathx.quat_from_axis_angle(
                jnp.array([0.0, 1.0, 0.0]), 0.15 * math.sin(angle)
            )
            return Camera.create(
                position=pos, rotation=rot, fov_y=0.9, near=0.1, far=400.0
            )
        r = 14.0 if args.scene == "colonnade" else 4.0
        h = 3.0 if args.scene == "colonnade" else 1.6
        pos = jnp.array([r * math.sin(angle), h, r * math.cos(angle)], jnp.float32)
        rot = mathx.quat_mul(
            mathx.quat_from_axis_angle(jnp.array([0.0, 1.0, 0.0]), angle),
            mathx.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), -0.35),
        )
        return Camera.create(position=pos, rotation=rot, fov_y=0.9, near=0.1, far=100.0)

    t0 = time.time()
    out = renderer.render(make_camera(args.orbit), time_s=0.0)
    jax.block_until_ready(out["image"])
    print(f"first frame (incl. compile): {time.time() - t0:.2f}s on {jax.devices()[0].platform}")

    reloader = None
    if args.watch:
        from renderer_jax.runtime import KernelReloader

        reloader = KernelReloader(renderer)

    if args.frames > 1:
        t0 = time.time()
        for k in range(args.frames):
            if reloader is not None and reloader.poll():
                print(f"[watch] kernels reloaded at frame {k}")
            out = renderer.render(make_camera(args.orbit + 0.02 * k), time_s=k / 60.0)
        jax.block_until_ready(out["image"])
        dt = (time.time() - t0) / args.frames
        print(f"steady-state: {dt * 1e3:.1f} ms/frame ({1.0 / dt:.1f} FPS)")

    img, vis = out["image"], out["vis"]
    covered = float(np.mean(np.asarray(vis.tri_id) != -1))
    print(f"coverage: {covered:.1%}")
    if args.hud:
        from renderer_jax.ops.overlay import hud_overlay
        from renderer_jax.runtime.hud import format_hud

        text = format_hud(
            renderer, extra={"coverage": f"{covered:.1%}"},
            soup=out.get("soup") if args.pallas else None,
            prepared=out.get("prepared"),
        )
        print(text)
        # burn the HUD into the frame (the imgui pass, ref renderer.rs:1799+)
        renderer.set_config(hud=True)
        renderer.apply_config_now()
        out = renderer.render(
            make_camera(args.orbit), time_s=0.0,
            overlay=hud_overlay(text, args.size),
        )
        img = out["image"]
    write_png(args.out, srgb_encode(np.asarray(img)))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
