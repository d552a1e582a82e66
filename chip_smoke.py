"""Smoke run of the renderer on NVIDIA GPUs, through its user entry points.

    python chip_smoke.py            # one GPU: phases 1-4 below
    python chip_smoke.py --mesh 4   # four GPUs: the SPMD frame vs one card

One process drives the card(s). With no GPU it exits non-zero and prints
no result.

Phases on one GPU, each failing the run if it fails:
1. kernels — the tile raster kernel (ops/raster_pallas.py) and the rt
   occlusion kernel (ops/rt_grid.py), compiled for the card at the bench's
   widths (bench scene, 1920x1088, T=131072; the rt tier's half-resolution
   receiver grid), checked against their plain-XLA references, with
   kernel-vs-XLA times.
2. frames — the bench configuration (bench.py) through Renderer: base exact,
   base checkerboard+fix, shadowed static, shadowed dynamic. Each frame is
   finite, covers pixels and overflows no raster bin; compile seconds,
   steady ms, peak device memory and the checkerboard 40 dB gate printed.
3. demo — renderer_jax.demo.main in-process (textured scene, shadows and
   one rt frame); the PNG it writes is read back.
4. GPU checks — the checks of tests/test_gpu.py (renderer_jax/gpu_checks.py).

With --mesh N only the SPMD frame of the bench scene over an N-device mesh
and the one-card frame it is compared with run.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import tempfile
import time

import bench

STEADY_FRAMES = 5
KERNEL_REPS = 5
SPMD_ATOL = 2e-6  # tests/test_parallel.py's SPMD-vs-one-device image tolerance


def _ms(fn, reps=KERNEL_REPS):
    """(first call s incl. compile, median steady ms, last output) of fn(),
    each call ending in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return first, statistics.median(times), out


def _peak_bytes(device=None):
    import jax

    device = device or jax.devices()[0]
    return (device.memory_stats() or {}).get("peak_bytes_in_use", -1)


def _say(*parts):
    print(*parts, flush=True)


def bench_probe(scene, cfg):
    """One base frame of the bench config: (soup, vis, prepared)."""
    from renderer_jax.runtime import Renderer

    out = Renderer(scene, cfg, outputs=("soup", "vis", "prepared")).render(
        bench.make_camera(0.3)
    )
    return out["soup"], out["vis"], out["prepared"]


def phase_kernels(scene, cfg):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from renderer_jax import gpu_checks
    from renderer_jax.ops.geometry import mats44, unproject_depth
    from renderer_jax.ops.raster_jax import rasterize
    from renderer_jax.ops.raster_pallas import bin_overflow_tiles, rasterize_pallas
    from renderer_jax.ops.rt_grid import (
        directional_inputs,
        occlusion_dense,
        occlusion_grid,
    )
    from renderer_jax.ops.shadow import directional_light_matrices

    w, h = cfg.width, cfg.height
    soup, vis, prepared = bench_probe(scene, cfg)
    _say(f"[kernels] bench soup: {int(soup.count)} visible of {soup.clip.shape[0]} "
         f"triangles, {w}x{h}")

    # -- tile raster kernel vs the unbinned XLA rasterizer ------------------
    def kern():
        return rasterize_pallas(soup.clip, soup.valid, w, h, with_bary=False)

    def xla():
        return rasterize(soup.clip, soup.valid, w, h, count=soup.count)

    compiled = rasterize_pallas.lower(
        soup.clip, soup.valid, w, h, with_bary=False
    ).compile()
    _say(f"[kernels] raster memory_analysis: {compiled.memory_analysis()}")
    k_first, k_ms, got = _ms(kern)
    _, b_ms, _ = _ms(lambda: bin_overflow_tiles(soup.clip, soup.valid, w, h))
    x_first, x_ms, want = _ms(xla, reps=1)
    stats = gpu_checks.compare_vis(got.tri_id, got.depth, want.tri_id, want.depth)
    _say(f"[kernels] raster triton vs xla: {stats}")
    _say(f"[kernels] raster triton {k_ms:.3f} ms (setup+binning alone {b_ms:.3f} ms; "
         f"first call {k_first:.1f} s) | xla unbinned {x_ms:.3f} ms "
         f"(first call {x_first:.1f} s)")
    assert stats["id_agreement"] >= gpu_checks.ID_AGREEMENT, stats
    assert stats["depth_max_err"] <= gpu_checks.DEPTH_ATOL, stats
    assert stats["covered"] > 0.5, stats
    overflow = int(bin_overflow_tiles(soup.clip, soup.valid, w, h))
    assert overflow == 0, f"{overflow} raster tiles overflowed their bin list"

    # -- rt occlusion kernel vs dense XLA, at the rt tier's receiver grid ---
    s, off = cfg.rt_scale, cfg.rt_scale // 2
    lights = scene.lights
    li = int(np.argmax(np.asarray((lights.shadow_slot == 0) & lights.alive)))
    with jax.default_matmul_precision("highest"):
        world = unproject_depth(vis.depth, prepared[7], w, h)[:, off::s, off::s]
        live = (vis.tri_id != -1)[off::s, off::s]
        hcf = jnp.concatenate([world, jnp.ones((1,) + world.shape[1:], jnp.float32)])
        mats = directional_light_matrices(lights, prepared[5], prepared[6])
        args = jax.jit(
            directional_inputs, static_argnames=("caster_capacity",)
        )(scene, mats[li], hcf, live, mats44(prepared[0]), prepared[4],
          caster_capacity=cfg.tri_capacity, depth_eps=1.5e-3)
    _say(f"[kernels] rt casters: {int(args[1].sum())} live of {args[0].shape[0]}, "
         f"receivers {args[2].shape}")
    g_first, g_ms, occ_k = _ms(lambda: occlusion_grid(*args))
    d_first, d_ms, occ_d = _ms(lambda: occlusion_dense(*args), reps=1)
    occ_k, occ_d = np.asarray(occ_k), np.asarray(occ_d)
    agree = float((occ_k == occ_d).mean())
    _say(f"[kernels] rt triton vs dense xla: agreement {agree:.6f}, shadowed "
         f"{float((occ_d == 0).mean()):.4f}")
    _say(f"[kernels] rt triton {g_ms:.3f} ms (first call {g_first:.1f} s) | xla "
         f"dense {d_ms:.3f} ms (first call {d_first:.1f} s)")
    assert agree >= gpu_checks.ID_AGREEMENT, agree


def _frame_mode(name, scene, cfg, shadows, dynamic):
    """Compile + steady frames of one bench mode; returns gate-pose frames."""
    import jax
    import numpy as np

    from renderer_jax.ops.overlay import Overlay
    from renderer_jax.runtime import Renderer

    r = Renderer(scene, cfg, outputs=("image",))  # bench.py's program
    if shadows:
        r.set_config(shadows=True)
        r.apply_config_now()
    base_tr = np.asarray(scene.instances.translation).copy()

    def scene_at(k):
        return bench._mover_scene(scene, base_tr, float(k)) if dynamic else None

    t0 = time.perf_counter()
    out = jax.block_until_ready(r.render(bench.make_camera(0.3), scene=scene_at(0)))
    compile_s = time.perf_counter() - t0
    if name == "base_exact":
        plan = r.plans.plan(r.config.as_dict())
        mem = r._jit_for(plan).lower(
            r.state, r.scene, bench.make_camera(0.3), np.float32(0.0), Overlay.empty()
        ).compile().memory_analysis()
        _say(f"[frames] frame program memory_analysis: {mem}")
    t0 = time.perf_counter()
    for k in range(1, STEADY_FRAMES + 1):
        out = r.render(bench.make_camera(0.3 + 0.01 * k), scene=scene_at(k))
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) / STEADY_FRAMES * 1e3
    img = np.asarray(out["image"])
    coverage = float((np.asarray(r.state["vis"].tri_id) != -1).mean())
    _say(f"[frames] {name}: compile {compile_s:.1f} s, steady {ms:.3f} ms/frame "
         f"over {STEADY_FRAMES} frames, coverage {coverage:.4f}, "
         f"peak_bytes_in_use {_peak_bytes()}")
    assert img.shape == (cfg.height, cfg.width, 3), img.shape
    assert np.isfinite(img).all(), f"{name}: non-finite pixels"
    assert coverage > 0.5, f"{name}: coverage {coverage}"
    frames = {}
    if not dynamic:
        for a in bench.GATE_ANGLES:
            frames[a] = np.clip(np.asarray(r.render(bench.make_camera(a))["image"]), 0, 1)
    return frames


def phase_frames(scene, cfg):
    import numpy as np

    from renderer_jax.ops.raster_pallas import bin_overflow_tiles
    from renderer_jax.runtime import Renderer

    probe = Renderer(scene, cfg, outputs=("soup",))
    overflow = 0
    for k in range(0, bench.FRAMES, 6):
        soup = probe.render(bench.make_camera(0.3 + 0.01 * k))["soup"]
        overflow += int(bin_overflow_tiles(soup.clip, soup.valid, cfg.width, cfg.height))
    del probe
    assert overflow == 0, f"{overflow} raster tile bin lists overflowed over the orbit"
    cfg_cb = dataclasses.replace(cfg, shade_rate="checkerboard", shade_fix=True)
    exact = _frame_mode("base_exact", scene, cfg, False, False)
    cb = _frame_mode("base_checkerboard_fix", scene, cfg_cb, False, False)
    sh = _frame_mode("shadowed_static", scene, cfg_cb, True, False)
    _frame_mode("shadowed_dynamic", scene, bench.dynamic_config(cfg_cb), True, True)
    gate = bench.psnr_min(exact, cb)
    golden = bench.psnr_vs_golden(sh)
    _say(f"[frames] checkerboard+fix gate (min over {len(exact)} poses): "
         f"{gate:.2f} dB -> {'PASS' if gate >= bench.GATE_DB else 'FAIL'} "
         f"(gate {bench.GATE_DB} dB); psnr_vs_golden_db {golden:.2f}")
    assert gate >= bench.GATE_DB, f"checkerboard+fix gate {gate:.2f} dB"
    assert np.isfinite(golden) and golden > 0, golden


def phase_demo():
    from renderer_jax import demo
    from renderer_jax.utils.image import read_png

    with tempfile.TemporaryDirectory() as d:
        for name, extra in (("shadows", ["--shadows"]), ("rt", ["--rt"])):
            path = os.path.join(d, f"demo_{name}.png")
            demo.main(["--scene", "textured", "--size", "512", "--pallas",
                       *extra, "--out", path])
            img = read_png(path)
            _say(f"[demo] {name}: {img.shape}, mean {img.mean():.2f}, std {img.std():.2f}")
            assert img.shape == (512, 512, 3), img.shape
            assert img.std() > 5.0, "demo image is flat"


def phase_gpu_checks():
    from renderer_jax import gpu_checks

    for check in gpu_checks.GPU_CHECKS:
        t0 = time.perf_counter()
        result = check()
        _say(f"[gpu checks] {check.__name__}: PASS ({time.perf_counter() - t0:.1f} s)")
        if check is gpu_checks.check_raster_spec:
            for case, s in result.items():
                _say(f"    {case}: {s}")
        else:
            _say(f"    {result}")


def phase_mesh(n, scene, cfg):
    """The SPMD frame graph over an n-device mesh vs the one-card frame."""
    import jax
    import numpy as np

    from renderer_jax.parallel import make_mesh
    from renderer_jax.runtime import Renderer

    devices = jax.devices()[:n]
    assert len(devices) == n, f"--mesh {n}: only {len(jax.devices())} devices"
    cam = bench.make_camera(0.3)

    def run(renderer):
        t0 = time.perf_counter()
        out = jax.block_until_ready(renderer.render(cam))
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(STEADY_FRAMES):
            out = renderer.render(cam)
        jax.block_until_ready(out)
        return out, first, (time.perf_counter() - t0) / STEADY_FRAMES * 1e3

    out1, c1, ms1 = run(Renderer(scene, cfg, outputs=("image", "vis")))
    cfg_n = dataclasses.replace(cfg, spmd_devices=n)
    outn, cn, msn = run(Renderer(scene, cfg_n, outputs=("image", "vis"),
                                 spmd_mesh=make_mesh(devices)))
    _say(f"[mesh] one card: compile {c1:.1f} s, steady {ms1:.3f} ms/frame")
    _say(f"[mesh] {n} cards: compile {cn:.1f} s, steady {msn:.3f} ms/frame")
    rows = {}
    for shard in outn["vis"].tri_id.addressable_shards:
        rows[shard.device.id] = (shard.index[0].start, shard.index[0].stop)
    _say(f"[mesh] tri_id row shards per device: {rows}")
    assert len(rows) == n and len(set(rows.values())) == n, rows
    peaks = {d.id: _peak_bytes(d) for d in devices}
    _say(f"[mesh] peak_bytes_in_use per device: {peaks}")
    assert all(p > 0 for p in peaks.values()), peaks
    from renderer_jax import gpu_checks

    vis1, visn = out1["vis"], outn["vis"]
    cov1 = np.asarray(vis1.tri_id) != -1
    # triangle ids index each device's own stream, so coverage is compared
    cov_equal = bool((cov1 == (np.asarray(visn.tri_id) != -1)).all())
    depth_err = float(np.abs(np.asarray(vis1.depth) - np.asarray(visn.depth))[cov1].max())
    err = np.abs(np.asarray(out1["image"]) - np.asarray(outn["image"])).max(-1)
    off = err > SPMD_ATOL
    _say(f"[mesh] coverage equal: {cov_equal}; depth max abs err {depth_err:.3e}; "
         f"image max abs err {float(err.max()):.3e}; pixels > {SPMD_ATOL} "
         f"(tests/test_parallel.py atol): {int(off.sum())} of {off.size}")
    # Pixels over the atol with equal depth are depth ties between coplanar
    # triangles: the winner is the first in stream order, and the SPMD
    # stream is ordered device by device.
    assert np.isfinite(np.asarray(outn["image"])).all()
    assert cov_equal, "SPMD coverage differs from one card"
    assert depth_err <= gpu_checks.DEPTH_ATOL, depth_err
    assert off.mean() <= 1e-4, int(off.sum())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run only the SPMD frame over N GPUs and its one-card match")
    args = ap.parse_args(argv)

    import jax

    from renderer_jax.models import sponza_like_scene

    device = bench.gpu_device()  # exits non-zero without a GPU
    _say(f"device_kind: {device['kind']}, device count: {device['count']}")
    _say(f"nvidia-smi: {device['nvidia_smi']}")
    scene = sponza_like_scene(bench.N_INSTANCES)
    cfg = bench.bench_config()
    if args.mesh:
        phase_mesh(args.mesh, scene, cfg)
    else:
        for name, fn in (("kernels", lambda: phase_kernels(scene, cfg)),
                         ("frames", lambda: phase_frames(scene, cfg)),
                         ("demo", phase_demo),
                         ("gpu checks", phase_gpu_checks)):
            t0 = time.perf_counter()
            fn()
            _say(f"== phase {name}: PASS ({time.perf_counter() - t0:.1f} s)")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)


if __name__ == "__main__":
    main()
