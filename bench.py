"""Headline benchmark: Sponza-class instanced scene at 1080p on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": fps, "unit": "frames/sec", "vs_baseline": fps/60,
   "device": {"platform", "kind", "count", "power_limit"}, ...}

Baseline target (BASELINE.md): >= 60 FPS at 1080p for a Sponza-class scene
with 10k frustum-culled instances on one NVIDIA H100. Also reports
Mtris/s. It needs a GPU: with none it exits non-zero and measures nothing.

What is measured (the FULL-FEATURED frame):
- The scene carries tangent-space normal maps and every material uses them
  (the reference normal-maps every pixel, gltf_mesh.frag:46-71).
- Edge-aware AA is ON (the production tier standing in for the reference's
  always-on 4xMSAA; ops/aa.py).
- Three tiers: base (no shadows); shadowed STATIC orbit (amortized atlas,
  zero per-frame atlas work once converged — the JSON says so); shadowed
  DYNAMIC (one scripted moving caster, so the number contains real
  per-frame atlas updates through the per-band dirty tracking +
  progressive band renders of ops/shadow.py, with the measured
  `shadow_updates_per_frame`).
- Two shading modes per tier: the exact full-rate path, and the
  checkerboard+fix mode (a production variable-rate-shading knob). The fast
  mode is reported ONLY when its display-clamped PSNR — measured IN THIS
  RUN vs this repo's exact frame, at the MINIMUM over several orbit poses —
  passes 40 dB. That gate is fidelity vs the exact path of the SAME
  renderer; `psnr_basis` says so explicitly, and `psnr_vs_golden_db`
  additionally tracks fidelity against the COMMITTED golden frame set
  (assets/golden, scripts/make_golden.py) as a cross-round series.
- Headline promotion: `value` is the base tier until the DYNAMIC shadowed
  tier passes 30 FPS and its gate — then the shadowed tier (the
  reference's actual always-on configuration) becomes the headline
  (`headline_tier`).
"""

import dataclasses
import json
import math
import time


WIDTH, HEIGHT = 1920, 1088  # 1080p padded to the 16-row raster tile
N_INSTANCES = 10000
TRI_CAPACITY = 1 << 17  # post-cull capacity (expansion capacity is 2x this)
FRAMES = 30
TARGET_FPS = 60.0
GATE_DB = 40.0
# dynamic tier: per-band dirty tracking, 16 bands/slot (32-row band
# renders). The worst band demand is ~70.5k light-LOD triangles against a
# whole-slot demand of ~460k, so whole-slot renders at this capacity would
# truncate most casters; per-band rendering keeps the caster set complete
# at the camera path's capacity.
SHADOW_PROGRESSIVE = 16
SHADOW_BAND_CAPACITY = 131072
PROMOTE_SHADOWED_FPS = 30.0  # shadowed tier becomes the headline past this
# PSNR gate poses: spread across the timed orbit (a single-pose gate can
# pass while other views fail)
GATE_ANGLES = (0.3, 0.3 + 0.005 * FRAMES, 0.3 + 0.01 * (FRAMES - 1))


def make_camera(angle: float):
    # Pure-numpy camera construction: eager jnp quat math would be a
    # handful of device dispatches per frame; the jit call moves the six
    # tiny arrays in one transfer.
    import numpy as np

    from renderer_jax.mathx.camera import Camera

    r = 18.0
    pos = np.array([r * math.sin(angle), 6.0, r * math.cos(angle)], np.float32)

    def axis_angle(ax, a):
        s = math.sin(a / 2.0)
        return np.array(
            [math.cos(a / 2.0), ax[0] * s, ax[1] * s, ax[2] * s], np.float32
        )

    qa = axis_angle((0.0, 1.0, 0.0), angle)
    qb = axis_angle((1.0, 0.0, 0.0), -0.3)
    w1, x1, y1, z1 = qa
    w2, x2, y2, z2 = qb
    rot = np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        np.float32,
    )
    return Camera(
        position=pos,
        rotation=rot,
        fov_y=np.float32(0.9),
        aspect=np.float32(WIDTH / HEIGHT),
        near=np.float32(0.1),
        far=np.float32(200.0),
    )


MOVER_INSTANCE = 1  # first non-floor instance: the scripted dynamic caster


def _mover_scene(scene, base_translation, k: float):
    """Scene with the scripted caster at its frame-k orbit position.

    Host-numpy translation table (no eager jnp per frame); the lights
    pytree is shared so the Renderer's light-contract
    check stays on its cached fast path."""
    import numpy as np

    t = base_translation.copy()
    t[MOVER_INSTANCE] = (
        4.0 * math.sin(0.7 * k), 1.5 + 0.5 * math.sin(1.3 * k),
        4.0 * math.cos(0.7 * k),
    )
    return scene._replace(
        instances=scene.instances._replace(translation=t)
    )


def _measure_mode(scene, cfg, shadows: bool, dynamic: bool = False,
                  warmup: int = 1):
    """Timed orbit + gate-pose frames for one (config, shadows) mode.

    Returns (ms_per_frame, {angle: clamped uint8-free f32 frame}).
    dynamic=True moves one scripted caster every frame (real per-frame
    shadow-atlas work — the amortized cache cannot converge). The
    donated-state chain serializes frames on device; the timed window
    ends in block_until_ready."""
    import jax
    import numpy as np

    from renderer_jax.runtime import Renderer

    renderer = Renderer(scene, cfg, outputs=("image",))
    if shadows:
        renderer.set_config(shadows=True)
        renderer.apply_config_now()
    base_tr = np.asarray(scene.instances.translation).copy()

    def scene_at(k):
        return _mover_scene(scene, base_tr, float(k)) if dynamic else None

    out = renderer.render(make_camera(0.3), scene=scene_at(-warmup))
    for w in range(1, warmup):  # converge the progressive atlas units
        out = renderer.render(make_camera(0.3), scene=scene_at(w - warmup))
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for k in range(FRAMES):
        out = renderer.render(make_camera(0.3 + 0.01 * k), scene=scene_at(k))
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / FRAMES

    updates = None
    if dynamic and cfg.shadow_cache:
        # measured shadow work per frame (the JSON says how much atlas
        # work the shadowed number actually contains): count
        # dirty-unit re-renders over a few extra frames via the cache
        # signature (tiny fetch, outside the timed loop)
        sig_prev = np.asarray(renderer.state["shadow_cache"][1])
        changed = []
        for k in range(FRAMES, FRAMES + 8):
            renderer.render(make_camera(0.3 + 0.01 * k), scene=scene_at(k))
            sig = np.asarray(renderer.state["shadow_cache"][1])
            diff = (sig != sig_prev).reshape(-1, sig.shape[-1])
            changed.append(int(diff.any(axis=-1).sum()))  # units re-rendered
            sig_prev = sig
        updates = float(np.mean(changed))

    frames = {}
    if not dynamic:
        for a in GATE_ANGLES:
            img = np.asarray(renderer.render(make_camera(a))["image"])
            frames[a] = np.clip(img, 0.0, 1.0)
    del renderer
    return (dt, frames) if not dynamic else (dt, updates)


def psnr_min(frames_a, frames_b) -> float:
    """MIN display-clamped PSNR across the gate poses."""
    import numpy as np

    worst = float("inf")
    for a in frames_a:
        mse = float(np.mean(np.square(frames_a[a] - frames_b[a])))
        worst = min(worst, 10.0 * math.log10(1.0 / max(mse, 1e-12)))
    return worst


def gpu_device() -> dict:
    """The device every number is measured on; raises SystemExit when JAX
    finds no GPU (a measurement never falls back to the CPU). power_limit
    is nvidia-smi's, read by a child process that stays off JAX."""
    import subprocess

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default device platform is {devices[0].platform!r}"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "power_limit": smi[0].split(",")[-1].strip(),
        "nvidia_smi": smi[0],
    }


def bench_config():
    """The bench's PipelineConfig (base tier, exact shading)."""
    from renderer_jax.passes.pipeline import PipelineConfig

    return PipelineConfig(
        width=WIDTH,
        height=HEIGHT,
        tri_capacity=TRI_CAPACITY,
        use_pallas=True,
        shading="pbr",
        enable_normal_maps=True,  # the scene carries normal maps
        aa="edge",                # production AA tier always on
        trilinear=False,  # bilinear + nearest mip (GPU 'performance' filtering)
    )


def dynamic_config(cfg_cb):
    """The shadowed DYNAMIC tier's config: per-band dirty tracking +
    budget-1 progressive renders (ops/shadow.py)."""
    return dataclasses.replace(
        cfg_cb, shadow_update_budget=1,
        shadow_progressive=SHADOW_PROGRESSIVE,
        shadow_tri_capacity=SHADOW_BAND_CAPACITY,
    )


def main():
    import numpy as np

    from renderer_jax.models import sponza_like_scene
    from renderer_jax.runtime import Renderer

    device = gpu_device()
    scene = sponza_like_scene(N_INSTANCES)
    cfg = bench_config()
    cfg_cb = dataclasses.replace(cfg, shade_rate="checkerboard", shade_fix=True)

    # visible-triangle count for Mtris/s: averaged over the timed orbit's
    # camera range (a single-angle probe over/understates by a few %).
    # The same soups feed the raster bin-overflow check: an overflowed tile
    # silently degrades to walk-all-blocks (raster_pallas.py), so the bench
    # must warn — a clean FPS number with overflowing bins is misleading.
    probe = Renderer(scene, cfg, outputs=("soup",))
    probe_angles = [0.3 + 0.01 * k for k in range(0, FRAMES, max(1, FRAMES // 5))]
    counts = []
    overflow = 0
    for a in probe_angles:
        soup = probe.render(make_camera(a))["soup"]
        counts.append(int(np.asarray(soup.count)))
        from renderer_jax.ops.raster_pallas import bin_overflow_tiles

        overflow += int(bin_overflow_tiles(soup.clip, soup.valid, WIDTH, HEIGHT))
    tri_count = float(np.mean(counts))
    if overflow:
        import sys

        print(
            f"WARNING: {overflow} raster tile bin-lists overflowed across "
            f"{len(probe_angles)} probe frames (walk-all fallback active)",
            file=sys.stderr,
        )
    del probe

    # -- base tier (no shadows) ---------------------------------------------
    dt_exact, frames_exact = _measure_mode(scene, cfg, shadows=False)
    dt_cb, frames_cb = _measure_mode(scene, cfg_cb, shadows=False)
    psnr_base = psnr_min(frames_exact, frames_cb)

    # -- full-featured tier: shadows ON (amortized atlas) -------------------
    dt_sh_exact, frames_sh_exact = _measure_mode(scene, cfg, shadows=True)
    dt_sh_cb, frames_sh_cb = _measure_mode(scene, cfg_cb, shadows=True)
    psnr_sh = psnr_min(frames_sh_exact, frames_sh_cb)

    # -- DYNAMIC shadowed tier: one scripted moving caster ------------------
    # (the static orbit's converged cache does zero atlas work; this tier
    # pays real per-frame updates)
    cfg_dyn = dynamic_config(cfg_cb)
    n_units = cfg_dyn.shadow_slots * SHADOW_PROGRESSIVE
    dt_dyn, dyn_updates = _measure_mode(
        scene, cfg_dyn, shadows=True, dynamic=True, warmup=n_units + 1,
    )

    # -- fidelity vs the committed golden frames (cross-round gate) ---------
    golden_psnr = psnr_vs_golden(
        frames_sh_cb if psnr_sh >= GATE_DB else frames_sh_exact
    )

    print(json.dumps(result_line(
        device, tri_count,
        dt_exact, dt_cb, psnr_base,
        dt_sh_exact, dt_sh_cb, psnr_sh,
        dyn_dt=dt_dyn, dyn_updates=dyn_updates, golden_psnr=golden_psnr,
    )))


GOLDEN_DIR = "assets/golden"


def psnr_vs_golden(frames) -> float:
    """MIN PSNR of this run's shadowed frames vs the committed golden set.

    The goldens (scripts/make_golden.py) are max-quality renders — exact
    shading, SSAA 2x2 resolve, trilinear, shadows on — at the gate poses,
    committed as PNGs. The number is a CROSS-ROUND fidelity series (the
    in-run gate is self-referential): it stays
    flat while shading is stable and moves when a round changes the image,
    independent of what that round's in-run gate says. The absolute level
    reflects deliberate tier differences (edge AA vs SSAA, bilinear vs
    trilinear, 8-bit quantization), not error vs ground truth.
    Returns -1.0 when no golden set is committed."""
    import os

    import numpy as np

    from renderer_jax.utils.image import read_png

    worst = float("inf")
    for i, a in enumerate(GATE_ANGLES):
        path = os.path.join(os.path.dirname(__file__) or ".",
                            GOLDEN_DIR, f"shadowed_pose{i}.png")
        if not os.path.exists(path):
            return -1.0
        ref = read_png(path).astype(np.float32) / 255.0  # u8 PNG -> [0,1]
        img = frames[a]
        if ref.shape != img.shape:
            return -1.0
        mse = float(np.mean(np.square(ref - img)))
        worst = min(worst, 10.0 * math.log10(1.0 / max(mse, 1e-12)))
    return worst


def result_line(device, tri_count, dt, cb_dt, cb_psnr,
                sh_dt=None, sh_cb_dt=None, sh_psnr=None,
                dyn_dt=None, dyn_updates=None, golden_psnr=None):
    """Headline selection (pure function; tests/test_bench.py covers the
    branches hermetically).

    Within each tier the reported mode is the checkerboard+fix shading
    mode when its measured min-over-poses PSNR vs this run's exact frame
    passes the 40 dB gate, else the exact path. The active mode ships in
    `shade_rate`/`headline_mode`, and both modes' numbers are always
    present, so JSON consumers can track either series. `psnr_basis`
    records what the gate compares against (the Vulkan reference frame is
    not available in this environment — the gate is fidelity of the fast
    mode vs the exact mode of the SAME renderer); `psnr_vs_golden_db` is
    the cross-round series vs the committed golden frames.

    `device` names what was measured: platform, kind, count and power
    limit (gpu_device()).

    TIER promotion: the reference never renders an
    unshadowed frame, so once the DYNAMIC shadowed tier — real per-frame
    atlas updates from a scripted moving caster
    (`shadowed_dynamic_fps`, with its measured `shadow_updates_per_frame`)
    — passes 30 FPS and the shadowed gate, IT becomes the driver-tracked
    `value` (`headline_tier: "shadowed_dynamic"`); otherwise `value`
    stays the base tier and all tiers are reported."""
    fps = 1.0 / dt
    gate_ok = cb_psnr >= GATE_DB
    head_fps = (1.0 / cb_dt) if gate_ok else fps
    head_dt = cb_dt if gate_ok else dt
    out = {
        "metric": f"sponza_like_{N_INSTANCES}inst_{WIDTH}x{HEIGHT}_fps",
        "value": round(head_fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(head_fps / TARGET_FPS, 3),
        "mtris_per_sec": round(tri_count * head_fps / 1e6, 1),
        "visible_triangles": int(tri_count),
        "frame_ms": round(head_dt * 1e3, 2),
        "headline_tier": "base",
        "headline_mode": "checkerboard+fix" if gate_ok else "full",
        "shade_rate": "checkerboard+fix" if gate_ok else "full",
        "features": "normal_maps+edge_aa",
        "psnr_basis": "vs_exact_same_config_min_over_3_poses",
        "exact_path_fps": round(fps, 2),
        "exact_path_frame_ms": round(dt * 1e3, 2),
        "checkerboard_fix_fps": round(1.0 / cb_dt, 2),
        "checkerboard_fix_frame_ms": round(cb_dt * 1e3, 2),
        "checkerboard_fix_psnr_db_min": round(cb_psnr, 1),
        "device": {k: device[k] for k in ("platform", "kind", "count", "power_limit")},
    }
    sh_gate = False
    if sh_dt is not None:
        sh_gate = sh_psnr >= GATE_DB
        out.update({
            "shadowed_fps": round((1.0 / sh_cb_dt) if sh_gate else (1.0 / sh_dt), 2),
            "shadowed_frame_ms": round((sh_cb_dt if sh_gate else sh_dt) * 1e3, 2),
            "shadowed_mode": "checkerboard+fix" if sh_gate else "full",
            "shadowed_exact_fps": round(1.0 / sh_dt, 2),
            "shadowed_checkerboard_fix_fps": round(1.0 / sh_cb_dt, 2),
            "shadowed_psnr_db_min": round(sh_psnr, 1),
            # the static orbit's amortized cache converges to ZERO per-frame
            # atlas raster work (the JSON says so)
            "shadowed_shadow_updates_per_frame": 0.0,
        })
    if dyn_dt is not None:
        dyn_fps = 1.0 / dyn_dt
        out.update({
            "shadowed_dynamic_fps": round(dyn_fps, 2),
            "shadowed_dynamic_frame_ms": round(dyn_dt * 1e3, 2),
            # measured dirty-unit re-renders per frame during the moving-
            # caster orbit (per-band units, ops/shadow.shadow_signature)
            "shadow_updates_per_frame": (
                round(dyn_updates, 2) if dyn_updates is not None else None
            ),
            "shadow_progressive_bands": SHADOW_PROGRESSIVE,
            # per-band caster capacity, sized to the measured worst band
            # demand (whole-slot rendering truncated 71% at equal capacity)
            "shadow_caster_capacity": SHADOW_BAND_CAPACITY,
        })
        if sh_gate and dyn_fps >= PROMOTE_SHADOWED_FPS:
            out.update({
                "value": round(dyn_fps, 2),
                "vs_baseline": round(dyn_fps / TARGET_FPS, 3),
                "frame_ms": round(dyn_dt * 1e3, 2),
                "mtris_per_sec": round(tri_count * dyn_fps / 1e6, 1),
                "headline_tier": "shadowed_dynamic",
            })
    if golden_psnr is not None and golden_psnr > 0:
        out["psnr_vs_golden_db"] = round(golden_psnr, 1)
    return out


if __name__ == "__main__":
    main()
