"""Hermetic tests for bench.py's quality-gated headline selection.

The driver records bench.py's single JSON line as the round's headline, so
the selection logic must be provably correct without a GPU: the fast
(checkerboard+fix) shading mode becomes the headline ONLY when its measured
MIN-over-poses PSNR vs the exact path passes the 40 dB gate; the exact path
is always reported alongside, the active mode is explicit in the line
(headline_mode/shade_rate), and the gate's basis is explicit (psnr_basis —
it is fidelity vs this renderer's own exact frame, not vs the Vulkan
reference, which this environment cannot run)."""

import json

import numpy as np

import bench

DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
          "power_limit": "700.00 W", "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W"}


def test_gate_pass_promotes_fast_tier():
    r = bench.result_line(DEVICE, 100967.0, dt=0.02991, cb_dt=0.02621, cb_psnr=41.0)
    assert r["shade_rate"] == "checkerboard+fix"
    assert r["headline_mode"] == "checkerboard+fix"
    assert r["value"] == round(1.0 / 0.02621, 2)
    assert r["frame_ms"] == 26.21
    assert r["exact_path_fps"] == round(1.0 / 0.02991, 2)
    assert r["vs_baseline"] == round((1.0 / 0.02621) / bench.TARGET_FPS, 3)
    assert r["checkerboard_fix_psnr_db_min"] == 41.0
    assert "vs_exact" in r["psnr_basis"]
    # the line names the device it measured; the metric name is device-free
    assert r["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                           "count": 1, "power_limit": "700.00 W"}
    assert r["metric"] == "sponza_like_10000inst_1920x1088_fps"
    json.dumps(r)  # all values JSON-serializable


def test_gate_fail_falls_back_to_exact_path():
    r = bench.result_line(DEVICE, 100967.0, dt=0.02991, cb_dt=0.02621, cb_psnr=39.9)
    assert r["shade_rate"] == "full"
    assert r["headline_mode"] == "full"
    assert r["value"] == round(1.0 / 0.02991, 2)
    assert r["frame_ms"] == 29.91
    # the fast tier's numbers are still reported for the record
    assert r["checkerboard_fix_frame_ms"] == 26.21
    assert r["vs_baseline"] == round((1.0 / 0.02991) / bench.TARGET_FPS, 3)


def test_mtris_follows_headline_mode():
    fast = bench.result_line(DEVICE, 1e5, dt=0.030, cb_dt=0.025, cb_psnr=45.0)
    slow = bench.result_line(DEVICE, 1e5, dt=0.030, cb_dt=0.025, cb_psnr=10.0)
    assert fast["mtris_per_sec"] == round(1e5 * (1.0 / 0.025) / 1e6, 1)
    assert slow["mtris_per_sec"] == round(1e5 * (1.0 / 0.030) / 1e6, 1)


def test_shadowed_tier_gated_independently():
    r = bench.result_line(
        DEVICE, 1e5, dt=0.030, cb_dt=0.025, cb_psnr=45.0,
        sh_dt=0.040, sh_cb_dt=0.031, sh_psnr=41.5,
    )
    assert r["shadowed_mode"] == "checkerboard+fix"
    assert r["shadowed_fps"] == round(1.0 / 0.031, 2)
    assert r["shadowed_exact_fps"] == round(1.0 / 0.040, 2)
    assert r["shadowed_psnr_db_min"] == 41.5
    # base gate passing does not leak into a failing shadowed gate
    r2 = bench.result_line(
        DEVICE, 1e5, dt=0.030, cb_dt=0.025, cb_psnr=45.0,
        sh_dt=0.040, sh_cb_dt=0.031, sh_psnr=20.0,
    )
    assert r2["shadowed_mode"] == "full"
    assert r2["shadowed_fps"] == round(1.0 / 0.040, 2)
    json.dumps(r2)


def test_dynamic_tier_promotion_to_headline():
    # dynamic shadowed >= 30 FPS + shadowed gate pass -> value promotes
    r = bench.result_line(
        DEVICE, 1e5, dt=0.030, cb_dt=0.025, cb_psnr=45.0,
        sh_dt=0.040, sh_cb_dt=0.030, sh_psnr=41.0,
        dyn_dt=1.0 / 31.0, dyn_updates=1.2,
    )
    assert r["headline_tier"] == "shadowed_dynamic"
    assert r["value"] == 31.0
    assert r["shadowed_dynamic_fps"] == 31.0
    assert r["shadow_updates_per_frame"] == 1.2
    assert r["vs_baseline"] == round(31.0 / bench.TARGET_FPS, 3)
    assert r["mtris_per_sec"] == round(1e5 * 31.0 / 1e6, 1)
    # base-tier numbers still reported
    assert r["checkerboard_fix_fps"] == 40.0
    json.dumps(r)


def test_dynamic_tier_below_30_keeps_base_headline():
    r = bench.result_line(
        DEVICE, 1e5, dt=0.030, cb_dt=0.025, cb_psnr=45.0,
        sh_dt=0.040, sh_cb_dt=0.030, sh_psnr=41.0,
        dyn_dt=1.0 / 28.0, dyn_updates=1.0,
    )
    assert r["headline_tier"] == "base"
    assert r["value"] == 40.0
    assert r["shadowed_dynamic_fps"] == 28.0


def test_dynamic_tier_gate_fail_keeps_base_headline():
    # fast dynamic FPS but the shadowed PSNR gate fails -> no promotion
    r = bench.result_line(
        DEVICE, 1e5, dt=0.030, cb_dt=0.025, cb_psnr=45.0,
        sh_dt=0.040, sh_cb_dt=0.030, sh_psnr=30.0,
        dyn_dt=1.0 / 35.0, dyn_updates=1.0,
    )
    assert r["headline_tier"] == "base"
    assert r["value"] == 40.0


def test_static_shadowed_tier_reports_zero_atlas_work():
    r = bench.result_line(
        DEVICE, 1e5, dt=0.030, cb_dt=0.025, cb_psnr=45.0,
        sh_dt=0.040, sh_cb_dt=0.030, sh_psnr=41.0,
    )
    assert r["shadowed_shadow_updates_per_frame"] == 0.0


def test_golden_psnr_reported_when_available():
    r = bench.result_line(
        DEVICE, 1e5, dt=0.030, cb_dt=0.025, cb_psnr=45.0, golden_psnr=33.4
    )
    assert r["psnr_vs_golden_db"] == 33.4
    r2 = bench.result_line(
        DEVICE, 1e5, dt=0.030, cb_dt=0.025, cb_psnr=45.0, golden_psnr=-1.0
    )
    assert "psnr_vs_golden_db" not in r2


def test_golden_frame_set_is_committed():
    """The golden set must exist in the repo."""
    import os

    base = os.path.join(os.path.dirname(bench.__file__), bench.GOLDEN_DIR)
    for i in range(len(bench.GATE_ANGLES)):
        path = os.path.join(base, f"shadowed_pose{i}.png")
        assert os.path.exists(path), f"missing golden frame {path}"


def test_psnr_min_takes_worst_pose():
    a = {0.1: np.zeros((4, 4, 3), np.float32), 0.2: np.zeros((4, 4, 3), np.float32)}
    b = {
        0.1: np.zeros((4, 4, 3), np.float32),          # identical: inf dB
        0.2: np.full((4, 4, 3), 0.1, np.float32),      # 20 dB
    }
    assert abs(bench.psnr_min(a, b) - 20.0) < 1e-6


def test_bench_refuses_to_run_without_a_gpu():
    """No CPU fallback: on a CPU-only JAX the bench exits non-zero before
    measuring anything."""
    import jax
    import pytest

    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None)
