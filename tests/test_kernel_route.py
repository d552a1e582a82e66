"""Kernel route, Triton lowering, compile-cache placement, PNG codec and
matmul precision — the CPU-side contract of the GPU path.

The Triton route cannot compile here (no card), but it LOWERS here: a jax
export for the "cuda" platform runs the Pallas->Triton lowering on the CPU,
so an unsupported primitive or a non-power-of-two block fails a test
instead of a chip run.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
from renderer_jax import gpu_checks
from renderer_jax.ops import raster_pallas, rt_grid
from renderer_jax.utils import compile_cache
from renderer_jax.utils.image import read_png, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend", ["cpu", "gpu", "rocm"])
def test_kernel_route_per_backend(backend):
    """cpu -> the Pallas interpreter; gpu -> Triton compiler params;
    anything else has no route and raises."""
    if backend == "rocm":
        with pytest.raises(NotImplementedError):
            raster_pallas.kernel_route(backend)
        return
    route = raster_pallas.kernel_route(backend)
    if backend == "cpu":
        assert route == {"interpret": True}
    else:
        params = route["compiler_params"]
        assert params.BACKEND == "triton"
        assert params.num_warps == raster_pallas.NUM_WARPS
        assert "interpret" not in route
    assert raster_pallas.kernel_route() == {"interpret": True}  # this host


def _export_for_cuda(fn, *args):
    from jax import export

    exp = export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")],
    )(*args)
    return exp.mlir_module()


@pytest.mark.parametrize("kernel", ["raster", "raster_bary", "occlusion"])
def test_kernels_lower_through_triton(kernel, monkeypatch):
    gpu_route = raster_pallas.kernel_route("gpu")
    monkeypatch.setattr(raster_pallas, "kernel_route", lambda backend=None: gpu_route)
    monkeypatch.setattr(rt_grid, "kernel_route", lambda backend=None: gpu_route)
    jax.clear_caches()  # the jitted wrappers must retrace with the gpu route
    try:
        clip, valid, lx, ly, ld = (jnp.asarray(a) for a in gpu_checks.occlusion_case())
        if kernel == "occlusion":
            text = _export_for_cuda(rt_grid.occlusion_grid, clip, valid, lx, ly, ld)
        else:
            fn = functools.partial(
                raster_pallas.rasterize_pallas, width=128, height=64,
                with_bary=(kernel == "raster_bary"),
            )
            text = _export_for_cuda(fn, clip, valid)
    finally:
        jax.clear_caches()
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert "interpret" not in text


def test_occlusion_kernel_matches_dense_reference():
    out = gpu_checks.check_occlusion_matches_dense()
    assert out["agreement"] == 1.0  # same arithmetic on one host


def _cache_probe(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = (
        "import jax, jax.numpy as jnp\n"
        "from renderer_jax.utils.compile_cache import enable_persistent_cache\n"
        "d = enable_persistent_cache()\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: jnp.cos(x) * 3.0 + 1.25)(jnp.ones(7)).block_until_ready()\n"
        "print(d)\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True,
    )
    return out.stdout.split()[-2:]


def test_compile_cache_uses_env_dir_and_nothing_else(tmp_path):
    env_dir = str(tmp_path / "xla_cache")
    before = set(os.listdir(compile_cache.CACHE_DIR)) if os.path.isdir(
        compile_cache.CACHE_DIR) else set()
    used, configured = _cache_probe(env_dir)
    assert used == configured == env_dir
    assert any(n.endswith("-cache") for n in os.listdir(env_dir))
    after = set(os.listdir(compile_cache.CACHE_DIR)) if os.path.isdir(
        compile_cache.CACHE_DIR) else set()
    assert not any("cos" in n for n in after - before)


def test_compile_cache_defaults_to_fixed_dir_in_checkout():
    used, configured = _cache_probe(None)
    assert used == configured == compile_cache.CACHE_DIR
    assert os.path.dirname(compile_cache.CACHE_DIR) == REPO
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("pose", range(3))
def test_png_codec_round_trips_the_goldens(pose, tmp_path):
    path = os.path.join(REPO, bench.GOLDEN_DIR, f"shadowed_pose{pose}.png")
    img = read_png(path)
    assert img.shape == (bench.HEIGHT, bench.WIDTH, 3) and img.dtype == np.uint8
    assert 10 < img.mean() < 245  # a rendered frame, not a flat fill
    out = str(tmp_path / "rt.png")
    write_png(out, img)
    np.testing.assert_array_equal(read_png(out), img)
    # float input in [0, 1] quantizes back to the same bytes
    write_png(out, img.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(read_png(out), img)


def test_png_codec_matches_an_independent_decoder():
    Image = pytest.importorskip("PIL.Image")
    path = os.path.join(REPO, bench.GOLDEN_DIR, "shadowed_pose0.png")
    np.testing.assert_array_equal(read_png(path), np.asarray(Image.open(path)))


def test_png_codec_rgba(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(17, 23, 4), dtype=np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), img)


def test_texture_decode_without_pillow_raises_a_clear_error(monkeypatch):
    from renderer_jax.utils.image import pil_image

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        pil_image()


@pytest.mark.parametrize("switches", [{}, {"shadows": True}, {"rt": True}],
                         ids=["base", "shadows", "rt"])
def test_frame_plan_f32_dots_are_highest_precision(switches):
    """Every f32 dot_general of the bench plan (tiny size) carries HIGHEST
    precision: a default-precision f32 dot may run in TF32 on the GPU,
    which corrupts edges and shadow lookups."""
    from renderer_jax.models import sponza_like_scene
    from renderer_jax.ops.overlay import Overlay
    from renderer_jax.runtime import Renderer

    import dataclasses

    cfg = dataclasses.replace(
        bench.bench_config(), width=128, height=64, tri_capacity=4096,
        shade_rate="checkerboard", shadow_size=128,
    )
    r = Renderer(sponza_like_scene(16), cfg, outputs=("image",))
    r.set_config(**switches)
    r.apply_config_now()
    fn = r._jit_for(r.plans.plan(r.config.as_dict()))
    text = fn.lower(
        r.state, r.scene, bench.make_camera(0.3), np.float32(0.0), Overlay.empty()
    ).as_text()
    dots = [line for line in text.splitlines() if "stablehlo.dot_general" in line]
    assert dots, "plan has no dot_general to check"
    loose = [line.strip() for line in dots if "f32" in line and "HIGHEST" not in line]
    assert not loose, loose[:3]
