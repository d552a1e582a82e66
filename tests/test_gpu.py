"""Compiled-kernel checks on a CUDA GPU (marker `gpu`).

The rest of the suite runs the Pallas kernels in the interpreter on the
CPU, which validates semantics but not Triton compilation or on-card
numerics. These tests run the compiled kernels against their references
through the same check functions chip_smoke.py runs (renderer_jax/
gpu_checks.py). Whether a card is present is decided in the fixture, at
run time; elsewhere they skip.

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py
"""

import pytest

from renderer_jax import gpu_checks

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a CUDA GPU (default device platform: {platform})")


@pytest.mark.parametrize("check", gpu_checks.GPU_CHECKS, ids=lambda f: f.__name__)
def test_compiled_kernel_check(gpu, check):
    check()
