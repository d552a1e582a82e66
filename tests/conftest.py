"""Test config: JAX on a virtual 8-device CPU mesh unless told otherwise.

Tests are hermetic and fast on the CPU, where the Pallas kernels run in
the interpreter; multi-device sharding is validated on host CPU devices.
JAX_PLATFORMS, when set, is respected, so the GPU-marked tests
(tests/test_gpu.py) can run on a card with JAX_PLATFORMS=cuda.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
