"""Test harness config: run everything on a virtual 8-device CPU mesh.

Pallas kernels detect the CPU backend and run in interpreter mode (the
analog of the reference's CPU scalar simulator path, ``cpp_simulate.cc``);
sharding tests get 8 fake devices.  Must run before the first ``import jax``.
The GPU checks that cannot run here are in ``chip_smoke.py``.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
