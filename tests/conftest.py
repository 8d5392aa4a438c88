"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Sharding / multi-device logic is validated on host devices; the GPU path
is exercised by chip_smoke.py.  The platform is pinned through jax.config
so an accelerator on the test host is never opened.
"""
import os

# Default the codec drivers to the NumPy path in tests: each distinct block
# shape would otherwise trigger a fresh XLA compile (slow on the CPU test
# runner).  Dedicated device tests opt back in explicitly.
os.environ.setdefault("XSI_DEVICE", "numpy")

try:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:
    pass

import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
