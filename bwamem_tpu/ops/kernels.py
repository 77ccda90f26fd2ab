"""The one choice between the hand-written GPU kernels and their lax twins.

Every device DP stage with a Pallas kernel (ops/pallas/) asks this
function which implementation to trace. The kernels are compiled for the
GPU through Triton; every other backend runs the plain lax twin, which
is also the kernels' reference. Interpret mode is never chosen here: only
tests run a kernel in the Pallas interpreter, and they ask for it
explicitly. On the GPU a kernel that fails to compile raises; nothing
falls back.
"""
from __future__ import annotations

import jax


def use_gpu_kernels() -> bool:
    """True when the default backend is the GPU."""
    return jax.default_backend() == "gpu"
