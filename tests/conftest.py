"""Test configuration.

Tests run on the CPU backend with 8 virtual devices (multi-device sharding
is validated with xla_force_host_platform_device_count; the reference has
no distributed tests, SURVEY §4) -- unless the `gpu` marker is selected
(`pytest -m gpu`, run on the card), which leaves JAX on its default
backend.
"""
import os
import re
import tempfile

import numpy as np
import pytest


def _gpu_selected(markexpr: str) -> bool:
    return re.search(r"(?<!not )\bgpu\b", markexpr or "") is not None


def pytest_configure(config):
    if not _gpu_selected(config.option.markexpr):
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
    # isolate the learned-pool sidecar: tests must not read or pollute the
    # checkout's pool store (pool sizes change executable shapes, and
    # repeat-rich tests would inflate later tests' pools)
    os.environ.setdefault(
        "BWAMEM_TPU_POOLS",
        os.path.join(tempfile.mkdtemp(prefix="bwamem_pools_"), "pools.json"))
    import bwamem_tpu

    # raise vm.max_map_count when permitted: XLA:CPU's thunk runtime
    # JIT-maps thousands of code regions per executable and a full test
    # session blows the kernel default ~20-40 min in, surfacing as SIGSEGV
    # inside compile/cache calls (see tune_cache_for_backend's docstring)
    bwamem_tpu.tune_cache_for_backend()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def make_genome(rng, n):
    return rng.integers(0, 4, n, dtype=np.uint8)


def sample_read(rng, genome, length, n_err=0, revcomp=False):
    """Sample a read from a coded genome with optional substitutions."""
    pos = int(rng.integers(0, len(genome) - length + 1))
    read = genome[pos : pos + length].copy()
    for _ in range(n_err):
        i = int(rng.integers(0, length))
        read[i] = (read[i] + 1 + rng.integers(0, 3)) % 4
    if revcomp:
        read = (3 - read)[::-1]
    return pos, read


@pytest.fixture(scope="session")
def tiny_index():
    """A small random-genome index shared by tests."""
    from bwamem_tpu.index.build import build_index_from_codes
    from bwamem_tpu.index.format import Annotation

    g = np.random.default_rng(7).integers(0, 4, 2000, dtype=np.uint8)
    ann = Annotation(names=["chr1"], lengths=[2000], offsets=[0])
    return g, build_index_from_codes(g, ann, sa_intv=8)
