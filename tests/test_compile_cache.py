"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR when set,
else a fixed directory inside the checkout, never keyed by host name."""
import os
import pathlib
import platform
import subprocess
import sys

import bwamem_tpu

ROOT = pathlib.Path(bwamem_tpu.__file__).resolve().parents[1]


def _cache_dir(env_update: dict) -> str:
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_update, PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-c",
         "import bwamem_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, timeout=120, check=True)
    return r.stdout.strip().splitlines()[-1]


def test_env_dir_wins(tmp_path):
    d = str(tmp_path / "xla")
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": d,
                       "JAX_PLATFORMS": "cpu"}) == d


def test_default_is_fixed_inside_checkout():
    gpu = _cache_dir({"JAX_PLATFORMS": "cuda"})
    cpu = _cache_dir({"JAX_PLATFORMS": "cpu"})
    assert gpu == str(ROOT / ".jax_cache")
    # CPU executables embed the host's CPU features: one subdirectory each
    assert os.path.dirname(cpu) == gpu
    assert os.path.basename(cpu).startswith("cpu-")
    assert platform.node() not in gpu + cpu
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text()


def test_default_is_stable():
    assert bwamem_tpu._default_cache_dir() == bwamem_tpu._default_cache_dir()
    assert bwamem_tpu._default_cache_dir().startswith(
        str(ROOT / ".jax_cache"))
