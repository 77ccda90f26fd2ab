"""bwamem_tpu — a short-read seed-and-extend aligner in JAX.

A ground-up re-design of the capabilities of sflorescu/BWA-MEM_GPU
(bwa-gasal2: GPU-seeded, GPU-extended BWA-MEM 0.7.x) as batched JAX
programs:

  * FMD-index SMEM seeding as batched, fixed-shape XLA programs
    (reference: src/GPUSeed/seed_gen.cu)
  * banded affine-gap seed extension with ksw_extend semantics, as a
    Pallas (Triton) GPU kernel beside its lax twin (reference contract:
    src/bwamem.c:1791-1908 `decoy_cpu_align` / src/ksw.c `ksw_extend2`)
  * chaining / filtering / dedup / primary-marking / mapQ / CIGAR / SAM
    (reference: src/bwamem.c, src/bwa.c)
  * data-parallel scaling via jax.sharding over a device Mesh
    (replaces the reference's pthread pool, src/kthread.c)

Layout:
  index/     offline index toolchain + device-layout loader
  oracle/    pure-NumPy reference semantics (test anchors)
  ops/       jitted device programs + Pallas kernels (seeding, extension)
  pipeline/  host orchestration: chain, merge, SAM emit
  parallel/  mesh sharding of the alignment step
  io/        FASTA/FASTQ reading, SAM writing
  models/    end-to-end aligner configurations ("flagship" = MemAligner)
"""

__version__ = "0.1.0"

# Rows/positions of large genomes need >32 bits (human fwd+rev ~2^32.5;
# reference threads 33-bit positions via split words, seed_gen.cu:530-531).
# Only row/position arrays are int64 — counts, codes and lane indices
# stay int32.
import jax as _jax

_jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the CLI is a one-shot process; without
# it every invocation re-pays the XLA compiles (the executables are
# shape-bucketed, so the cache converges after a few runs). Where
# JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
# set here. Otherwise the cache lives at a fixed path inside the
# checkout: the path is part of no cache key, so it must not move.
import os as _os

CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def _cpu_fingerprint() -> str:
    """Hash of the host CPU's feature flags. XLA:CPU executables embed
    the features of the machine that compiled them, and one loaded on a
    host without them can crash the process, so CPU-pinned processes
    keep their entries in a subdirectory per feature set."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    import hashlib

                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    return hashlib.sha1(feats.encode()).hexdigest()[:10]
    except OSError:
        pass
    return "nofp"


def _default_cache_dir() -> str:
    d = _os.path.join(CHECKOUT, ".jax_cache")
    if _os.environ.get("JAX_PLATFORMS", "").split(",")[0] == "cpu":
        d = _os.path.join(d, "cpu-" + _cpu_fingerprint())
    return d


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _default_cache_dir())
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)


def tune_cache_for_backend() -> None:
    """Call from any long-lived compile-heavy process (aligner init,
    test session, driver entry): raises vm.max_map_count when permitted.

    XLA:CPU's thunk runtime JIT-maps thousands of small code regions per
    compiled executable (~4k new mappings/min measured over a full test
    session); at the kernel default 65530 the process exhausts its VMA
    budget and the next failing mmap inside compile/cache code surfaces
    as a SIGSEGV — observed as three full-suite crashes whose faulting
    frame wandered between backend_compile, cache put, and cache get
    (the persistent cache itself was exonerated: a run with the cache
    fully disabled crashed identically). Best-effort; no-op without
    root."""
    try:
        with open("/proc/sys/vm/max_map_count", "r+") as f:
            if int(f.read()) < 2_000_000:
                f.seek(0)
                f.write("2000000")
    except OSError:
        pass
