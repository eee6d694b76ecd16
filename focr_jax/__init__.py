"""focr_jax — a JAX rebuild of aconz2/font-ocr for accelerators.

Layers (SURVEY.md §1 re-layering):
  fonts/     L1 host font layer: ctypes FreeType + startup template banks
  ops/       L2/L3 device ops: exact-integer SSD + NCC (jax.numpy / lax)
  models/    L4 decode engines: focr grid decoder, ncc matcher, post-processing
  parallel/  L5 page-mesh scale-out (shard_map over jax.sharding.Mesh)
  io/        L0 image I/O, overlays, synthetic corpora
  cli/       L6 flag-parity focr/ncc command-line entry points
  oracle/    stage-0 NumPy reference semantics (test oracle)
  native/    C++ host kernel (differential oracle and overflow fallback)
"""

import os as _os

import jax as _jax

# int64 is required for exact full-page integral arithmetic on large pages
# (sum-of-squares cumsums exceed 2^31). All device float math remains
# explicitly f32/bf16 — no f64 ever reaches the device.
_jax.config.update("jax_enable_x64", True)

_compile_cache_decided = False

# fixed, inside the checkout: the cache is keyed by path, so a directory
# that moved would never hit
_DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache() -> None:
    """Persistent XLA compilation cache, so a CLI invocation after the first
    skips the compile of every shape it has seen.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and this
    sets no directory; otherwise the cache lives in ``<repo>/.jax_cache/``.
    Called lazily by the compiling entry points (GridDecoder / NccMatcher /
    PropDecoder constructors) so importing the package never forces backend
    initialization. Never enabled here when the RESOLVED backend is CPU (not
    just when JAX_PLATFORMS says so): CPU AOT artifacts bake in the
    compiling host's -march features, and loading them on a different
    machine risks SIGILL."""
    global _compile_cache_decided
    if _compile_cache_decided:
        return
    _compile_cache_decided = True
    if _jax.default_backend() == "cpu":
        return
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update("jax_compilation_cache_dir", _DEFAULT_CACHE_DIR)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


__version__ = "0.1.0"
