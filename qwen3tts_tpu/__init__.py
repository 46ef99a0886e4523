"""qwen3tts_tpu — real-time Qwen3-TTS inference framework in JAX.

Built from scratch in JAX/XLA/Pallas with the same capabilities as the
CUDA-graph reference engine `faster-qwen3-tts` (see SURVEY.md)."""

import os as _os

# Persistent XLA compile cache: the durable analog of "graphs already
# captured" (SURVEY.md §5 checkpoint/resume row).  The path is part of the
# cache key, so it is fixed: <checkout>/.xla_cache.
CACHE_DIR = _os.path.join(_os.path.dirname(_os.path.dirname(__file__)),
                          ".xla_cache")


def compile_cache_dir(platforms: str, env=None):
    """Where this process keeps its persistent compile cache, or None.

    ``JAX_COMPILATION_CACHE_DIR`` set: JAX's own setting stands and this
    package sets nothing (None).  CPU-only processes keep no cache: this
    JAX build's XLA:CPU AOT loader never loads its own entries (the object
    code records LLVM tuning preferences such as +prefer-no-scatter as
    required target features, and the loader checks them against the
    host's CPUID features, which never include preferences), so a CPU
    cache is pure cost.  Every other process uses ``CACHE_DIR``."""
    env = _os.environ if env is None else env
    if env.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if platforms and set(platforms.split(",")) <= {"cpu"}:
        return None
    return CACHE_DIR


def _enable_compile_cache():
    import jax

    platforms = (_os.environ.get("JAX_PLATFORMS", "")
                 or str(jax.config.jax_platforms or ""))
    if not platforms:
        # no platform named: an installed accelerator plugin means JAX will
        # pick the accelerator, otherwise it runs on the CPU
        from importlib.util import find_spec

        platforms = "plugin" if find_spec("jax_plugins") else "cpu"
    cache_dir = compile_cache_dir(platforms)
    if cache_dir is None:
        return
    _os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    # persist every program, small ones included: a warm start then replays
    # all of them from disk
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


_enable_compile_cache()

from .api.model import FasterQwen3TTS

__version__ = "0.3.0"
__all__ = ["FasterQwen3TTS", "__version__"]
