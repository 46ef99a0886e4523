"""Where the persistent XLA compile cache goes (qwen3tts_tpu/__init__.py):
JAX's own JAX_COMPILATION_CACHE_DIR wins, accelerator processes otherwise use
the fixed <checkout>/.xla_cache, and CPU-only processes keep none."""
import os

import pytest

import qwen3tts_tpu
from qwen3tts_tpu import CACHE_DIR, compile_cache_dir


def test_cache_dir_is_fixed_checkout_path():
    checkout = os.path.dirname(os.path.dirname(qwen3tts_tpu.__file__))
    assert CACHE_DIR == os.path.join(checkout, ".xla_cache")


@pytest.mark.parametrize("platforms", ["cuda", "gpu", "cuda,cpu", "plugin"])
def test_accelerator_process_uses_checkout_cache(platforms):
    assert compile_cache_dir(platforms, env={}) == CACHE_DIR


@pytest.mark.parametrize("platforms", ["cuda", "cpu", ""])
def test_env_var_leaves_jax_setting_alone(platforms):
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/dir"}
    assert compile_cache_dir(platforms, env=env) is None


def test_cpu_process_keeps_no_cache():
    assert compile_cache_dir("cpu", env={}) is None


def test_cpu_test_process_has_no_persistent_cache():
    import jax

    assert jax.config.jax_compilation_cache_dir in (None, "")
