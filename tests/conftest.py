"""Test configuration: force a local 8-device virtual CPU mesh.

Tests run on the CPU even where a GPU is present: ``jax.config.update``
after import overrides any platform setting, and ``jax_num_cpu_devices=8``
provides the virtual mesh for sharding and replica tests (SURVEY.md §4:
multi-card sharding is tested on a virtual CPU mesh).  Checks that need the
card are marked ``gpu`` and run on it through ``python chip_smoke.py``.
"""
import jax

jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_platforms", "cpu")
# No persistent XLA cache for tests: this jax build's XLA:CPU AOT cache
# NEVER loads its own entries — the compiled object embeds LLVM *tuning*
# preferences (+prefer-no-scatter/+prefer-no-gather) as required target
# features, and the loader validates them against host CPUID features,
# which never include preferences.  Measured same-host, two fresh
# processes: run 1 writes 2 entries, run 2 logs 4 cpu_aot_loader failures
# loading them.  A CPU cache is therefore pure cost (write + failed-load
# spam + cold recompile anyway); tests are budgeted cold.

import jax.numpy as jnp
import numpy as np
import pytest

from qwen3tts_tpu.core.presets import get_preset


@pytest.fixture(scope="session")
def tiny_cfg():
    return get_preset("tiny")


@pytest.fixture(scope="session")
def tiny_models(tiny_cfg):
    """Session-scoped tiny talker+predictor params (class-scoped fixtures in
    the reference keep at most one model pair resident, tests:151-158)."""
    from qwen3tts_tpu.models import predictor as P
    from qwen3tts_tpu.models import talker as T

    tp = T.init_params(jax.random.PRNGKey(0), tiny_cfg.talker, jnp.float32)
    pp = P.init_params(jax.random.PRNGKey(1), tiny_cfg.predictor,
                       tiny_cfg.talker.hidden_size, jnp.float32)
    return tp, pp


@pytest.fixture(scope="session")
def tiny_engine(tiny_cfg, tiny_models):
    from qwen3tts_tpu.runtime.engine import Engine

    tp, pp = tiny_models
    return Engine(tp, pp, tiny_cfg, max_seq_len=64)


@pytest.fixture(scope="session")
def prompt_inputs(tiny_cfg):
    H = tiny_cfg.talker.hidden_size
    embeds = jax.random.normal(jax.random.PRNGKey(2), (1, 10, H), jnp.float32) * 0.1
    tth = jax.random.normal(jax.random.PRNGKey(3), (1, 5, H), jnp.float32) * 0.1
    tpe = jnp.zeros((1, 1, H), jnp.float32)
    return embeds, tth, tpe


@pytest.fixture(scope="session")
def tiny_tts():
    """Session-scoped full API model (tiny preset)."""
    from qwen3tts_tpu import FasterQwen3TTS

    return FasterQwen3TTS.from_pretrained("random:tiny")


@pytest.fixture()
def ref_wav(tmp_path):
    from qwen3tts_tpu.audio.wav import write_wav

    sr = 24_000
    t = np.linspace(0, 1.0, sr, dtype=np.float32)
    wav = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    path = tmp_path / "ref.wav"
    write_wav(path, wav, sr)
    return str(path)
