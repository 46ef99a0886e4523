"""Engine/loops tests: the three-layer parity architecture adapted for JAX
(reference tests/test_e2e_parity.py; SURVEY.md §4 translation):

  Layer A (exactness, fp32): streaming == non-streaming token-exact (same
  executables, reference :726-780) and parity-path == fast-path token-exact
  (bucketed/chunked vs per-step — our analog of dynamic-vs-static cache).
  Layer B (structural): output frames satisfy the reference's structural
  invariants (16 codebooks, codebook-0 in the unsuppressed range, no EOS
  leak, all ids >= 0 — reference :40-101).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qwen3tts_tpu.models.predictor import SamplingPolicy
from qwen3tts_tpu.runtime import loops
from qwen3tts_tpu.runtime.engine import GenerationPolicy, bucket_for

POL = GenerationPolicy()
PPOL = SamplingPolicy()
KEY = jax.random.PRNGKey(7)


@pytest.fixture(scope="module")
def fast_ids(tiny_engine, prompt_inputs):
    embeds, tth, tpe = prompt_inputs
    ids, timing = loops.fast_generate(
        tiny_engine, embeds, tth, tpe, key=KEY, max_new_tokens=20,
        policy=POL, pred_policy=PPOL, device_chunk=8,
    )
    return ids, timing


def test_structural_invariants(fast_ids, tiny_cfg):
    ids, timing = fast_ids
    vocab = tiny_cfg.talker.vocab_size
    eos = tiny_cfg.talker.codec_eos_token_id
    assert ids is not None and ids.ndim == 2 and ids.shape[1] == 16
    assert (ids >= 0).all()
    assert (ids[:, 0] < vocab - 1024).all()  # suppressed-zone never sampled
    assert not (ids[:, 0] == eos).any()  # no EOS leak into frames
    assert (ids[:, 1:] < tiny_cfg.predictor.codebook_size).all()
    assert timing["steps"] == ids.shape[0]
    assert timing["ms_per_step"] > 0


def test_streaming_equals_nonstreaming(tiny_engine, prompt_inputs, fast_ids):
    """Same executables => token-exact (reference :726-780)."""
    embeds, tth, tpe = prompt_inputs
    chunks = list(loops.fast_generate_streaming(
        tiny_engine, embeds, tth, tpe, key=KEY, max_new_tokens=20,
        policy=POL, pred_policy=PPOL, chunk_size=8,
    ))
    stream_ids = np.concatenate([c for c, _ in chunks], axis=0)
    np.testing.assert_array_equal(stream_ids, fast_ids[0])
    # timing-dict contract (reference streaming.py:162-169)
    t0 = chunks[0][1]
    assert set(t0) == {"chunk_index", "chunk_steps", "prefill_ms", "decode_ms",
                       "total_steps_so_far", "is_final"}
    assert t0["prefill_ms"] > 0 and chunks[1][1]["prefill_ms"] == 0
    assert chunks[-1][1]["is_final"]


def test_parity_equals_fast(tiny_engine, prompt_inputs, fast_ids):
    """Un-bucketed per-step path == bucketed chunked path (layer-3 analog)."""
    embeds, tth, tpe = prompt_inputs
    ids, _ = loops.parity_generate(
        tiny_engine, embeds, tth, tpe, key=KEY, max_new_tokens=20,
        policy=POL, pred_policy=PPOL,
    )
    np.testing.assert_array_equal(ids, fast_ids[0])


def test_parity_streaming_equals_parity(tiny_engine, prompt_inputs):
    """True streaming parity path (per-step, incremental yields) is
    token-exact vs the non-streaming parity path (reference
    parity_generate_streaming, streaming.py:192-359)."""
    embeds, tth, tpe = prompt_inputs
    ids, _ = loops.parity_generate(
        tiny_engine, embeds, tth, tpe, key=KEY, max_new_tokens=11,
        policy=POL, pred_policy=PPOL,
    )
    chunks = list(loops.parity_generate_streaming(
        tiny_engine, embeds, tth, tpe, key=KEY, max_new_tokens=11,
        policy=POL, pred_policy=PPOL, chunk_size=4,
    ))
    stream_ids = np.concatenate([c for c, _ in chunks], axis=0)
    np.testing.assert_array_equal(stream_ids, ids)
    sizes = [c.shape[0] for c, _ in chunks]
    assert sizes[0] == 4  # yielded mid-generation, not one final slice
    t0 = chunks[0][1]
    assert set(t0) == {"chunk_index", "chunk_steps", "prefill_ms", "decode_ms",
                       "total_steps_so_far", "is_final"}
    assert t0["prefill_ms"] > 0 and not t0["is_final"]
    assert chunks[-1][1]["is_final"]


def test_budget_trim(tiny_engine, prompt_inputs):
    embeds, tth, tpe = prompt_inputs
    ids, _ = loops.fast_generate(
        tiny_engine, embeds, tth, tpe, key=KEY, max_new_tokens=3,
        policy=POL, pred_policy=PPOL, device_chunk=8,
    )
    assert ids.shape[0] == 3


def test_greedy_deterministic(tiny_engine, prompt_inputs):
    embeds, tth, tpe = prompt_inputs
    g = GenerationPolicy(do_sample=False)
    pg = SamplingPolicy(do_sample=False)
    a, _ = loops.fast_generate(tiny_engine, embeds, tth, tpe,
                               key=jax.random.PRNGKey(1), max_new_tokens=8,
                               policy=g, pred_policy=pg, device_chunk=8)
    b, _ = loops.fast_generate(tiny_engine, embeds, tth, tpe,
                               key=jax.random.PRNGKey(2), max_new_tokens=8,
                               policy=g, pred_policy=pg, device_chunk=8)
    np.testing.assert_array_equal(a, b)


def test_overlong_prefill_raises(tiny_engine, prompt_inputs, tiny_cfg):
    H = tiny_cfg.talker.hidden_size
    with pytest.raises(ValueError, match="too long"):
        loops.fast_generate(
            tiny_engine, jnp.zeros((1, 5000, H), jnp.float32),
            prompt_inputs[1], prompt_inputs[2], key=KEY,
            policy=POL, pred_policy=PPOL,
        )


def test_cache_overflow_stops_cleanly(tiny_engine, prompt_inputs):
    """max_seq_len guard: generation stops at the cache limit instead of
    overflowing (reference generate.py:174-177)."""
    embeds, tth, tpe = prompt_inputs
    ids, _ = loops.fast_generate(
        tiny_engine, embeds, tth, tpe, key=KEY, max_new_tokens=500,
        policy=POL, pred_policy=PPOL, device_chunk=8,
    )
    # KV is compacted after prefill, so the budget is measured from the TRUE
    # prefill length (10), not the padded bucket (32): the pad slots must NOT
    # consume generation budget.
    true_len = embeds.shape[1]
    assert ids.shape[0] <= tiny_engine.max_seq_len - true_len
    assert ids.shape[0] > tiny_engine.max_seq_len - 32  # recovered pad budget


def test_warmup_all_covers_every_bucket(tiny_cfg, tiny_models):
    """After warmup_all, requests of ANY length (any prefill/tth bucket,
    warmed chunk sizes) trigger ZERO new compiles — no mid-serving stall."""
    from qwen3tts_tpu.runtime.engine import Engine

    tp, pp = tiny_models
    eng = Engine(tp, pp, tiny_cfg, max_seq_len=64)
    eng.warmup_all(POL, PPOL, chunk_sizes=(4,), max_tth=64)
    n_prefill = eng._prefill_jit._cache_size()
    n_chunk = eng._chunk_jit._cache_size()
    assert n_prefill == 2  # buckets 32, 64
    assert n_chunk == 2    # tth buckets 16, 64 × chunk 4
    H = tiny_cfg.talker.hidden_size
    for T, Tt in ((3, 2), (10, 5), (40, 20), (60, 40)):
        embeds = jnp.zeros((1, T, H), jnp.float32)
        tth = jnp.zeros((1, Tt, H), jnp.float32)
        loops.fast_generate(
            eng, embeds, tth, jnp.zeros((1, 1, H), jnp.float32), key=KEY,
            max_new_tokens=2, policy=POL, pred_policy=PPOL, device_chunk=4)
    assert eng._prefill_jit._cache_size() == n_prefill  # zero new compiles
    assert eng._chunk_jit._cache_size() == n_chunk


def test_bucket_for():
    assert bucket_for(1) == 32
    assert bucket_for(33) == 64
    assert bucket_for(2048) == 2048
    with pytest.raises(ValueError):
        bucket_for(4000)


def test_first_chunks_rampup(tiny_engine, prompt_inputs, fast_ids):
    """Ramp-up chunk schedule produces identical tokens, smaller first yields."""
    embeds, tth, tpe = prompt_inputs
    chunks = list(loops.fast_generate_streaming(
        tiny_engine, embeds, tth, tpe, key=KEY, max_new_tokens=20,
        policy=POL, pred_policy=PPOL, chunk_size=8, first_chunks=(2, 4),
    ))
    sizes = [c.shape[0] for c, _ in chunks]
    assert sizes[0] == 2 and sizes[1] == 4
    ids = np.concatenate([c for c, _ in chunks], axis=0)
    np.testing.assert_array_equal(ids, fast_ids[0])


def test_prefill_pos_floor_token_exact(tiny_engine, prompt_inputs):
    """``pos_floor`` caps the cache compaction (the continuous batcher holds
    the start position so queued long-prompt joiners admit immediately);
    the retained left-pad is masked, so decode tokens are UNCHANGED."""
    embeds, tth, tpe = prompt_inputs

    def run(pos_floor):
        state = tiny_engine.prefill(embeds, KEY, POL, PPOL,
                                    pos_floor=pos_floor)
        pos = int(state["pos"])
        state, frames, n, lens, done = tiny_engine.decode_chunk(
            state, tth, tth.shape[1], tpe, POL, PPOL, 8)
        tiny_engine.release(state)
        return pos, np.asarray(frames[0, : int(lens[0])])

    pos_nat, frames_nat = run(None)
    pos_flr, frames_flr = run(32)
    assert pos_nat == embeds.shape[1]       # full compaction at B=1
    assert pos_flr == 32                    # floored at the bucket
    np.testing.assert_array_equal(frames_nat, frames_flr)
