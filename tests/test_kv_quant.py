"""Int8 KV cache (init_kv_cache kv_quant=True).

Contract: attention over the int8 cache equals attention over an exact bf16
cache up to the per-row quantization error (int8 symmetric, per
(position, head) scale ⇒ relative error ≲ 1/127 per element); the flash
kernel's in-register dequant matches the XLA masked path; and an Engine built
with kv_quant=True generates end-to-end with logits close to the exact
engine's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qwen3tts_tpu.models.layers import (
    BlockSpec,
    block_forward,
    decode_mask,
    init_block_stack,
    init_kv_cache,
)
from qwen3tts_tpu.ops.flash_decode import flash_decode_stacked
from qwen3tts_tpu.ops.rope import mrope_cos_sin

SPEC = BlockSpec(num_layers=2, hidden_size=128, num_heads=4, num_kv_heads=2,
                 head_dim=32, intermediate_size=256, rms_norm_eps=1e-6)


def _rand(key, shape, dtype=jnp.float32, scale=1.0):
    return jax.random.normal(key, shape, jnp.float32).astype(dtype) * scale


def test_quantized_cache_structure():
    kv = init_kv_cache(SPEC, 2, 16, jnp.bfloat16, kv_quant=True)
    assert kv["k"].dtype == jnp.int8 and kv["v"].dtype == jnp.int8
    # scales: [L, B, KVH, S] (S innermost: contiguous per-tile scale loads)
    assert kv["ks"].shape == (2, 2, 2, 16) and kv["ks"].dtype == jnp.float32


def test_block_forward_int8_cache_close_to_exact():
    """Same block, same inputs: int8-cache output ≈ bf16-cache output."""
    stack = init_block_stack(jax.random.PRNGKey(0), SPEC, jnp.float32)
    lp = jax.tree.map(lambda a: a[0] * 0.05, stack)
    B, S, pos_i = 1, 16, 3
    x = _rand(jax.random.PRNGKey(1), (B, 1, SPEC.hidden_size), scale=0.1)
    cos, sin = mrope_cos_sin(
        jnp.broadcast_to(jnp.full((B, 1), pos_i, jnp.int32)[None], (3, B, 1)),
        SPEC.head_dim, 1e6, None, dtype=jnp.float32)
    mask = decode_mask(S, jnp.int32(pos_i), jnp.zeros((B,), jnp.int32))

    outs = {}
    for quant in (False, True):
        kv = init_kv_cache(SPEC, B, S, jnp.float32, kv_quant=quant)
        # write a few rows of history first so attention reads real content
        for p in range(pos_i + 1):
            xp = _rand(jax.random.PRNGKey(10 + p), (B, 1, SPEC.hidden_size),
                       scale=0.1)
            xo, kv = block_forward(lp, xp if p < pos_i else x, cos, sin, kv,
                                   jnp.int32(0), jnp.int32(p), mask, SPEC)
        outs[quant] = np.asarray(xo, np.float32)
    np.testing.assert_allclose(outs[True], outs[False], atol=0.03, rtol=0.05)


@pytest.mark.parametrize("pad", [0, 5])
def test_flash_stacked_int8_matches_masked(pad):
    """Flash kernel (interpret) with int8 cache == XLA dequant attention."""
    L, B, S, KVH, D, NH = 2, 2, 64, 2, 32, 4
    key = jax.random.PRNGKey(2)
    ks = jax.random.split(key, 4)
    pos = 40
    q = _rand(ks[0], (B, NH, D), scale=0.3)
    kf = _rand(ks[1], (L, B, S, KVH, D), scale=0.3)
    vf = _rand(ks[2], (L, B, S, KVH, D), scale=0.3)
    # quantize per (l, b, s, h)
    sc_k = np.maximum(np.abs(np.asarray(kf, np.float32)).max(-1), 1e-8) / 127.0
    sc_v = np.maximum(np.abs(np.asarray(vf, np.float32)).max(-1), 1e-8) / 127.0
    kq = np.clip(np.round(np.asarray(kf) / sc_k[..., None]), -127, 127
                 ).astype(np.int8)
    vq = np.clip(np.round(np.asarray(vf) / sc_v[..., None]), -127, 127
                 ).astype(np.int8)
    pads = jnp.full((B,), pad, jnp.int32)

    out = flash_decode_stacked(
        q, jnp.asarray(kq), jnp.asarray(vq), jnp.int32(1), jnp.int32(pos),
        pads, block_k=32, interpret=True,
        # cache scale layout: [L, B, KVH, S]
        k_scale=jnp.asarray(sc_k.transpose(0, 1, 3, 2), jnp.float32),
        v_scale=jnp.asarray(sc_v.transpose(0, 1, 3, 2), jnp.float32))

    # oracle: dequantized masked attention on layer 1
    kd = jnp.asarray(kq[1] * sc_k[1][..., None], jnp.float32)
    vd = jnp.asarray(vq[1] * sc_v[1][..., None], jnp.float32)
    from qwen3tts_tpu.ops.flash_decode import flash_decode_reference

    for b in range(B):
        ref = flash_decode_reference(q[b].astype(jnp.float32), kd[b], vd[b],
                                     pos, pad)
        np.testing.assert_allclose(np.asarray(out[b], np.float32),
                                   np.asarray(ref, np.float32),
                                   atol=2e-2, rtol=2e-2)


def test_join_row_kv_quant_splices_scales(tiny_cfg, tiny_models):
    """Continuous-batching row join with an int8 cache: the spliced row's
    scale columns land on the POSITION axis (layout [L,B,KVH,S])."""
    from qwen3tts_tpu.models.predictor import SamplingPolicy
    from qwen3tts_tpu.runtime.engine import Engine, GenerationPolicy

    tp, pp = tiny_models
    H = tiny_cfg.talker.hidden_size
    eng = Engine(tp, pp, tiny_cfg, max_seq_len=64, batch=2, kv_quant=True)
    pol = GenerationPolicy(do_sample=False)
    embeds = jax.random.normal(jax.random.PRNGKey(0), (2, 10, H),
                               jnp.float32) * 0.1
    ppol = SamplingPolicy(do_sample=False)
    state = eng.prefill(embeds, jax.random.PRNGKey(1), pol)
    tth = jnp.zeros((2, 4, H), jnp.float32)
    tpe = jnp.zeros((2, 1, H), jnp.float32)
    # advance the batch past the joiner's prefill bucket (32 slots)
    for _ in range(3):
        state, *_ = eng.decode_chunk(state, tth, 0, tpe, pol, ppol, 12)
    pos0 = int(state["pos"])
    assert pos0 >= 32
    new_prompt = jax.random.normal(jax.random.PRNGKey(2), (1, 6, H),
                                   jnp.float32) * 0.1
    state = eng.join_row(state, 1, new_prompt, policy=pol,
                         pred_policy=ppol, pos_hint=pos0)
    ks = np.asarray(state["kv"]["ks"])  # [L, B, KVH, S]
    # the joined row's prompt occupies positions [pos0-bucket, pos0): its
    # scale columns there must be non-zero (quantized rows were written)
    assert (ks[:, 1, :, pos0 - 1] > 0).all()


def test_engine_kv_quant_generates(tiny_cfg, tiny_models, prompt_inputs):
    """End-to-end: kv_quant engine decodes; greedy tokens match the exact
    engine for a short horizon (tiny model, small activations)."""
    from qwen3tts_tpu.models.predictor import SamplingPolicy
    from qwen3tts_tpu.runtime import loops
    from qwen3tts_tpu.runtime.engine import Engine, GenerationPolicy

    tp, pp = tiny_models
    embeds, tth, tpe = prompt_inputs
    pol = GenerationPolicy(do_sample=False)
    ppol = SamplingPolicy(do_sample=False)
    outs = {}
    for quant in (False, True):
        eng = Engine(tp, pp, tiny_cfg, max_seq_len=64, kv_quant=quant)
        ids, _ = loops.fast_generate(
            eng, embeds, tth, tpe, key=jax.random.PRNGKey(7),
            max_new_tokens=8, policy=pol, pred_policy=ppol, device_chunk=4)
        outs[quant] = np.asarray(ids)
    assert outs[True].shape == outs[False].shape
    # greedy on random weights: early-step logit gaps are >> the int8 KV
    # noise, but ties can flip once quantization error accumulates — require
    # agreement on codebook 0 for the first steps only
    np.testing.assert_array_equal(outs[True][:3, 0], outs[False][:3, 0])
