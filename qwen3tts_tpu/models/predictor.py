"""The code predictor: 5-layer MTP transformer emitting codebooks 1..15.

The reference captures the *entire* 15-step loop — including sampling — as a
single CUDA graph (predictor_graph.py:115-167).  The JAX equivalent is
one jitted function: a 2-token prefill followed by a ``lax.scan`` over the 14
remaining codebooks, with the per-codebook LM heads and embedding tables
layer-stacked and indexed inside the scan.  The tiny KV cache (max_seq = 17,
predictor_graph.py:46) lives entirely inside the function as scan carry — it
never round-trips to host.

Unlike the reference, the sampling policy is NOT frozen at capture time
(predictor_graph.py:34-50): it is ordinary (static) function arguments, and
the PRNG key is threaded per call.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from ..core.config import PredictorConfig
from ..ops.initrand import normal as _init_normal, ones as _np_ones, zeros as _np_zeros  # traceable
from ..ops.rope import mrope_cos_sin
from ..ops.sampling import sample_logits
from .layers import (
    BlockSpec,
    decode_mask,
    init_block_stack,
    init_kv_cache,
    prefill_mask,
    rms_norm,
    stack_forward,
)

Params = Dict[str, jnp.ndarray]


@dataclasses.dataclass(frozen=True)
class StaticPolicy:
    """Structural part of the predictor sampling policy (jit static arg)."""

    do_sample: bool = True
    top_k: int = 50
    use_top_p: bool = False


@dataclasses.dataclass(frozen=True)
class SamplingPolicy:
    """User-facing predictor sampling policy (defaults mirror the reference
    ctor, model.py:124-133).  Numeric knobs may be passed to predict_frame as
    traced scalars so changes don't recompile."""

    do_sample: bool = True
    top_k: int = 50
    top_p: float = 1.0
    temperature: float = 0.9

    @property
    def static(self) -> StaticPolicy:
        return StaticPolicy(
            do_sample=self.do_sample, top_k=self.top_k, use_top_p=self.top_p < 1.0
        )


def block_spec(cfg: PredictorConfig) -> BlockSpec:
    return BlockSpec(
        num_layers=cfg.num_hidden_layers,
        hidden_size=cfg.hidden_size,
        num_heads=cfg.num_attention_heads,
        num_kv_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim,
        intermediate_size=cfg.intermediate_size,
        rms_norm_eps=cfg.rms_norm_eps,
    )


def init_params(
    key: jax.Array, cfg: PredictorConfig, talker_hidden: int, dtype=jnp.bfloat16
) -> Params:
    k = jax.random.split(key, 5)
    Hp, CB, NC = cfg.hidden_size, cfg.codebook_size, cfg.num_codebooks
    return {
        "small_to_mtp": {
            "w": _init_normal(k[0], (talker_hidden, Hp), talker_hidden**-0.5, dtype),
            "b": _np_zeros((Hp,), dtype),
        },
        "blocks": init_block_stack(k[1], block_spec(cfg), dtype),
        "final_norm": _np_ones((Hp,), dtype),
        # per-codebook LM heads (reference: ModuleList[15], predictor_graph.py:56)
        "lm_heads": _init_normal(k[2], (NC, Hp, CB), Hp**-0.5, dtype),
        # per-codebook embeddings in *talker* hidden space (generate.py:165 sums
        # them with the talker codec embedding to build the next talker input)
        "codec_embeddings": _init_normal(k[3], (NC, CB, talker_hidden), 0.02, dtype),
    }


def _proj(params: Params, x: jnp.ndarray) -> jnp.ndarray:
    p = params["small_to_mtp"]
    return x @ p["w"] + p["b"]


def _lm_logits(params: Params, cb, h: jnp.ndarray) -> jnp.ndarray:
    """h [B, Hp] @ lm_heads[cb] → f32 logits [B, CB]; supports the int8
    weight-only quantized form (ops/quant.py — the 15 heads are read in full
    every frame, so they are on the quantized decode path)."""
    from ..ops.quant import is_quantized

    lm = params["lm_heads"]
    if is_quantized(lm):
        y = jnp.matmul(h, lm["q"][cb].astype(h.dtype),
                       preferred_element_type=jnp.float32)
        return y * lm["scale"][cb].astype(jnp.float32)
    return (h @ lm[cb]).astype(jnp.float32)


def _rope(cfg: PredictorConfig, pos_1d: jnp.ndarray):
    return mrope_cos_sin(
        jnp.broadcast_to(pos_1d[None], (3,) + pos_1d.shape),
        cfg.head_dim,
        cfg.rope_theta,
        None,
        dtype=jnp.float32,
    )


def predict_frame(
    params: Params,
    cfg: PredictorConfig,
    pred_input: jnp.ndarray,  # [B, 2, H_talker] = cat(past_hidden, token0_embed)
    key: jax.Array,
    policy,  # SamplingPolicy or StaticPolicy
    temperature=None,  # traced scalar; defaults to policy.temperature
    top_p=None,  # traced scalar; defaults to policy.top_p
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Run the full 15-codebook frame.  Returns (tokens [B, 15], embed_sum
    [B, 1, H_talker]) where embed_sum = Σ_i codec_embeddings[i][tokens_i] —
    precomputed here so the decode loop can build the next talker input with
    no extra device round-trips (reference generate.py:163-166)."""
    if isinstance(policy, SamplingPolicy):
        temperature = policy.temperature if temperature is None else temperature
        top_p = policy.top_p if top_p is None else top_p
        policy = policy.static
    B = pred_input.shape[0]
    spec = block_spec(cfg)
    S = cfg.max_seq
    dtype = pred_input.dtype

    kv = init_kv_cache(spec, B, S, dtype)
    zero_pad = jnp.zeros((B,), jnp.int32)

    # --- prefill: 2 tokens ---
    h = _proj(params, pred_input)  # [B, 2, Hp]
    cos, sin = _rope(cfg, jnp.broadcast_to(jnp.arange(2, dtype=jnp.int32)[None], (B, 2)))
    m = prefill_mask(2, 2, zero_pad, cfg.sliding_window)  # local [B,2,2]
    h, kv = stack_forward(params["blocks"], h, cos, sin, kv, jnp.int32(0), m, spec)
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)

    logits0 = _lm_logits(params, 0, h[:, -1, :])
    key, k0 = jax.random.split(key)
    tok0 = sample_logits(
        k0,
        logits0,
        temperature=temperature,
        top_k=policy.top_k,
        top_p=top_p,
        use_top_p=policy.use_top_p,
        do_sample=policy.do_sample,
    )  # [B]

    def _sample(ks, logits):
        return sample_logits(
            ks, logits,
            temperature=temperature, top_k=policy.top_k, top_p=top_p,
            use_top_p=policy.use_top_p, do_sample=policy.do_sample,
        )

    # --- scan over codebooks 1..14 ---
    def body(carry, cb):
        kv_c, tok_prev, key_c = carry
        key_c, ks = jax.random.split(key_c)
        # embed previous token with table (cb-1), project to predictor space
        emb_t = params["codec_embeddings"][cb - 1][tok_prev]  # [B, H_talker]
        x = _proj(params, emb_t)[:, None, :]  # [B, 1, Hp]
        pos = jnp.int32(1) + cb  # cache position 2 + (cb-1)
        cos_d, sin_d = _rope(cfg, jnp.broadcast_to(pos[None, None], (B, 1)))
        m_d = decode_mask(S, pos, zero_pad, cfg.sliding_window)
        x, kv_c = stack_forward(params["blocks"], x, cos_d, sin_d, kv_c,
                                pos, m_d, spec)
        x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
        tok = _sample(ks, _lm_logits(params, cb, x[:, -1, :]))
        return (kv_c, tok, key_c), tok

    (_, _, _), toks_rest = jax.lax.scan(
        body, (kv, tok0, key),
        jnp.arange(1, cfg.num_codebooks, dtype=jnp.int32),
    )  # toks_rest: [14, B]

    tokens = jnp.concatenate([tok0[None], toks_rest], axis=0).T  # [B, 15]

    # embed_sum over the 15 predictor codebooks (talker space).  One-hot +
    # einsum fuses the 15 gathers + sum into one matrix product.
    return tokens, embed_sum_for(params, cfg, tokens, dtype)


def embed_sum_for(params: Params, cfg: PredictorConfig,
                  tokens: jnp.ndarray, dtype) -> jnp.ndarray:
    """Σ_i codec_embeddings[i][tokens_i] for a [B, 15] token frame — the
    predictor's contribution to the next talker input (reference
    generate.py:163-166)."""
    onehot = jax.nn.one_hot(tokens.T, cfg.codebook_size, dtype=dtype)  # [15, B, CB]
    return jnp.einsum(
        "ibc,ich->bh", onehot, params["codec_embeddings"],
        preferred_element_type=jnp.float32,
    ).astype(dtype)[:, None, :]  # [B, 1, Ht]


def predict_frame_teacher(
    params: Params,
    cfg: PredictorConfig,
    pred_input: jnp.ndarray,  # [B, 2, H_talker] = cat(past_hidden, token0_embed)
    teacher: jnp.ndarray,  # [B, 15] int32 — the forced codebook tokens 1..15
) -> jnp.ndarray:
    """Teacher-forced frame: run the 15-codebook micro-loop feeding the GIVEN
    tokens instead of sampling, and return every head's raw logits
    [B, 15, CB].  This is the measurement path for the quantization quality
    gate (utils/quality.py): with identical token history, per-step logit
    deltas between two models isolate quantization noise — free-running
    comparison can't (one early argmax flip makes the rest of the sequence
    incomparable).  Reference analog: committed parity samples + seeds
    (samples/parity/README.md), made numeric here."""
    B = pred_input.shape[0]
    spec = block_spec(cfg)
    S = cfg.max_seq
    dtype = pred_input.dtype

    kv = init_kv_cache(spec, B, S, dtype)
    zero_pad = jnp.zeros((B,), jnp.int32)

    h = _proj(params, pred_input)  # [B, 2, Hp]
    cos, sin = _rope(cfg, jnp.broadcast_to(
        jnp.arange(2, dtype=jnp.int32)[None], (B, 2)))
    m = prefill_mask(2, 2, zero_pad, cfg.sliding_window)
    h, kv = stack_forward(params["blocks"], h, cos, sin, kv, jnp.int32(0), m, spec)
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    logits0 = _lm_logits(params, 0, h[:, -1, :])  # [B, CB]

    def body(kv_c, cb):
        tok_prev = teacher[:, cb - 1]
        emb_t = params["codec_embeddings"][cb - 1][tok_prev]  # [B, Ht]
        x = _proj(params, emb_t)[:, None, :]
        pos = jnp.int32(1) + cb
        cos_d, sin_d = _rope(cfg, jnp.broadcast_to(pos[None, None], (B, 1)))
        m_d = decode_mask(S, pos, zero_pad, cfg.sliding_window)
        x, kv_c = stack_forward(params["blocks"], x, cos_d, sin_d, kv_c,
                                pos, m_d, spec)
        x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
        return kv_c, _lm_logits(params, cb, x[:, -1, :])

    _, logits_rest = jax.lax.scan(
        body, kv, jnp.arange(1, cfg.num_codebooks, dtype=jnp.int32),
    )  # [14, B, CB]
    return jnp.concatenate(
        [logits0[:, None], logits_rest.transpose(1, 0, 2)], axis=1)
