"""The talker: a 28-layer Qwen3-style decoder emitting codec codebook 0.

Functional JAX re-design of the upstream talker driven by the reference
through CUDA graphs (reference talker_graph.py; upstream surface pinned in
SURVEY.md §2.2).  Components:

  - ``codec_embedding``  — embeds codec-token ids into talker hidden space
    (reference ``talker.get_input_embeddings()``, generate.py:100,154)
  - ``text_embedding`` + ``text_projection`` — text-token path
    (reference model.py:353, 395-403)
  - stacked decoder blocks with MRoPE-3 + GQA (layers.py)
  - ``codec_head`` — LM head over the codec vocab (generate.py:101,182)

No mask tables and no DynamicCache→StaticCache copy: prefill writes straight
into the static KV cache, decode masks derive from (position, pad_count).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.config import TalkerConfig
from ..ops.initrand import normal as _init_normal, ones as _np_ones, zeros as _np_zeros  # traceable
from ..ops.rope import mrope_cos_sin
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


def block_spec(cfg: TalkerConfig) -> BlockSpec:
    return BlockSpec(
        num_layers=cfg.num_hidden_layers,
        hidden_size=cfg.hidden_size,
        num_heads=cfg.num_attention_heads,
        num_kv_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim,
        intermediate_size=cfg.intermediate_size,
        rms_norm_eps=cfg.rms_norm_eps,
    )


def layer_sliding_flags(cfg: TalkerConfig) -> jnp.ndarray:
    return jnp.array(
        [cfg.layer_is_sliding(i) for i in range(cfg.num_hidden_layers)], dtype=bool
    )


def init_params(key: jax.Array, cfg: TalkerConfig, dtype=jnp.bfloat16) -> Params:
    k = jax.random.split(key, 6)
    H, V = cfg.hidden_size, cfg.vocab_size

    def emb(kk, n, d, scale=0.02):
        return _init_normal(kk, (n, d), scale, dtype)

    return {
        "codec_embedding": emb(k[0], V, H),
        "text_embedding": emb(k[1], cfg.text_vocab_size, cfg.text_hidden_size),
        "text_projection": {
            "w": _init_normal(k[2], (cfg.text_hidden_size, H),
                              cfg.text_hidden_size**-0.5, dtype),
            "b": _np_zeros((H,), dtype),
        },
        "blocks": init_block_stack(k[3], block_spec(cfg), dtype),
        "final_norm": _np_ones((H,), dtype),
        "codec_head": _init_normal(k[4], (H, V), H**-0.5, dtype),
        # maps the speaker-encoder x-vector into talker hidden space (the
        # upstream equivalent is generate_speaker_prompt, model.py:347)
        "spk_proj": {
            "w": _init_normal(k[5], (cfg.speaker_embed_dim, H),
                              cfg.speaker_embed_dim**-0.5, dtype),
            "b": _np_zeros((H,), dtype),
        },
    }


def new_kv_cache(cfg: TalkerConfig, batch: int, max_len: int,
                 dtype=jnp.bfloat16, kv_quant: bool = False):
    return init_kv_cache(block_spec(cfg), batch, max_len, dtype,
                         kv_quant=kv_quant)


# ---------------------------------------------------------------------------
# embeddings / heads
# ---------------------------------------------------------------------------


def embed_codec(params: Params, ids: jnp.ndarray) -> jnp.ndarray:
    return params["codec_embedding"][ids]


def embed_text(params: Params, ids: jnp.ndarray) -> jnp.ndarray:
    """text token ids → projected talker-space embeddings."""
    tp = params["text_projection"]
    return params["text_embedding"][ids] @ tp["w"] + tp["b"]


def codec_head(params: Params, hidden: jnp.ndarray) -> jnp.ndarray:
    return (hidden @ params["codec_head"]).astype(jnp.float32)


def project_speaker(params: Params, xvector: jnp.ndarray) -> jnp.ndarray:
    """x-vector [E] → talker-space speaker embedding [H]."""
    p = params["spk_proj"]
    return xvector @ p["w"] + p["b"]


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _positions(cfg: TalkerConfig, pos_1d: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """pos_1d: [B, T] effective (pad-corrected) positions → MRoPE cos/sin."""
    pos3 = jnp.broadcast_to(pos_1d[None], (3,) + pos_1d.shape)
    return mrope_cos_sin(
        pos3, cfg.head_dim, cfg.rope_theta, cfg.mrope_section, dtype=jnp.float32
    )


def prefill(
    params: Params,
    cfg: TalkerConfig,
    inputs_embeds: jnp.ndarray,  # [B, T, H] — left-padded to the bucket length
    pad_count: jnp.ndarray,  # [B] int32
    kv: Dict[str, jnp.ndarray],  # zeroed static cache [L, B, S, KVH, D]
) -> Tuple[jnp.ndarray, jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Full-sequence prefill writing straight into the static KV cache.

    Returns (last_hidden [B,1,H], logits [B,V], kv').  Replaces the reference's
    HF-forward prefill + 28-layer DynamicCache→StaticCache copy
    (generate.py:107-137).
    """
    B, T, _ = inputs_embeds.shape
    S = kv["k"].shape[2]
    eff = jnp.arange(T, dtype=jnp.int32)[None, :] - pad_count[:, None]
    eff = jnp.maximum(eff, 0)
    cos, sin = _positions(cfg, eff)

    # LOCAL [B, T, T] masks: prefill attends over the prompt K/V directly
    # (models/layers.py:block_forward), not the padded S-slot cache
    m_full = prefill_mask(T, T, pad_count)
    m_slide = (
        prefill_mask(T, T, pad_count, cfg.sliding_window)
        if cfg.sliding_window is not None
        else None
    )

    x, kv = stack_forward(
        params["blocks"],
        inputs_embeds,
        cos,
        sin,
        kv,
        jnp.int32(0),
        m_full,
        block_spec(cfg),
        mask_sliding=m_slide,
        layer_is_sliding=layer_sliding_flags(cfg) if m_slide is not None else None,
    )
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last = x[:, -1:, :]
    logits = codec_head(params, last[:, 0, :])
    return last, logits, kv


def decode_step(
    params: Params,
    cfg: TalkerConfig,
    x: jnp.ndarray,  # [B, 1, H]
    pos: jnp.ndarray,  # scalar int32 — absolute cache position to write
    pad_count: jnp.ndarray,  # [B] int32
    kv: Dict[str, jnp.ndarray],
    use_flash: bool = False,
    unroll: int = 1,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Single-token decode over the static cache.  Returns (hidden [B,1,H], kv').

    Position for RoPE is ``pos - pad_count`` — the in-graph equivalent of the
    reference's ``position_ids = cache_position + rope_deltas``
    (talker_graph.py:209-211).

    ``use_flash`` reads attention through the flash-decode kernel
    (ops/flash_decode.py, GPU only; ``interpret=True`` runs it through the
    Pallas interpreter) instead of the masked XLA path.
    """
    B = x.shape[0]
    S = kv["k"].shape[2]
    eff = (pos - pad_count)[:, None]
    cos, sin = _positions(cfg, eff)

    m_full = decode_mask(S, pos, pad_count)
    m_slide = (
        decode_mask(S, pos, pad_count, cfg.sliding_window)
        if cfg.sliding_window is not None
        else None
    )

    # flash-decode covers full AND sliding layers: the window is a static
    # kernel parameter (it sets the first tile read), so mixed layer_types
    # stacks cond per layer between the two compiled variants (layers.py
    # block_forward).
    flash_ctx = None
    if use_flash:
        flash_ctx = {"pos": pos, "pad": pad_count, "window": cfg.sliding_window,
                     "interpret": interpret}

    x, kv = stack_forward(
        params["blocks"],
        x,
        cos,
        sin,
        kv,
        pos,
        m_full,
        block_spec(cfg),
        mask_sliding=m_slide,
        layer_is_sliding=layer_sliding_flags(cfg) if m_slide is not None else None,
        flash_ctx=flash_ctx,
        unroll=unroll,
    )
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return x, kv
