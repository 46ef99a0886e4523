"""Int8 quantization for the decode path: weight-only and w8a8.

Batch-1 decode is weight-bandwidth-bound (the 0.6B talker reads ~870 MB of
bf16 weights per step); storing matmul weights as int8 with per-output-channel
scales halves the bytes.  Two modes:

- ``int8`` (weight-only): the int8→bf16 convert + scale is fused into the
  dot's operand read — no materialized dequantized copy, activations stay
  bf16.  Format: ``{"q": int8, "scale": f32}``.
- ``w8a8``: activations are quantized per token on the fly and the dot is
  an int8×int8 product accumulated in int32 (``preferred_element_type=
  int32``), which XLA hands to the card's int8 matrix path (cuBLASLt IMMA on
  Hopper); no float copy of the weight matrix is made.  Rows are rescaled by
  the activation and weight scales afterwards.  Format:
  ``{"q8": int8, "scale": f32}`` — the key name is the (static) mode tag.

Opt-in: ``FasterQwen3TTS.from_pretrained(..., quantize="int8"|"w8a8")``, or
selectively per component: ``"int8-predictor"`` / ``"w8a8-predictor"`` /
``"...-talker"`` (see ``parse_mode``).
Only the layer-stack projection matrices (+ predictor lm_heads) are
quantized; embeddings/norms stay in the model dtype — they are small,
row-gathered, or accuracy-critical.
"""
from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp

# layer-stack leaves worth quantizing: [L, in, out] projection matrices
_QUANT_KEYS = ("qkv_proj", "o_proj", "gateup_proj", "down_proj")
_BASE_MODES = ("int8", "w8a8")
_PARTS = ("talker", "predictor")
# Selective modes quantize one component only.  "int8-predictor" is the
# bandwidth/quality sweet spot: the predictor reads ~69% of the decode
# step's weight bytes (benchmarks/decompose.py: 1.95 GB/frame vs the
# talker's 0.88 GB/step on 0.6B) but only refines codebooks 1-15 — the
# talker, whose codebook-0 tokens carry the semantic content, stays bf16.
MODES = _BASE_MODES + tuple(
    f"{b}-{p}" for b in _BASE_MODES for p in _PARTS)


def parse_mode(mode: str):
    """'int8' → ('int8', ('talker','predictor')); 'w8a8-predictor' →
    ('w8a8', ('predictor',)).  Raises on unknown modes."""
    if mode not in MODES:
        raise ValueError(f"unknown quantize mode {mode!r}; expected one of {MODES}")
    base, _, part = mode.partition("-")
    return base, ((part,) if part else _PARTS)


def quantize_tensor(w: jnp.ndarray, mode: str = "int8") -> Dict[str, jnp.ndarray]:
    """[..., in, out] float → int8 + f32 per-out-channel scale."""
    wf = w.astype(jnp.float32)
    amax = jnp.max(jnp.abs(wf), axis=-2, keepdims=True)  # per out channel
    scale = jnp.maximum(amax, 1e-8) / 127.0
    q = jnp.clip(jnp.round(wf / scale), -127, 127).astype(jnp.int8)
    return {"q": q, "scale": scale} if mode == "int8" else {"q8": q, "scale": scale}


def dequant_matmul(x: jnp.ndarray, qw: Dict[str, jnp.ndarray]) -> jnp.ndarray:
    """x @ dequant(qw) with the convert fused into the dot by XLA."""
    y = jnp.matmul(x, qw["q"].astype(x.dtype), preferred_element_type=jnp.float32)
    return (y * qw["scale"].astype(jnp.float32)).astype(x.dtype)


def quantize_act(x: jnp.ndarray):
    """Dynamic per-token symmetric int8 activation quant → (x_q, x_scale)."""
    xf = x.astype(jnp.float32)
    xs = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-8) / 127.0
    xq = jnp.clip(jnp.round(xf / xs), -127, 127).astype(jnp.int8)
    return xq, xs


def w8a8_matmul(x: jnp.ndarray, qw: Dict[str, jnp.ndarray]) -> jnp.ndarray:
    """Int8 dot: quantize x per token, int8×int8→int32, rescale."""
    xq, xs = quantize_act(x)
    acc = jax.lax.dot_general(
        xq, qw["q8"],
        (((xq.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return (acc.astype(jnp.float32) * xs * qw["scale"].astype(jnp.float32)
            ).astype(x.dtype)


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and set(leaf) in ({"q", "scale"}, {"q8", "scale"})


def quantize_block_stack(blocks: Dict[str, jnp.ndarray],
                         mode: str = "int8") -> Dict[str, Any]:
    """Quantize the projection matrices of a layer-stacked block dict."""
    out: Dict[str, Any] = {}
    for k, v in blocks.items():
        out[k] = quantize_tensor(v, mode) if k in _QUANT_KEYS else v
    return out


def quantize_bundle(bundle: Dict[str, Any], mode: str = "int8") -> Dict[str, Any]:
    """Quantize the decode-path weights in a param bundle.

    ``mode`` is "int8"/"w8a8" (both components) or a selective
    "<base>-talker"/"<base>-predictor" (see ``parse_mode``).  Beyond the
    block projections, the predictor's per-codebook lm_heads are quantized
    too: they are read in FULL every frame (15 × [Hp, CB] ≈ 60 MB bf16 per
    frame — benchmarks/decompose.py), unlike embeddings which are
    row-gathered."""
    base, parts = parse_mode(mode)
    mode = base
    out = dict(bundle)
    for part in parts:
        p = dict(bundle[part])
        p["blocks"] = quantize_block_stack(p["blocks"], mode)
        if part == "predictor":
            # lm_head logits feed sampling directly — keep weight-only int8
            # (bf16 accumulate over bf16 activations) even in w8a8 mode
            p["lm_heads"] = quantize_tensor(p["lm_heads"], "int8")
        out[part] = p
    return out


def maybe_matmul(x: jnp.ndarray, w: Any) -> jnp.ndarray:
    """x @ w for a plain array or a quantized dict (mode from its key set)."""
    if isinstance(w, dict):
        if "q8" in w:
            return w8a8_matmul(x, w)
        if "q" in w and "scale" in w:
            return dequant_matmul(x, w)
    return x @ w
