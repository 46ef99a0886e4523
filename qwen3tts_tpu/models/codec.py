"""The 12 Hz neural codec (speech tokenizer): decoder (codes→wav) and encoder.

The reference hides this entire model behind ``speech_tokenizer.decode``
(model.py:642,782-785) / the encoder inside ``create_voice_clone_prompt``
(SURVEY.md §2.2).  Architecture follows the public Code2Wav family: summed RVQ
code embeddings → sliding-window pre-transformer → ConvNeXt upsampling →
BigVGAN-style SnakeBeta conv stack; the encoder mirrors it with a strided
downsampling stack + residual vector quantization.

Design notes:
  - all convs are 1-D ``lax.conv_general_dilated`` in NLC layout with explicit
    left (causal) padding — XLA maps them onto cuDNN/its own kernels and fuses the
    elementwise (Snake/Norm) ops between them;
  - strict causality end-to-end means a fixed window of ``context + chunk``
    frames decodes streaming chunks bit-stably: a frame's waveform depends
    only on itself and its left context (reference relies on the same
    property for its 25-frame sliding window, model.py:737-826);
  - every frame maps to exactly ``total_upsample`` samples, so the
    "samples_per_frame calibration" dance of the reference (model.py:774-804)
    reduces to an exact constant.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.config import CodecConfig
from ..ops.initrand import normal as _init_normal

def _npz(shape, dtype):
    return jnp.zeros(shape, dtype)


def _npo(shape, dtype):
    return jnp.ones(shape, dtype)


def _npf(shape, val, dtype):
    return jnp.full(shape, val, dtype)

from ..ops.rope import mrope_cos_sin, apply_rope

Params = Dict


# ---------------------------------------------------------------------------
# primitives (NLC layout: [batch, length, channels])
# ---------------------------------------------------------------------------


def causal_conv(x: jnp.ndarray, w: jnp.ndarray, b: jnp.ndarray, *, dilation: int = 1,
                stride: int = 1) -> jnp.ndarray:
    """1-D causal conv.  w: [K, Cin, Cout].  Left-pads (K-1)*dilation zeros."""
    K = w.shape[0]
    pad = (K - 1) * dilation
    out = jax.lax.conv_general_dilated(
        x, w,
        window_strides=(stride,),
        padding=[(pad, 0)],
        rhs_dilation=(dilation,),
        dimension_numbers=("NHC", "HIO", "NHC"),
        preferred_element_type=jnp.float32,
    )
    return out.astype(x.dtype) + b


def causal_trans_conv(x: jnp.ndarray, w: jnp.ndarray, b: jnp.ndarray, *, stride: int) -> jnp.ndarray:
    """1-D causal transposed conv.  w: [K, Cin, Cout].  Output length T*stride
    (right-trimmed so output t depends only on inputs ≤ ceil(t/stride))."""
    T = x.shape[1]
    out = jax.lax.conv_transpose(
        x, w,
        strides=(stride,),
        padding="VALID",
        dimension_numbers=("NHC", "HIO", "NHC"),
        preferred_element_type=jnp.float32,
    )
    return out[:, : T * stride, :].astype(x.dtype) + b


def snake_beta(x: jnp.ndarray, alpha: jnp.ndarray, beta: jnp.ndarray) -> jnp.ndarray:
    """SnakeBeta activation: x + (1/e^beta) * sin^2(x * e^alpha), per-channel."""
    a = jnp.exp(alpha.astype(jnp.float32))
    bsc = jnp.exp(beta.astype(jnp.float32))
    xf = x.astype(jnp.float32)
    s = jnp.sin(xf * a)
    return (xf + (1.0 / (bsc + 1e-9)) * s * s).astype(x.dtype)


def layer_norm(x: jnp.ndarray, w: jnp.ndarray, b: jnp.ndarray, eps: float = 1e-6):
    xf = x.astype(jnp.float32)
    mu = xf.mean(-1, keepdims=True)
    var = ((xf - mu) ** 2).mean(-1, keepdims=True)
    return ((xf - mu) * jax.lax.rsqrt(var + eps)).astype(x.dtype) * w + b


def rms_norm(x, w, eps):
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, -1, keepdims=True)
    return (xf * jax.lax.rsqrt(var + eps)).astype(x.dtype) * w


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _conv_init(key, K, cin, cout, dtype):
    return {"w": _init_normal(key, (K, cin, cout), (K * cin) ** -0.5, dtype),
            "b": _npz((cout,), dtype)}


def _lin_init(key, cin, cout, dtype):
    return {"w": _init_normal(key, (cin, cout), cin**-0.5, dtype),
            "b": _npz((cout,), dtype)}


def _convnext_init(key, dim, dtype):
    k = jax.random.split(key, 3)
    return {
        "dw": _conv_init(k[0], 7, 1, dim, dtype),  # depthwise: feature_group_count
        "norm_w": _npo((dim,), dtype),
        "norm_b": _npz((dim,), dtype),
        "pw1": _lin_init(k[1], dim, 4 * dim, dtype),
        "pw2": _lin_init(k[2], 4 * dim, dim, dtype),
        "scale": _npf((dim,), 0.01, dtype),
    }


def _convnext_forward(p, x):
    """ConvNeXt-style block with causal depthwise conv."""
    h = jax.lax.conv_general_dilated(
        x, p["dw"]["w"],
        window_strides=(1,),
        padding=[(6, 0)],
        dimension_numbers=("NHC", "HIO", "NHC"),
        feature_group_count=x.shape[-1],
        preferred_element_type=jnp.float32,
    ).astype(x.dtype) + p["dw"]["b"]
    h = layer_norm(h, p["norm_w"], p["norm_b"])
    h = h @ p["pw1"]["w"] + p["pw1"]["b"]
    h = jax.nn.gelu(h)
    h = h @ p["pw2"]["w"] + p["pw2"]["b"]
    return x + h * p["scale"]


def _resunit_init(key, dim, dtype):
    k = jax.random.split(key, 2)
    return {
        "alpha1": _npz((dim,), dtype), "beta1": _npz((dim,), dtype),
        "conv1": _conv_init(k[0], 7, dim, dim, dtype),
        "alpha2": _npz((dim,), dtype), "beta2": _npz((dim,), dtype),
        "conv2": _conv_init(k[1], 1, dim, dim, dtype),
    }


def _resunit_forward(p, x, dilation):
    h = snake_beta(x, p["alpha1"], p["beta1"])
    h = causal_conv(h, p["conv1"]["w"], p["conv1"]["b"], dilation=dilation)
    h = snake_beta(h, p["alpha2"], p["beta2"])
    h = causal_conv(h, p["conv2"]["w"], p["conv2"]["b"])
    return x + h


# ---------------------------------------------------------------------------
# pre-transformer (sliding-window causal attention + LayerScale)
# ---------------------------------------------------------------------------


def _xf_layer_init(key, cfg: CodecConfig, dtype):
    H, I = cfg.hidden_size, cfg.intermediate_size
    D = cfg.head_dim
    NH, KVH = cfg.num_attention_heads, cfg.num_key_value_heads
    k = jax.random.split(key, 7)
    return {
        "ln1": _npo((H,), dtype),
        "q": _lin_init(k[0], H, NH * D, dtype),
        "k": _lin_init(k[1], H, KVH * D, dtype),
        "v": _lin_init(k[2], H, KVH * D, dtype),
        "o": _lin_init(k[3], NH * D, H, dtype),
        "scale1": _npf((H,), cfg.layer_scale_initial_scale, dtype),
        "ln2": _npo((H,), dtype),
        "up": _lin_init(k[4], H, I, dtype),
        "gate": _lin_init(k[5], H, I, dtype),
        "down": _lin_init(k[6], I, H, dtype),
        "scale2": _npf((H,), cfg.layer_scale_initial_scale, dtype),
    }


def _xf_forward(p, x, cfg: CodecConfig, mask, cos, sin):
    B, T, H = x.shape
    D, NH, KVH = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    h = rms_norm(x, p["ln1"], cfg.rms_norm_eps)
    q = (h @ p["q"]["w"] + p["q"]["b"]).reshape(B, T, NH, D)
    k = (h @ p["k"]["w"] + p["k"]["b"]).reshape(B, T, KVH, D)
    v = (h @ p["v"]["w"] + p["v"]["b"]).reshape(B, T, KVH, D)
    q, k = apply_rope(q, k, cos, sin)
    q = q.astype(x.dtype)
    k = k.astype(x.dtype)
    G = NH // KVH
    qg = q.reshape(B, T, KVH, G, D)
    scores = jnp.einsum("btkgd,bskd->bkgts", qg, k, preferred_element_type=jnp.float32)
    scores = scores * (D**-0.5)
    scores = jnp.where(mask[:, None, None, :, :], scores, -1e30)
    probs = jax.nn.softmax(scores, axis=-1).astype(v.dtype)
    attn = jnp.einsum("bkgts,bskd->btkgd", probs, v, preferred_element_type=jnp.float32)
    attn = attn.reshape(B, T, NH * D).astype(x.dtype)
    x = x + (attn @ p["o"]["w"] + p["o"]["b"]) * p["scale1"]
    h = rms_norm(x, p["ln2"], cfg.rms_norm_eps)
    h = jax.nn.silu(h @ p["gate"]["w"] + p["gate"]["b"]) * (h @ p["up"]["w"] + p["up"]["b"])
    x = x + (h @ p["down"]["w"] + p["down"]["b"]) * p["scale2"]
    return x


def _pre_transformer(params, x, cfg: CodecConfig):
    B, T, H = x.shape
    qi = jnp.arange(T, dtype=jnp.int32)[None, :, None]
    ki = jnp.arange(T, dtype=jnp.int32)[None, None, :]
    mask = (ki <= qi) & (ki > qi - cfg.sliding_window)
    pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (B, T))
    cos, sin = mrope_cos_sin(pos, cfg.head_dim, cfg.rope_theta, None)
    for layer in params:
        x = _xf_forward(layer, x, cfg, mask, cos, sin)
    return x


# ---------------------------------------------------------------------------
# full decoder / encoder init
# ---------------------------------------------------------------------------


def init_params(key: jax.Array, cfg: CodecConfig, dtype=jnp.float32) -> Params:
    H = cfg.hidden_size
    keys = jax.random.split(key, 64)
    ki = iter(range(64))

    # --- decoder ---
    dec: Dict = {
        "code_embedding": _init_normal(
            keys[next(ki)], (cfg.codebook_size * cfg.num_quantizers, H), 0.02, dtype),
        "pre_transformer": [
            _xf_layer_init(keys[next(ki)], cfg, dtype) for _ in range(cfg.num_hidden_layers)
        ],
        "upsample": [
            {
                "tconv": _conv_init(keys[next(ki)], r, H, H, dtype),
                "convnext": _convnext_init(keys[next(ki)], H, dtype),
            }
            for r in cfg.upsampling_ratios
        ],
        "dec_in": _conv_init(keys[next(ki)], 7, H, cfg.decoder_dim, dtype),
        "blocks": [],
        "out_alpha": None, "out_beta": None, "dec_out": None,
    }
    dim = cfg.decoder_dim
    for i, rate in enumerate(cfg.upsample_rates):
        out_dim = dim // 2
        blk = {
            "alpha": _npz((dim,), dtype), "beta": _npz((dim,), dtype),
            "tconv": _conv_init(keys[next(ki)], 2 * rate, dim, out_dim, dtype),
            "units": [
                _resunit_init(keys[next(ki)], out_dim, dtype) for d in (1, 3, 9)
            ],
        }
        dec["blocks"].append(blk)
        dim = out_dim
    dec["out_alpha"] = _npz((dim,), dtype)
    dec["out_beta"] = _npz((dim,), dtype)
    dec["dec_out"] = _conv_init(keys[next(ki)], 7, dim, 1, dtype)

    # --- encoder (mirror: strided downsample → transformer → RVQ) ---
    enc: Dict = {"stages": [], "in_conv": _conv_init(keys[next(ki)], 7, 1, 32, dtype)}
    ch = 32
    # downsample in reverse order of the decoder's total upsampling
    down_rates = list(cfg.upsampling_ratios)[::-1] + list(cfg.upsample_rates)[::-1]
    for r in down_rates:
        out_ch = min(ch * 2, H)
        enc["stages"].append(
            {
                "alpha": _npz((ch,), dtype), "beta": _npz((ch,), dtype),
                "conv": _conv_init(keys[next(ki)], 2 * r, ch, out_ch, dtype),
            }
        )
        ch = out_ch
    enc["proj"] = _lin_init(keys[next(ki)], ch, H, dtype)
    enc["transformer"] = [
        _xf_layer_init(keys[next(ki)], cfg, dtype) for _ in range(cfg.num_hidden_layers)
    ]
    # RVQ codebooks in hidden space
    enc["codebooks"] = _init_normal(
        keys[next(ki)], (cfg.num_quantizers, cfg.codebook_size, H), 0.05, dtype)

    return {"decoder": dec, "encoder": enc}


# ---------------------------------------------------------------------------
# decode: codes -> waveform
# ---------------------------------------------------------------------------


def decode(
    params: Params,
    cfg: CodecConfig,
    codes: jnp.ndarray,  # [B, T, num_quantizers] int32
) -> jnp.ndarray:
    """codes → waveform [B, T*total_upsample] float32 in [-1, 1].

    Shape bucketing is done by RIGHT-padding (callers pad ``codes`` on the
    right and trim the waveform tail): the stack is strictly causal, so the
    first ``T_valid * total_upsample`` samples are bit-identical to an
    unpadded decode regardless of bias/offset values.  (Left-pad masking is
    NOT exact once convs/norms carry nonzero biases — pad-region activations
    become bias-derived values that bleed into the valid region; see
    tests/test_codec.py::test_right_pad_equivalence_nonzero_biases.)
    """
    dec = params["decoder"]
    B, T, Q = codes.shape
    offsets = jnp.arange(cfg.num_quantizers, dtype=jnp.int32)[None, None, :] * cfg.codebook_size
    emb = dec["code_embedding"][codes + offsets]  # [B, T, Q, H]
    h = emb.mean(axis=2)

    h = _pre_transformer(dec["pre_transformer"], h, cfg)

    for st, ratio in zip(dec["upsample"], cfg.upsampling_ratios):
        h = causal_trans_conv(h, st["tconv"]["w"], st["tconv"]["b"], stride=ratio)
        h = _convnext_forward(st["convnext"], h)

    w = causal_conv(h, dec["dec_in"]["w"], dec["dec_in"]["b"])
    for blk, rate in zip(dec["blocks"], cfg.upsample_rates):
        w = snake_beta(w, blk["alpha"], blk["beta"])
        w = causal_trans_conv(w, blk["tconv"]["w"], blk["tconv"]["b"], stride=rate)
        for unit, dilation in zip(blk["units"], (1, 3, 9)):
            w = _resunit_forward(unit, w, dilation)
    w = snake_beta(w, dec["out_alpha"], dec["out_beta"])
    w = causal_conv(w, dec["dec_out"]["w"], dec["dec_out"]["b"])
    return jnp.clip(w[..., 0].astype(jnp.float32), -1.0, 1.0)


# ---------------------------------------------------------------------------
# encode: waveform -> codes (RVQ)
# ---------------------------------------------------------------------------


def encode(
    params: Params,
    cfg: CodecConfig,
    wav: jnp.ndarray,  # [B, N] float32 @ cfg.sample_rate
) -> jnp.ndarray:
    """waveform → codes [B, T, num_quantizers] (T = N // total_upsample)."""
    enc = params["encoder"]
    B, N = wav.shape
    T = N // cfg.total_upsample
    wav = wav[:, : T * cfg.total_upsample]
    h = wav[:, :, None].astype(enc["in_conv"]["w"].dtype)
    h = causal_conv(h, enc["in_conv"]["w"], enc["in_conv"]["b"])
    down_rates = list(cfg.upsampling_ratios)[::-1] + list(cfg.upsample_rates)[::-1]
    for st, rate in zip(enc["stages"], down_rates):
        h = snake_beta(h, st["alpha"], st["beta"])
        h = causal_conv(h, st["conv"]["w"], st["conv"]["b"], stride=rate)
    h = h @ enc["proj"]["w"] + enc["proj"]["b"]  # [B, T, H]
    h = _pre_transformer(enc["transformer"], h, cfg)

    # residual vector quantization
    def body(residual, codebook):
        # codebook: [CB, H]
        d = (
            jnp.sum(residual**2, -1, keepdims=True)
            - 2.0 * jnp.einsum("bth,ch->btc", residual, codebook,
                               preferred_element_type=jnp.float32)
            + jnp.sum(codebook.astype(jnp.float32) ** 2, -1)[None, None, :]
        )
        idx = jnp.argmin(d, axis=-1)  # [B, T]
        residual = residual - codebook[idx]
        return residual, idx

    _, codes = jax.lax.scan(body, h.astype(jnp.float32), params["encoder"]["codebooks"].astype(jnp.float32))
    return jnp.transpose(codes, (1, 2, 0)).astype(jnp.int32)  # [B, T, Q]


# ---------------------------------------------------------------------------
# stateful streaming decode: codes -> waveform, chunk by chunk, EXACTLY equal
# to the full decode
# ---------------------------------------------------------------------------
#
# The windowed streamer (audio/vocoder.py:StreamDecoder) re-decodes a
# context+chunk window every chunk: 25+8 frames of work for 8 frames of new
# audio (~4x redundant sample-domain compute), and its exactness holds only
# while the context covers the receptive field — which the pre-transformer's
# 72-frame sliding window over 4 layers does NOT fit.  The stateful decoder
# instead carries, across chunks:
#   - per-transformer-layer rolling K/V windows (last sliding_window-1
#     frames, post-rope at ABSOLUTE positions — rope attention scores depend
#     only on position differences, so this equals the full decode exactly);
#   - per-causal-conv input tails ((K-1)*dilation trailing inputs);
#   - per-transposed-conv overlap-add tails (the K-stride output samples the
#     VALID transpose emits beyond the chunk boundary — linearity makes
#     chunked overlap-add exact).
# Total state is < 1 MB; every chunk does only its own frames' work.


def _stream_conv(x, carry, w, b, *, dilation: int = 1):
    """Causal conv with carried left context.  carry: [B, (K-1)*d, Cin]."""
    xin = jnp.concatenate([carry.astype(x.dtype), x], axis=1)
    out = jax.lax.conv_general_dilated(
        xin, w, window_strides=(1,), padding=[(0, 0)], rhs_dilation=(dilation,),
        dimension_numbers=("NHC", "HIO", "NHC"),
        preferred_element_type=jnp.float32,
    ).astype(x.dtype) + b
    pad = carry.shape[1]
    new_carry = xin[:, xin.shape[1] - pad:] if pad else carry
    return out, new_carry


def _stream_tconv(x, tail, w, b, *, stride: int):
    """Causal transposed conv with carried overlap-add tail.
    tail: [B, K - stride, Cout] of PRE-bias contributions."""
    T = x.shape[1]
    K = w.shape[0]
    full = jax.lax.conv_transpose(
        x, w, strides=(stride,), padding="VALID",
        dimension_numbers=("NHC", "HIO", "NHC"),
        preferred_element_type=jnp.float32,
    )  # [B, (T-1)*stride + K, Cout] f32
    out = full[:, : T * stride, :]
    ts = tail.shape[1]  # K - stride (0 when K == stride)
    if ts:
        out = out.at[:, :ts, :].add(tail.astype(out.dtype))
        new_tail = full[:, T * stride:, :]
        # full's tail region is shorter than ts when T*stride overlaps it
        # fully; VALID length is (T-1)*stride+K = T*stride + (K-stride) ✓
    else:
        new_tail = tail
    return out.astype(x.dtype) + b, new_tail.astype(tail.dtype) if ts else tail


def _stream_convnext_forward(p, x, carry):
    xin = jnp.concatenate([carry.astype(x.dtype), x], axis=1)
    h = jax.lax.conv_general_dilated(
        xin, p["dw"]["w"], window_strides=(1,), padding=[(0, 0)],
        dimension_numbers=("NHC", "HIO", "NHC"),
        feature_group_count=x.shape[-1],
        preferred_element_type=jnp.float32,
    ).astype(x.dtype) + p["dw"]["b"]
    new_carry = xin[:, xin.shape[1] - carry.shape[1]:]
    h = layer_norm(h, p["norm_w"], p["norm_b"])
    h = h @ p["pw1"]["w"] + p["pw1"]["b"]
    h = jax.nn.gelu(h)
    h = h @ p["pw2"]["w"] + p["pw2"]["b"]
    return x + h * p["scale"], new_carry


def _stream_resunit(p, x, carry, dilation):
    h = snake_beta(x, p["alpha1"], p["beta1"])
    h, carry = _stream_conv(h, carry, p["conv1"]["w"], p["conv1"]["b"],
                            dilation=dilation)
    h = snake_beta(h, p["alpha2"], p["beta2"])
    h = causal_conv(h, p["conv2"]["w"], p["conv2"]["b"])  # K=1: stateless
    return x + h, carry


def _stream_xf(layers, x, kwins, vwins, frame0, cfg: CodecConfig):
    """Pre-transformer with per-layer rolling K/V windows (length W-1)."""
    B, n, H = x.shape
    D, NH, KVH = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    W = cfg.sliding_window
    G = NH // KVH
    # frame0 may be a scalar (all rows aligned) or a [B] vector: the
    # continuous-batching scheduler shares ONE batched stream state across
    # serving rows that joined at different times, so each row carries its
    # own absolute frame counter.  RoPE scores depend only on position
    # differences, so per-row absolute offsets stay exact; the mask's
    # ``ki >= 0`` term is what hides a young row's not-yet-filled window.
    f0 = jnp.asarray(frame0, jnp.int32).reshape(-1)[:, None]  # [B or 1, 1]
    qi = f0 + jnp.arange(n, dtype=jnp.int32)[None]  # [B?, n] absolute
    pos = jnp.broadcast_to(qi, (B, n))
    cos, sin = mrope_cos_sin(pos, D, cfg.rope_theta, None)
    ki = jnp.concatenate(
        [f0 - (W - 1) + jnp.arange(W - 1, dtype=jnp.int32)[None], qi],
        axis=1)  # [B?, W-1+n]
    mask = ((ki[:, None, :] <= qi[:, :, None])
            & (ki[:, None, :] > qi[:, :, None] - W)
            & (ki[:, None, :] >= 0))  # [B?, n, W-1+n]
    mask = jnp.broadcast_to(mask, (B, n, W - 1 + n))

    new_k, new_v = [], []
    for li, p in enumerate(layers):
        h = rms_norm(x, p["ln1"], cfg.rms_norm_eps)
        q = (h @ p["q"]["w"] + p["q"]["b"]).reshape(B, n, NH, D)
        k = (h @ p["k"]["w"] + p["k"]["b"]).reshape(B, n, KVH, D)
        v = (h @ p["v"]["w"] + p["v"]["b"]).reshape(B, n, KVH, D)
        q, k = apply_rope(q, k, cos, sin)  # absolute positions: rope scores
        q = q.astype(x.dtype)              # depend only on differences, so
        k = k.astype(x.dtype)              # this equals the full decode
        k_all = jnp.concatenate([kwins[li].astype(x.dtype), k], axis=1)
        v_all = jnp.concatenate([vwins[li].astype(x.dtype), v], axis=1)
        qg = q.reshape(B, n, KVH, G, D)
        scores = jnp.einsum("btkgd,bskd->bkgts", qg, k_all,
                            preferred_element_type=jnp.float32) * (D**-0.5)
        scores = jnp.where(mask[:, None, None, :, :], scores, -1e30)
        probs = jax.nn.softmax(scores, axis=-1).astype(v.dtype)
        attn = jnp.einsum("bkgts,bskd->btkgd", probs, v_all,
                          preferred_element_type=jnp.float32)
        attn = attn.reshape(B, n, NH * D).astype(x.dtype)
        x = x + (attn @ p["o"]["w"] + p["o"]["b"]) * p["scale1"]
        h = rms_norm(x, p["ln2"], cfg.rms_norm_eps)
        h = jax.nn.silu(h @ p["gate"]["w"] + p["gate"]["b"]) * (
            h @ p["up"]["w"] + p["up"]["b"])
        x = x + (h @ p["down"]["w"] + p["down"]["b"]) * p["scale2"]
        new_k.append(k_all[:, k_all.shape[1] - (W - 1):])
        new_v.append(v_all[:, v_all.shape[1] - (W - 1):])
    return x, new_k, new_v


def stream_init(params: Params, cfg: CodecConfig, batch: int = 1) -> Dict:
    """Zero streaming state for decode_stream."""
    dec = params["decoder"]
    dt = dec["dec_in"]["w"].dtype
    H = cfg.hidden_size
    W = cfg.sliding_window
    KVH, D = cfg.num_key_value_heads, cfg.head_dim
    L = len(dec["pre_transformer"])
    # every carry length derives from the ACTUAL weight shapes — a
    # checkpoint with different kernel widths gets correct state, not an
    # opaque shape error deep inside decode_stream
    st: Dict = {
        "frame0": jnp.zeros((batch,), jnp.int32),  # per-row frame counter
        "xf_k": [jnp.zeros((batch, W - 1, KVH, D), dt) for _ in range(L)],
        "xf_v": [jnp.zeros((batch, W - 1, KVH, D), dt) for _ in range(L)],
        "up": [],
        "dec_in": jnp.zeros(
            (batch, dec["dec_in"]["w"].shape[0] - 1, H), dt),
        "blocks": [],
        "out": None,
    }
    for stg, r in zip(dec["upsample"], cfg.upsampling_ratios):
        K = stg["tconv"]["w"].shape[0]
        Kd = stg["convnext"]["dw"]["w"].shape[0]
        st["up"].append({
            "tail": jnp.zeros((batch, K - r, H), jnp.float32),
            "cnx": jnp.zeros((batch, Kd - 1, H), dt),
        })
    dim = cfg.decoder_dim
    for blk, rate in zip(dec["blocks"], cfg.upsample_rates):
        out_dim = dim // 2
        K = blk["tconv"]["w"].shape[0]
        st["blocks"].append({
            "tail": jnp.zeros((batch, K - rate, out_dim), jnp.float32),
            "units": [
                jnp.zeros(
                    (batch, (u["conv1"]["w"].shape[0] - 1) * d, out_dim), dt)
                for u, d in zip(blk["units"], (1, 3, 9))
            ],
        })
        dim = out_dim
    st["out"] = jnp.zeros(
        (batch, dec["dec_out"]["w"].shape[0] - 1, dim), dt)
    return st


def decode_stream(
    params: Params,
    cfg: CodecConfig,
    state: Dict,
    codes: jnp.ndarray,  # [B, n, num_quantizers] int32
) -> Tuple[jnp.ndarray, Dict]:
    """Streaming decode of ``n`` new frames.  Returns (wav [B, n*up], state').
    Chaining calls is sample-exact vs decode() on the concatenated codes."""
    dec = params["decoder"]
    B, n, Q = codes.shape
    st = dict(state)
    offsets = jnp.arange(cfg.num_quantizers, dtype=jnp.int32)[None, None, :] \
        * cfg.codebook_size
    emb = dec["code_embedding"][codes + offsets]
    h = emb.mean(axis=2)

    h, new_k, new_v = _stream_xf(dec["pre_transformer"], h, st["xf_k"],
                                 st["xf_v"], st["frame0"], cfg)
    st["xf_k"], st["xf_v"] = new_k, new_v
    st["frame0"] = st["frame0"] + n

    new_up = []
    for stg, u_st, ratio in zip(dec["upsample"], st["up"], cfg.upsampling_ratios):
        h, tail = _stream_tconv(h, u_st["tail"], stg["tconv"]["w"],
                                stg["tconv"]["b"], stride=ratio)
        h, cnx = _stream_convnext_forward(stg["convnext"], h, u_st["cnx"])
        new_up.append({"tail": tail, "cnx": cnx})
    st["up"] = new_up

    w, st["dec_in"] = _stream_conv(h, st["dec_in"], dec["dec_in"]["w"],
                                   dec["dec_in"]["b"])
    new_blocks = []
    for blk, b_st, rate in zip(dec["blocks"], st["blocks"], cfg.upsample_rates):
        w = snake_beta(w, blk["alpha"], blk["beta"])
        w, tail = _stream_tconv(w, b_st["tail"], blk["tconv"]["w"],
                                blk["tconv"]["b"], stride=rate)
        new_units = []
        for unit, u_carry, dilation in zip(blk["units"], b_st["units"], (1, 3, 9)):
            w, u_carry = _stream_resunit(unit, w, u_carry, dilation)
            new_units.append(u_carry)
        new_blocks.append({"tail": tail, "units": new_units})
    st["blocks"] = new_blocks

    w = snake_beta(w, dec["out_alpha"], dec["out_beta"])
    w, st["out"] = _stream_conv(w, st["out"], dec["dec_out"]["w"],
                                dec["dec_out"]["b"])
    return jnp.clip(w[..., 0].astype(jnp.float32), -1.0, 1.0), st
