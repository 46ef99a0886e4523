"""Shared Qwen3-style decoder-layer primitives (functional JAX).

Both the talker (28 layers) and the code predictor (5 layers) are stacks of
identical blocks: RMSNorm → GQA attention with per-head q/k norm + RoPE →
RMSNorm → SwiGLU MLP.  Parameters are *layer-stacked* (leading ``L`` axis) and
the stack is traversed with ``lax.scan`` so XLA compiles one block, not 28.

The reference drives the upstream torch forward through CUDA graphs
(talker_graph.py:97-107); here the equivalent "graph" is simply the jitted
function containing these ops, and masks are computed in-graph from traced
scalars (position, pad_count) rather than from precomputed mask tables
(talker_graph.py:74-95).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.initrand import normal as _init_normal, ones as _init_ones
from ..ops.quant import maybe_matmul
from ..ops.rope import apply_rope


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Static geometry of a decoder-layer stack."""

    num_layers: int
    hidden_size: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    rms_norm_eps: float = 1e-6

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_block_stack(key: jax.Array, spec: BlockSpec, dtype) -> Dict[str, jnp.ndarray]:
    """Random-init a stacked parameter pytree for ``spec.num_layers`` blocks."""
    L, H, I = spec.num_layers, spec.hidden_size, spec.intermediate_size
    D = spec.head_dim
    ks = jax.random.split(key, 8)

    def w(k, shape, fan_in):
        return _init_normal(k, shape, fan_in**-0.5, dtype)

    # q/k/v and gate/up are stored FUSED (one matmul each in the hot loop —
    # fewer kernel boundaries in the latency-bound decode step); checkpoints
    # keep the unfused upstream names and the loader concatenates.
    return {
        "input_norm": _init_ones((L, H), dtype),
        "qkv_proj": w(ks[0], (L, H, spec.q_dim + 2 * spec.kv_dim), H),
        "o_proj": w(ks[3], (L, spec.q_dim, H), spec.q_dim),
        "q_norm": _init_ones((L, D), dtype),
        "k_norm": _init_ones((L, D), dtype),
        "post_norm": _init_ones((L, H), dtype),
        "gateup_proj": w(ks[4], (L, H, 2 * I), H),
        "down_proj": w(ks[6], (L, I, H), I),
    }


def init_kv_cache(
    spec: BlockSpec, batch: int, max_len: int, dtype, kv_quant: bool = False
) -> Dict[str, jnp.ndarray]:
    """Static KV cache pytree: the JAX analog of transformers StaticCache
    (talker_graph.py:43).  Donated across jitted steps so updates are in-place.

    ``kv_quant``: store K/V rows as int8 with per-(position, head) f32
    scales ("ks"/"vs") — halves the attention-read bytes at long positions
    and at batch > 1, where the per-row cache is not amortized like the
    shared weights are.  The quantization happens at write time in
    block_forward; presence of the "ks" key is what switches the read path.
    """
    shape = (spec.num_layers, batch, max_len, spec.num_kv_heads, spec.head_dim)
    if not kv_quant:
        return {"k": jnp.zeros(shape, dtype), "v": jnp.zeros(shape, dtype)}
    # scales live as [L, B, KVH, S] — S innermost, so the flash kernel's
    # per-tile scale loads are contiguous
    sshape = (spec.num_layers, batch, spec.num_kv_heads, max_len)
    return {
        "k": jnp.zeros(shape, jnp.int8),
        "v": jnp.zeros(shape, jnp.int8),
        "ks": jnp.zeros(sshape, jnp.float32),
        "vs": jnp.zeros(sshape, jnp.float32),
    }


def _quantize_rows(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """[B, T, KVH, D] float → (int8 rows, f32 per-(b,t,head) scales)."""
    xf = x.astype(jnp.float32)
    s = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1), 1e-8) / 127.0
    q = jnp.clip(jnp.round(xf / s[..., None]), -127, 127).astype(jnp.int8)
    return q, s


# ---------------------------------------------------------------------------
# math
# ---------------------------------------------------------------------------


def rms_norm(x: jnp.ndarray, w: jnp.ndarray, eps: float) -> jnp.ndarray:
    dt = x.dtype
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    return (xf * jax.lax.rsqrt(var + eps)).astype(dt) * w


def _attn_core(
    q: jnp.ndarray,  # [B, Tq, NH, D]
    k: jnp.ndarray,  # [B, S, KVH, D]
    v: jnp.ndarray,  # [B, S, KVH, D]
    mask: jnp.ndarray,  # [B, Tq, S] bool (True = attend)
    num_kv_groups: int,
) -> jnp.ndarray:
    B, Tq, NH, D = q.shape
    S = k.shape[1]
    KVH = k.shape[2]
    q = q.reshape(B, Tq, KVH, num_kv_groups, D)
    scores = jnp.einsum(
        "btkgd,bskd->bkgts", q, k, preferred_element_type=jnp.float32
    ) * (D**-0.5)  # [B, KVH, G, Tq, S]
    scores = jnp.where(mask[:, None, None, :, :], scores, -1e30)
    probs = jax.nn.softmax(scores, axis=-1)
    out = jnp.einsum(
        "bkgts,bskd->btkgd", probs.astype(v.dtype), v, preferred_element_type=jnp.float32
    )
    return out.reshape(B, Tq, NH, D).astype(v.dtype)


def block_forward(
    layer_params: Dict[str, jnp.ndarray],  # one layer (no leading L axis)
    x: jnp.ndarray,  # [B, Tq, H]
    cos: jnp.ndarray,  # [B, Tq, D]
    sin: jnp.ndarray,
    kv: Dict[str, jnp.ndarray],  # FULL stacked cache {"k","v"[,"ks","vs"]}
    layer_idx: jnp.ndarray,  # scalar int32 — this block's slot in the stack
    write_pos: jnp.ndarray,  # scalar int32 — where new K/V rows go
    mask: jnp.ndarray,  # [B, Tq, S] bool
    spec: BlockSpec,
    flash_ctx: Optional[Dict] = None,  # {"pos","pad","window","interpret"}
    sliding: Optional[jnp.ndarray] = None,  # traced bool — THIS layer slides
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """One decoder block over an S-slot static KV cache.  Returns
    (x_out, kv').

    The cache is passed STACKED with a (traced) layer index, written with one
    in-place ``dynamic_update_slice`` and — on the flash path — read by the
    Pallas kernel straight from device memory.  Scanning over per-layer cache
    slices instead made XLA materialize/re-stack each layer's ~8 MB slice
    every decode step (0.6B talker at S=2048).

    With an int8 cache (init_kv_cache kv_quant=True) the freshly computed
    K/V rows are quantized per (position, head) before the write; the local
    prefill-attention path still uses the exact bf16 K/V.
    """
    B, Tq, H = x.shape
    kv_quant = "ks" in kv
    p = layer_params
    eps = spec.rms_norm_eps

    h = rms_norm(x, p["input_norm"], eps)
    qkv = maybe_matmul(h, p["qkv_proj"])
    q = qkv[..., : spec.q_dim].reshape(B, Tq, spec.num_heads, spec.head_dim)
    k = qkv[..., spec.q_dim : spec.q_dim + spec.kv_dim].reshape(
        B, Tq, spec.num_kv_heads, spec.head_dim)
    v = qkv[..., spec.q_dim + spec.kv_dim :].reshape(
        B, Tq, spec.num_kv_heads, spec.head_dim)
    q = rms_norm(q, p["q_norm"], eps)
    k = rms_norm(k, p["k_norm"], eps)
    q, k = apply_rope(q, k, cos, sin)  # rope in f32 for precision...
    q = q.astype(x.dtype)
    k = k.astype(x.dtype)  # ...but K/V are cached in the model dtype

    kv = dict(kv)
    if kv_quant:
        kq, ks = _quantize_rows(k)
        vq, vs = _quantize_rows(v)
        # scales are [B, Tq, KVH] -> cache layout [L, B, KVH, S]
        kv["ks"] = jax.lax.dynamic_update_slice(
            kv["ks"], ks.transpose(0, 2, 1)[None],
            (layer_idx, 0, 0, write_pos))
        kv["vs"] = jax.lax.dynamic_update_slice(
            kv["vs"], vs.transpose(0, 2, 1)[None],
            (layer_idx, 0, 0, write_pos))
        k_row, v_row = kq, vq
    else:
        k_row, v_row = k, v
    kv["k"] = jax.lax.dynamic_update_slice(
        kv["k"], k_row[None], (layer_idx, 0, write_pos, 0, 0))
    kv["v"] = jax.lax.dynamic_update_slice(
        kv["v"], v_row[None], (layer_idx, 0, write_pos, 0, 0))

    if flash_ctx is not None and Tq == 1:
        # flash-decode kernel: each row reads only ITS live KV slots (per-row
        # pad bounds — joined rows skip their dead tiles), straight out of
        # layer ``layer_idx`` of the stacked cache
        from ..ops.flash_decode import flash_decode_stacked

        def _flash(window):
            return flash_decode_stacked(
                q[:, 0], kv["k"], kv["v"], layer_idx,
                flash_ctx["pos"], flash_ctx["pad"],
                sliding_window=window,
                interpret=flash_ctx.get("interpret", False),
                k_scale=kv.get("ks"), v_scale=kv.get("vs"),
            )[:, None]

        win = flash_ctx.get("window")
        if win is not None and sliding is not None:
            # Mixed layer_types stack (upstream Qwen3 carries
            # "sliding_attention" layers; reference talker_graph.py:76,
            # predictor_graph.py:96-104): the window is a STATIC kernel
            # parameter (it sets the first tile read), so per-layer choice
            # inside the layer scan is a two-way cond over two compiled
            # kernel variants — both trace once, and each step runs only
            # the selected branch.
            attn = jax.lax.cond(
                sliding, lambda: _flash(win), lambda: _flash(None))
        else:
            attn = _flash(win)
    elif Tq > 1 and mask.shape[-1] == Tq:
        # Prefill with a LOCAL [B, T, T] mask: attend over the just-computed
        # prompt K/V instead of reading the padded S-slot cache back — the
        # [B, T, S] score tensor is up to S/T times larger for nothing
        # (Exact bf16 K/V even with an int8 cache.)
        attn = _attn_core(q, k, v, mask,
                          spec.num_heads // spec.num_kv_heads)
    else:
        k_l = jax.lax.dynamic_index_in_dim(kv["k"], layer_idx, 0, keepdims=False)
        v_l = jax.lax.dynamic_index_in_dim(kv["v"], layer_idx, 0, keepdims=False)
        if kv_quant:
            ks_l = jax.lax.dynamic_index_in_dim(kv["ks"], layer_idx, 0,
                                                keepdims=False)
            vs_l = jax.lax.dynamic_index_in_dim(kv["vs"], layer_idx, 0,
                                                keepdims=False)
            # ks_l [B, KVH, S] -> broadcast against k_l [B, S, KVH, D]
            k_l = (k_l.astype(jnp.float32)
                   * ks_l.transpose(0, 2, 1)[..., None]).astype(x.dtype)
            v_l = (v_l.astype(jnp.float32)
                   * vs_l.transpose(0, 2, 1)[..., None]).astype(x.dtype)
        attn = _attn_core(q, k_l, v_l, mask,
                          spec.num_heads // spec.num_kv_heads)
    x = x + maybe_matmul(attn.reshape(B, Tq, spec.q_dim), p["o_proj"])

    h = rms_norm(x, p["post_norm"], eps)
    gu = maybe_matmul(h, p["gateup_proj"])
    I = spec.intermediate_size
    x = x + maybe_matmul(
        jax.nn.silu(gu[..., :I]) * gu[..., I:], p["down_proj"])
    return x, kv


def stack_forward(
    stack_params: Dict[str, jnp.ndarray],  # layer-stacked [L, ...]
    x: jnp.ndarray,  # [B, Tq, H]
    cos: jnp.ndarray,
    sin: jnp.ndarray,
    kv: Dict[str, jnp.ndarray],  # {"k","v"}: [L, B, S, KVH, D]
    write_pos: jnp.ndarray,  # scalar int32
    mask_full: jnp.ndarray,  # [B, Tq, S]
    spec: BlockSpec,
    mask_sliding: Optional[jnp.ndarray] = None,  # [B, Tq, S] for sliding layers
    layer_is_sliding: Optional[jnp.ndarray] = None,  # [L] bool
    flash_ctx: Optional[Dict] = None,
    unroll: int = 1,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Run the whole layer stack with lax.scan.  Returns (x_out, kv').

    The KV cache rides the scan CARRY as the full stacked array and is
    updated with one in-place dynamic_update_slice per layer.  (Round 1
    scanned over per-layer slices as xs/ys, which forced XLA to re-stack —
    i.e. copy — every layer's cache slice each step; at S=2048 that was
    ~470 MB of hidden traffic per talker decode step.)

    ``unroll``: scan unroll factor — >1 lets XLA overlap the next layer's
    weight reads across the loop boundary (longer compile; measure with
    benchmarks/decompose.py --unroll)."""

    if layer_is_sliding is None or mask_sliding is None:
        layer_is_sliding = jnp.zeros((spec.num_layers,), bool)
        mask_sliding = mask_full

    def body(carry, inp):
        xc, kvc = carry
        lp, sliding, l = inp
        m = jnp.where(sliding, mask_sliding, mask_full)
        xc, kvc = block_forward(lp, xc, cos, sin, kvc, l, write_pos, m,
                                spec, flash_ctx=flash_ctx, sliding=sliding)
        return (xc, kvc), None

    (x_out, kv_new), _ = jax.lax.scan(
        body,
        (x, kv),
        (stack_params, layer_is_sliding,
         jnp.arange(spec.num_layers, dtype=jnp.int32)),
        unroll=unroll,
    )
    return x_out, kv_new


# ---------------------------------------------------------------------------
# masks — computed from traced scalars, replacing the reference's mask tables
# ---------------------------------------------------------------------------


def decode_mask(
    max_len: int,
    pos: jnp.ndarray,  # scalar int32: current absolute cache position
    pad_count: jnp.ndarray,  # [B] int32: left-pad rows to ignore
    sliding_window: Optional[int] = None,
) -> jnp.ndarray:
    """[B, 1, max_len] bool mask for a single-token decode step."""
    idx = jnp.arange(max_len, dtype=jnp.int32)[None, None, :]
    pc = pad_count[:, None, None]
    m = (idx <= pos) & (idx >= pc)
    if sliding_window is not None:
        m = m & (idx > pos - sliding_window)
    return m


def prefill_mask(
    seq_len: int,
    max_len: int,
    pad_count: jnp.ndarray,  # [B]
    sliding_window: Optional[int] = None,
) -> jnp.ndarray:
    """[B, seq_len, max_len] causal + left-pad mask for bucketed prefill.
    Key slots >= seq_len (future cache slots) are masked out."""
    qi = jnp.arange(seq_len, dtype=jnp.int32)[None, :, None]
    ki = jnp.arange(max_len, dtype=jnp.int32)[None, None, :]
    pc = pad_count[:, None, None]
    m = (ki <= qi) & (ki >= pc) & (ki < seq_len)
    if sliding_window is not None:
        m = m & (ki > qi - sliding_window)
    return m
