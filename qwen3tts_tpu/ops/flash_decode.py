"""Split-K flash-decode attention over the stacked static KV cache (Pallas,
Triton route, written for Hopper).

The reference leans on cuDNN SDPA over the full fixed-length mask
(SURVEY.md §2.3 item 3); the masked XLA path (models/layers.py) likewise
scores all ``max_seq_len`` slots.  This kernel reads only the *live* slots
``[max(pad, pos - window + 1), pos]`` of each row:

  - grid ``(B, KVH, k_splits)``: the live range of every (row, kv-head) is
    cut into ``k_splits`` contiguous runs of tiles, one block each, so a
    batch-1 step still puts ``KVH * k_splits`` blocks on the card's SMs
    (flash-decoding).  Splits are combined by log-sum-exp in a small XLA
    epilogue;
  - each block loads its own layer index, position and per-row pad (no
    scalar prefetch on this route) and loops over ``block_k``-slot tiles of
    the stacked cache ``[L, B, S, KVH, D]`` — no per-layer slice is copied
    out before the call, and no copy or transpose of the stacked cache is
    made around it (``chip_smoke.py`` checks the decode chunk's optimised
    HLO for both);
  - GQA groups are tiny (G = NH/KVH = 2 for the shipped presets), below
    the 16 rows a tensor-core dot needs, so scores and the PV product are
    broadcast-multiply-reduce on the CUDA cores.  The kernel is bound by
    the bytes it reads either way;
  - an int8 cache (``k_scale``/``v_scale`` planes ``[L, B, KVH, S]``) is
    dequantized in registers: the K scale multiplies the score, the V scale
    the probability, so no dequantized tile is ever materialised.

Rows admitted mid-batch by the continuous-batching scheduler carry large
left pads; the per-row lower bound skips their dead tiles entirely.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NEG_INF = -1e30
# blocks the launch aims for: two waves over an H100's 132 SMs
_TARGET_BLOCKS = 264


def default_k_splits(batch: int, num_kv_heads: int) -> int:
    """Power-of-two split count that puts about ``_TARGET_BLOCKS`` blocks on
    the card: 16 at batch 1 (128 blocks for 8 kv heads), 1 at batch >= 32."""
    want = max(1, _TARGET_BLOCKS // max(batch * num_kv_heads, 1))
    k = 1
    while k * 2 <= min(want, 16):
        k *= 2
    return k


def _kernel(meta_ref, pad_ref, q_ref, k_ref, v_ref, *rest, block_k: int,
            k_splits: int, sliding_window: Optional[int], scale: float,
            quant: bool):
    if quant:
        ks_ref, vs_ref, o_ref, m_ref, l_ref = rest
    else:
        o_ref, m_ref, l_ref = rest
    b, h, j = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    G, D = q_ref.shape[2], q_ref.shape[3]
    lay = meta_ref[0]
    pos = meta_ref[1]
    lo = jnp.maximum(pad_ref[b], 0)
    if sliding_window is not None:
        lo = jnp.maximum(lo, pos - sliding_window + 1)
    hi = pos + 1  # exclusive
    # tiles stay aligned to block_k, so no load crosses the cache's end
    t_lo = lo // block_k
    t_hi = jnp.maximum((hi + block_k - 1) // block_k, t_lo)
    per = (t_hi - t_lo + k_splits - 1) // k_splits
    t0 = t_lo + j * per
    t1 = jnp.minimum(t0 + per, t_hi)

    qs = [plgpu.load(q_ref.at[b, h, g, :]).astype(jnp.float32) * scale
          for g in range(G)]
    lanes = jnp.arange(block_k, dtype=jnp.int32)

    def body(t, carry):
        start = t * block_k
        idx = start + lanes
        valid = (idx >= lo) & (idx < hi)
        k = plgpu.load(k_ref.at[lay, b, pl.ds(start, block_k), h, :]
                       ).astype(jnp.float32)  # [BK, D]
        v = plgpu.load(v_ref.at[lay, b, pl.ds(start, block_k), h, :]
                       ).astype(jnp.float32)
        if quant:
            k_sc = plgpu.load(ks_ref.at[lay, b, h, pl.ds(start, block_k)])
            v_sc = plgpu.load(vs_ref.at[lay, b, h, pl.ds(start, block_k)])
        out = []
        for g in range(G):
            m_prev, l_prev, acc_prev = carry[g]
            s = jnp.sum(k * qs[g][None, :], axis=1)  # [BK]
            if quant:
                s = s * k_sc
            s = jnp.where(valid, s, NEG_INF)
            m_new = jnp.maximum(m_prev, jnp.max(s))
            corr = jnp.exp(m_prev - m_new)
            # NEG_INF is a finite sentinel: with every slot masked m_new ==
            # NEG_INF and exp(0) == 1 would count the masked slots, so zero
            # them and let a fully masked row keep l == 0
            p = jnp.where(valid, jnp.exp(s - m_new), 0.0)
            pv = p * v_sc if quant else p
            out.append((m_new, l_prev * corr + jnp.sum(p),
                        acc_prev * corr + jnp.sum(pv[:, None] * v, axis=0)))
        return tuple(out)

    init = tuple((jnp.float32(NEG_INF), jnp.float32(0.0),
                  jnp.zeros((D,), jnp.float32)) for _ in range(G))
    res = jax.lax.fori_loop(t0, t1, body, init)
    for g in range(G):
        m_g, l_g, acc_g = res[g]
        plgpu.store(o_ref.at[b, h, j, g, :], acc_g)
        plgpu.store(m_ref.at[b, h, j, g], m_g)
        plgpu.store(l_ref.at[b, h, j, g], l_g)


@functools.partial(
    jax.jit, static_argnames=("block_k", "k_splits", "sliding_window",
                              "interpret"))
def flash_decode_stacked(
    q: jnp.ndarray,  # [B, NH, D] (post rope+norm)
    k_stack: jnp.ndarray,  # [L, B, S, KVH, D] — the full layer-stacked cache
    v_stack: jnp.ndarray,  # [L, B, S, KVH, D]
    layer: jnp.ndarray,  # scalar int32 — which layer's cache to read
    pos: jnp.ndarray,  # scalar int32 (shared cache position)
    pad_count: jnp.ndarray,  # [B] int32 per-row left pads
    *,
    block_k: int = 64,
    k_splits: Optional[int] = None,
    sliding_window: Optional[int] = None,
    interpret: bool = False,
    k_scale: Optional[jnp.ndarray] = None,  # [L, B, KVH, S] f32 (int8 cache)
    v_scale: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Attention output [B, NH, D] (dtype of q) for a single-token decode,
    reading layer ``layer`` straight out of the stacked cache.

    Compiled through Pallas' Triton route, so it runs on a GPU only;
    ``interpret=True`` runs the same kernel through the Pallas interpreter
    (the CPU tests).  A fully masked row (``pad > pos``) returns zeros."""
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "flash_decode_stacked is compiled for the GPU only (backend is "
            f"{jax.default_backend()!r}); pass interpret=True to run it "
            "through the Pallas interpreter, or use the masked XLA path")
    L, B, S, KVH, D = k_stack.shape
    NH = q.shape[1]
    G = NH // KVH
    quant = k_scale is not None
    block_k = min(block_k, S)
    if S % block_k:
        raise ValueError(f"cache length {S} is not a multiple of {block_k}")
    if k_splits is None:
        k_splits = default_k_splits(B, KVH)
    meta = jnp.stack([jnp.asarray(layer, jnp.int32),
                      jnp.asarray(pos, jnp.int32)])
    pads = jnp.broadcast_to(jnp.asarray(pad_count, jnp.int32).reshape(-1), (B,))
    args = [meta, pads, q.reshape(B, KVH, G, D), k_stack, v_stack]
    if quant:
        args += [k_scale, v_scale]
    part = (B, KVH, k_splits, G)
    o, m, l = pl.pallas_call(
        functools.partial(
            _kernel, block_k=block_k, k_splits=k_splits,
            sliding_window=sliding_window, scale=D**-0.5, quant=quant),
        grid=(B, KVH, k_splits),
        out_shape=[jax.ShapeDtypeStruct(part + (D,), jnp.float32),
                   jax.ShapeDtypeStruct(part, jnp.float32),
                   jax.ShapeDtypeStruct(part, jnp.float32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="flash_decode",
    )(*args)
    # log-sum-exp combine of the splits; empty splits carry m == NEG_INF and
    # l == 0, and an all-empty row divides 0 by the guard and returns zeros
    m_all = jnp.max(m, axis=2, keepdims=True)
    w = jnp.exp(m - m_all)
    num = jnp.sum(o * w[..., None], axis=2)
    den = jnp.sum(l * w, axis=2)
    out = num / jnp.maximum(den, 1e-30)[..., None]
    return out.reshape(B, NH, D).astype(q.dtype)


def flash_decode_batched(q, k_cache, v_cache, pos, pad_count, **kw):
    """Single-layer form: q [B, NH, D], cache [B, S, KVH, D]."""
    return flash_decode_stacked(q, k_cache[None], v_cache[None], jnp.int32(0),
                                pos, pad_count, **kw)


def flash_decode(q, k_cache, v_cache, pos, pad_count, **kw):
    """Single-row form: q [NH, D], cache [S, KVH, D].  Returns [NH, D]."""
    return flash_decode_batched(q[None], k_cache[None], v_cache[None], pos,
                                jnp.reshape(pad_count, (1,)), **kw)[0]


def flash_decode_reference(q, k_cache, v_cache, pos, pad_count,
                           sliding_window=None):
    """Plain float32 oracle: full-length masked attention for one row
    (q [NH, D], cache [S, KVH, D])."""
    S, KVH, D = k_cache.shape
    NH = q.shape[0]
    G = NH // KVH
    qg = q.reshape(KVH, G, D).astype(jnp.float32)
    k = jnp.swapaxes(k_cache, 0, 1).astype(jnp.float32)  # [KVH, S, D]
    v = jnp.swapaxes(v_cache, 0, 1).astype(jnp.float32)
    scores = jnp.einsum("kgd,ksd->kgs", qg, k) * (D**-0.5)
    idx = jnp.arange(S)
    valid = (idx <= pos) & (idx >= pad_count)
    if sliding_window is not None:
        valid = valid & (idx > pos - sliding_window)
    scores = jnp.where(valid[None, None, :], scores, NEG_INF)
    p = jax.nn.softmax(scores, axis=-1)
    p = jnp.where(valid[None, None, :], p, 0.0)  # fully masked row -> zeros
    out = jnp.einsum("kgs,ksd->kgd", p, v)
    return out.reshape(NH, D).astype(q.dtype)
