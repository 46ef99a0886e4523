#!/usr/bin/env python3
"""Talker decode-step ablation: where do the non-matmul milliseconds go?

benchmarks/decompose.py times the talker step against its 0.881 GB of
weights, and matvec_probe.py times a single XLA matmul's weight streaming.
This probe times progressively richer variants of the 28-layer step to
localize the gap.  Methodology follows decompose.py: params as jit
arguments (not baked constants), T dependent steps inside ONE program (so
per-call dispatch does not swamp the device time), KV carried through the
in-program loop so updates stay in-place.

  mm_only      the 4 projection matmuls per layer, dependency-chained
  mm_norms     + rms_norms / silu / residuals
  mm_rope      + q/k head norms + rope (no attention)
  attn_masked  + masked jnp attention over the full S-slot cache
  attn_flash   + the flash-decode kernel instead (the engine's GPU path)

Run: python benchmarks/layer_ablation.py [--pos 500] [--iters 20] [--inner 20]
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from qwen3tts_tpu.core.presets import PRESETS
from qwen3tts_tpu.models import talker as talker_lib
from qwen3tts_tpu.models.layers import (
    BlockSpec, block_forward, decode_mask, init_kv_cache, rms_norm,
)
from qwen3tts_tpu.ops.rope import apply_rope


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timeit_readback_delta(mk_run, call_T, T, reps=5):
    """Per-step seconds via the two-length readback protocol.

    Timing the SAME program at inner-loop lengths T and 2T, each ended by
    a device->host readback (np.asarray), and taking the delta cancels both
    the readback and the dispatch cost exactly."""
    def med(T_):
        run = mk_run(T_)
        np.asarray(call_T(run))  # warm (compile) + readback
        ts = []
        for _ in range(reps):
            t0 = time.time()
            np.asarray(call_T(run))
            ts.append(time.time() - t0)
        return sorted(ts)[len(ts) // 2]
    return (med(2 * T) - med(T)) / T


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="qwen3-tts-0.6b")
    p.add_argument("--pos", type=int, default=500)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--inner", type=int, default=20)
    args = p.parse_args()

    cfg = PRESETS[args.preset].talker
    spec = BlockSpec(
        num_layers=cfg.num_hidden_layers,
        hidden_size=cfg.hidden_size,
        num_heads=cfg.num_attention_heads,
        num_kv_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim,
        intermediate_size=cfg.intermediate_size,
        rms_norm_eps=cfg.rms_norm_eps,
    )
    dt = jnp.bfloat16
    params = talker_lib.init_params(jax.random.PRNGKey(0), cfg, dtype=dt)
    blocks = params["blocks"]
    S = 2048
    T = args.inner
    x0 = jax.random.normal(jax.random.PRNGKey(1), (1, 1, cfg.hidden_size), dt)
    pos = jnp.int32(args.pos)
    pad = jnp.zeros((1,), jnp.int32)

    gb = sum(int(np.prod(v.shape)) * 2 for v in blocks.values() if v.ndim == 3) / 1e9
    log(f"layer-stack weight GB/step: {gb:.3f}")

    cos, sin = talker_lib._positions(cfg, (pos - pad)[:, None])
    I = spec.intermediate_size

    def mm_layer(xc, lp):
        qkv = xc @ lp["qkv_proj"]
        a = qkv[..., : spec.q_dim]
        xc = xc + a @ lp["o_proj"]
        gu = xc @ lp["gateup_proj"]
        return xc + (gu[..., :I] * gu[..., I:]) @ lp["down_proj"]

    def mmn_layer(xc, lp):
        h = rms_norm(xc, lp["input_norm"], spec.rms_norm_eps)
        qkv = h @ lp["qkv_proj"]
        a = qkv[..., : spec.q_dim]
        xc = xc + a @ lp["o_proj"]
        h = rms_norm(xc, lp["post_norm"], spec.rms_norm_eps)
        gu = h @ lp["gateup_proj"]
        return xc + (jax.nn.silu(gu[..., :I]) * gu[..., I:]) @ lp["down_proj"]

    def mmr_layer(xc, lp):
        h = rms_norm(xc, lp["input_norm"], spec.rms_norm_eps)
        qkv = h @ lp["qkv_proj"]
        q = qkv[..., : spec.q_dim].reshape(1, 1, spec.num_heads, spec.head_dim)
        k = qkv[..., spec.q_dim : spec.q_dim + spec.kv_dim].reshape(
            1, 1, spec.num_kv_heads, spec.head_dim)
        q = rms_norm(q, lp["q_norm"], spec.rms_norm_eps)
        k = rms_norm(k, lp["k_norm"], spec.rms_norm_eps)
        q, k = apply_rope(q, k, cos, sin)
        a = q.astype(xc.dtype).reshape(1, 1, spec.q_dim)
        xc = xc + a @ lp["o_proj"]
        h = rms_norm(xc, lp["post_norm"], spec.rms_norm_eps)
        gu = h @ lp["gateup_proj"]
        return xc + (jax.nn.silu(gu[..., :I]) * gu[..., I:]) @ lp["down_proj"]

    def make_stateless(layer_fn):
        def mk(T_):
            @jax.jit
            def run(x, bl):
                def outer(i, xc):
                    def body(carry, lp):
                        return layer_fn(carry, lp), None
                    xc, _ = jax.lax.scan(body, xc, bl)
                    # keep magnitude bounded across T steps; the clip keeps
                    # the norm-free variant finite (28 un-normalized layers
                    # overflow bf16 into NaN otherwise)
                    return jnp.clip(xc * 1e-3, -10.0, 10.0)
                return jax.lax.fori_loop(0, T_, outer, x)
            return run
        return mk

    results = {}
    for name, fn in (("mm_only", mm_layer), ("mm_norms", mmn_layer),
                     ("mm_rope", mmr_layer)):
        t = timeit_readback_delta(make_stateless(fn),
                                  lambda run: run(x0, blocks), T)
        results[name] = round(t * 1e3, 3)
        log(name, results[name], "ms", f"{gb/t:.0f} GB/s")

    # --- variants that touch the KV cache ---
    def make_kv_variant(mode):
        def mk(T_):
            @functools.partial(jax.jit, donate_argnames=("kv",),
                               static_argnames=("m",))
            def run(x, bl, kv, m):
                def outer(i, carry):
                    xc, kvc = carry
                    pos_i = pos  # fixed position: constant bytes per step
                    mask = decode_mask(S, pos_i, pad)
                    fctx = ({"pos": pos_i, "pad": pad, "window": None}
                            if m == "flash" else None)

                    def body(c, inp):
                        xb, kvb = c
                        lp, l = inp
                        xb, kvb = block_forward(
                            lp, xb, cos, sin, kvb, l, pos_i, mask, spec,
                            flash_ctx=fctx)
                        return (xb, kvb), None

                    (xc, kvc), _ = jax.lax.scan(
                        body, (xc, kvc),
                        (bl, jnp.arange(spec.num_layers, dtype=jnp.int32)))
                    return xc * 1e-3, kvc
                return jax.lax.fori_loop(0, T_, outer, (x, kv))
            return run
        return mk

    for name, m in (("attn_masked", "masked"), ("attn_flash", "flash")):
        def call(run, m=m):
            # fresh cache every call: kv is donated into the program
            out, _ = run(x0, blocks, init_kv_cache(spec, 1, S, dt), m)
            return out

        t = timeit_readback_delta(make_kv_variant(m), call, T)
        results[name] = round(t * 1e3, 3)
        log(name, results[name], "ms", f"{gb/t:.0f} GB/s")

    out = {"device": str(jax.devices()[0]), "pos": args.pos,
           "weight_GB": round(gb, 3), "inner": T, "ms": results}
    log(json.dumps(out))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
