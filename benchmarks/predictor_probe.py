#!/usr/bin/env python3
"""Predictor-frame decomposition: layers vs lm_heads vs sampling.

The 15-codebook frame reads ~1.95 GB of predictor weights per frame (0.6B,
bf16).  Candidate costs per micro-step (×15): lax.top_k(50) over the
2048-logit codebook, the lm_head read, rope/mask recompute, scan structure.
This probe times pred_frame variants to attribute the time:

  sampled      the real path (top_k=50, temperature)
  greedy       do_sample=False (argmax — no top_k/softmax/gumbel)
  layers_only  15 micro-steps of the 5-layer stack, token fixed (no lm_head,
               no sampling, no embedding gather)

Run: python benchmarks/predictor_probe.py [--iters 30]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timeit(fn, iters):
    jax.block_until_ready(fn())
    t0 = time.time()
    out = None
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.time() - t0) / iters


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="qwen3-tts-0.6b")
    p.add_argument("--iters", type=int, default=30)
    args = p.parse_args()

    from qwen3tts_tpu.core.loader import load_pretrained
    from qwen3tts_tpu.models import predictor as predictor_lib
    from qwen3tts_tpu.models.predictor import SamplingPolicy, StaticPolicy

    cfg, params = load_pretrained(f"random:{args.preset}")
    pp = params["predictor"]
    pcfg = cfg.predictor
    H = cfg.talker.hidden_size
    dt = cfg.jnp_dtype
    pred_in = jnp.zeros((1, 2, H), dt)
    key = jax.random.PRNGKey(0)

    results = {}

    @jax.jit
    def run_sampled(pp, k):
        return predictor_lib.predict_frame(
            pp, pcfg, pred_in, k, StaticPolicy(do_sample=True, top_k=50),
            temperature=jnp.float32(0.9), top_p=jnp.float32(1.0))

    @jax.jit
    def run_greedy(pp, k):
        return predictor_lib.predict_frame(
            pp, pcfg, pred_in, k, StaticPolicy(do_sample=False, top_k=50),
            temperature=jnp.float32(0.9), top_p=jnp.float32(1.0))

    for name, fn in (("sampled", run_sampled), ("greedy", run_greedy)):
        log(f"{name}: compiling...")
        t = timeit(lambda fn=fn: fn(pp, key), args.iters)
        results[name] = round(t * 1e3, 3)
        log(name, results[name], "ms")

    # --- layers_only: the 15 sequential 5-layer micro-steps with a fixed
    #     token (weight streaming + scan structure, nothing else)
    from qwen3tts_tpu.models.layers import decode_mask, init_kv_cache, rms_norm, stack_forward
    from qwen3tts_tpu.models.predictor import _proj, _rope, block_spec

    spec = block_spec(pcfg)
    S = pcfg.max_seq

    @jax.jit
    def run_layers(pp):
        kv = init_kv_cache(spec, 1, S, dt)
        emb0 = pp["codec_embeddings"][0][0]  # [H_talker]
        x0 = _proj(pp, emb0[None, None, :])

        def body(carry, cb):
            kv_c, x = carry
            pos = jnp.int32(1) + cb
            cos_d, sin_d = _rope(pcfg, jnp.broadcast_to(pos[None, None], (1, 1)))
            m_d = decode_mask(S, pos, jnp.zeros((1,), jnp.int32))
            y, kv_c = stack_forward(pp["blocks"], x, cos_d, sin_d, kv_c, pos,
                                    m_d, spec)
            y = rms_norm(y, pp["final_norm"], pcfg.rms_norm_eps)
            return (kv_c, y * 1e-3 + x0), y[:, 0, 0]

        (_, _), ys = jax.lax.scan(
            body, (kv, x0), jnp.arange(0, 15, dtype=jnp.int32))
        return ys

    log("layers_only: compiling...")
    t = timeit(lambda: run_layers(pp), args.iters)
    results["layers_only"] = round(t * 1e3, 3)
    log("layers_only", results["layers_only"], "ms")

    out = {"device": jax.devices()[0].device_kind, "preset": args.preset,
           "ms": results}
    log(json.dumps(out))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
