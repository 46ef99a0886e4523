#!/usr/bin/env python3
"""Per-component decode-step decomposition on the real device.

Times, in isolation: the talker decode step, the predictor 15-codebook
frame, the fused one-step, the fused chunk (per-step), and the streaming
vocoder window — the JAX analog of the reference's per-component table
(README.md:388-395: talker 12 ms / predictor 26 ms / overhead 16 ms on
Jetson).  Speed-of-light comparison: each component's weight bytes read
from device memory / measured time.

Usage: python benchmarks/decompose.py [--preset qwen3-tts-0.6b] [--iters 50]
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import time

sys.path.insert(0, ".")  # run from the repo root: python benchmarks/decompose.py

import jax
import jax.numpy as jnp
import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timeit(fn, iters, *, pipeline=False):
    """Median wall per call.  pipeline=True: dispatch all, block once
    (measures device-serial throughput, hiding host dispatch)."""
    jax.block_until_ready(fn())  # warm (compile)
    log(f"  compiled, timing {iters} iters...")
    if pipeline:
        t0 = time.time()
        out = None
        for _ in range(iters):
            out = fn()
        jax.block_until_ready(out)
        return (time.time() - t0) / iters
    times = []
    for _ in range(iters):
        t0 = time.time()
        jax.block_until_ready(fn())
        times.append(time.time() - t0)
    return float(np.median(times))


def tree_bytes(t):
    return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(t))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="qwen3-tts-0.6b")
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--quantize", default=None)
    p.add_argument("--no-flash", action="store_true")
    p.add_argument("--unroll", type=int, default=1)
    p.add_argument("--max-seq-len", type=int, default=2048)
    args = p.parse_args()

    from qwen3tts_tpu.core.loader import load_pretrained
    from qwen3tts_tpu.core.presets import get_preset
    from qwen3tts_tpu.models import predictor as predictor_lib
    from qwen3tts_tpu.models import talker as talker_lib
    from qwen3tts_tpu.models.predictor import SamplingPolicy
    from qwen3tts_tpu.runtime.engine import Engine, GenerationPolicy

    t0 = time.time()
    cfg, params = load_pretrained(f"random:{args.preset}")
    if args.quantize:
        from qwen3tts_tpu.ops.quant import quantize_bundle
        params = quantize_bundle(params, args.quantize)
    eng = Engine(params["talker"], params["predictor"], cfg,
                 use_flash_decode=False if args.no_flash else None,
                 scan_unroll=args.unroll, max_seq_len=args.max_seq_len)
    log(f"load: {time.time()-t0:.1f}s on {jax.devices()[0]}")

    H = cfg.talker.hidden_size
    dt = cfg.jnp_dtype
    pol, ppol = GenerationPolicy(), SamplingPolicy()
    knobs = eng.knobs(pol, ppol)
    key = jax.random.PRNGKey(0)
    embeds = jnp.zeros((1, 32, H), dt)
    tth = jnp.zeros((1, 16, H), dt)
    tpe = jnp.zeros((1, 1, H), dt)

    # --- build a decode state
    log("prefill (compile)...")
    state = eng.prefill(embeds, key, pol)
    jax.block_until_ready(state["token"])
    log("prefill done")

    # --- talker decode step alone.  Params are ARGUMENTS (a closure capture
    #     would bake 1.2 GB of weights into the HLO as constants).  kv
    #     donated, or iters in-flight copies of the 235 MB cache pile up in
    #     device memory.
    tcfg = cfg.talker
    kv = jax.tree.map(jnp.copy, state["kv"])
    x1 = jnp.zeros((1, 1, H), dt)

    @functools.partial(jax.jit, donate_argnames=("kv",))
    def talker_step(tp, x, pos, pad, kv):
        h, kv = talker_lib.decode_step(tp, tcfg, x, pos, pad, kv,
                                       use_flash=eng.use_flash_decode,
                                       unroll=eng.scan_unroll)
        return talker_lib.codec_head(tp, h[:, 0, :]), kv

    pos0 = state["pos"]
    pad0 = state["pad_count"]

    def run_talker():
        nonlocal kv
        logits, kv = talker_step(params["talker"], x1, pos0, pad0, kv)
        return logits

    log("talker_step: compiling...")
    t_talker = timeit(run_talker, args.iters, pipeline=True)
    log(f"talker_step: {t_talker*1e3:.2f} ms")

    # --- predictor frame alone (jitted; params as args, as above)
    pred_in = jnp.zeros((1, 2, H), dt)

    @jax.jit
    def pred_frame(pp, k):
        return predictor_lib.predict_frame(
            pp, cfg.predictor, pred_in, k, ppol.static,
            temperature=jnp.float32(0.9), top_p=jnp.float32(1.0))

    log("pred_frame: compiling...")
    t_pred = timeit(lambda: pred_frame(params["predictor"], key),
                    args.iters, pipeline=True)
    log(f"pred_frame: {t_pred*1e3:.2f} ms")

    # --- fused one-step (engine path)
    st = {k: (jax.tree.map(jnp.copy, v) if k == "kv" else v) for k, v in state.items()}

    def run_step():
        nonlocal st
        st, frame = eng.decode_step(st, tth, 16, tpe, pol, ppol, knobs=knobs)
        return frame

    log("fused step: running...")
    t_step = timeit(run_step, args.iters, pipeline=True)
    log(f"fused step: {t_step*1e3:.2f} ms")

    # --- fused chunk (16 steps per program), per-step
    st2 = eng.prefill(embeds, key, pol)

    def run_chunk():
        nonlocal st2
        st2, frames, n, lens, done = eng.decode_chunk(st2, tth, 0, tpe, pol,
                                                      ppol, 16, knobs=knobs)
        return frames

    log("chunk16: running...")
    t_chunk16 = timeit(run_chunk, max(4, args.iters // 8), pipeline=True) / 16
    log(f"chunk16/step: {t_chunk16*1e3:.2f} ms")

    # --- streaming vocoder: legacy window (25 ctx + 8) vs stateful stream
    from qwen3tts_tpu.audio.vocoder import Vocoder
    from qwen3tts_tpu.models import codec as codec_mod
    voc = Vocoder(params["codec"], cfg.codec)
    codes = jnp.zeros((1, 33, cfg.codec.num_quantizers), jnp.int32)
    voc_fn = lambda: voc._decode_jit(voc.params, codes=codes)
    t_voc = timeit(voc_fn, max(4, args.iters // 4), pipeline=True)

    vstate = jax.jit(lambda: codec_mod.stream_init(voc.params, voc.cfg, 1))()
    stream_step = jax.jit(
        functools.partial(codec_mod.decode_stream, cfg=voc.cfg),
        donate_argnames=("state",))
    codes8 = jnp.zeros((1, 8, cfg.codec.num_quantizers), jnp.int32)

    def voc_stream():
        nonlocal vstate
        wav, vstate = stream_step(voc.params, state=vstate, codes=codes8)
        return wav

    t_voc_stream = timeit(voc_stream, max(4, args.iters // 4), pipeline=True)
    log(f"vocoder stream(8): {t_voc_stream*1e3:.2f} ms "
        f"(window33: {t_voc*1e3:.2f})")

    talker_gb = tree_bytes(params["talker"]["blocks"]) / 1e9
    pred_frame_gb = (tree_bytes(params["predictor"]["blocks"]) * 15
                     + tree_bytes(params["predictor"]["lm_heads"])) / 1e9
    out = {
        "device": str(jax.devices()[0]),
        "preset": args.preset,
        "quantize": args.quantize,
        "talker_step_ms": round(t_talker * 1e3, 3),
        "predictor_frame_ms": round(t_pred * 1e3, 3),
        "fused_step_ms": round(t_step * 1e3, 3),
        "chunk16_per_step_ms": round(t_chunk16 * 1e3, 3),
        "vocoder_window33_ms": round(t_voc * 1e3, 3),
        "vocoder_stream8_ms": round(t_voc_stream * 1e3, 3),
        "talker_weight_GB_per_step": round(talker_gb, 3),
        "predictor_weight_GB_per_frame": round(pred_frame_gb, 3),
        "talker_achieved_GBps": round(talker_gb / t_talker, 1),
        "predictor_achieved_GBps": round(pred_frame_gb / t_pred, 1),
    }
    log(json.dumps(out, indent=2))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
