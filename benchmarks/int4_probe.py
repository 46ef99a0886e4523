#!/usr/bin/env python3
"""int4 weight-streaming probe: is a 4-bit weight path worth building?

Batch-1 decode reads every weight once per step, so int4 would halve the
weight bytes again — IF the runtime actually streams 0.5 B/weight from
device memory instead of upcasting to a materialized copy.  This probe
times, on representative decode shapes, using the serial in-program chain
from matvec_probe.py (per-dispatch cost swamps sub-ms device times
otherwise):

  bf16          y = x @ W                       (2 B/weight)
  int8_deq      y = (x @ W8.astype(bf16)) * s   (1 B/weight, convert fused)
  w8a8          y = dot_int8(xq, W8) * s        (1 B/weight, int8 dot)
  int4_deq      y = (x @ W4.astype(bf16)) * s   (0.5 B/weight IF s4 stays packed)
  int4_packed   W4 packed 2-per-int8 [K/2,N,2]-style, shift-unpacked in-program

Verdict logic: int4_deq materially faster than int8_deq ⇒ an "int4" quant
mode would cut decode ms/step further; int4 ≈ int8 (or slower) ⇒ the unpack
cost eats the bandwidth win and the mode is not worth shipping.

Run on the real chip: python benchmarks/int4_probe.py
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


def inner_loop(mv, T, K):
    """One program containing T DEPENDENT matvecs (x feeds back), so the
    weights re-stream from HBM every iteration and dispatch cost amortizes."""

    def run(x, w):
        def body(i, xc):
            y = mv(xc, w)
            return xc + y.reshape(1, -1)[:, :K].astype(xc.dtype) * 1e-30

        return jax.lax.fori_loop(0, T, body, x)

    return jax.jit(run)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--k", type=int, default=1024)
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--inner", type=int, default=20)
    args = p.parse_args()

    K, N, T = args.k, args.n, args.inner
    rs = np.random.RandomState(0)
    wf = rs.randn(K, N).astype(np.float32)
    x = jnp.asarray(rs.randn(1, K), jnp.bfloat16)

    # int8 per-output-channel quant (ops/quant.py layout)
    amax8 = np.abs(wf).max(axis=0, keepdims=True)
    s8 = np.maximum(amax8, 1e-8) / 127.0
    q8 = np.clip(np.round(wf / s8), -127, 127).astype(np.int8)

    # int4 per-output-channel quant, range [-7, 7]
    s4 = np.maximum(amax8, 1e-8) / 7.0
    q4np = np.clip(np.round(wf / s4), -7, 7).astype(np.int8)

    w16 = jnp.asarray(wf, jnp.bfloat16)
    w8 = jnp.asarray(q8)
    s8d = jnp.asarray(s8)
    s4d = jnp.asarray(s4)

    # packed: rows 2k and 2k+1 share a byte -> [K//2, N] int8
    lo = q4np[0::2] & 0x0F
    hi = (q4np[1::2] & 0x0F) << 4
    wp = jnp.asarray((lo | hi).astype(np.uint8).view(np.int8))

    def mv_bf16(a, w):
        return a @ w

    def mv_int8(a, w):
        y = jnp.matmul(a, w.astype(a.dtype), preferred_element_type=jnp.float32)
        return (y * s8d).astype(a.dtype)

    def mv_w8a8(a, w):
        xf = a.astype(jnp.float32)
        xs = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-8) / 127.0
        xq = jnp.clip(jnp.round(xf / xs), -127, 127).astype(jnp.int8)
        acc = jax.lax.dot_general(xq, w, (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.int32)
        return (acc.astype(jnp.float32) * xs * s8d).astype(a.dtype)

    def mv_int4(a, w):
        y = jnp.matmul(a, w.astype(a.dtype), preferred_element_type=jnp.float32)
        return (y * s4d).astype(a.dtype)

    def mv_int4_packed(a, w):
        # unpack in-program: sign-extend each nibble via shifts
        lo = jnp.left_shift(w, 4)
        lo = jnp.right_shift(lo.astype(jnp.int8), 4)
        hi = jnp.right_shift(w.astype(jnp.int8), 4)
        full = jnp.stack([lo, hi], axis=1).reshape(K, N)  # rows interleave
        y = jnp.matmul(a, full.astype(a.dtype), preferred_element_type=jnp.float32)
        return (y * s4d).astype(a.dtype)

    cases = {
        "bf16": (mv_bf16, w16, 2.0),
        "int8_deq": (mv_int8, w8, 1.0),
        "w8a8": (mv_w8a8, w8, 1.0),
        "int4_packed": (mv_int4_packed, wp, 0.5),
    }
    try:
        # upload int8 and cast on device (jit so the cast runs as a
        # program): not every backend takes an s4 host transfer
        w4 = jax.jit(lambda a: a.astype(jnp.int4))(jnp.asarray(q4np))
        jax.block_until_ready(w4)
        cases["int4_deq"] = (mv_int4, w4, 0.5)
    except Exception as e:  # s4 unsupported on this backend/version
        log(f"jnp.int4 unavailable: {type(e).__name__}: {str(e)[:150]}")

    results = {}
    for name, (mv, w, bytes_per) in cases.items():
        gb = K * N * bytes_per / 1e9
        try:
            fn = inner_loop(mv, T, K)
            t = timeit(lambda: fn(x, w), args.iters) / T
            results[name] = {"ms": round(t * 1e3, 4),
                             "eff_GBps": round(gb / t, 1),
                             "bytes_per_weight": bytes_per}
            log(name, results[name])
        except Exception as e:
            results[name] = {"error": f"{type(e).__name__}: {str(e)[:200]}"}
            log(f"{name} failed: {results[name]['error']}")

    print(json.dumps({"device": str(jax.devices()[0]), "k": K, "n": N,
                      "inner": T, "results": results}))


if __name__ == "__main__":
    main()
