#!/usr/bin/env python3
"""Matvec weight-streaming probe: how fast can one card read weights?

Batch-1 decode is a chain of [1,K]x[K,N] matvecs; the whole step is bound by
streaming the weight matrices from device memory at best.  This probe times
isolated XLA formulations, as GB/s of weights read:

  xla_1row      y = x @ W                  (what the model does today)
  xla_8row      y = X8 @ W                 (padded-row variant)
  xla_pre_t     y = W_t @ x_t              ([N,K] layout, contraction on K)

Run: python benchmarks/matvec_probe.py [--k 1024] [--n 65536] [--iters 30]
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
    """Wrap a matvec in a serial in-program loop: per-call dispatch swamps
    sub-ms device times, so the device number is (one program containing T
    dependent matvecs) / T.  The x→y→x dependency forces sequential
    execution; size W above the 50 MB L2 so every iteration re-streams it."""

    def run(x, w):
        def body(i, xc):
            y = mv(xc, w)
            return xc + y.reshape(1, -1)[:, :K].astype(xc.dtype) * 1e-30

        return jax.lax.fori_loop(0, T, body, x)

    return jax.jit(run)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--k", type=int, default=1024)
    p.add_argument("--n", type=int, default=65536)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--inner", type=int, default=20, help="matvecs per program")
    p.add_argument("--dtype", default="bfloat16")
    args = p.parse_args()

    dt = jnp.dtype(args.dtype)
    K, N = args.k, args.n
    rs = np.random.RandomState(0)
    w = jnp.asarray(rs.randn(K, N), dt)
    wt = jnp.asarray(np.ascontiguousarray(np.asarray(w, np.float32).T), dt)
    x = jnp.asarray(rs.randn(1, K), dt)
    x8 = jnp.asarray(rs.randn(8, K), dt)
    gb = K * N * dt.itemsize / 1e9

    T = args.inner
    cases = {
        "xla_1row": (inner_loop(lambda a, ww: a @ ww, T, K), x, w),
        "xla_8row": (inner_loop(lambda a, ww: a @ ww, T, K), x8, w),
        "xla_pre_t": (inner_loop(lambda a, ww: (ww @ a.reshape(-1)[:K])[None, :], T, K), x, wt),
    }
    results = {}
    for name, (fn, a, ww) in cases.items():
        try:
            t = timeit(lambda: fn(a, ww), args.iters) / T
            results[name] = {"ms": round(t * 1e3, 3), "GBps": round(gb / t, 1)}
            log(name, results[name])
        except Exception as e:
            log(f"{name} failed: {type(e).__name__}: {str(e)[:200]}")

    dev = jax.devices()[0]
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind},
           "K": K, "N": N,
           "dtype": args.dtype, "weight_GB": round(gb, 3), "results": results}
    log(json.dumps(out, indent=2))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
