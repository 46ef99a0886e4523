#!/usr/bin/env python3
"""On-card smoke check of the TTS engine: runs the main path once on one
GPU, at the full width of the 0.6B preset (random weights from a seed), in
one process.

    python chip_smoke.py                  # one card, every phase below
    python chip_smoke.py --four-cards     # four cards: replicas + TP only
    python chip_smoke.py --attention-grid # one card: the decode-attention
                                          # timing grid (PERF.md decision)

Phases (one line each; any failure ends the run with a non-zero exit):

  device     a GPU is present (else exit 2, no result line), its kind, the
             count and the card's name and power limit from nvidia-smi
  kernel     the flash-decode kernel, compiled for the card, against the
             plain float32 reference at NH 16 / KVH 8 / D 128 / S 2048; the
             decode chunk's optimised HLO (no cache slice or copy around the
             kernel); one 8-step decode chunk timed on both attention paths
  clone      B=1 voice clone, non-streaming and streaming (chunk 8): finite
             audio of exactly steps x 2000 samples; load/compile/TTFA/RTF
  serve      the OpenAI-compatible server in-process at max_batch 8: four
             concurrent POST /v1/audio/speech, each a valid WAV of exactly
             the pinned 24 frames
  modes      short generations with quantize=int8, quantize=w8a8 and an
             int8 KV cache

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

PRESET = "random:qwen3-tts-0.6b"
SPF = 2000  # audio samples per codec frame (24 kHz / 12 Hz)
F32_TOL = 1e-4  # float32 inputs: summation order only
BF16_TOL = 2e-2  # bf16 inputs: outputs are convex mixes of bf16 values
TEXT = ("The quick brown fox jumps over the lazy dog while the tired "
        "developer checks the speech engine on a new card.")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them (a card
    set below its maximum runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return " | ".join(line.strip() for line in out.stdout.splitlines()
                      if line.strip())


def phase_device(jax, want: int) -> dict:
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform is {devs[0].platform!r})",
              file=sys.stderr)
        sys.exit(2)
    if len(devs) < want:
        print(f"chip_smoke: need {want} GPUs, found {len(devs)}",
              file=sys.stderr)
        sys.exit(2)
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    say("device", f"{info['kind']} x{info['count']}; nvidia-smi: {card_line()}")
    return info


def _write_ref_wav(path: str) -> None:
    from qwen3tts_tpu.audio.wav import write_wav

    sr = 24_000
    t = np.linspace(0, 3.0, 3 * sr, dtype=np.float32)
    wav = 0.25 * np.sin(2 * np.pi * 180 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 2.5 * t))
    write_wav(path, wav.astype(np.float32), sr)


# ---------------------------------------------------------------------------
# kernel parity + attention timing
# ---------------------------------------------------------------------------


def parity_cases():
    """(name, B, pos, pads, window, quant) at the talker's real geometry."""
    mixed = [0, 5, 100, 349, 0, 17, 200, 64]
    cases = []
    for B in (1, 8):
        for pos in (0, 350, 2047):
            cases.append((f"B{B}-pos{pos}", B, pos, mixed[:B], None, False))
    cases.append(("window256", 8, 1500, mixed, 256, False))
    cases.append(("padded-row", 2, 100, [0, 300], None, False))
    cases.append(("int8-B1", 1, 2047, [0], None, True))
    cases.append(("int8-B8", 8, 350, mixed, None, True))
    return cases


def check_kernel_parity(jax, jnp) -> dict:
    """Max |kernel - f32 reference| over every case and input dtype; raises
    if any case is outside its tolerance."""
    from qwen3tts_tpu.ops.flash_decode import (flash_decode_reference,
                                               flash_decode_stacked)

    NH, KVH, D, S, L = 16, 8, 128, 2048, 2
    worst = {}
    ref_fn = jax.jit(jax.vmap(flash_decode_reference,
                              in_axes=(0, 0, 0, None, 0, None)),
                     static_argnums=(5,))
    for name, B, pos, pads, window, quant in parity_cases():
        ks = jax.random.split(jax.random.PRNGKey(pos + B), 3)
        q = jax.random.normal(ks[0], (B, NH, D), jnp.float32)
        k = jax.random.normal(ks[1], (L, B, S, KVH, D), jnp.float32)
        v = jax.random.normal(ks[2], (L, B, S, KVH, D), jnp.float32)
        pads_a = jnp.asarray(pads, jnp.int32)
        for dtype, tol in ((jnp.float32, F32_TOL), (jnp.bfloat16, BF16_TOL)):
            qd = q.astype(dtype)
            if quant:
                kq, ksc = _quantize(k)
                vq, vsc = _quantize(v)
                out = flash_decode_stacked(
                    qd, kq, vq, jnp.int32(1), jnp.int32(pos), pads_a,
                    sliding_window=window, k_scale=ksc, v_scale=vsc)
                kr = kq[1].astype(jnp.float32) * jnp.swapaxes(ksc[1], 1, 2)[..., None]
                vr = vq[1].astype(jnp.float32) * jnp.swapaxes(vsc[1], 1, 2)[..., None]
            else:
                kd, vd = k.astype(dtype), v.astype(dtype)
                out = flash_decode_stacked(
                    qd, kd, vd, jnp.int32(1), jnp.int32(pos), pads_a,
                    sliding_window=window)
                kr, vr = kd[1].astype(jnp.float32), vd[1].astype(jnp.float32)
            with jax.default_matmul_precision("highest"):
                ref = ref_fn(qd.astype(jnp.float32), kr, vr, pos, pads_a, window)
            err = float(jnp.max(jnp.abs(out.astype(jnp.float32) - ref)))
            if not np.isfinite(err) or err > tol:
                raise AssertionError(
                    f"kernel parity {name} {jnp.dtype(dtype).name}: max abs "
                    f"err {err:.3g} > tol {tol:g}")
            key = jnp.dtype(dtype).name
            worst[key] = max(worst.get(key, 0.0), err)
            if pads and max(pads) > pos:  # a fully padded row gives zeros
                row = int(np.argmax(np.asarray(pads) > pos))
                if float(jnp.max(jnp.abs(out[row]))) != 0.0:
                    raise AssertionError(f"{name}: fully padded row not zero")
    return worst


def _quantize(x):
    """[L,B,S,KVH,D] f32 -> int8 rows + [L,B,KVH,S] scales (cache layout)."""
    import jax.numpy as jnp

    s = jnp.maximum(jnp.max(jnp.abs(x), axis=-1), 1e-8) / 127.0
    q = jnp.clip(jnp.round(x / s[..., None]), -127, 127).astype(jnp.int8)
    return q, jnp.swapaxes(s, 2, 3)


def _chunk_setup(jax, jnp, model, B: int, pos: int, pads, kv_quant: bool,
                 flash: bool):
    """A bf16 0.6B Engine on the chosen attention path and the arguments of
    one 8-step decode_chunk at cache position ``pos`` with per-row
    ``pads`` (no row ends early)."""
    from qwen3tts_tpu.models.predictor import SamplingPolicy
    from qwen3tts_tpu.runtime.engine import Engine, GenerationPolicy

    cfg = model.cfg
    eng = Engine(model.params["talker"], model.params["predictor"], cfg,
                 max_seq_len=2048, batch=B, kv_quant=kv_quant,
                 use_flash_decode=flash)
    H, V = cfg.talker.hidden_size, cfg.talker.vocab_size
    pol = GenerationPolicy(min_new_tokens=1 << 20)
    ppol = SamplingPolicy()
    state = {
        "kv": eng.new_kv(), "past_hidden": jnp.zeros((B, 1, H), eng.dtype),
        "token": jnp.zeros((B,), jnp.int32), "pos": jnp.int32(pos),
        "pad_count": jnp.asarray(pads, jnp.int32),
        "gen_step": jnp.zeros((B,), jnp.int32),
        "seen": jnp.zeros((B, V), bool), "n_gen": jnp.zeros((B,), jnp.int32),
        "done": jnp.zeros((B,), bool), "key": jax.random.PRNGKey(0),
    }
    args = (state, jnp.zeros((B, 16, H), eng.dtype), 0,
            jnp.zeros((B, 1, H), eng.dtype), pol, ppol, 8)
    return eng, args


def time_decode_chunk(jax, jnp, model, B: int, pos: int, pads, kv_quant: bool,
                      flash: bool, calls: int = 20, warm: int = 3):
    """(median ms, first-call s) of one 8-step decode_chunk (bf16 0.6B) at
    cache position ``pos`` with per-row ``pads``, on the chosen attention
    path."""
    eng, (state, tth, tth_len, tpe, pol, ppol, cs) = _chunk_setup(
        jax, jnp, model, B, pos, pads, kv_quant, flash)
    knobs = eng.knobs(pol, ppol)
    times = []
    for i in range(warm + calls):
        state["pos"] = jnp.int32(pos)
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        state, frames, n, _, _ = eng.decode_chunk(state, tth, tth_len, tpe,
                                                  pol, ppol, cs, knobs=knobs)
        jax.block_until_ready(frames)
        times.append((time.perf_counter() - t0) * 1e3)
        if int(n) != cs:
            raise AssertionError(f"decode_chunk ran {int(n)} of {cs} steps")
    return float(np.median(times[warm:])), times[0] / 1e3


_HLO_INSTR = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\w+)\[([\d,]*)\]\S*\s+([\w\-]+)\(")
_HLO_CALL = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=.*?\scustom-call\(([^)]*)\)")
_FREE_OPS = {"parameter", "get-tuple-element", "bitcast", "tuple"}


def _operands(line: str, start: int) -> list:
    """Operand names of the instruction whose argument list opens at
    ``line[start]``."""
    args = re.sub(r"/\*.*?\*/", "", line[start:].split(")", 1)[0])
    return [a.split()[-1].lstrip("%") for a in args.split(",") if a.strip()]


def hlo_cache_audit(hlo: str, stacked_shapes, layer_shapes) -> dict:
    """Scan optimised HLO text for KV-cache-sized buffers that a program
    materialises outside fused computations: any op (but a bitcast) that
    yields a per-layer cache shape, and any copy, or fusion not rooted in
    an in-place dynamic-update-slice, that yields a stacked cache shape.
    Shapes match in any order of their dims, so transposes count too.
    Also counts the Triton custom calls and whether one of them takes a
    stacked cache operand (through bitcasts)."""
    stacked = {tuple(sorted(s)) for s in stacked_shapes}
    layer = {tuple(sorted(s)) for s in layer_shapes}
    fused = set(re.findall(r"\bfusion\(.*?calls=%?([\w.\-]+)", hlo))
    comps, comp = {}, None  # computation -> [line]
    for line in hlo.splitlines():
        if line and not line[0].isspace() and line.rstrip().endswith("{"):
            comp = line.split()[1 if line.startswith("ENTRY") else 0].lstrip("%")
            comps[comp] = []
        elif comp is not None:
            comps[comp].append(line)
    roots = {}
    for name, lines in comps.items():
        for line in lines:
            m = _HLO_INSTR.match(line)
            if m and line.lstrip().startswith("ROOT"):
                roots[name] = m.group(4)
    out = {"layer_buffers": [], "stacked_copies": [], "stacked_updates": 0,
           "triton_calls": 0, "kernel_reads_stacked": False}
    for name, lines in comps.items():
        if name in fused:
            continue
        instrs = {}  # name -> (dims, op, operands)
        for line in lines:
            m = _HLO_INSTR.match(line)
            if m:
                dims = tuple(sorted(int(d) for d in m.group(3).split(",") if d))
                instrs[m.group(1)] = (dims, m.group(4),
                                      _operands(line, m.end()))
        for line in lines:
            call = _HLO_CALL.match(line)
            if call and "triton" in line:
                out["triton_calls"] += 1
                for op in _operands(line, call.start(1)):
                    while op in instrs and instrs[op][1] == "bitcast":
                        op = instrs[op][2][0]
                    if op in instrs and instrs[op][0] in stacked:
                        out["kernel_reads_stacked"] = True
                continue
            m = _HLO_INSTR.match(line)
            if not m:
                continue
            iname, op = m.group(1), m.group(4)
            dims = instrs[iname][0]
            if dims in layer and op not in _FREE_OPS:
                out["layer_buffers"].append(f"{iname} ({op})")
            elif dims in stacked and op.startswith("copy"):
                out["stacked_copies"].append(iname)
            elif dims in stacked and op == "fusion":
                callee = re.search(r"calls=%?([\w.\-]+)", line)
                if callee and roots.get(callee.group(1)) == "dynamic-update-slice":
                    out["stacked_updates"] += 1
                else:
                    out["stacked_copies"].append(f"{iname} (fusion)")
    return out


def decode_hlo(jax, jnp, model, B: int, kv_quant: bool, flash: bool) -> str:
    """Optimised HLO text of one 8-step decode_chunk at 0.6B width."""
    eng, (state, tth, tth_len, tpe, pol, ppol, cs) = _chunk_setup(
        jax, jnp, model, B, 0, [0] * B, kv_quant, flash)
    return eng._chunk_jit.lower(
        eng.talker_params, eng.predictor_params, state, tth,
        eng._tth_len_vec(tth_len), tpe, eng.knobs(pol, ppol),
        policy=pol.static, pred_policy=ppol.static,
        chunk_size=cs).compile().as_text()


def cache_audit(model, hlo: str, B: int) -> dict:
    """hlo_cache_audit at the talker's cache shapes (S = 2048)."""
    t = model.cfg.talker
    L, S, KVH, D = t.num_hidden_layers, 2048, t.num_key_value_heads, t.head_dim
    return hlo_cache_audit(hlo, [(L, B, S, KVH, D), (L, B, KVH, S)],
                           [(B, S, KVH, D), (B, KVH, S)])


def phase_decode_hlo(jax, jnp, model) -> None:
    """The kernel reads the stacked cache in place: in the optimised HLO of
    the decode chunk (B=1, bf16 and int8 caches) no per-layer cache buffer
    and no copy of the stacked cache is materialised around the call."""
    for kvq in (False, True):
        audit = cache_audit(model, decode_hlo(jax, jnp, model, 1, kvq, True), 1)
        if (audit["layer_buffers"] or audit["stacked_copies"]
                or not audit["kernel_reads_stacked"]):
            raise AssertionError(f"decode_chunk HLO materialises cache "
                                 f"buffers around the kernel: {audit}")
        say("kernel", f"decode_chunk(8) HLO, {'int8' if kvq else 'bf16'} "
                      f"cache: {audit['triton_calls']} Triton calls read the "
                      f"stacked cache, {audit['stacked_updates']} in-place "
                      f"cache updates, no per-layer cache buffer, no copy of "
                      f"the stacked cache")


def attention_shapes(full: bool):
    """(label, B, pos, pads, kv_quant).  ``full``: the decision grid."""
    mixed8 = [0, 40, 120, 300, 0, 500, 77, 650]
    mixed24 = [(37 * i) % 700 for i in range(24)]
    shapes = [("B1-pos350-bf16", 1, 350, [0], False),
              ("B8-pos1024-mixed-bf16", 8, 1024, mixed8, False)]
    if full:
        shapes = [
            ("B1-pos350-bf16", 1, 350, [0], False),
            ("B1-pos1800-bf16", 1, 1800, [0], False),
            ("B8-pos1024-mixed-bf16", 8, 1024, mixed8, False),
            ("B24-pos1024-mixed-bf16", 24, 1024, mixed24, False),
            ("B1-pos350-int8", 1, 350, [0], True),
            ("B1-pos1800-int8", 1, 1800, [0], True),
            ("B8-pos1024-mixed-int8", 8, 1024, mixed8, True),
            ("B24-pos1024-mixed-int8", 24, 1024, mixed24, True),
        ]
    return shapes


def time_attention_paths(jax, jnp, model, full: bool) -> list:
    rows = []
    for label, B, pos, pads, kvq in attention_shapes(full):
        masked, c_m = time_decode_chunk(jax, jnp, model, B, pos, pads, kvq,
                                        False)
        kernel, c_k = time_decode_chunk(jax, jnp, model, B, pos, pads, kvq,
                                        True)
        rows.append({"shape": label, "masked_ms": masked, "kernel_ms": kernel})
        say("kernel", f"decode_chunk(8) {label}: masked XLA {masked:.3f} ms, "
                      f"flash kernel {kernel:.3f} ms (median of 20; first "
                      f"calls {c_m:.1f}s / {c_k:.1f}s)")
    return rows


# ---------------------------------------------------------------------------
# end-to-end phases
# ---------------------------------------------------------------------------


def clone_kwargs(ref_wav: str, steps: int) -> dict:
    return dict(text=TEXT, language="English", ref_audio=ref_wav,
                ref_text="reference transcript", max_new_tokens=steps,
                min_new_tokens=steps)  # random weights: pin the length


def _check_audio(audio, steps: int, what: str) -> None:
    audio = np.asarray(audio)
    if audio.shape != (steps * SPF,) or not np.isfinite(audio).all():
        raise AssertionError(
            f"{what}: audio shape {audio.shape}, want ({steps * SPF},), "
            f"finite={bool(np.isfinite(audio).all())}")


def phase_clone(model, ref_wav: str, load_s: float, card: str) -> None:
    steps = 48
    kw = clone_kwargs(ref_wav, steps)
    t0 = time.time()
    audio, _ = model.generate_voice_clone(**kw)
    first_s = time.time() - t0
    _check_audio(audio[0], steps, "generate_voice_clone (first)")
    t0 = time.time()
    audio, _ = model.generate_voice_clone(**kw)
    wall = time.time() - t0
    _check_audio(audio[0], steps, "generate_voice_clone")
    rtf = (steps / 12.0) / wall

    t0 = time.time()
    chunks = [c for c, _, _ in model.generate_voice_clone_streaming(
        **kw, chunk_size=8)]
    stream_first_s = time.time() - t0
    _check_audio(np.concatenate(chunks), steps, "streaming (first)")
    t0 = time.time()
    ttfa = None
    chunks = []
    for c, _, _ in model.generate_voice_clone_streaming(**kw, chunk_size=8):
        if ttfa is None:
            ttfa = (time.time() - t0) * 1e3
        chunks.append(c)
    stream_rtf = (steps / 12.0) / (time.time() - t0)
    _check_audio(np.concatenate(chunks), steps, "streaming")
    say("clone", f"0.6B bf16 B=1 {steps} steps: load {load_s:.1f}s, first "
                 f"call (compile+run) {first_s:.1f}s, streaming first call "
                 f"{stream_first_s:.1f}s; RTF {rtf:.3f}, streaming RTF "
                 f"{stream_rtf:.3f}, TTFA {ttfa:.1f} ms (information only; "
                 f"{card})")


def _post_speech(url: str, text: str, steps: int) -> bytes:
    req = urllib.request.Request(
        url + "/v1/audio/speech",
        data=json.dumps({"input": text, "response_format": "wav",
                         "max_new_tokens": steps}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.read()


def _wav_samples(data: bytes, steps: int, what: str) -> int:
    """Validate one streamed WAV (44-byte header, PCM16 body of exactly
    ``steps`` codec frames); return its sample count."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE" or len(data) < 44:
        raise AssertionError(f"{what}: not a WAV stream")
    body = len(data) - 44
    n = body // 2
    if body % 2 or n != steps * SPF:
        raise AssertionError(f"{what}: {body} body bytes, want "
                             f"{steps * SPF} PCM16 samples")
    pcm = np.frombuffer(data[44:], np.int16)
    if not np.any(pcm):
        raise AssertionError(f"{what}: silent audio")
    return n


@contextlib.contextmanager
def running_server(model, registry, steps: int, **serve_kw):
    """The OpenAI-compatible server, in-process on a free local port, its
    batchers pinned to ``steps`` frames a request (random weights).  Yields
    (url, batcher); stops both on exit."""
    from qwen3tts_tpu.apps.openai_server import serve
    from qwen3tts_tpu.runtime.engine import GenerationPolicy

    httpd = serve(model, registry, host="127.0.0.1", port=0,
                  policy=GenerationPolicy(min_new_tokens=steps), **serve_kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", httpd.tts_state.batcher
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.tts_state.batcher.close()


def post_concurrently(url: str, n: int, steps: int) -> list:
    """``n`` concurrent speech requests; returns each WAV's sample count."""
    results, errors = {}, []

    def fetch(i):
        try:
            results[i] = _post_speech(url, f"Request number {i}. " + TEXT, steps)
        except Exception as e:  # reported below
            errors.append(f"request {i}: {e!r}")

    threads = [threading.Thread(target=fetch, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or len(results) != n:
        raise AssertionError(f"served {len(results)} of {n}: {errors}")
    return [_wav_samples(results[i], steps, f"request {i}") for i in range(n)]


def phase_serve(model, ref_wav: str) -> None:
    from qwen3tts_tpu.apps.openai_server import VoiceRegistry

    reg = VoiceRegistry.from_args(None, ref_wav, "reference transcript")
    t0 = time.time()
    with running_server(model, reg, 24, max_batch=8) as (url, batcher):
        counts = post_concurrently(url, 4, 24)
        stats = batcher.stats
    say("serve", f"max_batch 8: {len(counts)} concurrent requests served in "
                 f"{time.time() - t0:.1f}s, WAV samples {counts}, "
                 f"batcher served {stats['served']}")


def phase_modes(ref_wav: str) -> None:
    from qwen3tts_tpu import FasterQwen3TTS

    steps = 16
    for label, kw in (("int8", {"quantize": "int8"}),
                      ("w8a8", {"quantize": "w8a8"}),
                      ("kv_quant", {"kv_quant": True})):
        t0 = time.time()
        m = FasterQwen3TTS.from_pretrained(PRESET, dtype="bf16", **kw)
        audio, _ = m.generate_voice_clone(**clone_kwargs(ref_wav, steps))
        _check_audio(audio[0], steps, label)
        say("modes", f"{label}: {steps} steps, finite audio of "
                     f"{steps * SPF} samples ({time.time() - t0:.1f}s incl. "
                     f"load+compile)")
        del m


# ---------------------------------------------------------------------------
# four cards: replicas behind the server, tensor parallelism
# ---------------------------------------------------------------------------


def greedy_tokens(model, ref_wav: str, steps: int = 16) -> np.ndarray:
    from qwen3tts_tpu.models.predictor import SamplingPolicy
    from qwen3tts_tpu.runtime import loops
    from qwen3tts_tpu.runtime.engine import GenerationPolicy

    import jax

    embeds, trailing, tpe, _ = model._prepare_clone(
        TEXT, ref_wav, "reference transcript", "English", True, True, True,
        None)
    ids, _ = loops.fast_generate(
        model.engine, embeds, trailing, tpe, key=jax.random.PRNGKey(0),
        max_new_tokens=steps,
        policy=GenerationPolicy(do_sample=False, min_new_tokens=steps),
        pred_policy=SamplingPolicy(do_sample=False))
    return np.asarray(ids)


def phase_replicas(model, ref_wav: str) -> None:
    from qwen3tts_tpu.apps.openai_server import VoiceRegistry

    reg = VoiceRegistry.from_args(None, ref_wav, "reference transcript")
    t0 = time.time()
    with running_server(model, reg, 24, max_batch=2,
                        replicas=4) as (url, pool):
        counts = post_concurrently(url, 8, 24)
        served = [r["served"] for r in pool.stats["replicas"]]
        if len(served) != 4 or min(served) < 1 or sum(served) != 8:
            raise AssertionError(f"replica occupancy {served}")
        base = greedy_tokens(pool.models[0], ref_wav)
        for i, m in enumerate(pool.models[1:], 1):
            if not np.array_equal(greedy_tokens(m, ref_wav), base):
                raise AssertionError(
                    f"replica {i} greedy tokens differ from card 0")
    say("replicas", f"4 replicas: 8 requests served {served} in "
                    f"{time.time() - t0:.1f}s, WAV samples {counts}; greedy "
                    f"tokens of replicas 1-3 equal card 0's "
                    f"({base.shape[0]} steps)")


def phase_tensor_parallel(jax, jnp) -> None:
    from qwen3tts_tpu.core.presets import get_preset
    from qwen3tts_tpu.parallel.sharding import (host_init_flagship, make_mesh,
                                                sharded_flagship_check)

    t0 = time.time()
    mesh = make_mesh(4, dp=1, tp=4)
    cfg = dataclasses.replace(get_preset("qwen3-tts-0.6b"), dtype="float32")
    params = host_init_flagship(cfg, jnp.float32)
    # float32 matmuls default to TF32 on this card; the exactness claim
    # needs true float32
    with jax.default_matmul_precision("highest"):
        sharded, single = sharded_flagship_check(mesh, steps=4, kv_quant=True,
                                                 params=params)
    if not np.array_equal(sharded, single):
        raise AssertionError(f"TP tokens {sharded} != single-card {single}")
    say("tp", f"0.6B fp32 tp=4 int8 KV: {sharded.shape[0]} greedy steps "
              f"token-exact vs one card ({time.time() - t0:.1f}s)")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--four-cards", action="store_true",
                      help="run only the four-card replica and TP phases")
    mode.add_argument("--attention-grid", action="store_true",
                      help="run only the kernel parity and the full "
                           "decode-attention timing grid")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    info = phase_device(jax, 4 if args.four_cards else 1)
    card = card_line()

    from qwen3tts_tpu import FasterQwen3TTS

    with tempfile.TemporaryDirectory() as tmp:
        ref_wav = os.path.join(tmp, "ref.wav")
        _write_ref_wav(ref_wav)
        t0 = time.time()
        model = FasterQwen3TTS.from_pretrained(PRESET, dtype="bf16")
        load_s = time.time() - t0
        if args.four_cards:
            phase_replicas(model, ref_wav)
            del model
            phase_tensor_parallel(jax, jnp)
        else:
            worst = check_kernel_parity(jax, jnp)
            say("kernel", f"flash-decode vs f32 reference, "
                          f"{len(parity_cases())} cases: max abs err f32 "
                          f"{worst['float32']:.2e} (tol {F32_TOL:g}), bf16 "
                          f"{worst['bfloat16']:.2e} (tol {BF16_TOL:g})")
            phase_decode_hlo(jax, jnp, model)
            time_attention_paths(jax, jnp, model, full=args.attention_grid)
            if not args.attention_grid:
                phase_clone(model, ref_wav, load_s, card)
                phase_serve(model, ref_wav)
                del model
                phase_modes(ref_wav)
    print(card)
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
