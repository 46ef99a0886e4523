"""First-party CTC speech recognizer for the demo's /transcribe endpoint.

The reference demo transcribes the uploaded reference audio with
nano-parakeet (reference demo/server.py:225-248); no ASR checkpoint exists
in this zero-egress image, so round 2 shipped a pluggable hook returning 501.
This module closes that gap with a minimal, accelerator-friendly
CTC recognizer that runs end-to-end TODAY on random weights (garbage-but-
functional text) and becomes real the moment trained weights are dropped in
— same convert/load machinery as the main model (safetensors + flat pytree).

Architecture (deliberately small and XLA-fusable):
  log-mel 80 @ 16 kHz (shared frontend, models/speaker.py)
  → 2× strided conv (4× time downsample)
  → N residual GLU conv blocks (kernel 5)
  → linear CTC head over a character vocabulary
Greedy CTC decode (collapse repeats, drop blanks) on host.

Mel length is bucketed to multiples of 256 frames so the jitted forward
compiles a handful of shapes, not one per utterance.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from pathlib import Path
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.initrand import normal as _init_normal
from .speaker import log_mel

# index 0 is the CTC blank
VOCAB = ["<blank>"] + list("abcdefghijklmnopqrstuvwxyz '") + list("0123456789")
_CHAR_TO_ID = {c: i for i, c in enumerate(VOCAB)}
_MEL_BUCKET = 256
_LOG_MEL_PAD = -23.0  # log(1e-10): the frontend's silence floor


@dataclasses.dataclass(frozen=True)
class ASRConfig:
    n_mels: int = 80
    channels: int = 192
    num_layers: int = 4
    kernel: int = 5
    vocab_size: int = len(VOCAB)
    sample_rate: int = 16_000

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


PRESETS = {
    "ctc-tiny": ASRConfig(channels=64, num_layers=2),
    "ctc-base": ASRConfig(),
}


def init_params(key: jax.Array, cfg: ASRConfig, dtype=jnp.float32) -> Dict:
    C, K = cfg.channels, cfg.kernel
    ks = jax.random.split(key, 3 + cfg.num_layers)

    def conv(key_, k, cin, cout):
        return {"w": _init_normal(key_, (k, cin, cout), (k * cin) ** -0.5, dtype),
                "b": jnp.zeros(cout, dtype)}

    return {
        "down1": conv(ks[0], 3, cfg.n_mels, C),
        "down2": conv(ks[1], 3, C, C),
        "blocks": [
            {"conv": conv(ks[3 + i], K, C, 2 * C),
             "norm": jnp.ones((C,), dtype)}
            for i in range(cfg.num_layers)
        ],
        "head": {"w": _init_normal(ks[2], (C, cfg.vocab_size), C ** -0.5, dtype),
                 "b": jnp.zeros(cfg.vocab_size, dtype)},
    }


def _conv1d(x, p, stride=1):
    """x [T, Cin] → [T', Cout] (SAME padding)."""
    y = jax.lax.conv_general_dilated(
        x[None], p["w"], window_strides=(stride,), padding="SAME",
        dimension_numbers=("NWC", "WIO", "NWC"))[0]
    return y + p["b"]


def _layer_norm(x, g, eps=1e-5):
    mu = jnp.mean(x, -1, keepdims=True)
    var = jnp.mean((x - mu) ** 2, -1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + eps) * g


def forward(params: Dict, cfg: ASRConfig, mel: jnp.ndarray) -> jnp.ndarray:
    """mel [T, n_mels] → CTC logits [ceil(T/4), vocab]."""
    x = jax.nn.relu(_conv1d(mel, params["down1"], stride=2))
    x = jax.nn.relu(_conv1d(x, params["down2"], stride=2))
    for blk in params["blocks"]:
        h = _layer_norm(x, blk["norm"])
        h = _conv1d(h, blk["conv"])
        a, b = jnp.split(h, 2, axis=-1)
        x = x + a * jax.nn.sigmoid(b)  # GLU, residual
    return x @ params["head"]["w"] + params["head"]["b"]


def cer(ref: str, hyp: str) -> float:
    """Character error rate: edit distance / len(ref) (standard ASR metric;
    the self-training gate asserts it on held-out in-domain samples)."""
    if not ref:
        return float(len(hyp) > 0)
    prev = list(range(len(hyp) + 1))
    for i, rc in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, hc in enumerate(hyp, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (rc != hc))
        prev = cur
    return prev[-1] / len(ref)


def greedy_ctc_decode(token_ids: np.ndarray) -> str:
    """Frame-wise argmax ids → text: collapse repeats, drop blanks."""
    out = []
    prev = -1
    for t in np.asarray(token_ids).ravel():
        if t != prev and t != 0:
            out.append(VOCAB[int(t)])
        prev = t
    return "".join(out).strip()


def _resample(wav: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    # polyphase (anti-aliased) — linear interp would alias >8 kHz content
    # of a 24 kHz demo reference into the 16 kHz mel band
    from ..audio.wav import resample

    return resample(np.asarray(wav, np.float32), sr, target_sr)


class CTCRecognizer:
    """Minimal ASR with the reference nano-parakeet surface:
    ``from_pretrained(...)``, ``transcribe(wav, sr) -> str``, ``warmup()``
    (reference demo/server.py:44, 244-247)."""

    def __init__(self, cfg: ASRConfig, params: Dict):
        self.cfg = cfg
        self.params = params
        self._fwd = jax.jit(functools.partial(forward, cfg=self.cfg))

    @classmethod
    def from_pretrained(cls, ref: str = "random:ctc-base", seed: int = 0):
        if ref.startswith("random:"):
            cfg = PRESETS[ref.split(":", 1)[1]]
            return cls(cfg, init_params(jax.random.PRNGKey(seed), cfg))
        path = Path(ref)
        from ..core.loader import unflatten

        cfg = ASRConfig.from_dict(json.loads((path / "config.json").read_text()))
        from safetensors.numpy import load_file

        flat = load_file(str(path / "model.safetensors"))
        return cls(cfg, jax.tree.map(jnp.asarray, unflatten(flat)))

    def save_pretrained(self, path) -> None:
        from safetensors.numpy import save_file

        from ..core.loader import flatten

        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        (path / "config.json").write_text(json.dumps(self.cfg.to_dict()))
        save_file({k: np.ascontiguousarray(v)
                   for k, v in flatten(self.params).items()},
                  str(path / "model.safetensors"))

    def transcribe(self, wav: np.ndarray, sr: int) -> str:
        wav = _resample(np.asarray(wav, np.float32).ravel(), sr,
                        self.cfg.sample_rate)
        mel = np.asarray(log_mel(jnp.asarray(wav), self.cfg.n_mels,
                                 self.cfg.sample_rate))
        T = mel.shape[0]
        Tb = max(_MEL_BUCKET, -(-T // _MEL_BUCKET) * _MEL_BUCKET)
        mel = np.pad(mel, ((0, Tb - T), (0, 0)),
                     constant_values=_LOG_MEL_PAD)
        logits = self._fwd(params=self.params, mel=jnp.asarray(mel))
        valid = -(-T // 4)  # conv downsample factor
        ids = np.argmax(np.asarray(logits)[:valid], axis=-1)
        return greedy_ctc_decode(ids)

    def warmup(self):
        self.transcribe(np.zeros(self.cfg.sample_rate, np.float32),
                        self.cfg.sample_rate)


def default_checkpoint() -> str:
    """The committed self-trained checkpoint (tools/train_asr.py) when
    present, else random init.  The self-trained weights transcribe audio
    from this framework's own TTS family (eval CER asserted in
    tests/test_asr.py); real human speech still needs a converted real
    checkpoint (RUNBOOK.md)."""
    ckpt = Path(__file__).resolve().parents[2] / "samples/asr/ctc_selftrained"
    if (ckpt / "model.safetensors").exists():
        return str(ckpt)
    return "random:ctc-base"


def builtin_asr(ref: Optional[str] = None, warmup: bool = True):
    """Demo-server hook factory: returns (audio, sr) -> str.

    ``ref=None`` resolves via ``default_checkpoint()`` — the committed
    self-trained weights when present.  ``warmup`` pre-compiles the jitted
    forward so the first /transcribe click doesn't stall on XLA compilation
    (reference warms nano-parakeet at startup, demo/server.py:44,244-247)."""
    rec = CTCRecognizer.from_pretrained(ref or default_checkpoint())
    if warmup:
        rec.warmup()
    return rec.transcribe
