"""FasterQwen3TTS — the public API class.

API-compatible with the reference wrapper (model.py:22-1166): same method
names, signatures, defaults and semantics; the implementation underneath is
the JAX engine (runtime/engine.py), the jitted codec vocoder
(audio/vocoder.py) and the first-party model stack.

Key differences (all JAX-native design, documented per method):
  - "CUDA graph capture" → jit warmup (first generation compiles the prefill
    bucket + decode-chunk executables, mirroring the deferred capture at
    model.py:280-281);
  - no DynamicCache→StaticCache copies, no mask tables;
  - codec frames are exactly ``sample_rate/frame_rate`` samples, so ICL
    trimming and streaming-window math are exact instead of calibrated.
"""
from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Dict, Generator, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..audio.vocoder import Vocoder
from ..audio.wav import read_wav, resample
from ..core.config import TTSModelConfig
from ..core.loader import load_pretrained
from ..models import speaker as speaker_lib
from ..models import talker as talker_lib
from ..models.predictor import SamplingPolicy
from ..runtime import loops
from ..runtime.engine import Engine, GenerationPolicy
from .prompt import PromptBuilder
from .tokenizer import TextTokenizer

logger = logging.getLogger(__name__)


def _infer_sample_rate(codec_cfg, model_cfg) -> int:
    """Sample-rate inference chain (reference model.py:49-69):
    speech-tokenizer rate → model-level rate → 24000 default."""
    sr = getattr(codec_cfg, "sample_rate", None)
    if sr is None:
        sr = getattr(model_cfg, "sample_rate", None)
    if sr is None:
        logger.warning("Could not infer sample rate; defaulting to 24000 Hz.")
        return 24_000
    return int(sr)


class FasterQwen3TTS:
    """Qwen3-TTS with jitted fixed-shape decode for real-time inference."""

    def __init__(
        self,
        cfg: TTSModelConfig,
        params: Dict,
        *,
        max_seq_len: int = 2048,
        seed: int = 0,
        tokenizer_json: Optional[str] = None,
        vocoder_compute_dtype=jnp.bfloat16,
        kv_quant: bool = False,
    ):
        self.cfg = cfg
        self.params = params
        self.max_seq_len = max_seq_len
        self.dtype = cfg.jnp_dtype
        self.kv_quant = kv_quant
        self.engine = Engine(
            params["talker"], params["predictor"], cfg, max_seq_len=max_seq_len,
            kv_quant=kv_quant,
        )
        self.vocoder = Vocoder(params["codec"], cfg.codec,
                               compute_dtype=vocoder_compute_dtype)
        # host-side prompt assembly (see prompt.py: avoids ~40 op-dispatch
        # programs per generation)
        self.prompt_builder = PromptBuilder(params["talker"], params["predictor"], cfg)
        self.tokenizer = TextTokenizer(
            tokenizer_json=tokenizer_json, vocab_size=cfg.talker.text_vocab_size
        )
        self.sample_rate = _infer_sample_rate(cfg.codec, cfg)
        self._voice_prompt_cache: Dict = {}
        self._warmed_up = False
        self._rng = jax.random.PRNGKey(seed)
        self.tts_model_type = cfg.model_type
        self.tts_model_size = cfg.model_size

    # ------------------------------------------------------------------
    @classmethod
    def from_pretrained(
        cls,
        model_name: str,
        device: Optional[str] = None,
        dtype: Union[str, jnp.dtype, None] = None,
        max_seq_len: int = 2048,
        seed: int = 0,
        quantize: Optional[str] = None,
        kv_quant: bool = False,
    ) -> "FasterQwen3TTS":
        """Load weights ('random:<preset>' or checkpoint dir) and build the
        runtime.  Compilation is deferred to the first generation (reference
        defers CUDA-graph capture the same way, model.py:143,280-281).

        quantize="int8": store the talker/predictor projection matrices as
        int8 with per-channel scales — halves decode weight bandwidth.
        Selective modes ("int8-predictor", "w8a8-predictor", ...-talker)
        quantize one component only; int8-predictor keeps codebook-0 (the
        semantic stream) at full precision while cutting ~69% of the decode
        step's weight bytes (benchmarks/decompose.py).
        kv_quant=True: int8 KV cache (per-position/head scales) — halves
        attention-read bytes; matters at batch>1 and long positions."""
        if isinstance(dtype, str):
            dtype = {"bfloat16": jnp.bfloat16, "bf16": jnp.bfloat16,
                     "float32": jnp.float32, "fp32": jnp.float32,
                     "float16": jnp.float16, "fp16": jnp.float16}[dtype]
        cfg, params = load_pretrained(model_name, dtype=dtype, seed=seed)
        # Thread the checkpoint's tokenizer.json into the text tokenizer; the
        # byte-level fallback's invented special ids would silently garble
        # text conditioning with real weights.
        tokenizer_json = None
        ckpt_dir = Path(model_name)
        if ckpt_dir.is_dir():
            tok = ckpt_dir / "tokenizer.json"
            if tok.exists():
                tokenizer_json = str(tok)
            else:
                logger.warning(
                    "Checkpoint %s has no tokenizer.json — falling back to the "
                    "byte-level tokenizer, whose token ids will NOT match the "
                    "Qwen text vocab. Place the upstream tokenizer.json in the "
                    "checkpoint dir for correct text conditioning.", model_name)
        if quantize:
            from ..ops.quant import MODES, quantize_bundle

            if quantize not in MODES:
                raise ValueError(
                    f"unknown quantize mode '{quantize}' (use one of {MODES})")
            params = quantize_bundle(params, quantize)
        logger.info("Loaded %s (%s, %s%s)", model_name, cfg.model_type, cfg.dtype,
                    f", {quantize}" if quantize else "")
        return cls(cfg, params, max_seq_len=max_seq_len, seed=seed,
                   tokenizer_json=tokenizer_json, kv_quant=kv_quant)

    # ------------------------------------------------------------------
    def _next_key(self) -> jax.Array:
        self._rng, k = jax.random.split(self._rng)
        return k

    def _warmup(self, prefill_len: int, tth_len: int, policy, pred_policy,
                chunk_sizes=(8, 16)):
        if self._warmed_up:
            return
        logger.info("Compiling jitted decode executables (one-time)...")
        self.engine.warmup(prefill_len, tth_len, policy, pred_policy,
                           chunk_sizes, vocoder=self.vocoder)
        self._warmed_up = True

    def warmup_all(self, chunk_sizes=(8, 16), max_prefill: Optional[int] = None):
        """Compile every (prefill bucket × tth bucket × chunk size) executable
        up front so no request — however long — hits a mid-serving compile
        stall.  Servers call this at startup; all programs land in the
        persistent XLA cache so restarts are cache reads."""
        pol, ppol = self._policies(0.9, 50, 1.0, True, 1.05, 2)
        dt = self.engine.warmup_all(pol, ppol, chunk_sizes,
                                    max_prefill=max_prefill,
                                    vocoder=self.vocoder)
        self._warmed_up = True
        logger.info("warmup_all finished in %.1fs", dt)
        return dt

    # ------------------------------------------------------------------
    # voice-clone prompt construction
    # ------------------------------------------------------------------

    def _load_ref_audio_with_silence(
        self, ref_audio: Union[str, Path], silence_secs: float = 0.5
    ) -> Tuple[np.ndarray, int]:
        """Load ref audio mono + append trailing silence so the ICL prompt
        ends on silence, not mid-phoneme (reference model.py:185-200)."""
        audio, sr = read_wav(ref_audio)
        if silence_secs > 0:
            audio = np.concatenate([audio, np.zeros(int(silence_secs * sr), np.float32)])
        return audio, sr

    def extract_speaker_embedding(self, ref_audio: Union[str, Path, np.ndarray],
                                  sr: Optional[int] = None) -> np.ndarray:
        """x-vector from reference audio (reference examples/extract_speaker.py)."""
        if isinstance(ref_audio, (str, Path)):
            audio, sr = read_wav(ref_audio)
        else:
            audio = np.asarray(ref_audio, np.float32)
            assert sr is not None, "sr required with raw audio"
        target = self.cfg.speaker_encoder.sample_rate
        audio16 = resample(audio, sr, target)
        emb = speaker_lib.embed(self.params["speaker"], self.cfg.speaker_encoder,
                                jnp.asarray(audio16))
        return np.asarray(emb)

    def create_voice_clone_prompt(
        self,
        ref_audio: Union[str, Path, Tuple[np.ndarray, int]],
        ref_text: str = "",
        x_vector_only_mode: bool = False,
    ) -> Dict:
        """Returns {'ref_spk_embedding', 'ref_code', 'x_vector_only_mode',
        'icl_mode'} (reference upstream surface, SURVEY.md §2.2)."""
        if isinstance(ref_audio, tuple):
            audio, sr = ref_audio
        else:
            audio, sr = read_wav(ref_audio)
        xvec = self.extract_speaker_embedding(audio, sr)
        out = {
            "ref_spk_embedding": xvec,
            "ref_code": None,
            "x_vector_only_mode": x_vector_only_mode,
            "icl_mode": not x_vector_only_mode,
            "ref_text": ref_text,
        }
        if not x_vector_only_mode:
            audio24 = resample(audio, sr, self.cfg.codec.sample_rate)
            out["ref_code"] = self.vocoder.encode(audio24)  # [Tr, 16]
        return out

    def _voice_prompt(self, ref_audio, ref_text, xvec_only, append_silence):
        """ref_audio: path, or an in-memory ``(audio_f32, sr)`` tuple (used by
        longform cross-segment conditioning).  Cache key: path string, or
        sha1 of the raw samples (reference keys on the path only,
        model.py:230-232)."""
        if isinstance(ref_audio, tuple):
            import hashlib

            audio, sr = ref_audio
            audio = np.asarray(audio, np.float32)
            ident = hashlib.sha1(audio.tobytes()).hexdigest()
        else:
            ident = str(ref_audio)
        key = (ident, ref_text, xvec_only, append_silence)
        if key in self._voice_prompt_cache:
            return self._voice_prompt_cache[key]
        if isinstance(ref_audio, tuple):
            if not xvec_only and append_silence:
                audio = np.concatenate([audio, np.zeros(int(0.5 * sr), np.float32)])
            vcp = self.create_voice_clone_prompt(
                (audio, sr), "" if xvec_only else ref_text,
                x_vector_only_mode=xvec_only)
        elif xvec_only:
            vcp = self.create_voice_clone_prompt(ref_audio, "", x_vector_only_mode=True)
        else:
            silence = 0.5 if append_silence else 0.0
            audio, sr = self._load_ref_audio_with_silence(ref_audio, silence)
            vcp = self.create_voice_clone_prompt((audio, sr), ref_text)
        self._voice_prompt_cache[key] = vcp
        return vcp

    # ------------------------------------------------------------------
    # prompt prep
    # ------------------------------------------------------------------

    def _to_device(self, *host_arrays):
        """float32 host arrays → device arrays in the model dtype.  The dtype
        cast happens on HOST (ml_dtypes) so the transfer is a pure copy — no
        convert_element_type program on the accelerator."""
        from ..ops.initrand import fast_astype

        return tuple(
            jnp.asarray(fast_astype(np.asarray(a), self.dtype)) for a in host_arrays
        )

    def _prepare_clone(self, text, ref_audio, ref_text, language, xvec_only,
                       non_streaming_mode, append_silence, instruct,
                       device: bool = True):
        input_ids = self.tokenizer.build_assistant_ids(text)
        instruct_ids = self.tokenizer.build_instruct_ids(instruct) if instruct else None
        vcp = self._voice_prompt(ref_audio, ref_text, xvec_only, append_silence)
        spk = self.prompt_builder.project_speaker(vcp["ref_spk_embedding"])
        ref_ids = None
        if vcp["icl_mode"] and vcp.get("ref_text"):
            ref_ids = self.tokenizer.build_ref_ids(vcp["ref_text"])
        embeds, trailing, tpe = self.prompt_builder.build(
            input_ids=input_ids,
            ref_ids=ref_ids,
            spk_embedding=spk,
            ref_codes=vcp["ref_code"],
            icl_mode=vcp["icl_mode"] and vcp["ref_code"] is not None and ref_ids is not None,
            language=language,
            non_streaming_mode=non_streaming_mode,
            instruct_ids=instruct_ids,
        )
        if device:
            # embeds stay HOST numpy even on the device path: engine.prefill
            # left-pads them to the bucket host-side before the cast+upload
            # (a device-resident prompt forces a per-(T, bucket) pad-concat
            # program — 150-400 ms compile on first use of each length)
            trailing, tpe = self._to_device(trailing, tpe)
            embeds = np.asarray(embeds, np.float32)
        # device=False callers (the continuous batcher) keep the host numpy
        # arrays: stacking/joining re-uploads anyway, so an upload per
        # submit would be wasted
        ref_codes = vcp["ref_code"] if not xvec_only else None
        return embeds, trailing, tpe, ref_codes

    def _prepare_custom(self, text, language, speaker, instruct):
        input_ids = self.tokenizer.build_assistant_ids(text)
        instruct_ids = self.tokenizer.build_instruct_ids(instruct) if instruct else None
        embeds, trailing, tpe = self.prompt_builder.build(
            input_ids=input_ids,
            language=language,
            speaker=speaker,
            non_streaming_mode=False,
            instruct_ids=instruct_ids,
        )
        return (*self._to_device(embeds, trailing, tpe),)

    # ------------------------------------------------------------------
    # generation: voice clone
    # ------------------------------------------------------------------

    def generate(self, *a, **k):
        raise NotImplementedError(
            "Default voice generation not yet implemented. "
            "Use generate_voice_clone() with reference audio."
        )

    def _policies(self, temperature, top_k, top_p, do_sample, repetition_penalty,
                  min_new_tokens):
        pol = GenerationPolicy(
            temperature=temperature, top_k=top_k, top_p=top_p, do_sample=do_sample,
            repetition_penalty=repetition_penalty, min_new_tokens=min_new_tokens,
        )
        # The predictor ALWAYS samples at top_k=50/temp=0.9 regardless of the
        # talker's do_sample — the reference freezes this policy into the
        # captured predictor graph at build time (model.py:124-133,
        # predictor_graph.py:34-50), so --greedy only makes codebook 0 greedy.
        ppol = SamplingPolicy(do_sample=True, top_k=50, top_p=1.0, temperature=0.9)
        return pol, ppol

    def _finish_audio(self, codec_ids: Optional[np.ndarray], ref_codes, timing):
        if codec_ids is None:
            logger.warning("Generation returned no tokens")
            return [np.zeros(1, np.float32)], self.sample_rate
        if ref_codes is not None and len(ref_codes):
            codes = np.concatenate([np.asarray(ref_codes), codec_ids], axis=0)
            wav = self.vocoder.decode(codes)
            wav = wav[len(ref_codes) * self.vocoder.spf :]  # exact trim
        else:
            wav = self.vocoder.decode(codec_ids)
        n_steps = timing["steps"]
        dur = n_steps / self.cfg.codec.frame_rate
        total = timing["prefill_ms"] / 1000 + timing["decode_s"]
        rtf = dur / total if total > 0 else 0.0
        logger.info(
            "Generated %.2fs audio in %.2fs (%.1fms/step, RTF: %.2f)",
            dur, total, timing["ms_per_step"], rtf,
        )
        return [wav], self.sample_rate

    def generate_voice_clone(
        self,
        text: str,
        language: str,
        ref_audio: Union[str, Path],
        ref_text: str,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        xvec_only: bool = True,
        non_streaming_mode: bool = True,
        append_silence: bool = True,
        instruct: Optional[str] = None,
        parity_mode: bool = False,
    ) -> Tuple[list, int]:
        """Voice-cloned speech (reference model.py:555-668)."""
        embeds, trailing, tpe, ref_codes = self._prepare_clone(
            text, ref_audio, ref_text, language, xvec_only, non_streaming_mode,
            append_silence, instruct,
        )
        pol, ppol = self._policies(temperature, top_k, top_p, do_sample,
                                   repetition_penalty, min_new_tokens)
        if not parity_mode:
            self._warmup(embeds.shape[1], trailing.shape[1], pol, ppol)
        gen = loops.parity_generate if parity_mode else loops.fast_generate
        from ..utils.timing import device_trace

        with device_trace(os.environ.get("QWEN3TTS_PROFILE_DIR")):
            codec_ids, timing = gen(
                self.engine, embeds, trailing, tpe,
                key=self._next_key(), max_new_tokens=max_new_tokens,
                policy=pol, pred_policy=ppol,
            )
        return self._finish_audio(codec_ids, ref_codes, timing)

    def _batch_engine(self, batch: int) -> Engine:
        """Engines share params; one per batch size, lazily built (the
        reference is strictly batch-1 — SURVEY §2.4 — so this whole mode is
        beyond-reference throughput capability)."""
        if batch == 1:
            return self.engine
        if not hasattr(self, "_batch_engines"):
            self._batch_engines: Dict[int, Engine] = {}
        if batch not in self._batch_engines:
            self._batch_engines[batch] = Engine(
                self.params["talker"], self.params["predictor"], self.cfg,
                max_seq_len=self.max_seq_len, batch=batch,
                kv_quant=self.kv_quant)
        return self._batch_engines[batch]

    def generate_voice_clone_batch(
        self,
        texts: list,
        language: str,
        ref_audio: Union[str, Path],
        ref_text: str,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        xvec_only: bool = True,
        non_streaming_mode: bool = True,
        append_silence: bool = True,
        instruct: Optional[str] = None,
    ) -> Tuple[list, int]:
        """Batched voice clone: synthesize ``len(texts)`` utterances in ONE
        engine pass (shared voice prompt, per-row prompts/EOS).  Returns
        ([B] waveforms, sample_rate).  Throughput mode — per-utterance
        latency is higher than batch-1, total frames/s is much higher."""
        B = len(texts)
        if B == 0:
            return [], self.sample_rate
        rows = [self._prepare_clone(t, ref_audio, ref_text, language, xvec_only,
                                    non_streaming_mode, append_silence, instruct)
                for t in texts]
        ref_codes = rows[0][3]
        H = self.cfg.talker.hidden_size
        # stack straight at the bucket width: engine.prefill then never pads
        # device-side (the pad concat is a per-(T, bucket) program that
        # compiles at first use of each length — see Engine.prefill)
        from ..runtime.engine import bucket_for as _bucket
        T = _bucket(max(r[0].shape[1] for r in rows))
        Tt = max(max(r[1].shape[1] for r in rows), 1)
        embeds = np.zeros((B, T, H), np.float32)
        trailing = np.zeros((B, Tt, H), np.float32)
        tpe = np.zeros((B, 1, H), np.float32)
        pads = np.zeros((B,), np.int32)
        tth_lens = np.zeros((B,), np.int32)
        for b, (e, t, p, _) in enumerate(rows):
            e, t, p = np.asarray(e, np.float32), np.asarray(t, np.float32), np.asarray(p, np.float32)
            pads[b] = T - e.shape[1]
            embeds[b, pads[b]:] = e[0]
            trailing[b, : t.shape[1]] = t[0]
            trailing[b, t.shape[1]:] = p[0]  # pad rows with tts_pad embed
            tth_lens[b] = t.shape[1]
            tpe[b] = p[0]
        trailing_d, tpe_d = self._to_device(trailing, tpe)
        embeds_d = embeds  # host: engine.prefill pads+casts
        pol, ppol = self._policies(temperature, top_k, top_p, do_sample,
                                   repetition_penalty, min_new_tokens)
        eng = self._batch_engine(B)
        ids_rows, timing = loops.fast_generate_batch(
            eng, embeds_d, trailing_d, tpe_d, key=self._next_key(),
            pad_count=pads, tth_lens=tth_lens, max_new_tokens=max_new_tokens,
            policy=pol, pred_policy=ppol)
        wavs = []
        for ids in ids_rows:
            if ids.shape[0] == 0:
                wavs.append(np.zeros(1, np.float32))
                continue
            if ref_codes is not None and len(ref_codes):
                codes = np.concatenate([np.asarray(ref_codes), ids], axis=0)
                wav = self.vocoder.decode(codes)[len(ref_codes) * self.vocoder.spf:]
            else:
                wav = self.vocoder.decode(ids)
            wavs.append(wav)
        total_audio = sum(len(w) for w in wavs) / self.sample_rate
        wall = timing["prefill_ms"] / 1000 + timing["decode_s"]
        logger.info("Batch %d: %.2fs audio in %.2fs (throughput RTF %.2f)",
                    B, total_audio, wall, total_audio / wall if wall else 0)
        return wavs, self.sample_rate

    def generate_voice_clone_streaming(
        self,
        text: str,
        language: str,
        ref_audio: Union[str, Path],
        ref_text: str,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        chunk_size: int = 12,
        xvec_only: bool = True,
        non_streaming_mode: bool = True,
        append_silence: bool = True,
        parity_mode: bool = False,
        instruct: Optional[str] = None,
        first_chunks: Tuple[int, ...] = (),
    ) -> Generator[Tuple[np.ndarray, int, dict], None, None]:
        """Streaming voice clone: yields (audio_chunk, sr, timing) every
        ``chunk_size`` codec steps (reference model.py:670-826).

        ``first_chunks``: optional ramp-up of initial chunk sizes (e.g.
        ``(2, 4)``) to cut TTFA — audio starts flowing after the first small
        chunk instead of a full ``chunk_size`` one."""
        embeds, trailing, tpe, ref_codes = self._prepare_clone(
            text, ref_audio, ref_text, language, xvec_only, non_streaming_mode,
            append_silence, instruct,
        )
        pol, ppol = self._policies(temperature, top_k, top_p, do_sample,
                                   repetition_penalty, min_new_tokens)
        if not parity_mode:
            self._warmup(embeds.shape[1], trailing.shape[1], pol, ppol,
                         chunk_sizes=tuple(dict.fromkeys(list(first_chunks) + [chunk_size])))
        yield from self._stream_audio(
            embeds, trailing, tpe, ref_codes, pol, ppol, max_new_tokens,
            chunk_size, parity_mode, first_chunks=first_chunks,
        )

    def _stream_audio(self, embeds, trailing, tpe, ref_codes, pol, ppol,
                      max_new_tokens, chunk_size, parity_mode=False,
                      first_chunks=()):
        if not parity_mode:
            # fused decode+vocode device program: one dispatch + one fetch
            # per audio chunk (Engine.chunk_vocode), with the STATEFUL codec
            # stream — sample-exact vs a full decode (the old 25-frame
            # window scheme was only approximately exact)
            for _codes, audio, timing in loops.fast_generate_streaming_audio(
                self.engine, self.vocoder, embeds, trailing, tpe,
                key=self._next_key(), max_new_tokens=max_new_tokens,
                policy=pol, pred_policy=ppol, chunk_size=chunk_size,
                first_chunks=first_chunks, ref_codes=ref_codes,
            ):
                yield audio, self.sample_rate, timing
            return
        sd = self.vocoder.stateful_stream_decoder()
        if ref_codes is not None and len(ref_codes):
            sd.feed(np.asarray(ref_codes))  # prime acoustic context, discard audio
        codes_iter = self._parity_stream(embeds, trailing, tpe, pol, ppol,
                                         max_new_tokens, chunk_size)
        for codec_chunk, timing in codes_iter:
            audio = sd.feed(codec_chunk)
            yield audio, self.sample_rate, timing

    def _parity_stream(self, embeds, trailing, tpe, pol, ppol, max_new_tokens,
                       chunk_size):
        """TRUE streaming over the per-step parity path — chunks are yielded
        as they are decoded, so parity-mode TTFA measurements are real
        (reference parity_generate_streaming, streaming.py:192-359)."""
        yield from loops.parity_generate_streaming(
            self.engine, embeds, trailing, tpe, key=self._next_key(),
            max_new_tokens=max_new_tokens, policy=pol, pred_policy=ppol,
            chunk_size=chunk_size,
        )

    # ------------------------------------------------------------------
    # custom voice / voice design
    # ------------------------------------------------------------------

    def _validate_languages(self, languages):
        for lg in languages:
            if lg and lg.lower() != "auto" and lg.lower() not in self.cfg.talker.codec_language_id:
                raise NotImplementedError(f"Language {lg} not implemented")

    def _validate_speakers(self, speakers):
        for sp in speakers:
            if sp and sp.lower() not in self.cfg.talker.spk_id:
                raise NotImplementedError(f"Speaker {sp} not implemented")

    def generate_custom_voice(
        self,
        text: str,
        speaker: str,
        language: str,
        instruct: Optional[str] = None,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
    ) -> Tuple[list, int]:
        """Predefined-speaker synthesis (reference model.py:828-903)."""
        if self.tts_model_type != "custom_voice":
            raise ValueError("Loaded model does not support custom voice generation")
        self._validate_languages([language])
        self._validate_speakers([speaker])
        if self.tts_model_size == "0.6b":  # 0.6B drops instruct (model.py:849-850;
            instruct = None                # sizes are normalized at config load)
        embeds, trailing, tpe = self._prepare_custom(text, language, speaker, instruct)
        pol, ppol = self._policies(temperature, top_k, top_p, do_sample,
                                   repetition_penalty, min_new_tokens)
        self._warmup(embeds.shape[1], trailing.shape[1], pol, ppol)
        codec_ids, timing = loops.fast_generate(
            self.engine, embeds, trailing, tpe, key=self._next_key(),
            max_new_tokens=max_new_tokens, policy=pol, pred_policy=ppol,
        )
        return self._finish_audio(codec_ids, None, timing)

    def generate_custom_voice_streaming(
        self,
        text: str,
        speaker: str,
        language: str,
        instruct: Optional[str] = None,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        chunk_size: int = 12,
    ) -> Generator[Tuple[np.ndarray, int, dict], None, None]:
        if self.tts_model_type != "custom_voice":
            raise ValueError("Loaded model does not support custom voice generation")
        self._validate_languages([language])
        self._validate_speakers([speaker])
        if self.tts_model_size == "0.6b":
            instruct = None
        embeds, trailing, tpe = self._prepare_custom(text, language, speaker, instruct)
        pol, ppol = self._policies(temperature, top_k, top_p, do_sample,
                                   repetition_penalty, min_new_tokens)
        self._warmup(embeds.shape[1], trailing.shape[1], pol, ppol,
                     chunk_sizes=(chunk_size,))
        yield from self._stream_audio(embeds, trailing, tpe, None, pol, ppol,
                                      max_new_tokens, chunk_size)

    def generate_voice_design(
        self,
        text: str,
        instruct: str,
        language: str,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
    ) -> Tuple[list, int]:
        """Instruction-conditioned voice design (reference model.py:1003-1073)."""
        if self.tts_model_type != "voice_design":
            raise ValueError("Loaded model does not support voice design generation")
        self._validate_languages([language])
        embeds, trailing, tpe = self._prepare_custom(text, language, None, instruct)
        pol, ppol = self._policies(temperature, top_k, top_p, do_sample,
                                   repetition_penalty, min_new_tokens)
        self._warmup(embeds.shape[1], trailing.shape[1], pol, ppol)
        codec_ids, timing = loops.fast_generate(
            self.engine, embeds, trailing, tpe, key=self._next_key(),
            max_new_tokens=max_new_tokens, policy=pol, pred_policy=ppol,
        )
        return self._finish_audio(codec_ids, None, timing)

    def generate_voice_design_streaming(
        self,
        text: str,
        instruct: str,
        language: str,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        chunk_size: int = 12,
    ) -> Generator[Tuple[np.ndarray, int, dict], None, None]:
        if self.tts_model_type != "voice_design":
            raise ValueError("Loaded model does not support voice design generation")
        self._validate_languages([language])
        embeds, trailing, tpe = self._prepare_custom(text, language, None, instruct)
        pol, ppol = self._policies(temperature, top_k, top_p, do_sample,
                                   repetition_penalty, min_new_tokens)
        self._warmup(embeds.shape[1], trailing.shape[1], pol, ppol,
                     chunk_sizes=(chunk_size,))
        yield from self._stream_audio(embeds, trailing, tpe, None, pol, ppol,
                                      max_new_tokens, chunk_size)

    # ------------------------------------------------------------------
    # persistence helpers
    # ------------------------------------------------------------------

    def save_pretrained(self, path: Union[str, Path]) -> None:
        from ..core.loader import save_checkpoint

        save_checkpoint(path, self.cfg, self.params)

    # ------------------------------------------------------------------
    # data-parallel replication (SURVEY §2.4: multi-card scale-out = N
    # independent replicas behind the server; the latency path stays on one
    # card, so the links between cards play no role in it)
    # ------------------------------------------------------------------

    def replicate_to(self, device, seed: Optional[int] = None) -> "FasterQwen3TTS":
        """Full model replica pinned to another accelerator device.

        Weights are copied to ``device`` (committed placement — every jitted
        program dispatched on the replica runs there).  Host-side helpers
        (config, tokenizer, prompt builder) are SHARED with the source model:
        prompt assembly is host numpy, so a replica adds no host memory.
        Per-replica mutable state — engines, vocoder executables, RNG,
        voice-prompt cache, warmup flags — is fresh, so replicas never
        contend on donated buffers.  Used by runtime/replicas.ReplicaPool."""
        clone = object.__new__(type(self))
        clone.__dict__.update(self.__dict__)
        # per-replica lazily-built engine caches must not leak across devices
        clone.__dict__.pop("_batch_engines", None)
        clone.params = jax.device_put(self.params, device)
        clone.engine = Engine(
            clone.params["talker"], clone.params["predictor"], self.cfg,
            max_seq_len=self.max_seq_len, kv_quant=self.kv_quant,
        )
        # vocoder params are already cast to the compute dtype — transfer the
        # cast copy and skip the re-cast (compute_dtype=None)
        clone.vocoder = Vocoder(
            jax.device_put(self.vocoder.params, device), self.cfg.codec,
            context_frames=self.vocoder.context_frames, compute_dtype=None,
        )
        clone._voice_prompt_cache = {}
        clone._warmed_up = False
        clone._rng = jax.device_put(jax.random.PRNGKey(
            seed if seed is not None else hash(str(device)) % (2**31)), device)
        return clone
