"""Fixed-shape jitted decode runtime — the JAX analog of CUDA-graph capture.

Reference mapping (SURVEY.md §2.3):
  - ``torch.cuda.CUDAGraph`` capture/replay (talker_graph.py:109-147,
    predictor_graph.py:169-202)  →  ``jax.jit`` of fixed-shape step functions;
    one compile replaces one capture, replay = calling the executable.
  - ``transformers.StaticCache`` in-place updates  →  donated KV pytrees +
    ``lax.dynamic_update_slice`` (donation makes buffer reuse a hard error
    instead of a ``.clone()`` convention — talker_graph.py:214).
  - per-pad-count mask tables (talker_graph.py:71-95,172-196)  →  masks
    computed in-graph from traced (position, pad_count) scalars.
  - DynamicCache→StaticCache prefill copy (generate.py:137)  →  gone: bucketed
    prefill writes straight into the static cache.

Beyond the reference: ``decode_chunk`` runs up to ``chunk_size`` full steps
(predictor frame + talker step + sampling) inside ONE device program with a
``lax.while_loop``, so the host syncs once per chunk instead of once per step
(the reference syncs every step for its EOS check, generate.py:149-150).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import time
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import TTSModelConfig
from ..models import predictor as predictor_lib
from ..models import talker as talker_lib
from ..models.predictor import SamplingPolicy
from ..ops.sampling import apply_repetition_penalty, build_suppress_mask, sample_logits

logger = logging.getLogger(__name__)

# Prefill lengths are padded up to one of these buckets so the number of
# compiled prefill programs stays ≈ len(PREFILL_BUCKETS) (SURVEY.md §7 item 6).
PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)
# Trailing-text buckets (consumed one embed per decode step, generate.py:168).
TTH_BUCKETS = (16, 64, 256, 1024, 2048)


def bucket_for(n: int, buckets=PREFILL_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"Input is too long: prefill has {n} tokens but max bucket={buckets[-1]}. "
        "Use shorter text or shorter reference audio."
    )


@dataclasses.dataclass(frozen=True)
class StaticPolicy:
    """The *structural* part of a sampling policy — the only part that is a
    jit static argument.  Numeric knob values (temperature, top_p, penalty,
    min_new_tokens) are traced scalars, so per-request changes do NOT
    recompile (the reference instead froze the whole policy into the captured
    graph, predictor_graph.py:34-50)."""

    do_sample: bool = True
    top_k: int = 50
    use_top_p: bool = False
    use_rep_penalty: bool = True


@dataclasses.dataclass(frozen=True)
class GenerationPolicy:
    """User-facing sampling policy for the talker's codebook-0 head
    (defaults match the reference CLI, cli.py:314-390)."""

    temperature: float = 0.9
    top_k: int = 50
    top_p: float = 1.0
    do_sample: bool = True
    repetition_penalty: float = 1.05
    min_new_tokens: int = 2

    @property
    def static(self) -> StaticPolicy:
        return StaticPolicy(
            do_sample=self.do_sample,
            top_k=self.top_k,
            use_top_p=self.top_p < 1.0,
            use_rep_penalty=self.repetition_penalty != 1.0,
        )


def make_knobs(policy: "GenerationPolicy", pred_policy: SamplingPolicy,
               device=None) -> jnp.ndarray:
    """Pack the traced knob values into one [6] f32 device array (built once
    per generation so chunk calls transfer nothing):
    [temperature, top_p, rep_penalty, min_new_tokens, pred_temp, pred_top_p].
    ``device``: where to place it (default: JAX's default device)."""
    return jax.device_put(np.asarray(
        [policy.temperature, policy.top_p, policy.repetition_penalty,
         float(policy.min_new_tokens), pred_policy.temperature, pred_policy.top_p],
        np.float32,
    ), device)


def flash_decode_default(talker_cfg) -> bool:
    """Whether the Engine reads decode attention through the flash-decode
    kernel (ops/flash_decode.py) when the caller does not say.  The kernel
    is compiled for the GPU only; elsewhere the masked XLA path runs.  The
    rule on the GPU is the measured one (PERF.md, "Kernel decisions on the
    H100")."""
    if jax.default_backend() != "gpu":
        return False
    D = talker_cfg.head_dim
    return D & (D - 1) == 0  # Triton tiles are powers of two


def _committed_devices(tree) -> set:
    """The devices the committed leaves of ``tree`` live on."""
    devs = set()
    for leaf in jax.tree.leaves(tree):
        if isinstance(leaf, jax.Array) and leaf.committed:
            devs |= leaf.devices()
    return devs


def device_scope(device):
    """Default-device scope for fresh allocations (no-op for None)."""
    return jax.default_device(device) if device is not None else contextlib.nullcontext()


class Engine:
    """Jitted fixed-shape runtime for one (talker, predictor) model instance.

    Holds the static KV cache geometry and the compiled executables; the
    decode state is an explicit pytree threaded (and donated) through calls.
    """

    def __init__(
        self,
        talker_params,
        predictor_params,
        cfg: TTSModelConfig,
        *,
        max_seq_len: int = 2048,
        batch: int = 1,
        use_flash_decode: Optional[bool] = None,
        scan_unroll: int = 1,
        kv_quant: bool = False,
    ):
        self.cfg = cfg
        self.talker_cfg = cfg.talker
        self.pred_cfg = cfg.predictor
        self.talker_params = talker_params
        self.predictor_params = predictor_params
        self.max_seq_len = max_seq_len
        self.batch = batch
        self.dtype = cfg.jnp_dtype
        self.eos_id = cfg.talker.codec_eos_token_id
        # the device the weights are committed to (a replica's card); None
        # when they are sharded or uncommitted.  Fresh buffers the engine
        # allocates (KV cache, suppress mask, knobs) are placed there.
        devices = _committed_devices(talker_params)
        self.device = next(iter(devices)) if len(devices) == 1 else None
        if use_flash_decode is None:
            # XLA's SPMD partitioner does not split the kernel, so engines
            # over sharded weights read attention through the masked path
            use_flash_decode = (flash_decode_default(cfg.talker)
                                and len(devices) <= 1)
        if use_flash_decode and jax.default_backend() != "gpu":
            raise ValueError(
                "use_flash_decode=True needs a GPU (backend is "
                f"{jax.default_backend()!r}); the Pallas interpreter runs the "
                "kernel for tests through talker.decode_step(interpret=True)")
        self.use_flash_decode = use_flash_decode
        self.scan_unroll = scan_unroll
        # int8 KV cache (opt-in): halves KV memory (serving-batch headroom).
        # The flash-decode kernel dequantizes each tile in registers; the
        # masked XLA path dequantizes a copy of each layer's whole cache
        # slice every step (on the H100 no slower than a bf16 cache, PERF.md).
        self.kv_quant = kv_quant
        if kv_quant and not self.use_flash_decode:
            logger.warning(
                "kv_quant=True on the masked attention path: each step "
                "dequantizes the full cache slice of every layer, so the int8 "
                "cache saves memory but not bandwidth.")
        self._suppress = jax.device_put(
            build_suppress_mask(cfg.talker.vocab_size, self.eos_id), self.device)
        self._warmed_up = False
        # recycled KV buffers: a finished generation's cache is donated into
        # the next prefill (stale rows are never read — masks bound reads to
        # the live prefix), cutting ~35ms of allocation off the TTFA path
        self._kv_pool = []

        self._prefill_jit = jax.jit(
            self._prefill_impl, static_argnames=("policy",), donate_argnames=("kv",)
        )
        self._step_jit = jax.jit(
            self._step_impl,
            static_argnames=("policy", "pred_policy"),
            donate_argnames=("state",),
        )
        self._chunk_jit = jax.jit(
            self._chunk_impl,
            static_argnames=("policy", "pred_policy", "chunk_size"),
            donate_argnames=("state",),
        )

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def new_kv(self):
        if self._kv_pool:
            return self._kv_pool.pop()
        with device_scope(self.device):
            return talker_lib.new_kv_cache(
                self.talker_cfg, self.batch, self.max_seq_len, self.dtype,
                kv_quant=self.kv_quant,
            )

    def knobs(self, policy: "GenerationPolicy",
              pred_policy: SamplingPolicy) -> jnp.ndarray:
        """make_knobs placed on this engine's device."""
        return make_knobs(policy, pred_policy, self.device)

    def release(self, state: Dict) -> None:
        """Recycle a finished generation's KV cache into the pool."""
        if state and "kv" in state and len(self._kv_pool) < 1:
            self._kv_pool.append(state["kv"])

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------

    def _prefill_impl(
        self,
        talker_params,
        embeds: jnp.ndarray,  # [B, Tb, H] left-padded to bucket
        pad_count: jnp.ndarray,  # [B]
        kv,
        key: jax.Array,
        knobs: jnp.ndarray,  # [6] traced sampling knobs (make_knobs)
        max_roll: jnp.ndarray,  # [] int32 — compaction cap (pos floor)
        policy: StaticPolicy,
    ):
        last, logits, kv = talker_lib.prefill(
            talker_params, self.talker_cfg, embeds, pad_count, kv
        )
        # Compact the cache: roll the shared left-pad out so the live prefix
        # starts near row 0 and ``pos`` starts at the TRUE max prefill length.
        # Recovers the generation budget the bucket padding would otherwise
        # consume (stop condition is pos < max_seq_len-1), shrinks every
        # decode step's attention read to the live prefix, and reduces
        # pad_count for the whole decode phase.  One fused O(cache) move,
        # amortized over the generation.  The roll amount is min over the
        # batch (the cache position axis is shared across rows); for B==1
        # this is full compaction.  ``max_roll`` caps the compaction so the
        # continuous batcher can FLOOR the start position: a mid-batch
        # join_row splices at [pos-Tb', pos), so a queued joiner whose
        # prompt buckets at Tb' can only admit once pos >= Tb' — holding
        # pos at batch start (instead of waiting ~Tb'/chunk decode chunks)
        # removes the largest avoidable occupancy hole in saturated serving.
        roll = jnp.minimum(jnp.min(pad_count), max_roll)
        # position axis: 2 for k/v [L,B,S,KVH,D], 3 for scales [L,B,KVH,S]
        kv = {key_: jnp.roll(val, -roll, axis=2 if val.ndim == 5 else 3)
              for key_, val in kv.items()}
        key, ks = jax.random.split(key)
        token = sample_logits(
            ks,
            logits,
            temperature=knobs[0],
            top_k=policy.top_k,
            top_p=knobs[1],
            use_top_p=policy.use_top_p,
            do_sample=policy.do_sample,
            suppress_mask=self._suppress,
            suppress_eos=knobs[3] > 0,
            eos_id=self.eos_id,
        )
        token = token.astype(jnp.int32)
        B = embeds.shape[0]
        state = {
            "kv": kv,
            "past_hidden": last,
            "token": token,
            "pos": jnp.int32(embeds.shape[1]) - roll.astype(jnp.int32),
            "pad_count": (pad_count - roll).astype(jnp.int32),
            # per-row counters: rows admitted mid-batch (join_row) restart
            # their own text/EOS clocks while others keep counting
            "gen_step": jnp.zeros((B,), jnp.int32),
            "seen": jnp.zeros((B, self.talker_cfg.vocab_size), bool),
            "n_gen": jnp.zeros((B,), jnp.int32),
            "done": token == self.eos_id,  # [B]
            "key": key,
        }
        return state

    def prefill(
        self,
        embeds: jnp.ndarray,  # [B, T, H] (unpadded)
        key: jax.Array,
        policy: GenerationPolicy,
        pred_policy: SamplingPolicy = SamplingPolicy(),
        knobs: Optional[jnp.ndarray] = None,
        pad_count: Optional[jnp.ndarray] = None,
        bucketed: bool = True,
        pos_floor: Optional[int] = None,
    ) -> Dict:
        """Left-pad to a bucket, run prefill, sample the first token.

        ``pos_floor``: cap the cache compaction so the post-prefill position
        is at least this value (continuous batcher: queued joiners whose
        prompts bucket at ``pos_floor`` can then admit immediately instead
        of waiting for the position to grow past their bucket)."""
        B, T, H = embeds.shape
        base_pad = (
            np.zeros((B,), np.int32) if pad_count is None else np.asarray(pad_count)
        )
        Tb = bucket_for(T) if bucketed else T
        if Tb > self.max_seq_len:
            raise ValueError(f"prefill bucket {Tb} exceeds max_seq_len {self.max_seq_len}")
        extra = Tb - T
        if isinstance(embeds, np.ndarray):
            # pad on HOST: the device-side concat is a distinct program per
            # (T, bucket) pair, and each first use would compile one more
            if extra:
                embeds = np.concatenate(
                    [np.zeros((B, extra, H), np.float32),
                     np.asarray(embeds, np.float32)], axis=1)
            from ..ops.initrand import fast_astype
            embeds = jnp.asarray(fast_astype(np.ascontiguousarray(embeds),
                                             self.dtype))
        elif extra:
            embeds = jnp.concatenate(
                [jnp.zeros((B, extra, H), embeds.dtype), embeds], axis=1
            )
        pad = jnp.asarray(base_pad + extra, jnp.int32)
        if knobs is None:
            knobs = self.knobs(policy, pred_policy)
        max_roll = Tb if pos_floor is None else max(Tb - pos_floor, 0)
        return self._prefill_jit(
            self.talker_params, embeds, pad, self.new_kv(), key, knobs,
            jnp.int32(max_roll), policy=policy.static,
        )

    # ------------------------------------------------------------------
    # one decode step (predictor frame + talker step + sampling, fused)
    # ------------------------------------------------------------------

    def _one_step(
        self,
        talker_params,
        pred_params,
        state: Dict,
        tth: jnp.ndarray,  # [B, Ttth, H] trailing text hiddens (padded w/ tts_pad)
        tth_len: jnp.ndarray,  # [B] int32 — true per-row lengths
        tts_pad_embed: jnp.ndarray,  # [B, 1, H]
        knobs: jnp.ndarray,  # [6] traced sampling knobs
        policy: StaticPolicy,
        pred_policy: predictor_lib.StaticPolicy,
    ) -> Tuple[Dict, jnp.ndarray]:
        """One full frame step.  Rows whose ``done`` flag is set still flow
        through the math (their outputs are masked by the caller via the
        per-row length counts) — the batch stops when ALL rows are done."""
        tcfg, pcfg = self.talker_cfg, self.pred_cfg
        token = state["token"]  # [B]
        key = state["key"]

        # --- predictor: 15 codebooks in-graph (reference generate.py:154-156)
        tok_embed = talker_lib.embed_codec(talker_params, token)[:, None, :]
        pred_input = jnp.concatenate([state["past_hidden"], tok_embed], axis=1)
        key, kp = jax.random.split(key)
        cb_tokens, cb_embed_sum = predictor_lib.predict_frame(
            pred_params, pcfg, pred_input, kp, pred_policy,
            temperature=knobs[4], top_p=knobs[5],
        )
        frame = jnp.concatenate([token[:, None], cb_tokens], axis=1)  # [B, 16]

        # --- next talker input = Σ 16 codec embeds + trailing text hidden
        #     (reference generate.py:163-171)
        x = tok_embed + cb_embed_sum.astype(tok_embed.dtype)
        idx = jnp.minimum(state["gen_step"], tth.shape[1] - 1)  # [B]
        row_tth = jnp.take_along_axis(tth, idx[:, None, None], axis=1)  # [B,1,H]
        trailing = jnp.where(
            (state["gen_step"] < tth_len)[:, None, None], row_tth, tts_pad_embed,
        )
        x = x + trailing

        # --- talker decode step
        hidden, kv = talker_lib.decode_step(
            talker_params, tcfg, x, state["pos"], state["pad_count"], state["kv"],
            use_flash=self.use_flash_decode, unroll=self.scan_unroll,
        )
        logits = talker_lib.codec_head(talker_params, hidden[:, 0, :])

        # --- repetition penalty over codebook-0 history incl. current token,
        #     per batch row (reference generate.py:184-186)
        B = token.shape[0]
        seen = state["seen"].at[jnp.arange(B), token].set(True)
        if policy.use_rep_penalty:
            logits = apply_repetition_penalty(logits, seen, knobs[2])

        key, ks = jax.random.split(key)
        n_gen = state["n_gen"] + 1  # [B]
        next_token = sample_logits(
            ks,
            logits,
            temperature=knobs[0],
            top_k=policy.top_k,
            top_p=knobs[1],
            use_top_p=policy.use_top_p,
            do_sample=policy.do_sample,
            suppress_mask=self._suppress,
            suppress_eos=n_gen < knobs[3].astype(jnp.int32),  # per-row
            eos_id=self.eos_id,
        )

        next_token = next_token.astype(jnp.int32)
        new_state = {
            "kv": kv,
            "past_hidden": hidden,
            "token": next_token,
            "pos": state["pos"] + 1,
            "pad_count": state["pad_count"],
            "gen_step": state["gen_step"] + 1,
            "seen": seen,
            "n_gen": n_gen,
            "done": state["done"] | (next_token == self.eos_id),
            "key": key,
        }
        return new_state, frame

    def _step_impl(self, talker_params, pred_params, state, tth, tth_len, tpe,
                   knobs, policy: StaticPolicy, pred_policy):
        return self._one_step(
            talker_params, pred_params, state, tth, tth_len, tpe, knobs,
            policy, pred_policy,
        )

    def _tth_len_vec(self, tth_len) -> jnp.ndarray:
        """Broadcast a scalar tth length to the per-row [B] vector the step
        functions take (per-row lengths matter once rows join mid-batch)."""
        return jnp.broadcast_to(
            jnp.asarray(tth_len, jnp.int32), (self.batch,))

    def decode_step(self, state, tth, tth_len, tpe, policy, pred_policy,
                    knobs=None):
        """Single fused decode step (parity/debug path)."""
        if knobs is None:
            knobs = self.knobs(policy, pred_policy)
        return self._step_jit(
            self.talker_params, self.predictor_params, state, tth,
            self._tth_len_vec(tth_len), tpe, knobs,
            policy=policy.static, pred_policy=pred_policy.static,
        )

    # ------------------------------------------------------------------
    # chunked decode: up to chunk_size steps per device program
    # ------------------------------------------------------------------

    def _chunk_impl(
        self,
        talker_params,
        pred_params,
        state,
        tth,
        tth_len,
        tpe,
        knobs,
        policy: StaticPolicy,
        pred_policy,
        chunk_size: int,
    ):
        B = self.batch
        frames0 = jnp.zeros((B, chunk_size, 16), jnp.int32)
        lens0 = jnp.zeros((B,), jnp.int32)  # per-row VALID frames this chunk
        limit = jnp.int32(self.max_seq_len - 1)

        def cond(carry):
            st, _, _, n = carry
            return (
                (n < chunk_size)
                & ~jnp.all(st["done"])
                & (st["pos"] < limit)
            )

        def body(carry):
            st, frames, lens, n = carry
            live = ~st["done"]  # rows still generating at entry to this step
            st, frame = self._one_step(
                talker_params, pred_params, st, tth, tth_len, tpe, knobs,
                policy, pred_policy,
            )
            frames = jax.lax.dynamic_update_slice(frames, frame[:, None, :], (0, n, 0))
            return st, frames, lens + live.astype(jnp.int32), n + 1

        state, frames, lens, n = jax.lax.while_loop(
            cond, body, (state, frames0, lens0, jnp.int32(0)))
        done = jnp.all(state["done"]) | (state["pos"] >= limit)
        return state, frames, n, lens, done

    def decode_chunk(self, state, tth, tth_len, tpe, policy, pred_policy,
                     chunk_size, knobs=None):
        """Run up to chunk_size fused steps in one device program.
        Returns (state, frames [B,chunk,16], n_steps, lens [B], done) — one
        host sync.  ``lens[b]`` = row b's VALID frames within this chunk
        (rows freeze at their EOS; a done row's later frames are garbage and
        must be dropped).  ``done`` = every row finished or cache full."""
        if knobs is None:
            knobs = self.knobs(policy, pred_policy)
        return self._chunk_jit(
            self.talker_params, self.predictor_params, state, tth,
            self._tth_len_vec(tth_len), tpe, knobs,
            policy=policy.static, pred_policy=pred_policy.static,
            chunk_size=chunk_size,
        )

    # ------------------------------------------------------------------
    # fused decode-chunk + streaming-vocoder window (one device program)
    # ------------------------------------------------------------------

    def _build_chunk_vocode(self, vocoder, chunk_size: int,
                            full_batch: bool = False, pcm16: bool = False):
        """Compile decode_chunk + the codec's STATEFUL streaming decode into
        ONE program: one dispatch and one host fetch per streamed audio chunk.

        The separate-program streaming path pays ~3-4 host↔device round
        trips per chunk (chunk dispatch, frames fetch, codes upload + vocoder
        dispatch, audio fetch).  The reference necessarily
        splits them too (CUDA-graph decode, then speech_tokenizer decode —
        model.py:769-826); one jitted composite removes the split.

        The vocoder side uses models/codec.py:decode_stream with its carried
        conv/attention state instead of re-decoding a 25+chunk frame window:
        only the NEW frames' samples are computed (the window redecode was
        ~4x redundant), and the result is sample-EXACT vs a full decode —
        stronger than the window scheme, whose exactness required the
        context to cover the receptive field (the codec pre-transformer's
        72-frame sliding window over 4 layers does not fit in 25 frames)."""
        from ..models import codec as codec_lib

        voc_cfg = vocoder.cfg

        def impl(talker_params, pred_params, voc_params, state, tth, tth_len,
                 tpe, knobs, voc_state, policy, pred_policy):
            state, frames, n, lens, done = self._chunk_impl(
                talker_params, pred_params, state, tth, tth_len, tpe, knobs,
                policy, pred_policy, chunk_size)
            # Frames beyond ``n`` (post-EOS garbage on the FINAL chunk) do
            # enter the stream state, but the stream ends there — no later
            # chunk reads the corrupted state.  Mid-stream chunks are full.
            # (Batched serving: a retired row's state churns garbage until
            # the row is re-primed on its next admission — also harmless,
            # the codec is strictly causal and the row's state is reset.)
            fr = frames[:, :chunk_size] if full_batch else frames[:1, :chunk_size]
            audio, voc_state = codec_lib.decode_stream(
                voc_params, voc_cfg, voc_state, fr)
            out_audio = audio if full_batch else audio[0]
            if pcm16:
                # emit wire-ready PCM16 from the device: it halves the
                # per-chunk fetch (B=24 chunk-8 = 1.5 MB fp32 vs 0.77 MB
                # int16), and every server endpoint ships 16-bit
                # (pcm/wav/mp3) anyway.  Quantization lives on device; the
                # host restores f32 for API uniformity.
                out_audio = jnp.clip(
                    jnp.round(out_audio.astype(jnp.float32) * 32767.0),
                    -32768.0, 32767.0).astype(jnp.int16)
            return state, frames, n, lens, done, out_audio, voc_state

        return jax.jit(impl, static_argnames=("policy", "pred_policy"),
                       donate_argnames=("state", "voc_state"))

    def vocode_stream_init(self, vocoder):
        """Fresh device-side codec streaming state — one fused program
        instead of ~30 eager per-buffer allocations.  The executable lives
        on the Vocoder and is shared by every consumer."""
        return vocoder.stream_state()

    def vocode_prime(self, vocoder, voc_state, codes: np.ndarray):
        """Feed reference codec codes (ICL voice clone) through the stream
        state, discarding audio.  Bounded-shape chunking and the shared
        executables live on the Vocoder (stream_feed); audio is never
        fetched, so the priming dispatches pipeline asynchronously."""
        _, voc_state = vocoder.stream_feed(voc_state, codes,
                                           collect_audio=False)
        return voc_state

    def chunk_vocode(self, vocoder, state, tth, tth_len, tpe, policy,
                     pred_policy, chunk_size, voc_state, knobs=None):
        """Fused decode_chunk + stateful vocoder.  Returns
        (state, frames, n, lens, done, audio [chunk*spf] f32, voc_state') —
        batch-1 streaming only.  ``audio`` must be trimmed to ``n*spf``
        samples by the caller."""
        assert self.batch == 1, "fused streaming vocode is batch-1"
        if knobs is None:
            knobs = self.knobs(policy, pred_policy)
        fn = self._chunk_vocode_fn(vocoder, chunk_size, full_batch=False)
        return fn(
            self.talker_params, self.predictor_params, vocoder.params, state,
            tth, self._tth_len_vec(tth_len), tpe, knobs, voc_state,
            policy=policy.static, pred_policy=pred_policy.static,
        )

    def chunk_vocode_batched(self, vocoder, state, tth, tth_len, tpe, policy,
                             pred_policy, chunk_size, voc_state, knobs=None,
                             pcm16: bool = False):
        """Fused decode_chunk + BATCHED stateful vocoder: every batch row's
        chunk is decoded AND vocoded in one device program.  Returns
        (state, frames, n, lens, done, audio [B, chunk*spf] f32 — or int16
        PCM when ``pcm16`` (halves the per-chunk fetch bytes), voc_state').
        Row ``b``'s valid audio is ``audio[b, :lens[b]*spf]`` — the codec is
        strictly causal, so the valid prefix is exact even when the tail of
        the chunk is post-EOS garbage.  The continuous-batching scheduler's
        serving loop runs on this: one dispatch and one fetch per chunk for
        the WHOLE batch (the per-row vocode path paid B extra dispatches and
        a codes re-upload per chunk)."""
        if knobs is None:
            knobs = self.knobs(policy, pred_policy)
        fn = self._chunk_vocode_fn(vocoder, chunk_size, full_batch=True,
                                   pcm16=pcm16)
        return fn(
            self.talker_params, self.predictor_params, vocoder.params, state,
            tth, self._tth_len_vec(tth_len), tpe, knobs, voc_state,
            policy=policy.static, pred_policy=pred_policy.static,
        )

    def _chunk_vocode_fn(self, vocoder, chunk_size: int, full_batch: bool,
                         pcm16: bool = False):
        cache = getattr(self, "_chunk_vocode_cache", None)
        if cache is None:
            cache = self._chunk_vocode_cache = {}
        # the cache entry holds a strong ref to the vocoder: id() keys are
        # only unique while the object is alive, and the compiled fn has the
        # vocoder's cfg baked in
        ck = (id(vocoder), chunk_size, full_batch, pcm16)
        entry = cache.get(ck)
        if entry is None or entry[0] is not vocoder:
            entry = cache[ck] = (vocoder, self._build_chunk_vocode(
                vocoder, chunk_size, full_batch=full_batch, pcm16=pcm16))
        return entry[1]

    # ------------------------------------------------------------------
    # continuous batching: admit one request into a running batch
    # ------------------------------------------------------------------

    def _join_impl(
        self,
        talker_params,
        state,  # donated
        embeds: jnp.ndarray,  # [1, Tb, H] left-padded to bucket
        pad_inner: jnp.ndarray,  # [1] int32 — left pad within the bucket
        row: jnp.ndarray,  # scalar int32 — batch row to occupy
        knobs: jnp.ndarray,
        policy: StaticPolicy,
    ):
        """Splice a fresh request's prefill into ``row`` of a RUNNING batch.

        The row's prompt is prefilled batch-1 in its own local coordinates
        and written so it ENDS at the shared cache position ``state["pos"]``:
        slot ``s`` of the splice holds RoPE position ``s - pad_count_row``
        with ``pad_count_row = pos - Tb + pad_inner`` — exactly what the
        shared decode step will compute for this row from then on.  This is
        the mechanism behind serving-level continuous batching, which the
        reference (strictly batch-1, SURVEY §2.4) cannot express.
        """
        Tb = embeds.shape[1]
        tiny_kv = talker_lib.new_kv_cache(self.talker_cfg, 1, Tb, self.dtype,
                                          kv_quant=self.kv_quant)
        last, logits, tiny_kv = talker_lib.prefill(
            talker_params, self.talker_cfg, embeds, pad_inner, tiny_kv
        )
        pos = state["pos"]
        start = pos - Tb
        kv = dict(state["kv"])
        for key_ in tiny_kv:  # k/v (+ks/vs when the cache is int8)
            if kv[key_].ndim == 5:  # k/v [L, B, S, KVH, D]
                idx = (0, row, start, 0, 0)
            else:  # scales [L, B, KVH, S] — position is the LAST axis
                idx = (0, row, 0, start)
            kv[key_] = jax.lax.dynamic_update_slice(kv[key_], tiny_kv[key_], idx)
        key, ks = jax.random.split(state["key"])
        token = sample_logits(
            ks, logits,
            temperature=knobs[0], top_k=policy.top_k, top_p=knobs[1],
            use_top_p=policy.use_top_p, do_sample=policy.do_sample,
            suppress_mask=self._suppress, suppress_eos=knobs[3] > 0,
            eos_id=self.eos_id,
        ).astype(jnp.int32)[0]
        zero = jnp.int32(0)
        state = {
            "kv": kv,
            "past_hidden": jax.lax.dynamic_update_slice(
                state["past_hidden"], last.astype(state["past_hidden"].dtype),
                (row, zero, zero)),
            "token": state["token"].at[row].set(token),
            "pos": pos,
            "pad_count": state["pad_count"].at[row].set(
                start + pad_inner[0]),
            "gen_step": state["gen_step"].at[row].set(0),
            "seen": state["seen"].at[row].set(False),
            "n_gen": state["n_gen"].at[row].set(0),
            "done": state["done"].at[row].set(token == self.eos_id),
            "key": key,
        }
        return state

    def join_row(
        self,
        state: Dict,
        row: int,
        embeds: jnp.ndarray,  # [1, T, H] unpadded prompt embeddings
        key_unused=None,
        *,
        policy: GenerationPolicy,
        pred_policy: SamplingPolicy = SamplingPolicy(),
        knobs: Optional[jnp.ndarray] = None,
        pos_hint: Optional[int] = None,
        pad_inner: Optional[int] = None,
    ) -> Dict:
        """Admit a request into ``row`` of a running batch (donates ``state``).

        Caller must ensure the shared position is at least the prompt's
        bucket length (``pos_hint`` — host-tracked position — is validated
        when given).  Compiles once per prefill bucket.

        ``pad_inner``: pass when ``embeds`` is ALREADY left-padded to its
        bucket (the continuous batcher pads on host at admission time — the
        device-side pad concat here is a distinct program per (T, bucket)
        pair, whose serve-time first compile would stall every live stream).
        """
        self._ensure_join_jit()
        B, T, H = embeds.shape
        assert B == 1, "join_row admits one request at a time"
        if pad_inner is None:
            Tb = bucket_for(T)
            extra = Tb - T
            if isinstance(embeds, np.ndarray):
                if extra:
                    embeds = np.concatenate(
                        [np.zeros((1, extra, H), np.float32),
                         np.asarray(embeds, np.float32)], axis=1)
                embeds = jnp.asarray(embeds, self.dtype)
            elif extra:
                embeds = jnp.concatenate(
                    [jnp.zeros((1, extra, H), embeds.dtype), embeds], axis=1)
        else:
            Tb, extra = T, pad_inner
            if Tb not in PREFILL_BUCKETS:
                raise ValueError(
                    f"pre-padded join embeds length {Tb} is not a prefill "
                    f"bucket {PREFILL_BUCKETS}")
        if pos_hint is not None and Tb > pos_hint:
            raise ValueError(
                f"cannot join: prompt bucket {Tb} exceeds current batch "
                f"position {pos_hint} (row would underflow the cache)")
        if knobs is None:
            knobs = self.knobs(policy, pred_policy)
        return self._join_jit(
            self.talker_params, state, embeds,
            jnp.asarray([extra], jnp.int32), jnp.int32(row), knobs,
            policy=policy.static,
        )

    def _ensure_join_jit(self):
        if not hasattr(self, "_join_jit"):
            self._join_jit = jax.jit(
                self._join_impl, static_argnames=("policy",),
                donate_argnames=("state",),
            )
        return self._join_jit

    def warm_join(
        self,
        prompt_len: int,
        *,
        policy: GenerationPolicy,
        pred_policy: SamplingPolicy = SamplingPolicy(),
        knobs: Optional[jnp.ndarray] = None,
    ) -> int:
        """AOT-compile the ``join_row`` executable for ``prompt_len``'s
        bucket from shape specs alone — no device state, no allocation.

        Safe to call from a background thread while a batch is serving: the
        compile lands in the persistent compilation cache, so the serving
        thread's later ``join_row`` at this bucket pays a trace + cache load
        instead of a full compile that would stall every live stream.  Returns the bucket."""
        if knobs is None:
            knobs = self.knobs(policy, pred_policy)
        jit_fn = self._ensure_join_jit()
        Tb = bucket_for(prompt_len)
        B, H = self.batch, self.talker_cfg.hidden_size
        sds = jax.ShapeDtypeStruct

        def spec(tree):
            return jax.tree.map(lambda x: sds(x.shape, x.dtype), tree)

        p_spec = spec(self.talker_params)
        kv_spec = jax.eval_shape(
            lambda: talker_lib.new_kv_cache(
                self.talker_cfg, self.batch, self.max_seq_len, self.dtype,
                kv_quant=self.kv_quant))
        state_spec = jax.eval_shape(
            functools.partial(self._prefill_jit, policy=policy.static),
            p_spec, sds((B, Tb, H), self.dtype), sds((B,), jnp.int32),
            kv_spec, spec(jax.random.PRNGKey(0)), spec(jnp.asarray(knobs)),
            sds((), jnp.int32))
        t0 = time.time()
        jit_fn.lower(
            p_spec, state_spec, sds((1, Tb, H), self.dtype),
            sds((1,), jnp.int32), sds((), jnp.int32), spec(jnp.asarray(knobs)),
            policy=policy.static,
        ).compile()
        logger.info("warm_join: bucket %d compiled in %.1fs",
                    Tb, time.time() - t0)
        return Tb

    # ------------------------------------------------------------------
    # warmup — AOT compile at fixed shapes (reference model.py:154-163)
    # ------------------------------------------------------------------

    def warmup(
        self,
        prefill_len: int,
        tth_len: int,
        policy: GenerationPolicy,
        pred_policy: SamplingPolicy,
        chunk_sizes=(8,),
        vocoder=None,
    ) -> float:
        """Compile the prefill bucket + chunk executables (and, when a
        ``vocoder`` is given, the fused chunk+vocode streaming programs).
        Returns seconds."""
        with device_scope(self.device):
            t0 = time.time()
            B, H = self.batch, self.talker_cfg.hidden_size
            Tb = bucket_for(prefill_len)
            Tt = bucket_for(max(tth_len, 1), TTH_BUCKETS)
            embeds = jnp.zeros((B, Tb, H), self.dtype)
            tth = jnp.zeros((B, Tt, H), self.dtype)
            tpe = jnp.zeros((B, 1, H), self.dtype)
            key = jax.random.PRNGKey(0)
            knobs = self.knobs(policy, pred_policy)
            state = self._prefill_jit(
                self.talker_params, embeds, jnp.zeros((B,), jnp.int32), self.new_kv(),
                key, knobs, jnp.int32(Tb), policy=policy.static,
            )
            for cs in chunk_sizes:
                state, frames, n, lens, done = self.decode_chunk(
                    state, tth, 0, tpe, policy, pred_policy, cs, knobs=knobs
                )
            if vocoder is not None and B == 1:
                vst = self.vocode_stream_init(vocoder)
                for cs in chunk_sizes:
                    out = self.chunk_vocode(vocoder, state, tth, 0, tpe, policy,
                                            pred_policy, cs, vst, knobs=knobs)
                    state, vst = out[0], out[6]
            jax.block_until_ready(state)
            self._warmed_up = True
            dt = time.time() - t0
            logger.info("engine warmup (prefill bucket %d, chunks %s): %.1fs", Tb, chunk_sizes, dt)
            return dt

    def warmup_all(
        self,
        policy: GenerationPolicy,
        pred_policy: SamplingPolicy,
        chunk_sizes=(8, 16),
        max_prefill: Optional[int] = None,
        max_tth: Optional[int] = None,
        vocoder=None,
    ) -> float:
        """Compile EVERY (prefill bucket, tth bucket × chunk size) executable
        so no later request hits a mid-serving compile stall (the reference's
        mask-table design covers all lengths after one capture,
        talker_graph.py:71-95; our bucketed design needs one compile per
        bucket instead).  All programs land in the
        persistent XLA compile cache, so across restarts this is a cache read.
        Returns seconds."""
        with device_scope(self.device):
            t0 = time.time()
            B, H = self.batch, self.talker_cfg.hidden_size
            key = jax.random.PRNGKey(0)
            knobs = self.knobs(policy, pred_policy)
            tpe = jnp.zeros((B, 1, H), self.dtype)
            p_buckets = [b for b in PREFILL_BUCKETS
                         if b <= min(max_prefill or self.max_seq_len, self.max_seq_len)]
            t_buckets = [b for b in TTH_BUCKETS if b <= (max_tth or TTH_BUCKETS[-1])]
            state = None
            for Tb in p_buckets:
                if state is not None:
                    self.release(state)  # recycle the KV buffer across compiles
                embeds = jnp.zeros((B, Tb, H), self.dtype)
                state = self._prefill_jit(
                    self.talker_params, embeds, jnp.zeros((B,), jnp.int32),
                    self.new_kv(), key, knobs, jnp.int32(Tb), policy=policy.static,
                )
            for Tt in t_buckets:
                tth = jnp.zeros((B, Tt, H), self.dtype)
                for cs in dict.fromkeys(chunk_sizes):
                    state, _, _, _, _ = self.decode_chunk(
                        state, tth, 0, tpe, policy, pred_policy, cs, knobs=knobs
                    )
                    if vocoder is not None and B == 1:
                        vst = self.vocode_stream_init(vocoder)
                        out = self.chunk_vocode(vocoder, state, tth, 0, tpe,
                                                policy, pred_policy, cs, vst,
                                                knobs=knobs)
                        state = out[0]
            jax.block_until_ready(state["token"])
            self.release(state)
            self._warmed_up = True
            dt = time.time() - t0
            logger.info(
                "engine warmup_all (%d prefill buckets, %d tth buckets × %d chunk "
                "sizes): %.1fs", len(p_buckets), len(t_buckets), len(set(chunk_sizes)), dt)
            return dt
