"""Continuous batching scheduler: dynamic request admission onto one
batched Engine.

The reference serializes concurrent requests behind a lock (reference
examples/openai_server.py:71,181; demo/server.py:167-168) — one request owns
the GPU at a time.  Here a worker thread owns the device and runs ONE batched
engine; requests are admitted into free batch rows *while the batch is
running* (Engine.join_row splices a one-row prefill into the shared KV at a
chunk boundary), stream their audio independently, and retire at their own
EOS.  Aggregate frames/s scales with occupancy while per-request latency
stays near batch-B latency — a serving mode the reference's strictly
batch-1 design cannot express (SURVEY §2.4).

Sampling knobs (temperature/top-k/penalty) are shared per batcher — they are
one traced knob vector per program call.  Greedy/sampled policy is fixed at
construction.  Per-request texts, voices, prompt lengths and EOS times are
fully independent.
"""
from __future__ import annotations

import contextlib
import hashlib
import logging
import os
import queue
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, Generator, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.predictor import SamplingPolicy
from .engine import (
    Engine,
    GenerationPolicy,
    PREFILL_BUCKETS,
    TTH_BUCKETS,
    bucket_for,
    device_scope,
)

logger = logging.getLogger(__name__)

# per-chunk serving-loop timing trace (join/dispatch/fetch split) — the
# observability hook for diagnosing batched-serving walls where host round
# trips dominate
_TRACE = os.environ.get("QWEN3TTS_BATCH_TRACE", "0") == "1"

_SENTINEL = object()

# per-request audio queue depth and how long a full queue may stall the
# worker before the stream is failed (module-level so tests can shrink them)
OUT_QUEUE_SIZE = 64
EMIT_TIMEOUT_S = 5.0

# Out-of-order admission scan depth: how many waiting requests are
# considered for a free row.  FIFO order is preferred, but a request whose
# prompt bucket exceeds the batch's current position must not block the
# admissible requests behind it (measured: a bucket-256 head held a
# saturated batch at 3/8 occupancy for ~1 s while bucket-64 requests waited
# behind it — the dominant term in serving 459 vs raw-batched 902 frames/s).
ADMIT_SCAN = 16

# Batch-start burst collection: when ≥2 requests are already waiting as a
# batch forms (a concurrent burst), the worker briefly keeps collecting —
# a batch that starts full prefills ALL rows in one stacked program and
# skips the position-gated join path entirely.  The refresh window SCALES
# with how many requests are already waiting (more waiting = stronger
# flood evidence = worth waiting longer for the next arrival): under a
# 24-request flood whose submits land ~40 ms apart (GIL-serialized host
# prompt prep), a fixed 20 ms window started the batch 4/8 full and the
# stragglers all paid the position-gated join path (measured: batch
# started rows=4, 20 mid-batch joins).  A single waiting request still
# starts immediately, and a 2-request light burst waits at most one
# 3×window refresh, so light-load TTFA pays ≤ ~60 ms only when a second
# request is ALREADY queued.
START_WINDOW_S = float(os.environ.get("QWEN3TTS_BATCH_START_WINDOW", "0.02"))
START_WINDOW_CAP_S = float(
    os.environ.get("QWEN3TTS_BATCH_START_CAP", "0.6"))

# Adaptive post-join TTFA ramp: re-running the first_chunks ramp after a
# join only pays when the joiner's clock is latency-dominated.  A joiner
# that already sat ≥ this long in the queue is saturated — the ramp could
# shave at most ~(chunk_size - first_chunks[0]) steps (~50 ms) off a TTFA
# that queueing already pushed into the seconds, while every small chunk
# taxes ALL rows' throughput (each ramp chunk pays the same fixed
# dispatch+fetch cost as a full one).  Fresh joiners (light load) still get
# the ramp and its TTFA win.  The batch-START ramp is unconditional either way: it runs once and
# covers the initial rows' TTFA.
RAMP_FRESH_S = float(os.environ.get("QWEN3TTS_RAMP_FRESH", "0.25"))


@dataclass
class _Request:
    embeds: np.ndarray  # [1, T, H]
    trailing: np.ndarray  # [1, Tt, H]
    tpe: np.ndarray  # [1, 1, H]
    ref_codes: Optional[np.ndarray]
    max_new_tokens: int
    out_q: "queue.Queue" = field(
        default_factory=lambda: queue.Queue(maxsize=OUT_QUEUE_SIZE))
    submitted_at: float = field(default_factory=time.time)
    started_at: float = 0.0
    steps: int = 0
    chunk_index: int = 0
    row: int = -1
    cancelled: bool = False
    # predictive budget retirement: dispatched-step upper bound and the
    # "this row is certainly retiring by its in-flight chunk's fetch" flag
    planned: int = 0
    retiring: bool = False
    # admission-time async uploads (overlap host->device transfer with the
    # running batch instead of paying it inside the tail join).  embeds_dev
    # is pre-padded on HOST to its prefill bucket (join_pad = inner left
    # pad): the device-side pad concat is a per-(T, bucket) program whose
    # serve-time first compile stalled every live stream 150-415 ms.
    embeds_dev: Optional[object] = None
    join_pad: int = 0
    tth_row_dev: Optional[object] = None


class StreamHandle:
    """Client-side handle: iterate ``chunks()`` for (audio, sr, timing)."""

    def __init__(self, req: _Request, sr: int):
        self._req = req
        self._sr = sr

    def chunks(self) -> Generator[Tuple[np.ndarray, int, dict], None, None]:
        while True:
            item = self._req.out_q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, Exception):
                raise item
            audio, timing = item
            if audio.dtype == np.int16:  # pcm16 wire: restore f32 here,
                audio = audio.astype(np.float32) / 32767.0  # off the hot loop
            yield audio, self._sr, timing

    def cancel(self):
        """Best-effort: the row finishes its current chunk then is retired."""
        self._req.cancelled = True


class ContinuousBatcher:
    """Worker-thread scheduler over one batched Engine.

    ``submit`` builds the prompt on the caller's thread (host numpy), then
    enqueues; the worker starts a batch when idle, joins requests into free
    rows at chunk boundaries while running, and pushes per-row audio chunks
    to each request's queue.
    """

    def __init__(
        self,
        model,
        max_batch: int = 4,
        chunk_size: int = 8,
        max_new_tokens: int = 2048,
        policy: Optional[GenerationPolicy] = None,
        pred_policy: Optional[SamplingPolicy] = None,
        first_chunks: Tuple[int, ...] = (),
    ):
        self.model = model
        self.B = max_batch
        self.chunk_size = chunk_size
        # TTFA ramp (same contract as loops.py first_chunks): after a batch
        # starts AND after every mid-batch join, the next dispatches use
        # these smaller chunk sizes before settling at ``chunk_size`` — the
        # newest row's first audio leaves after e.g. 2 steps instead of 8.
        # All rows share each dispatch's size, so a join briefly shrinks
        # everyone's chunks (a small throughput tax, bounded by the ramp
        # length); leave empty to serve at fixed chunk_size.
        self.first_chunks = tuple(first_chunks)
        self.max_new_tokens = max_new_tokens
        self.policy = policy or GenerationPolicy()
        self.pred_policy = pred_policy or SamplingPolicy()
        self.engine: Engine = model._batch_engine(max_batch)
        self.knobs = self.engine.knobs(self.policy, self.pred_policy)
        # fetch audio as device-quantized PCM16 (QWEN3TTS_SERVE_PCM16=0 to
        # disable): the audio fetch is the dominant per-chunk wire cost at
        # large B, every server endpoint ships 16-bit anyway, and the host
        # restores f32 right after the fetch so the API surface (and the
        # sample budget per request) is unchanged up to 1/32767 quantization
        self._pcm16 = os.environ.get("QWEN3TTS_SERVE_PCM16", "1") == "1"
        self._pending: "queue.Queue[_Request]" = queue.Queue()
        # primed single-row codec stream states keyed by voice (ref codes
        # content): admitting a repeat voice is a pure device-side scatter
        # instead of re-feeding the reference codes through the vocoder
        self._voice_states: "OrderedDict[object, object]" = OrderedDict()
        self._voice_cache_cap = 8
        self._stop = threading.Event()
        # mid-batch admission requires the join executable for the request's
        # prompt bucket; buckets not compiled yet are AOT-compiled on a
        # BACKGROUND thread (Engine.warm_join) while the batch keeps
        # serving, and the request is admitted once ready — a mid-serve
        # inline compile would stall every live stream for seconds.  The
        # ready-set lives on the ENGINE (where the executable cache lives),
        # so it survives batcher re-creation over the same model.
        if not hasattr(self.engine, "_join_ready_buckets"):
            self.engine._join_ready_buckets = set()
        self._join_ready: set = self.engine._join_ready_buckets
        self._compiling_buckets: set = set()
        self._stats = {"served": 0, "joined_mid_batch": 0, "batches": 0,
                       "cancelled": 0, "active_rows": 0,
                       "retired_predictively": 0}
        # arrivals advertised via ``arriving()`` but not yet submitted:
        # the burst collector keeps collecting while any are in flight
        self._incoming = 0
        self._incoming_lock = threading.Lock()
        # requests the worker has popped from _pending but not yet admitted
        # (worker-thread-only; admission scans it out of order, see
        # _peek_admissible)
        self._waiting: List[_Request] = []
        self._worker = threading.Thread(
            target=self._run, name="continuous-batcher", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    # client side
    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def arriving(self):
        """Advertise a request BEFORE its host-side prompt prep.

        Under a concurrent flood, submits land tens of ms apart (prep is
        GIL-serialized), so the worker otherwise starts the batch with
        whatever trickled in first and every straggler pays the
        position-gated ``join_row`` path (measured: a 24-request flood
        started rows=4 with 20 mid-batch joins).  Wrapping the prep+submit
        in ``arriving()`` lets ``_collect_start_burst`` keep collecting —
        bounded by START_WINDOW_CAP_S — while ANY advertised arrival has
        not yet submitted.  Costs nothing at light load: with no arrivals
        advertised, batch start is as eager as before."""
        with self._incoming_lock:
            self._incoming += 1
        try:
            yield
        finally:
            with self._incoming_lock:
                self._incoming -= 1

    def submit(
        self,
        text: str,
        language: str,
        ref_audio,
        ref_text: str,
        *,
        xvec_only: bool = True,
        non_streaming_mode: bool = True,
        append_silence: bool = True,
        instruct: Optional[str] = None,
        max_new_tokens: Optional[int] = None,
    ) -> StreamHandle:
        if self._stop.is_set():
            raise RuntimeError("batcher is closed")
        if not self._worker.is_alive():
            # catastrophic worker death (logged by _run): nothing will ever
            # drain _pending again — fail fast instead of queueing into the
            # void (ReplicaPool uses `alive` to route around dead replicas)
            raise RuntimeError("batcher worker is dead (see earlier log)")
        embeds, trailing, tpe, ref_codes = self.model._prepare_clone(
            text, ref_audio, ref_text, language, xvec_only,
            non_streaming_mode, append_silence, instruct, device=False,
        )
        req = _Request(
            embeds=np.asarray(embeds, np.float32),
            trailing=np.asarray(trailing, np.float32),
            tpe=np.asarray(tpe, np.float32),
            ref_codes=np.asarray(ref_codes) if ref_codes is not None and len(ref_codes) else None,
            max_new_tokens=min(max_new_tokens or self.max_new_tokens,
                               self.max_new_tokens),
        )
        self._pending.put(req)
        if not self._worker.is_alive():
            # worker died between the liveness check above and the put — the
            # catastrophic drain may already have run, so nothing would ever
            # fail this request.  Double-delivery of the error is harmless
            # (the consumer reads the first item only).
            req.out_q.put(RuntimeError("batcher worker is dead (see earlier log)"))
        return StreamHandle(req, self.model.sample_rate)

    def close(self, timeout: float = 30.0):
        self._stop.set()
        self._pending.put(_SENTINEL)  # wake the worker
        self._worker.join(timeout=timeout)

    @property
    def alive(self) -> bool:
        """True while the worker thread is serving (False after close() or a
        catastrophic worker failure)."""
        return self._worker.is_alive() and not self._stop.is_set()

    @property
    def stats(self) -> Dict:
        return dict(self._stats,
                    queue_depth=self._pending.qsize() + len(self._waiting))

    # ------------------------------------------------------------------
    # worker side
    # ------------------------------------------------------------------

    def _drain_arrivals(self) -> None:
        """Move every already-arrived request from _pending into _waiting
        (never blocks).  Worker thread only."""
        while True:
            try:
                nxt = self._pending.get_nowait()
            except queue.Empty:
                return
            if nxt is _SENTINEL:
                self._stop.set()
                return
            self._waiting.append(nxt)

    def _collect_start_burst(self) -> None:
        """Before starting a batch: if a burst is evident (≥2 requests
        already waiting, or arrivals advertised via ``arriving()`` are
        still preparing), keep collecting briefly so the batch starts as
        full as possible — rows prefilled together skip the position-gated
        join path.  The window refreshes on each arrival, scales with the
        evidence (more waiting = worth waiting longer for the next), and
        is capped overall; a lone request with nothing advertised starts
        with zero added latency."""
        deadline = time.time() + START_WINDOW_CAP_S
        while len(self._waiting) < self.B and not self._stop.is_set():
            try:
                nxt = self._pending.get_nowait()
            except queue.Empty:
                burst = len(self._waiting) >= 2 or self._incoming > 0
                if not burst or START_WINDOW_S <= 0:
                    return
                # flood-evidence-scaled refresh: n waiting → n+1 windows
                wait = min(START_WINDOW_S * (len(self._waiting) + 1),
                           deadline - time.time())
                if wait <= 0:
                    return
                try:
                    nxt = self._pending.get(timeout=wait)
                except queue.Empty:
                    if self._incoming > 0 and time.time() < deadline:
                        continue  # advertised arrivals still preparing
                    return  # no new arrival inside the refresh window
            if nxt is _SENTINEL:
                self._stop.set()
                return
            self._waiting.append(nxt)

    def _run(self):
        # the buffers the worker uploads land on the replica's own device
        with device_scope(self.engine.device):
            batch: List[_Request] = []  # popped but not yet served
            try:
                while not self._stop.is_set():
                    if not self._waiting:
                        first = self._pending.get()
                        if first is _SENTINEL or self._stop.is_set():
                            break
                        self._waiting.append(first)
                    self._collect_start_burst()
                    batch = self._waiting[: self.B]
                    del self._waiting[: self.B]
                    self._serve_batch(batch)
                    batch = []
            except Exception:  # catastrophic worker failure
                logger.exception("batcher worker died")
                self._stop.set()  # alive -> False before the drain, not after
                # in-flight batch members and popped-but-waiting requests must
                # not hang
                for req in batch + self._waiting:
                    req.out_q.put(RuntimeError("batcher worker died"))
                self._waiting = []
                while True:
                    try:
                        req = self._pending.get_nowait()
                    except queue.Empty:
                        break
                    if req is not _SENTINEL:
                        req.out_q.put(RuntimeError("batcher worker died"))
            finally:
                for req in self._waiting:  # terminate never-started streams
                    req.out_q.put(_SENTINEL)
                self._waiting = []
                while True:  # drain: fail anything still queued at shutdown
                    try:
                        req = self._pending.get_nowait()
                    except queue.Empty:
                        break
                    if req is not _SENTINEL:
                        req.out_q.put(_SENTINEL)

        # ---- batch lifecycle

    def _serve_batch(self, initial: List[_Request]):
        """Run one batch to completion.  Any unexpected failure fails every
        request the batch currently owns (live rows AND admitted-but-not-yet-
        joined) — a stream that hangs forever is strictly worse than one that
        raises — and the worker survives to serve the next batch."""
        rows: List[Optional[_Request]] = [None] * self.B
        for i, req in enumerate(initial):
            rows[i] = req
        admitted: List[_Request] = []  # popped from _pending, not yet in rows
        try:
            self._serve_batch_inner(rows, initial, admitted)
        except Exception as exc:  # noqa: BLE001 — deliver, don't hang
            logger.exception("batch serving failed")
            victims = {id(r): r for r in rows + admitted if r is not None}
            for req in victims.values():
                self._fail(req, RuntimeError(
                    f"batch serving failed: {exc!r}"))

    def _serve_batch_inner(self, rows: List[Optional[_Request]],
                           initial: List[_Request],
                           admitted: List[_Request]):
        eng, B = self.engine, self.B
        H = self.model.cfg.talker.hidden_size
        self._stats["batches"] += 1
        t_batch0 = time.time()

        # --- stacked initial prefill: rows left-padded ON HOST straight to
        #     the bucket width with true per-row pad counts (masks + RoPE
        #     need them); rows beyond the initial set are zero prompts,
        #     marked done right after.  Building at the bucket (not the true
        #     max length) means engine.prefill never pads device-side — the
        #     pad concat was a per-(T, bucket) program compiling at serve
        #     time (325-380 ms of batch-setup stall per new length).
        T = max(r.embeds.shape[1] for r in initial)
        Tb = bucket_for(T)
        # Position headroom for queued joiners: join_row splices a prompt at
        # [pos-Tb, pos), so a joiner's bucket must be <= the shared position
        # — which only crosses a larger bucket after enough decode chunks.
        # On a saturated start, lift the initial prefill straight to the
        # largest bucket any ALREADY-WAITING request needs: pos begins there
        # and every queued joiner admits the moment a slot frees (measured:
        # bucket-256 joiners otherwise idled 5-7 chunks at live=2-3 waiting
        # for pos to cross 256 — the largest avoidable occupancy hole in the
        # saturated trace).  Light load (empty queue) keeps the minimal
        # bucket: TTFA beats position headroom when nobody is waiting.
        self._drain_arrivals()
        need = max((bucket_for(r.embeds.shape[1]) for r in self._waiting),
                   default=0)
        Tb = max(Tb, need)
        self._check_warmed(Tb)
        embeds = np.zeros((B, Tb, H), np.float32)
        pads = np.full((B,), Tb, np.int32)  # unused rows: fully padded
        for i, req in enumerate(initial):
            L = req.embeds.shape[1]
            pads[i] = Tb - L
            embeds[i, Tb - L:] = req.embeds[0]
        t_embeds = time.time()
        state = eng.prefill(
            embeds, self.model._next_key(), self.policy,
            pad_count=pads, knobs=self.knobs,
            pos_floor=need if need else None,
        )
        t_prefill = time.time()
        # prefill compacts by min(pad), capped so pos >= need (pos_floor)
        pos = Tb - min(int(pads.min()), Tb - need)
        if len(initial) < B:
            mask = np.zeros((B,), bool)
            mask[len(initial):] = True
            state["done"] = state["done"] | jnp.asarray(mask)

        # --- per-row tth arrays (device), re-bucketed as needed.  Width
        # starts at the warmup-covered bucket (floor): a mid-serve re-bucket
        # re-uploads the whole (B, W, H) array while every live stream
        # waits, so pay the few hundred KB up front and make every join a
        # row scatter instead.
        tth_w = max(
            bucket_for(max(max(r.trailing.shape[1] for r in initial), 1),
                       TTH_BUCKETS),
            getattr(self, "_tth_floor", 0))
        tth = np.zeros((B, tth_w, H), np.float32)
        tth_lens = np.zeros((B,), np.int32)
        tpe = np.zeros((B, 1, H), np.float32)
        for i, req in enumerate(initial):
            L = req.trailing.shape[1]
            tth[i, :L] = req.trailing[0]
            tth[i, L:] = req.tpe[0]
            tth_lens[i] = L
            tpe[i] = req.tpe[0]
        tth_dev = jnp.asarray(tth, eng.dtype)
        tpe_dev = jnp.asarray(tpe, eng.dtype)

        # --- ONE batched codec stream state for the whole batch: each
        # live row's chunk is vocoded inside the fused device program
        # (chunk_vocode_batched); admissions splice a primed single-row
        # state in via scatter_stream_row
        voc = self.model.vocoder
        spf = voc.spf
        t_tth = time.time()
        voc_state = voc.stream_state_batched(B)
        t_vocinit = time.time()
        for i, req in enumerate(initial):
            voc_state = voc.scatter_stream_row(
                voc_state, self._primed_state(req), i)
        t_prime = time.time()

        for req in initial:
            self._start_request(req)
        if _TRACE:
            logger.info(
                "batch setup split: embeds=%.1fms prefill=%.1f tth=%.1f "
                "vocinit=%.1f prime=%.1f", (t_embeds - t_batch0) * 1e3,
                (t_prefill - t_embeds) * 1e3, (t_tth - t_prefill) * 1e3,
                (t_vocinit - t_tth) * 1e3, (t_prime - t_vocinit) * 1e3)

        # --- deep-pipelined chunk loop.  Up to ``depth`` decode chunks are
        # in flight at once; each output's host transfer is started at
        # dispatch time (copy_to_host_async), so the per-chunk fetch
        # overlaps both the device running later chunks AND the other
        # chunks' transfers.  A 1-deep pipeline serializes one full fetch
        # per chunk and bounds the whole batch at host round-trip latency.
        #
        # Mutations (joins, force-done) apply to the pipeline TAIL state —
        # the one the host still owns — the iteration after they are
        # decided at fetch time.  Two occupancy views keep that honest:
        # ``row_owner`` is occupancy at the tail (set at join, cleared at
        # retirement) and drives admission; ``rows`` is occupancy as seen
        # by the chunk being FETCHED (a join becomes visible only when the
        # first chunk dispatched after it is fetched — each queue entry
        # carries its activations).  Post-EOS speculative chunks exit
        # their while_loop in zero iterations, so overshoot stays cheap;
        # budget/cancel-forced rows burn at most ``depth`` extra chunks
        # before the force lands at the tail (their frames are trimmed at
        # emission either way).  Decode AND vocode run as ONE fused
        # batched program (chunk_vocode_batched): audio for every row
        # comes back in the same single fetch as the chunk bookkeeping.
        limit = eng.max_seq_len - 1
        depth = int(os.environ.get("QWEN3TTS_BATCH_PIPELINE", "3"))
        deferred_joins: List[Tuple[int, _Request]] = []
        pending_force = np.zeros((B,), bool)
        row_owner: List[Optional[_Request]] = list(rows)
        q: deque = deque()
        cur_state, cur_voc = state, voc_state
        pos_lb = pos  # actual position through the last FETCHED chunk
        inflight_steps = 0  # planned upper bound of steps in flight
        activations: List[Tuple[int, _Request]] = []  # joins awaiting fetch

        ramp: List[int] = list(self.first_chunks)  # upcoming dispatch sizes

        def dispatch_one():
            nonlocal cur_state, cur_voc, inflight_steps, activations
            size = ramp.pop(0) if ramp else self.chunk_size
            out = eng.chunk_vocode_batched(
                voc, cur_state, tth_dev, jnp.asarray(tth_lens), tpe_dev,
                self.policy, self.pred_policy, size, cur_voc,
                knobs=self.knobs, pcm16=self._pcm16)
            cur_state, cur_voc = out[0], out[6]
            # per-row done AFTER this chunk; `| False` copies it out of the
            # state pytree so the next dispatch's donation can't invalidate it
            done_snap = cur_state["done"] | False
            for arr in (out[2], out[3], out[5], done_snap):  # n, lens, audio
                try:
                    arr.copy_to_host_async()
                except (AttributeError, NotImplementedError):
                    pass
            q.append((out, done_snap, activations, size))
            activations = []
            inflight_steps += size
            # --- predictive budget retirement: the chunk just dispatched
            # takes each live tail row to ``planned`` steps (an upper bound —
            # early device EOS only retires it sooner).  A row whose budget
            # is exhausted by an IN-FLIGHT chunk is certainly retiring by
            # that chunk's fetch, so free its tail slot NOW: the replacement
            # joins ~pipeline-depth chunks earlier than fetch-time discovery
            # would allow (measured: live=4..7 stretches between retire and
            # join dominate the saturated-throughput gap vs the raw batched
            # engine).  Bookkeeping (frame trim + finish) still happens at
            # the fetch, via ``rows``; the force below stops the device from
            # stepping the stale row past the exhausting chunk.
            for b in range(B):
                r = row_owner[b]
                if r is None or r.retiring:
                    continue
                r.planned += size
                if r.planned >= r.max_new_tokens:
                    r.retiring = True
                    pending_force[b] = True
                    row_owner[b] = None
                    self._stats["retired_predictively"] += 1

        dispatch_one()
        t_chunk = time.time()
        if _TRACE:
            logger.info("batch start: rows=%d setup=%.1fms (prefill+prime+"
                        "first dispatch)", len(initial),
                        (t_chunk - t_batch0) * 1e3)
        while True:
            # --- apply mutations decided at the previous fetch to the TAIL.
            # Order matters: force-done lands BEFORE joins, so a join into a
            # row whose previous occupant was budget-forced this iteration
            # cleanly resets the row's done flag.
            if pending_force.any():
                # device-resident per-row masks (uploaded once): the or is a
                # pure async dispatch — a serve-time host->device transfer
                # here would block the worker for a full round trip
                cur_state = dict(cur_state)
                d = cur_state["done"]
                for fb in np.nonzero(pending_force)[0]:
                    d = d | self._force_mask(int(fb))
                cur_state["done"] = d
                pending_force = np.zeros((B,), bool)
            for b, req in deferred_joins:
                t_j0 = time.time()
                # no _check_warmed here: admission already gated on
                # _bucket_join_ready, so the executable exists by now
                if req.embeds_dev is not None:
                    embeds_dev, pad_inner = req.embeds_dev, req.join_pad
                else:  # fallback: host-pad now (never a device concat)
                    Lp = req.embeds.shape[1]
                    pad_inner = bucket_for(Lp) - Lp
                    padded = np.concatenate(
                        [np.zeros((1, pad_inner, H), np.float32),
                         req.embeds], axis=1) if pad_inner else req.embeds
                    embeds_dev = jnp.asarray(padded, eng.dtype)
                req.embeds_dev = None
                cur_state = eng.join_row(
                    cur_state, b, embeds_dev,
                    policy=self.policy, pred_policy=self.pred_policy,
                    knobs=self.knobs, pos_hint=pos_lb, pad_inner=pad_inner,
                )
                t_j1 = time.time()
                L = req.trailing.shape[1]
                if L > tth_dev.shape[1]:  # re-bucket the shared tth array
                    new_w = bucket_for(L, TTH_BUCKETS)
                    grown = np.asarray(tth_dev, np.float32)
                    grown = np.concatenate(
                        [grown, np.tile(tpe, (1, new_w - grown.shape[1], 1))],
                        axis=1)
                    tth_dev = jnp.asarray(grown, eng.dtype)
                # width check guards against a re-bucket (by this or an
                # earlier join in the same group) since the pre-upload
                if req.tth_row_dev is not None \
                        and req.tth_row_dev.shape[0] == tth_dev.shape[1]:
                    row_dev = req.tth_row_dev
                    req.tth_row_dev = None
                else:
                    req.tth_row_dev = None
                    row_full = np.tile(req.tpe[0], (tth_dev.shape[1], 1))
                    row_full[:L] = np.asarray(req.trailing[0], np.float32)
                    row_dev = jnp.asarray(row_full, eng.dtype)
                # row index TRACED (jnp.int32): a Python int bakes the row
                # into the program — 8 rows × 2 scatters = 16 executables,
                # each a serve-time compile stall on its first use (measured
                # 827 ms on the first mid-batch join group)
                tth_dev = tth_dev.at[jnp.int32(b)].set(row_dev)
                tpe[b] = req.tpe[0]
                tpe_dev = tpe_dev.at[jnp.int32(b)].set(
                    jnp.asarray(req.tpe[0], eng.dtype))
                tth_lens[b] = L
                # reset + prime the row's slice of the shared vocoder state
                # (its first frames appear in the chunk dispatched below)
                cur_voc = voc.scatter_stream_row(
                    cur_voc, self._primed_state(req), b)
                row_owner[b] = req
                activations.append((b, req))
                self._stats["joined_mid_batch"] += 1
                self._start_request(req)
                if _TRACE:
                    logger.info(
                        "join row=%d bucket=%d join_row=%.1fms "
                        "tth+scatter=%.1fms", b,
                        bucket_for(req.embeds.shape[1]),
                        (t_j1 - t_j0) * 1e3, (time.time() - t_j1) * 1e3)
            if deferred_joins and self._ramp_after_join(
                    [req for _, req in deferred_joins]):
                ramp[:] = self.first_chunks  # joiner TTFA: re-run the ramp
            deferred_joins = []
            t_join_done = time.time()

            # --- keep the pipeline full.  Growth is bounded per iteration
            # so the oldest chunk's fetch (someone's TTFA) is never starved
            # behind a dispatch burst; dispatch stops when the planned
            # position would exceed the window or nothing is live at the
            # tail (the device loop also self-clamps at max_seq_len-1).
            grown = 0
            while (len(q) <= depth and grown < 2
                   and pos_lb + inflight_steps < limit
                   and any(r is not None for r in row_owner)):
                dispatch_one()
                grown += 1
            t_dispatch_done = time.time()
            if not q:
                break  # nothing in flight, nothing live to dispatch

            # --- fetch the oldest in-flight chunk (transfer began at its
            # dispatch; later chunks are already running / transferring)
            out, done_snap, acts, size_k = q.popleft()
            for b, req in acts:  # joins visible from this chunk on
                rows[b] = req
                admitted.remove(req)
            _, _frames, n, lens, _done_all, audio, _ = out
            n_val, lens_np, audio_np, row_done = jax.device_get(
                (n, lens, audio, done_snap))
            inflight_steps -= size_k
            pos_lb += int(n_val)
            if _TRACE:
                now = time.time()
                logger.info(
                    "chunk wall=%.1fms join=%.1f dispatch=%.1f fetch=%.1f "
                    "q=%d joins=%d live=%d pos=%d",
                    (now - t_chunk) * 1e3, (t_join_done - t_chunk) * 1e3,
                    (t_dispatch_done - t_join_done) * 1e3,
                    (now - t_dispatch_done) * 1e3, len(q), len(acts),
                    sum(r is not None for r in rows), pos_lb)
                t_chunk = now

            # --- emit per-row audio; retire rows at EOS / budget.
            # ``audio_np[b]`` holds the row's whole vocoded chunk; the
            # valid prefix (causal codec) is the deliverable slice.
            retires: List[int] = []
            for b in range(B):
                req = rows[b]
                if req is None:
                    continue
                valid = int(lens_np[b])
                if req.cancelled:
                    valid = 0
                take = min(valid, req.max_new_tokens - req.steps)
                if take > 0:
                    req.steps += take  # counted at decode time (budget)
                    # pcm16 wire buffers are delivered as int16 views and
                    # restored to f32 on the CONSUMER's thread
                    # (StreamHandle.chunks) — the astype+scale is ~2 MB of
                    # numpy per chunk at B=32, real time on a 1-core host,
                    # and this fetch loop is the serving serialization point
                    self._deliver(req, audio_np[b, : take * spf], take)
                over_budget = req.steps >= req.max_new_tokens
                if bool(row_done[b]) or over_budget or req.cancelled:
                    if req.cancelled:
                        self._stats["cancelled"] += 1
                    if not bool(row_done[b]) and not req.retiring:
                        # over-budget OR cancelled: mark done on device too
                        # (applied at the tail next iteration) so the row
                        # stops burning decode steps.  A predictively-retired
                        # row was already forced when its slot was freed —
                        # re-forcing here would kill the NEW occupant that
                        # may have joined the slot since.
                        pending_force[b] = True
                    retires.append(b)
            for b in retires:
                req = rows[b]
                self._finish_request(req)
                rows[b] = None
                if row_owner[b] is req:
                    row_owner[b] = None  # slot reusable at the tail
                # else: predictive retirement freed the slot at dispatch
                # time and a new request may already own it

            # --- decide admissions; they join at the tail next iteration
            for b in range(B):
                if row_owner[b] is not None or any(
                        jb == b for jb, _ in deferred_joins):
                    continue
                req = self._peek_admissible(pos_lb, pos_lb + inflight_steps,
                                            limit)
                if req is None:
                    break
                # start the joiner's host->device uploads NOW (async): by the
                # time the join runs at the tail next iteration the transfers
                # have ridden the wire behind the running chunks instead of
                # blocking the worker inside the join.  Pad to the bucket on
                # host so join_row never compiles a per-length pad concat.
                Lp = req.embeds.shape[1]
                req.join_pad = bucket_for(Lp) - Lp
                padded = np.concatenate(
                    [np.zeros((1, req.join_pad, H), np.float32), req.embeds],
                    axis=1) if req.join_pad else req.embeds
                req.embeds_dev = jnp.asarray(padded, eng.dtype)
                L = req.trailing.shape[1]
                if L <= tth_dev.shape[1]:
                    row_full = np.tile(req.tpe[0], (tth_dev.shape[1], 1))
                    row_full[:L] = req.trailing[0]
                    req.tth_row_dev = jnp.asarray(row_full, eng.dtype)
                deferred_joins.append((b, req))
                admitted.append(req)

            if _TRACE:
                t_tail = time.time()
                if t_tail - t_chunk > 0.005:
                    logger.info("emit+admit tail=%.1fms retires=%d admits=%d",
                                (t_tail - t_chunk) * 1e3, len(retires),
                                len(deferred_joins))
            self._stats["active_rows"] = sum(r is not None for r in rows)
            if not any(r is not None for r in row_owner) \
                    and not any(r is not None for r in rows) \
                    and not deferred_joins and not admitted:
                # batch over.  Chunks still in flight carry no deliverable
                # frames: device-done rows generate zero-length chunks, and
                # forced rows' overshoot is over-budget (trimmed at emission
                # anyway) — skip their fetches entirely.  With predictive
                # retirement the tail view empties EARLY, so ``rows`` (frames
                # of a retiring row still in flight) and ``admitted`` (a
                # joiner whose first chunk is still in flight) must be empty
                # too — breaking past either drops deliverable audio and
                # hangs its client.
                break

        # --- wind-down.  Any request still owned at the tail hit the
        # bounded window (same truncation contract as batch-1).  Normally
        # unreachable while admission requires 64 spare positions and
        # chunks are < 64 — kept as armor.
        for b in range(B):
            if row_owner[b] is not None:
                self._finish_request(row_owner[b])
                rows[b] = None
                row_owner[b] = None
        # admitted-but-never-joined requests seed the NEXT batch (dropping
        # them would hang their clients)
        for _, req in deferred_joins:
            admitted.remove(req)
        self._waiting[:0] = [req for _, req in deferred_joins]
        eng.release(cur_state)
        self._stats["active_rows"] = 0

    # ---- per-request helpers

    def _force_mask(self, b: int) -> jnp.ndarray:
        """Device-resident one-hot bool [B] mask for forcing row ``b`` done
        (uploaded once per row, cached for the batcher's lifetime)."""
        masks = getattr(self, "_force_masks", None)
        if masks is None:
            masks = self._force_masks = {}
        m = masks.get(b)
        if m is None:
            host = np.zeros((self.B,), bool)
            host[b] = True
            m = masks[b] = jnp.asarray(host)
        return m

    def _start_request(self, req: _Request):
        req.started_at = time.time()

    def _ramp_after_join(self, joined: List[_Request]) -> bool:
        """Re-run the TTFA ramp only when some joiner is latency-dominated
        (queue wait under RAMP_FRESH_S).  Saturated joiners spent seconds in
        the queue — a ~50 ms ramp saving is noise to them, but the small
        chunks tax every live row's throughput (see RAMP_FRESH_S)."""
        if not self.first_chunks:
            return False
        return any(r.started_at - r.submitted_at < RAMP_FRESH_S
                   for r in joined)

    def _primed_state(self, req: _Request):
        """Single-row codec stream state primed with the request's ICL
        reference codes, LRU-cached per voice: repeat voices admit with a
        device-side scatter only (no re-feed of the reference).  The cached
        state is never donated — scatter_stream_row leaves it intact."""
        voc = self.model.vocoder
        if req.ref_codes is None:
            key = None
        else:
            c = np.ascontiguousarray(req.ref_codes, np.int32)
            key = (c.shape, hashlib.sha1(c.tobytes()).hexdigest())
        st = self._voice_states.get(key)
        if st is None:
            st = voc.stream_state()
            if req.ref_codes is not None:
                _, st = voc.stream_feed(st, req.ref_codes,
                                        collect_audio=False)
            self._voice_states[key] = st
            while len(self._voice_states) > self._voice_cache_cap:
                self._voice_states.popitem(last=False)
        else:
            self._voice_states.move_to_end(key)
        return st

    def _deliver(self, req: _Request, audio: np.ndarray, n_frames: int):
        timing = {
            "chunk_index": req.chunk_index,
            "chunk_steps": n_frames,
            "total_steps_so_far": req.steps,
            "is_final": False,
            "queue_ms": (req.started_at - req.submitted_at) * 1000.0,
        }
        if req.chunk_index == 0:
            timing["ttfa_ms"] = (time.time() - req.submitted_at) * 1000.0
        req.chunk_index += 1
        try:
            req.out_q.put((audio, timing), timeout=EMIT_TIMEOUT_S)
        except queue.Full:
            # A persistently full queue means the consumer stopped pulling.
            # Dropping mid-stream chunks would hand the client gapped PCM
            # with no error, so fail the stream instead: cancel the request
            # (the row is retired at the next chunk boundary) and deliver
            # the error in place of audio.
            self._fail(req, RuntimeError(
                "stream consumer stalled (audio queue full for 5s); "
                "request cancelled"))

    def _fail(self, req: _Request, exc: Exception):
        """Cancel ``req`` and deliver ``exc`` promptly, dropping any audio
        still queued so a stalled consumer sees the failure, not stale
        chunks.  Never blocks."""
        req.cancelled = True
        while True:
            try:
                req.out_q.get_nowait()
            except queue.Empty:
                break
        try:
            req.out_q.put_nowait(exc)
        except queue.Full:  # pragma: no cover — racing consumer refilled it
            pass

    def _finish_request(self, req: _Request):
        self._stats["served"] += 1
        try:
            req.out_q.put(_SENTINEL, timeout=EMIT_TIMEOUT_S)
        except queue.Full:
            # consumer stopped pulling right at retirement: fail the stream
            # explicitly (an error the client sees beats silently-dropped
            # audio) and make sure the terminator still lands — the worker
            # must never block on a dead consumer
            self._fail(req, RuntimeError(
                "stream consumer stalled at end of stream"))
            try:
                req.out_q.put_nowait(_SENTINEL)
            except queue.Full:  # pragma: no cover
                pass

    def _peek_admissible(self, pos_lb: int, pos_ub: int,
                         limit: int) -> Optional[_Request]:
        """Pop the next waiting request admissible into the running batch,
        scanning the first ADMIT_SCAN waiting requests out of order — FIFO
        preferred, but a request whose prompt bucket exceeds the current
        position must not block admissible requests behind it (head-of-line
        blocking measured at 2× aggregate throughput under saturation).
        With chunks in flight the true device position at the pipeline tail
        is only bracketed host-side: ``pos_lb`` (through the last fetched
        chunk) lower-bounds it, ``pos_ub`` (plus planned in-flight steps)
        upper-bounds it.  Each check uses its conservative side: the prompt
        bucket must fit below ``pos_lb`` (join splices [pos-Tb, pos) — an
        underflow corrupts the row), and the window must have room past
        ``pos_ub`` for the row to speak."""
        self._drain_arrivals()
        if any(r.cancelled for r in self._waiting):
            # cancelled-while-waiting: terminate the stream now instead of
            # spending a join program on a dead request
            for r in self._waiting:
                if r.cancelled:
                    self._stats["cancelled"] += 1
                    # every submitted request must eventually count as
                    # served (ReplicaPool tracks inflight = submits-served)
                    self._stats["served"] += 1
                    r.out_q.put(_SENTINEL)
            self._waiting[:] = [r for r in self._waiting if not r.cancelled]
        for j, req in enumerate(self._waiting[:ADMIT_SCAN]):
            Tb = bucket_for(req.embeds.shape[1])
            if Tb > pos_lb:
                continue  # too early in the batch window for THIS request
            if pos_ub + min(req.max_new_tokens, 64) > limit:
                continue  # not enough window left for it to speak
            if not self._bucket_join_ready(Tb):
                continue  # its join executable compiles in the background
            return self._waiting.pop(j)
        return None

    # ---- warmup

    def _check_warmed(self, Tb: int) -> None:
        """Warn (once per bucket) when a serve-time prompt hits a prefill
        bucket that warmup() did not compile: the resulting mid-serve
        compile stalls EVERY live stream for seconds."""
        warmed = getattr(self, "_warmed_buckets", None)
        if not warmed or Tb in warmed:
            return
        warned = getattr(self, "_warned_buckets", None)
        if warned is None:
            warned = self._warned_buckets = set()
        if Tb not in warned:
            warned.add(Tb)
            logger.warning(
                "prefill bucket %d was not warmed (warmup had %s): the "
                "first batch/join at this size compiles at serve time and "
                "stalls all live streams — add it to "
                "warmup(prefill_buckets=...)", Tb, sorted(warmed))

    def _bucket_join_ready(self, Tb: int) -> bool:
        """True when the join executable for bucket ``Tb`` exists.  Otherwise
        kick a background AOT compile (Engine.warm_join) and return False —
        the caller re-checks at the next chunk boundary, and the running
        batch never stalls on the compile."""
        if Tb in self._join_ready:
            return True
        if Tb in self._compiling_buckets:
            return False
        self._compiling_buckets.add(Tb)

        def work():
            try:
                self.engine.warm_join(Tb, policy=self.policy,
                                      pred_policy=self.pred_policy,
                                      knobs=self.knobs)
            except Exception:  # pragma: no cover — fall back to inline
                logger.exception("background warm_join(bucket=%d) failed; "
                                 "the next join at this bucket compiles "
                                 "inline", Tb)
            finally:
                self._join_ready.add(Tb)
                self._compiling_buckets.discard(Tb)

        threading.Thread(target=work, daemon=True,
                         name=f"warm-join-{Tb}").start()
        return False

    def warmup(self, prefill_buckets=(128,), max_tth: Optional[int] = None):
        """Compile the batched prefill/chunk/join executables ahead of
        serving (persistent-cached, like Engine.warmup_all)."""
        with device_scope(self.engine.device):
            t0 = time.time()
            self._warmed_buckets = set(getattr(self, "_warmed_buckets", ())) \
                | set(prefill_buckets)
            self._join_ready |= set(prefill_buckets)
            eng = self.engine
            H = self.model.cfg.talker.hidden_size
            eng.warmup_all(self.policy, self.pred_policy,
                           chunk_sizes=(), max_tth=max_tth)
            # Compile each bucket's batched prefill AND join executable with a
            # LEGAL state: join_row requires the shared position to be >= the
            # joining prompt's bucket (engine.py:666-668).  The old shortcut
            # prefilled once at the smallest bucket and joined every larger
            # bucket into it — an underflowing row whose garbage per-row bounds
            # sent the flash-decode kernel out of bounds.  Sync after every
            # program so compiles never pile up an unbounded queue.
            state = None
            for Tb in sorted(set(prefill_buckets)):
                if state is not None:
                    eng.release(state)
                state = eng.prefill(
                    jnp.zeros((self.B, Tb, H), eng.dtype),
                    jax.random.PRNGKey(0), self.policy, knobs=self.knobs)
                jax.block_until_ready(jax.tree.leaves(state)[0])
                state = eng.join_row(
                    state, 0, jnp.zeros((1, Tb, H), eng.dtype),
                    policy=self.policy, pred_policy=self.pred_policy,
                    knobs=self.knobs, pos_hint=Tb)
                jax.block_until_ready(jax.tree.leaves(state)[0])
            if state is None:  # no prefill buckets requested: minimal state
                state = eng.prefill(
                    jnp.zeros((self.B, PREFILL_BUCKETS[0], H), eng.dtype),
                    jax.random.PRNGKey(0), self.policy, knobs=self.knobs)
            # force-done program: predictive budget retirement ORs a device-
            # resident row mask into state["done"] mid-serve; without this its
            # first use compiles inline in the join section (measured 0.8-1.1 s
            # stall, every live stream waiting).  Also pre-uploads all B masks.
            jax.block_until_ready(
                [state["done"] | self._force_mask(b) for b in range(self.B)])
            # fused batched decode+vocode program (every tth bucket, so a
            # mid-serving re-bucket never hits a compile stall) + row scatter
            voc = self.model.vocoder
            vst = voc.scatter_stream_row(voc.stream_state_batched(self.B),
                                         voc.stream_state(), 0)
            tpe0 = jnp.zeros((self.B, 1, H), eng.dtype)
            out = None
            # always warm at least the smallest bucket: serve-time tth below it
            # still rounds up to TTH_BUCKETS[0], and an empty list would leave
            # `out` None below
            warm = [b for b in TTH_BUCKETS
                    if b <= (max_tth or TTH_BUCKETS[-1])] or [TTH_BUCKETS[0]]
            # serve batches allocate tth at this width from the start, so a
            # joiner inside the warmed range is a row scatter, never a full
            # (B, W, H) re-upload mid-serve
            self._tth_floor = warm[-1]
            # join-path row scatters at the serving tth width (traced row index —
            # one executable each; without this the first mid-batch join pays
            # the compile/cache-load stall while every live stream waits)
            tth_w = jnp.zeros((self.B, self._tth_floor, H), eng.dtype)
            jax.block_until_ready(
                tth_w.at[jnp.int32(0)].set(jnp.zeros((self._tth_floor, H),
                                                     eng.dtype)))
            jax.block_until_ready(
                tpe0.at[jnp.int32(0)].set(jnp.zeros((1, H), eng.dtype)))
            sizes = list(dict.fromkeys(list(self.first_chunks)
                                       + [self.chunk_size]))
            for tb in warm:
                for size in sizes:  # ramp sizes compile their own executables
                    out = eng.chunk_vocode_batched(
                        voc, state, jnp.zeros((self.B, tb, H), eng.dtype),
                        jnp.zeros((self.B,), jnp.int32), tpe0,
                        self.policy, self.pred_policy, size, vst,
                        knobs=self.knobs, pcm16=self._pcm16)
                    state, vst = out[0], out[6]
                    jax.block_until_ready(out[5])
            eng.release(state)
            logger.info("batcher warmup: %.1fs", time.time() - t0)
