"""Continuous-batching scheduler tests (runtime/scheduler.py): requests are
served through one batched engine, join mid-batch, and stream independently."""
import threading
import time

import numpy as np
import pytest

from qwen3tts_tpu.runtime.engine import GenerationPolicy
from qwen3tts_tpu.runtime.scheduler import ContinuousBatcher

# deterministic: greedy, EOS suppressed past the step budget so every row
# runs to its own max_new_tokens
NO_EOS = GenerationPolicy(do_sample=False, min_new_tokens=10_000)


@pytest.fixture()
def batcher(tiny_tts):
    b = ContinuousBatcher(tiny_tts, max_batch=2, chunk_size=8,
                          max_new_tokens=40, policy=NO_EOS)
    # join executables ready up-front: tests below assert mid-batch joins,
    # which admission defers until the bucket's join program exists
    b.warmup(prefill_buckets=(32, 64), max_tth=16)
    yield b
    b.close()


def _collect(handle):
    chunks = [a for a, _, _ in handle.chunks()]
    return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)


def test_two_requests_batch_and_third_joins(batcher, tiny_tts, ref_wav):
    spf = tiny_tts.vocoder.spf
    h1 = batcher.submit("First utterance.", "English", ref_wav, "ref")
    h2 = batcher.submit("A different second text.", "English", ref_wav, "ref")
    results = {}
    first_chunk = threading.Event()

    def drain(name, h):
        chunks = []
        for a, _, _ in h.chunks():
            chunks.append(a)
            first_chunk.set()
        results[name] = (np.concatenate(chunks) if chunks
                         else np.zeros(0, np.float32))

    t1 = threading.Thread(target=drain, args=("a", h1))
    t2 = threading.Thread(target=drain, args=("b", h2))
    t1.start(); t2.start()
    # submit the third as soon as the batch has PROVABLY started streaming
    # (a fixed sleep can overshoot a fully-warmed 40-step batch) — it must
    # join the RUNNING batch (both rows busy until their budget, so the
    # join path is the only way it gets served before the batch ends)
    assert first_chunk.wait(timeout=300), "batch never produced a chunk"
    h3 = batcher.submit("Late third arrival.", "English", ref_wav, "ref")
    results["c"] = _collect(h3)
    t1.join(timeout=600); t2.join(timeout=600)

    for name in ("a", "b", "c"):
        wav = results[name]
        assert len(wav) == 40 * spf, f"row {name}: {len(wav)} samples"
        assert np.isfinite(wav).all()
    assert batcher.stats["served"] == 3
    assert batcher.stats["joined_mid_batch"] >= 1, (
        "third request was not admitted into the running batch")


def test_more_requests_than_rows_all_served(batcher, tiny_tts, ref_wav):
    spf = tiny_tts.vocoder.spf
    handles = [
        batcher.submit(f"Utterance number {i}.", "English", ref_wav, "ref",
                       max_new_tokens=16)
        for i in range(5)
    ]
    outs = []
    threads = []
    lock = threading.Lock()

    def drain(h):
        w = _collect(h)
        with lock:
            outs.append(w)

    for h in handles:
        t = threading.Thread(target=drain, args=(h,))
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=600)
    assert len(outs) == 5
    for wav in outs:
        assert len(wav) == 16 * spf
    assert batcher.stats["served"] == 5


def test_cancel_stops_stream_early(batcher, ref_wav):
    h = batcher.submit("A long cancelled utterance.", "English", ref_wav, "ref")
    got = []
    for audio, _, _ in h.chunks():
        got.append(audio)
        h.cancel()
    total = sum(len(a) for a in got)
    assert 0 < total < 40 * batcher.model.vocoder.spf


def test_cancel_releases_row_for_pending_request(tiny_tts, ref_wav):
    """Cancelling a running request frees its row (and marks it done on
    DEVICE — cancelled rows must not keep burning decode steps),
    so a queued request gets served without waiting out the budget."""
    spf = tiny_tts.vocoder.spf
    b = ContinuousBatcher(tiny_tts, max_batch=1, chunk_size=8,
                          max_new_tokens=400, policy=NO_EOS)
    try:
        ha = b.submit("A very long utterance to be cancelled.", "English",
                      ref_wav, "ref")
        it = ha.chunks()
        next(it)  # A is definitely occupying the only row
        hb = b.submit("Short follower.", "English", ref_wav, "ref",
                      max_new_tokens=16)
        ha.cancel()
        wav_b = _collect(hb)  # must complete — the row was released
        assert len(wav_b) == 16 * spf
        for _ in it:  # drain A to its sentinel
            pass
        assert b.stats["cancelled"] == 1
        assert b.stats["served"] == 2
    finally:
        b.close()


def test_pending_requests_admitted_fifo(tiny_tts, ref_wav):
    """When every row is busy, queued requests are admitted in submission
    order (the scheduler peeks/pops the pending queue FIFO)."""
    b = ContinuousBatcher(tiny_tts, max_batch=1, chunk_size=4,
                          max_new_tokens=12, policy=NO_EOS)
    try:
        ha = b.submit("Occupies the row.", "English", ref_wav, "ref")
        hc = b.submit("Queued first.", "English", ref_wav, "ref")
        hd = b.submit("Queued second.", "English", ref_wav, "ref")
        results = {}
        threads = [
            threading.Thread(target=lambda n, h: results.__setitem__(n, _collect(h)),
                             args=(n, h))
            for n, h in (("a", ha), ("c", hc), ("d", hd))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert sorted(results) == ["a", "c", "d"]
        assert 0 < hc._req.started_at < hd._req.started_at
    finally:
        b.close()


def test_join_during_final_chunk(tiny_tts, ref_wav):
    """A request submitted while the current batch is inside its FINAL chunk
    is still served (either by joining that batch or by a fresh one) with the
    exact requested length."""
    spf = tiny_tts.vocoder.spf
    b = ContinuousBatcher(tiny_tts, max_batch=2, chunk_size=8,
                          max_new_tokens=16, policy=NO_EOS)
    try:
        ha = b.submit("Two chunk utterance.", "English", ref_wav, "ref")
        it = ha.chunks()
        next(it)  # chunk 1 of 2 received → the batch is in its final chunk
        hb = b.submit("Late joiner.", "English", ref_wav, "ref")
        wav_b = _collect(hb)
        rest = sum(len(a) for a, _, _ in it)
        assert rest + 8 * spf == 16 * spf
        assert len(wav_b) == 16 * spf
        assert b.stats["served"] == 2
    finally:
        b.close()


@pytest.mark.slow
def test_eight_concurrent_mixed_lengths(tiny_tts, ref_wav):
    """8 concurrent requests with mixed text/budget lengths through a 4-row
    batch: every stream completes with exactly its own budget of audio."""
    spf = tiny_tts.vocoder.spf
    b = ContinuousBatcher(tiny_tts, max_batch=4, chunk_size=4,
                          max_new_tokens=64, policy=NO_EOS)
    try:
        lengths = [8, 12, 16, 8, 20, 12, 8, 16]
        handles = [
            b.submit(f"Mixed load utterance number {i} with extra words " +
                     "padding " * (i % 3), "English", ref_wav, "ref",
                     max_new_tokens=n)
            for i, n in enumerate(lengths)
        ]
        outs = {}
        threads = [
            threading.Thread(target=lambda i, h: outs.__setitem__(i, _collect(h)),
                             args=(i, h))
            for i, h in enumerate(handles)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert sorted(outs) == list(range(8))
        for i, n in enumerate(lengths):
            assert len(outs[i]) == n * spf, (i, n, len(outs[i]))
            assert np.isfinite(outs[i]).all()
        assert b.stats["served"] == 8
        # the worker zeroes active_rows a moment after the final sentinel
        deadline = time.time() + 30
        while time.time() < deadline and b.stats["active_rows"] != 0:
            time.sleep(0.05)
        assert b.stats["active_rows"] == 0
    finally:
        b.close()


@pytest.mark.slow
@pytest.mark.parametrize("depth", [1, 4])
def test_pipeline_depth_invariants(tiny_tts, ref_wav, monkeypatch, depth):
    """The deep-pipelined serving loop (joins/forces applied at the pipeline
    TAIL, row visibility deferred to the first chunk dispatched after the
    join) must preserve the serving contract at any depth: every request —
    batch-seeding or mid-batch joiner — gets exactly its budget of finite
    audio and a clean retirement."""
    monkeypatch.setenv("QWEN3TTS_BATCH_PIPELINE", str(depth))
    spf = tiny_tts.vocoder.spf
    b = ContinuousBatcher(tiny_tts, max_batch=2, chunk_size=4,
                          max_new_tokens=64, policy=NO_EOS)
    b.warmup(prefill_buckets=(32, 64), max_tth=16)  # joins assert below
    try:
        lengths = [8, 20, 8, 12, 16]
        handles = [
            b.submit(f"Depth {depth} utterance {i}.", "English", ref_wav,
                     "ref", max_new_tokens=n)
            for i, n in enumerate(lengths)
        ]
        outs = {}
        threads = [
            threading.Thread(target=lambda i, h: outs.__setitem__(i, _collect(h)),
                             args=(i, h))
            for i, h in enumerate(handles)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert sorted(outs) == list(range(5))
        for i, n in enumerate(lengths):
            assert len(outs[i]) == n * spf, (depth, i, n, len(outs[i]))
            assert np.isfinite(outs[i]).all()
        assert b.stats["served"] == 5
        assert b.stats["joined_mid_batch"] >= 1
    finally:
        b.close()


def test_queue_full_fails_stream_not_drops(tiny_tts, ref_wav, monkeypatch):
    """A consumer that stops pulling must get a FAILED stream
    (error + prompt retirement), never silently gapped audio."""
    import qwen3tts_tpu.runtime.scheduler as sched

    monkeypatch.setattr(sched, "OUT_QUEUE_SIZE", 2)
    monkeypatch.setattr(sched, "EMIT_TIMEOUT_S", 0.2)
    b = ContinuousBatcher(tiny_tts, max_batch=1, chunk_size=4,
                          max_new_tokens=200, policy=NO_EOS)
    try:
        h = b.submit("A stream nobody reads.", "English", ref_wav, "ref")
        deadline = time.time() + 120
        while time.time() < deadline and b.stats["cancelled"] < 1:
            time.sleep(0.1)
        assert b.stats["cancelled"] == 1, "stalled stream was never failed"
        with pytest.raises(RuntimeError, match="stalled"):
            for _ in h.chunks():
                pass
        # the scheduler keeps serving after the failure
        h2 = b.submit("Healthy follower.", "English", ref_wav, "ref",
                      max_new_tokens=8)
        assert len(_collect(h2)) == 8 * b.model.vocoder.spf
    finally:
        b.close()


def test_warmup_below_smallest_tth_bucket(batcher):
    """warmup(max_tth=8) with TTH_BUCKETS starting at 16 must warm the
    smallest bucket instead of crashing on an empty bucket list."""
    batcher.warmup(max_tth=8)


def test_timing_contract(batcher, ref_wav):
    h = batcher.submit("Check the timing dict.", "English", ref_wav, "ref",
                       max_new_tokens=16)
    timings = [t for _, _, t in h.chunks()]
    assert timings, "no chunks emitted"
    assert "ttfa_ms" in timings[0] and timings[0]["ttfa_ms"] > 0
    assert timings[0]["chunk_index"] == 0
    assert timings[-1]["total_steps_so_far"] == 16
    for t in timings:
        assert t["chunk_steps"] > 0 and "queue_ms" in t


def test_worker_failure_fails_live_streams_not_hangs(tiny_tts, ref_wav,
                                                     monkeypatch):
    """An unexpected device/runtime error mid-batch must surface as an
    error on every live stream (and the worker must survive to serve the
    next batch) — a silently hung stream is the worst failure mode."""
    from qwen3tts_tpu.runtime.engine import Engine

    calls = {"n": 0}
    real = Engine.chunk_vocode_batched

    def flaky(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 3:  # let the batch get rolling, then blow up
            raise RuntimeError("injected device fault")
        return real(self, *a, **k)

    monkeypatch.setattr(Engine, "chunk_vocode_batched", flaky)
    b = ContinuousBatcher(tiny_tts, max_batch=2, chunk_size=4,
                          max_new_tokens=400, policy=NO_EOS)
    try:
        h = b.submit("Doomed stream.", "English", ref_wav, "ref")
        with pytest.raises(RuntimeError, match="batch serving failed"):
            for _ in h.chunks():
                pass
        # worker survived: the next batch is served normally
        h2 = b.submit("Recovery stream.", "English", ref_wav, "ref",
                      max_new_tokens=8)
        assert len(_collect(h2)) == 8 * b.model.vocoder.spf
    finally:
        b.close()


@pytest.mark.slow
def test_randomized_stress_mixed_cancels_and_budgets(tiny_tts, ref_wav,
                                                     monkeypatch):
    """Seeded concurrency fuzz over the full serving surface: staggered
    submits, mixed budgets, cancels at random points (including before the
    first chunk), under a non-default pipeline depth.  Contract: every
    uncancelled request gets exactly its budget of finite audio, every
    cancelled request's stream still terminates, and the batcher retires
    everything (no stuck rows, no lost requests)."""
    rng = np.random.default_rng(1337)
    monkeypatch.setenv("QWEN3TTS_BATCH_PIPELINE", "5")
    spf = tiny_tts.vocoder.spf
    b = ContinuousBatcher(tiny_tts, max_batch=2, chunk_size=4,
                          max_new_tokens=64, policy=NO_EOS,
                          first_chunks=(1, 2))
    b.warmup(prefill_buckets=(32, 64), max_tth=16)
    N = 12
    plans = []  # (n_tokens, cancel_after_chunks or None, submit_delay_s)
    for i in range(N):
        n = int(rng.integers(4, 41))
        cancel_after = int(rng.integers(0, 3)) if rng.random() < 0.3 else None
        plans.append((n, cancel_after, float(rng.random()) * 0.3))
    outs, errs = {}, {}

    def run(i, n, cancel_after, delay):
        time.sleep(delay)
        try:
            h = b.submit(f"Stress utterance {i}.", "English", ref_wav, "ref",
                         max_new_tokens=n)
            if cancel_after == 0:
                h.cancel()  # possibly before admission
            chunks = []
            for k, (a, _, _) in enumerate(h.chunks()):
                chunks.append(a)
                if cancel_after is not None and k + 1 >= cancel_after:
                    h.cancel()
            outs[i] = (np.concatenate(chunks) if chunks
                       else np.zeros(0, np.float32))
        except Exception as e:  # pragma: no cover - fail loudly below
            errs[i] = e

    try:
        threads = [threading.Thread(target=run, args=(i, *p))
                   for i, p in enumerate(plans)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not errs, errs
        assert sorted(outs) == list(range(N)), "a stream never terminated"
        for i, (n, cancel_after, _) in enumerate(plans):
            assert np.isfinite(outs[i]).all(), i
            if cancel_after is None:
                assert len(outs[i]) == n * spf, (i, n, len(outs[i]))
            else:
                assert len(outs[i]) <= n * spf, (i, n, len(outs[i]))
        assert b.stats["served"] == N
        assert b.stats["active_rows"] == 0
        assert b.stats["queue_depth"] == 0
        # the batcher is still healthy after the storm
        h = b.submit("Post-storm sanity.", "English", ref_wav, "ref",
                     max_new_tokens=8)
        assert len(_collect(h)) == 8 * spf
    finally:
        b.close()


def test_first_chunks_ramp_cuts_first_audio_size(tiny_tts, ref_wav,
                                                 monkeypatch):
    """``first_chunks`` TTFA ramp: after batch start AND after a mid-batch
    join the dispatch sizes re-run the ramp, so the newest row's first
    audio chunk is ramp[0] frames (not chunk_size) — while every stream
    still delivers exactly its budget."""
    from qwen3tts_tpu.runtime import scheduler as S

    # pin the joiner as "fresh" regardless of test-machine speed: this test
    # asserts the light-load ramp contract, not the saturation skip
    monkeypatch.setattr(S, "RAMP_FRESH_S", 60.0)
    spf = tiny_tts.vocoder.spf
    b = ContinuousBatcher(tiny_tts, max_batch=2, chunk_size=4,
                          max_new_tokens=24, policy=NO_EOS,
                          first_chunks=(1, 2))
    b.warmup(prefill_buckets=(32, 64), max_tth=16)  # join asserted below
    try:
        h1 = b.submit("Ramp seed one.", "English", ref_wav, "ref")
        h2 = b.submit("Ramp seed two.", "English", ref_wav, "ref")
        sizes = {}
        totals = {}
        first_chunk = threading.Event()

        def drain(name, h):
            chunks = []
            for a, _, _ in h.chunks():
                chunks.append(a)
                first_chunk.set()  # proves the batch is RUNNING
            sizes[name] = [len(a) for a in chunks]
            totals[name] = sum(len(a) for a in chunks)

        t1 = threading.Thread(target=drain, args=("a", h1))
        t2 = threading.Thread(target=drain, args=("b", h2))
        t1.start(); t2.start()
        assert first_chunk.wait(timeout=300)
        h3 = b.submit("Ramp joiner.", "English", ref_wav, "ref")
        drain("c", h3)
        t1.join(timeout=600); t2.join(timeout=600)

        for name in ("a", "b", "c"):
            assert totals[name] == 24 * spf, (name, totals[name])
            # first audio after the 1-frame ramp chunk, then the 2-frame one
            assert sizes[name][0] == 1 * spf, (name, sizes[name])
            assert sizes[name][1] == 2 * spf, (name, sizes[name])
        assert b.stats["joined_mid_batch"] >= 1
    finally:
        b.close()


def test_unwarmed_bucket_warns(tiny_tts, ref_wav, caplog):
    """Serving a prompt bucket that warmup() did not compile must log a
    warning naming the bucket (a mid-serve compile stalls every live
    stream), and warmed buckets must stay silent."""
    import logging

    b = ContinuousBatcher(tiny_tts, max_batch=2, chunk_size=4,
                          max_new_tokens=8, policy=NO_EOS)
    try:
        b.warmup(prefill_buckets=(32,), max_tth=16)
        with caplog.at_level(logging.WARNING,
                             logger="qwen3tts_tpu.runtime.scheduler"):
            b._check_warmed(32)
            assert not caplog.records
            b._check_warmed(256)
            assert any("256" in r.message and "not warmed" in r.message
                       for r in caplog.records)
            n = len(caplog.records)
            b._check_warmed(256)  # once per bucket
            assert len(caplog.records) == n
        # end-to-end: serving still works after the warning machinery
        h = b.submit("Post-warn sanity.", "English", ref_wav, "ref",
                     max_new_tokens=8)
        assert len(_collect(h)) == 8 * tiny_tts.vocoder.spf
    finally:
        b.close()


@pytest.mark.slow
def test_unwarmed_join_bucket_compiles_off_thread(tiny_tts, ref_wav,
                                                  monkeypatch):
    """A mid-batch admission whose prompt bucket has no join executable yet
    must NOT stall the running batch: the compile runs on a background
    thread (Engine.warm_join) and the request joins once it's ready.  With
    the compile artificially slowed, the already-running stream must keep
    delivering chunks throughout."""
    from qwen3tts_tpu.runtime.engine import Engine

    calls = []
    real = Engine.warm_join

    def slow_warm(self, prompt_len, **kw):
        calls.append(prompt_len)
        time.sleep(1.0)  # a "slow compile service"
        return real(self, prompt_len, **kw)

    monkeypatch.setattr(Engine, "warm_join", slow_warm)
    b = ContinuousBatcher(tiny_tts, max_batch=2, chunk_size=4,
                          max_new_tokens=200, policy=NO_EOS)
    # the ready-set lives on the (session-cached) engine: clear it so every
    # bucket starts join-unready for this test
    b._join_ready.clear()
    try:
        spf = tiny_tts.vocoder.spf
        # seed buckets at 64 (42-token prompt); the joiner's 79-token
        # prompt buckets at 128, admissible once the seed has decoded 64
        # steps — at which point the batch is mid-flight and the join
        # executable does not exist yet
        ha = b.submit("Seed stream that keeps running.", "English", ref_wav,
                      "ref", max_new_tokens=190)
        it = ha.chunks()
        next(it)  # batch is running
        hb = b.submit("Joiner with a longer prompt " + "word " * 8,
                      "English", ref_wav, "ref", max_new_tokens=8)
        # drain A's first chunks; B's bucket becomes admissible mid-run and
        # kicks the (slowed) background compile.  A must keep streaming the
        # whole time — the serving loop never blocks on the compile.
        stall = 0.0
        last = time.time()
        chunks_a = 1
        for _ in it:
            now = time.time()
            stall = max(stall, now - last)
            last = now
            chunks_a += 1
        wav_b = _collect(hb)
        assert len(wav_b) == 8 * spf
        assert calls, "background warm_join was never invoked"
        assert chunks_a * 4 >= 190 // 4 * 4, "seed stream was truncated"
        # inter-chunk gap must stay well under the 1 s compile sleep (CPU
        # chunk walls here are ~50-200 ms; an inline compile would add 1 s+)
        assert stall < 0.9, f"stream stalled {stall:.2f}s during compile"
        assert b.stats["served"] == 2
    finally:
        b.close()


# ---------------------------------------------------------------------------
# admission policy units (no worker involvement: the worker is stopped and
# the internals are driven directly — deterministic, no engine programs run)
# ---------------------------------------------------------------------------

def _stopped_batcher(tiny_tts):
    """A batcher whose worker has exited cleanly (internals can then be
    driven synchronously from the test thread)."""
    from qwen3tts_tpu.runtime import scheduler as S

    b = ContinuousBatcher(tiny_tts, max_batch=4, chunk_size=8,
                          max_new_tokens=40, policy=NO_EOS)
    b._pending.put(S._SENTINEL)
    b._worker.join(timeout=10)
    assert not b._worker.is_alive()
    b._stop.clear()  # re-arm the internals for direct driving
    return b


def _req(tiny_tts, prompt_len, max_new_tokens=40):
    from qwen3tts_tpu.runtime.scheduler import _Request

    H = tiny_tts.cfg.talker.hidden_size
    return _Request(
        embeds=np.zeros((1, prompt_len, H), np.float32),
        trailing=np.zeros((1, 4, H), np.float32),
        tpe=np.zeros((1, 1, H), np.float32),
        ref_codes=None, max_new_tokens=max_new_tokens)


def test_admission_skips_blocked_head(tiny_tts):
    """A long-prompt head whose bucket exceeds the batch position must not
    block admissible requests queued behind it (head-of-line blocking
    measured at 2x saturated throughput)."""
    b = _stopped_batcher(tiny_tts)
    b._join_ready.update({32, 128})  # pretend both join programs exist
    long_req = _req(tiny_tts, 100)   # bucket 128
    short_req = _req(tiny_tts, 20)   # bucket 32
    b._waiting[:] = [long_req, short_req]
    got = b._peek_admissible(pos_lb=40, pos_ub=40, limit=2047)
    assert got is short_req, "short request was blocked behind the long head"
    assert b._waiting == [long_req]
    # once the position clears the head's bucket, FIFO order resumes
    b._waiting[:] = [long_req, short_req]
    got = b._peek_admissible(pos_lb=128, pos_ub=128, limit=2047)
    assert got is long_req


def test_admission_respects_window_budget_per_request(tiny_tts):
    """A head that cannot fit its generation budget into the remaining
    window is skipped in favor of one that can."""
    b = _stopped_batcher(tiny_tts)
    b._join_ready.update({32})
    big_budget = _req(tiny_tts, 20, max_new_tokens=2048)
    tiny_budget = _req(tiny_tts, 20, max_new_tokens=8)
    b._waiting[:] = [big_budget, tiny_budget]
    got = b._peek_admissible(pos_lb=2000, pos_ub=2000, limit=2047)
    assert got is tiny_budget, "fit-able request was blocked behind the big one"


def test_start_burst_collects_concurrent_arrivals(tiny_tts):
    """When >=2 requests are already waiting, the batch-start window keeps
    collecting arrivals (refreshing per arrival) so the batch starts full;
    a lone request starts with no added wait."""
    from qwen3tts_tpu.runtime import scheduler as S

    b = _stopped_batcher(tiny_tts)
    # lone request: returns immediately
    b._waiting[:] = [_req(tiny_tts, 20)]
    t0 = time.time()
    b._collect_start_burst()
    assert time.time() - t0 < S.START_WINDOW_S, "lone request waited"
    assert len(b._waiting) == 1

    # burst: two waiting, a third arrives inside the refresh window
    b._waiting[:] = [_req(tiny_tts, 20), _req(tiny_tts, 20)]
    late = _req(tiny_tts, 20)

    def put_late():
        time.sleep(S.START_WINDOW_S / 2)
        b._pending.put(late)

    threading.Thread(target=put_late).start()
    b._collect_start_burst()
    assert any(r is late for r in b._waiting), (
        "in-window arrival missed the batch start")
    assert len(b._waiting) == 3


def test_arriving_hint_holds_batch_start_for_preparing_flood(tiny_tts):
    """A lone waiting request normally starts immediately — but while
    arrivals advertised via ``arriving()`` are still preparing (the OpenAI
    server wraps prep+submit in it), the collector keeps waiting, bounded
    by the cap, so a cold flood's batch starts full instead of paying one
    position-gated join per straggler."""
    from qwen3tts_tpu.runtime import scheduler as S

    b = _stopped_batcher(tiny_tts)
    b._waiting[:] = [_req(tiny_tts, 20)]
    late = _req(tiny_tts, 20)
    cm = b.arriving()
    cm.__enter__()

    def put_late():
        # land well past the lone-request give-up point: only the
        # advertised-arrival path can still be collecting by then
        time.sleep(S.START_WINDOW_S * 3)
        b._pending.put(late)
        cm.__exit__(None, None, None)

    threading.Thread(target=put_late).start()
    b._collect_start_burst()
    assert any(r is late for r in b._waiting), (
        "advertised arrival missed the batch start")
    assert len(b._waiting) == 2


@pytest.mark.slow
def test_predictive_budget_retirement_frees_slot_early(tiny_tts, ref_wav):
    """A row whose budget is exhausted by an in-flight chunk is retired at
    DISPATCH time (the fetch can only confirm it), so its replacement joins
    ~pipeline-depth chunks earlier.  Every stream must still deliver exactly
    its budget — the retiring row's final frames ride chunks that are still
    in flight when the slot is handed over."""
    spf = tiny_tts.vocoder.spf
    b = ContinuousBatcher(tiny_tts, max_batch=2, chunk_size=4,
                          max_new_tokens=64, policy=NO_EOS)
    b.warmup(prefill_buckets=(32,), max_tth=16)
    try:
        budgets = {"a": 8, "b": 16, "c": 12}
        handles = {
            "a": b.submit("Seed one.", "English", ref_wav, "ref",
                          max_new_tokens=budgets["a"]),
            "b": b.submit("Seed two.", "English", ref_wav, "ref",
                          max_new_tokens=budgets["b"]),
        }
        results = {}
        first_chunk = threading.Event()

        def drain(name, h):
            chunks = []
            for a, _, _ in h.chunks():
                chunks.append(a)
                first_chunk.set()
            results[name] = sum(len(x) for x in chunks)

        threads = [threading.Thread(target=drain, args=(n, h))
                   for n, h in handles.items()]
        for t in threads:
            t.start()
        assert first_chunk.wait(timeout=300)
        # joins into the slot request "a" predictively vacates at budget 8
        hc = b.submit("Late joiner.", "English", ref_wav, "ref",
                      max_new_tokens=budgets["c"])
        drain("c", hc)
        for t in threads:
            t.join(timeout=600)
        for name, budget in budgets.items():
            assert results[name] == budget * spf, (name, results[name])
        assert b.stats["retired_predictively"] >= 1, b.stats
        assert b.stats["served"] == 3
    finally:
        b.close()


def test_post_join_ramp_skips_saturated_joiners(tiny_tts):
    """The post-join TTFA ramp re-runs only for latency-dominated joiners
    (queue wait < RAMP_FRESH_S).  A joiner that queued for seconds gains
    ~50 ms from the ramp while every small chunk taxes all rows' throughput
    (measured: saturated 486.6 frames/s without the post-join ramp vs 310.4
    with it), so saturated joins keep full-size chunks."""
    b = _stopped_batcher(tiny_tts)
    b.first_chunks = (2, 4)
    now = time.time()

    fresh = _req(tiny_tts, 20)
    fresh.submitted_at = now - 0.01
    fresh.started_at = now

    stale = _req(tiny_tts, 20)
    stale.submitted_at = now - 10.0
    stale.started_at = now

    assert b._ramp_after_join([fresh])
    assert not b._ramp_after_join([stale])
    # one fresh joiner in the group is enough — its TTFA is on the line
    assert b._ramp_after_join([stale, fresh])
    b.first_chunks = ()
    assert not b._ramp_after_join([fresh])  # no ramp configured at all


@pytest.mark.slow
def test_long_head_does_not_delay_short_joiner_end_to_end(tiny_tts, ref_wav):
    """Integration: with the only free row gated, a short request submitted
    AFTER a long-prompt request still starts first (out-of-order admission),
    and both are eventually served in full."""
    spf = tiny_tts.vocoder.spf
    b = ContinuousBatcher(tiny_tts, max_batch=2, chunk_size=4,
                          max_new_tokens=200, policy=NO_EOS)
    try:
        first_chunk = threading.Event()
        results = {}

        def drain(name, h):
            chunks = []
            for a, _, _ in h.chunks():
                chunks.append(a)
                first_chunk.set()
            results[name] = sum(len(c) for c in chunks)

        # row A retires early (frees a row while pos is still small);
        # row B keeps the batch alive long enough for every admission
        ha = b.submit("A.", "English", ref_wav, "ref", max_new_tokens=24)
        hb = b.submit("B.", "English", ref_wav, "ref", max_new_tokens=160)
        ta = threading.Thread(target=drain, args=("a", ha))
        tb = threading.Thread(target=drain, args=("b", hb))
        ta.start(); tb.start()
        assert first_chunk.wait(timeout=300)
        long_text = " ".join(["lengthy, deliberately padded clause"] * 3)
        hl = b.submit(long_text, "English", ref_wav, "ref", max_new_tokens=8)
        hs = b.submit("Short.", "English", ref_wav, "ref", max_new_tokens=8)
        drain("long", hl)
        drain("short", hs)
        ta.join(timeout=600); tb.join(timeout=600)
        assert results["short"] == 8 * spf
        assert results["long"] == 8 * spf
        assert 0 < hs._req.started_at < hl._req.started_at, (
            "short request should start before the gated long head")
    finally:
        b.close()


def test_pcm16_flag_honoured(tiny_tts, monkeypatch):
    """QWEN3TTS_SERVE_PCM16 is read at construction: default on, '0' off.
    (Audio parity of the two wire encodings is engine-level — see
    test_fused_stream.py::test_pcm16_wire_parity — because the serving
    engine's held batch-start position makes fresh end-to-end runs
    legitimately non-identical on chaotic random weights.)"""
    monkeypatch.delenv("QWEN3TTS_SERVE_PCM16", raising=False)
    b = ContinuousBatcher(tiny_tts, max_batch=1, chunk_size=8)
    try:
        assert b._pcm16 is True
    finally:
        b.close()
    monkeypatch.setenv("QWEN3TTS_SERVE_PCM16", "0")
    b = ContinuousBatcher(tiny_tts, max_batch=1, chunk_size=8)
    try:
        assert b._pcm16 is False
    finally:
        b.close()
