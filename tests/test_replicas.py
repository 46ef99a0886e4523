"""Data-parallel replica serving (runtime/replicas.py): one model copy per
device behind a single submit() front door — the SURVEY §2.4 scale-out story
(multi-chip = N independent replicas behind the server).  Runs on the
virtual 8-device CPU mesh (conftest)."""
import jax
import numpy as np
import pytest

from qwen3tts_tpu.models.predictor import SamplingPolicy
from qwen3tts_tpu.runtime.engine import GenerationPolicy
from qwen3tts_tpu.runtime.replicas import ReplicaPool

# deterministic: both heads greedy (cross-replica parity needs the
# predictor greedy too — its RNG keys differ per replica), EOS suppressed
# so rows run to max_new_tokens
NO_EOS = GenerationPolicy(do_sample=False, min_new_tokens=10_000)
GREEDY_PRED = SamplingPolicy(do_sample=False)
MAX_NEW = 16


@pytest.fixture(scope="module")
def pool(tiny_tts):
    p = ReplicaPool(tiny_tts, jax.devices()[:2], max_batch=2, chunk_size=8,
                    max_new_tokens=MAX_NEW, policy=NO_EOS,
                    pred_policy=GREEDY_PRED)
    p.warmup(prefill_buckets=(32,), max_tth=16)
    yield p
    p.close()


def _collect(handle):
    chunks = [a for a, _, _ in handle.chunks()]
    return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)


@pytest.mark.slow
def test_replica_weights_live_on_their_devices(pool):
    assert len(pool.models) == 2
    for m, dev in zip(pool.models, pool.devices):
        for leaf in jax.tree.leaves(m.params):
            assert leaf.devices() == {dev}
    # replicas share host-side helpers but not device/mutable state
    m0, m1 = pool.models
    assert m0.tokenizer is m1.tokenizer
    assert m0.prompt_builder is m1.prompt_builder
    assert m0.engine is not m1.engine
    assert m0.vocoder is not m1.vocoder
    assert m0._voice_prompt_cache is not m1._voice_prompt_cache


def test_requests_spread_and_complete(pool, tiny_tts, ref_wav):
    spf = tiny_tts.vocoder.spf
    handles = [
        pool.submit(f"Utterance number {i}.", "English", ref_wav, "ref")
        for i in range(4)
    ]
    for h in handles:
        audio = _collect(h)
        assert len(audio) == MAX_NEW * spf
        assert np.isfinite(audio).all()
    st = pool.stats
    assert st["served"] == 4
    assert len(st["replicas"]) == 2
    # least-loaded + round-robin routing uses both replicas (exact 2/2 split
    # would race with service completing between submits)
    assert all(r["served"] >= 1 for r in st["replicas"])
    assert all(r["inflight"] == 0 for r in st["replicas"])


@pytest.mark.slow
def test_identical_requests_give_identical_audio_across_replicas(
        pool, tiny_tts, ref_wav):
    # greedy + identical weights ⇒ the same request is bit-identical on
    # every replica (device copies are exact)
    h0 = pool.submit("Cross replica parity.", "English", ref_wav, "ref")
    a0 = _collect(h0)
    h1 = pool.submit("Cross replica parity.", "English", ref_wav, "ref")
    a1 = _collect(h1)
    np.testing.assert_array_equal(a0, a1)


# ---------------------------------------------------------------------------
# failover — these KILL the shared pool's replicas, so they run LAST
# ---------------------------------------------------------------------------

def _kill(pool, i, ref_wav):
    """Inject a catastrophic worker failure into replica i and wait for it
    to be marked dead."""
    b = pool.batchers[i]

    def boom(batch):
        raise RuntimeError("injected replica fault")

    b._serve_batch = boom
    h = b.submit("Doomed.", "English", ref_wav, "ref")  # trips the fault
    with pytest.raises(RuntimeError, match="worker died"):
        for _ in h.chunks():
            pass
    b._worker.join(timeout=10)
    assert not b.alive


@pytest.mark.slow
def test_dead_replica_is_routed_around(pool, tiny_tts, ref_wav):
    _kill(pool, 0, ref_wav)
    # dead batcher fails fast on direct submit
    with pytest.raises(RuntimeError, match="dead|closed"):
        pool.batchers[0].submit("x", "English", ref_wav, "ref")
    # the pool keeps serving on the survivor
    spf = tiny_tts.vocoder.spf
    before = pool.batchers[1]._stats["served"]
    handles = [pool.submit(f"Failover {i}.", "English", ref_wav, "ref")
               for i in range(3)]
    for h in handles:
        assert len(_collect(h)) == MAX_NEW * spf
    assert pool.batchers[1]._stats["served"] == before + 3
    flags = [r["alive"] for r in pool.stats["replicas"]]
    assert flags == [False, True]


@pytest.mark.slow
def test_all_replicas_dead_raises(pool, ref_wav):
    _kill(pool, 1, ref_wav)
    with pytest.raises(RuntimeError, match="all 2 replicas are dead"):
        pool.submit("No survivors.", "English", ref_wav, "ref")


def test_replica_allocations_land_on_its_device(tiny_tts):
    """A replica's fresh buffers (KV cache, suppress mask, sampling knobs,
    RNG) are placed on the replica's device, not on the default one."""
    dev = jax.devices()[3]
    rep = tiny_tts.replicate_to(dev, seed=5)
    eng = rep.engine
    assert eng.device == dev
    for leaf in jax.tree.leaves(eng.new_kv()):
        assert leaf.devices() == {dev}
    assert eng._suppress.devices() == {dev}
    assert eng.knobs(NO_EOS, GREEDY_PRED).devices() == {dev}
    assert rep._rng.devices() == {dev}
    # batch engines built later on the replica inherit its device
    assert rep._batch_engine(2).device == dev
