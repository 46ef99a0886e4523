"""Data-parallel replica serving: one model replica per accelerator device
behind a single ``submit()`` front door.

The reference is strictly single-GPU; concurrent requests serialize behind a
lock (reference examples/openai_server.py:71,181).  SURVEY §2.4 frames the
scale-out story as "multi-card = N independent replicas behind the
server" — the latency path stays on one card, so the links between cards
play no role in it.  ReplicaPool is that component:

  * the weights are copied once per device (FasterQwen3TTS.replicate_to —
    host-side helpers are shared, device state is per-replica);
  * each replica runs its own ContinuousBatcher (runtime/scheduler.py), so
    every device serves a continuously-batched request stream;
  * ``submit()`` routes each request to the replica with the fewest
    in-flight requests (round-robin tie-break), tracked pool-side from
    submit/served counters — no cross-device coordination of any kind;
  * a replica whose worker dies (catastrophic device/runtime failure) is
    detected via ``ContinuousBatcher.alive`` and routed around — the pool
    keeps serving on the survivors and only fails when none remain.

Aggregate throughput scales ~linearly with device count (replicas share
nothing); per-request latency stays at single-chip batch latency.  Tensor
parallelism over a Mesh (parallel/sharding.py) remains the escape hatch for
models too large for one chip; the two compose — shard a replica over a
sub-mesh, replicate sub-meshes behind the pool.
"""
from __future__ import annotations

import contextlib
import logging
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import jax

from ..models.predictor import SamplingPolicy
from .engine import GenerationPolicy
from .scheduler import ContinuousBatcher, StreamHandle

logger = logging.getLogger(__name__)


class ReplicaPool:
    """N independent (model, ContinuousBatcher) replicas with least-loaded
    request routing.  Duck-types the batcher surface the servers consume
    (``submit`` / ``stats`` / ``warmup`` / ``close``), so ``--replicas N``
    is a drop-in for a single batcher in apps/openai_server.py."""

    def __init__(
        self,
        model,
        devices: Optional[Sequence] = None,
        *,
        max_batch: int = 4,
        chunk_size: int = 8,
        max_new_tokens: int = 2048,
        policy: Optional[GenerationPolicy] = None,
        pred_policy: Optional[SamplingPolicy] = None,
        first_chunks: Tuple[int, ...] = (),
    ):
        self.devices = list(devices) if devices is not None else list(jax.local_devices())
        if not self.devices:
            raise ValueError("ReplicaPool needs at least one device")
        leaf = jax.tree.leaves(model.params)[0]
        src_devices = leaf.devices() if hasattr(leaf, "devices") else set()
        self.models = []
        for i, dev in enumerate(self.devices):
            if src_devices == {dev}:
                self.models.append(model)  # weights already live there
            else:
                logger.info("replicating model to %s", dev)
                self.models.append(model.replicate_to(dev, seed=i + 1))
        self.batchers: List[ContinuousBatcher] = [
            ContinuousBatcher(
                m, max_batch=max_batch, chunk_size=chunk_size,
                max_new_tokens=max_new_tokens, policy=policy,
                pred_policy=pred_policy, first_chunks=first_chunks,
            )
            for m in self.models
        ]
        self._submits = [0] * len(self.batchers)
        self._rr = 0
        self._lock = threading.Lock()
        self._reported_dead: set = set()

    # ------------------------------------------------------------------

    def _inflight(self, i: int) -> int:
        st = self.batchers[i]._stats
        return max(0, self._submits[i] - st["served"])

    def _live(self) -> List[int]:
        """Indices of replicas whose worker is still serving.  A dead worker
        (catastrophic failure — its own log line explains why) is routed
        around, once loudly; requests in flight on it fail via their stream
        handles, new requests go to the survivors."""
        live = []
        for i, b in enumerate(self.batchers):
            if b.alive:
                live.append(i)
            elif i not in self._reported_dead:
                self._reported_dead.add(i)
                logger.error("replica %d (%s) is dead; routing around it",
                             i, self.devices[i])
        return live

    @contextlib.contextmanager
    def arriving(self):
        """Advertise an in-flight request to every replica's burst
        collector (ContinuousBatcher.arriving): routing happens at submit
        time, so before prep finishes any replica might receive it."""
        with contextlib.ExitStack() as stack:
            for b in list(self.batchers):
                stack.enter_context(b.arriving())
            yield

    def submit(self, *args, **kwargs) -> StreamHandle:
        """Route to the least-loaded live replica (same signature as
        ContinuousBatcher.submit)."""
        n = len(self.batchers)
        for _ in range(n):  # retry if a replica dies mid-routing
            with self._lock:
                live = self._live()
                if not live:
                    raise RuntimeError(
                        f"all {n} replicas are dead (see earlier logs)")
                order = [(self._inflight(i), (i - self._rr) % n, i)
                         for i in live]
                i = min(order)[2]
                self._submits[i] += 1
                self._rr = (i + 1) % n
            try:
                return self.batchers[i].submit(*args, **kwargs)
            except RuntimeError:
                if self.batchers[i].alive:
                    raise  # a genuine submit error, not replica death
                # died between routing and submit: undo the count, reroute
                with self._lock:
                    self._submits[i] -= 1
        raise RuntimeError(f"all {n} replicas are dead (see earlier logs)")

    @property
    def stats(self) -> Dict:
        per = [b.stats for b in self.batchers]
        agg = {
            k: sum(s[k] for s in per)
            for k in ("served", "joined_mid_batch", "batches", "cancelled",
                      "active_rows", "queue_depth", "retired_predictively")
        }
        agg["replicas"] = [
            dict(s, device=str(d), inflight=self._inflight(i),
                 alive=self.batchers[i].alive)
            for i, (s, d) in enumerate(zip(per, self.devices))
        ]
        return agg

    def warmup(self, prefill_buckets=(128,), max_tth: Optional[int] = None):
        """Warm every replica's batched executables.  Replicas compile
        sequentially: on same-kind devices all but the first are persistent-
        cache hits, so the wall cost is ~one replica's warmup."""
        for i, b in enumerate(self.batchers):
            logger.info("warming replica %d/%d (%s)", i + 1,
                        len(self.batchers), self.devices[i])
            b.warmup(prefill_buckets=prefill_buckets, max_tth=max_tth)

    def close(self, timeout: float = 30.0):
        for b in self.batchers:
            b.close(timeout=timeout)
