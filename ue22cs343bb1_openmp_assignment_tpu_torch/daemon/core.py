"""The daemon scheduler core: continuous admission, lanes, buckets.

The port of the JAX package's ``daemon/core.py``, on the port's wave
runner (``ops.step.run_wave_chunk``: one ``cycle`` under
``torch.func.vmap`` over the slot axis) and ``state.set_state``, with the
buckets' batches on ``device`` (None means the card). After a chunk the
host reads the two [B] masks, and the batch itself only when a slot
finished (one copy a leaf, then per-job slicing on the host).

This is the whole serving brain, deliberately with NO socket in it:
a synchronous, clock-injected state machine the socket layer
(daemon/server.py) merely transports requests into. Under a
VirtualClock two identical submission schedules produce byte-identical
serve-trace docs and stats — every scheduler behavior (lane priority,
bucket choice, mid-wave swaps, backpressure) is pinned by tests
without a socket or wall clock.

Continuous admission
--------------------
serve.py admits only at wave boundaries: one straggler holds every
finished slot hostage until the whole wave quiesces. The daemon runs
each bucket's wave as a sequence of ``ops.step.run_wave_chunk`` calls
(one jitted chunk of masked cycles, per-slot done mask returned) and
swaps between chunks: a slot whose job is done is extracted and
refilled via ``state.set_state`` while the other slots are still
mid-flight. Correctness rides the PR-9 parity argument unchanged — a
quiescent (or budget-masked) slot is a frozen fixpoint under the
chunk body's done-mask, so neither the extra chunks it sits through
nor the traced-index ``set_state`` swap of a NEIGHBORING slot can
change its bits, and every job's dump stays byte-identical to its
solo run (tests/test_daemon.py, tests/test_torch_daemon.py).

Shape buckets
-------------
Jobs run in the cheapest slot class covering their (nodes, trace_len),
chosen online from the submitted-shape histogram
(daemon/bucketing.choose_buckets) up to ``max_buckets`` classes per
protocol. Each bucket is one ``run_wave_chunk`` slot shape. When a job
fits no bucket and the class budget is spent, the nearest bucket grows
to cover it — only once idle, counted in ``bucket_growths``.

Priority lanes + backpressure
-----------------------------
Two lanes (interactive/batch) with bounded FIFO queues. Admission
picks the next lane by smooth weighted round-robin over non-empty
lanes (default 4:1 interactive), so interactive jobs overtake queued
batch work at full contention without starving it. A submit into a
full lane gets an explicit ``rejected`` response — backpressure is
always visible, never a silent drop (and never touches the simulated
machines, so ``mb_dropped`` stays orthogonal).

Result retention
----------------
A long-lived daemon must not grow with jobs served: only the newest
``retain_results`` terminal jobs keep their result doc, status entry,
and closed span (older ones answer ``unknown``; ``--out-dir`` is the
durable record). Lifetime counters (``jobs``, per-lane totals) are
exact forever — only per-job payloads are evicted — and the stats
latency summaries become a sliding window over the retained spans.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ue22cs343bb1_openmp_assignment_tpu_torch.daemon import bucketing, protocol
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import burnrate, events, recording
from ue22cs343bb1_openmp_assignment_tpu_torch.obs.clock import MonotonicClock
from ue22cs343bb1_openmp_assignment_tpu_torch.serve import (
    JobSpec, SpanBook, build_job_arrays, build_job_state, empty_state,
    host_state, job_config, job_dumps, job_metrics_doc, protocol_phase,
    serve_trace_doc, _dev)

#: bound on the retained queue-depth/occupancy sample trail (each
#: sample is one 3-tuple per scheduler turn; the oldest are dropped)
_MAX_SAMPLES = 65_536


@dataclasses.dataclass
class _Lane:
    """One priority lane: a bounded FIFO plus its admission weight and
    lifetime counters."""

    name: str
    weight: int
    depth: int
    queue: List[Tuple[JobSpec, float]] = dataclasses.field(
        default_factory=list)
    credit: int = 0          # smooth weighted round-robin accumulator
    submitted: int = 0
    admitted: int = 0
    rejected: int = 0
    done: int = 0


class _Bucket:
    """One slot shape class: a chunk-wave over ``slots`` batch
    positions at one (nodes, trace_len, protocol) signature."""

    # lint: host
    def __init__(self, shape: bucketing.Shape, proto: str, slots: int,
                 queue_capacity: int, device):
        from ue22cs343bb1_openmp_assignment_tpu_torch import state as st
        from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
        self.shape = shape
        self.protocol = proto
        self.label = f"{proto}:{shape[0]}x{shape[1]}"
        self.slots = slots
        self.scfg = SystemConfig.scale(
            num_nodes=shape[0], max_instrs=shape[1],
            queue_capacity=queue_capacity, protocol=proto)
        self.phase = protocol_phase(proto)
        self.bstate = st.stack_states(
            [empty_state(self.scfg, device)] * slots)
        self.occupant: List[Optional[JobSpec]] = [None] * slots
        self.lane_of: List[Optional[str]] = [None] * slots
        self.real_by_slot = [0] * slots
        self.started_chunk = [0] * slots
        self.chunks = 0
        self.admitted = 0

    # lint: host
    def busy(self) -> int:
        return sum(1 for o in self.occupant if o is not None)


class DaemonCore:
    """The deterministic serving scheduler (no transport, no threads).

    The socket layer calls :meth:`submit` / :meth:`status` /
    :meth:`result` / :meth:`stats` / :meth:`trace_doc` /
    :meth:`drain` under its lock and :meth:`pump` from the one
    scheduler thread; tests and :func:`drive` call the same methods
    directly. ``pump`` runs ONE chunk on every occupied bucket —
    admission happens between chunks, which is what makes it
    continuous. The batches live on ``device`` (None: the card).
    """

    # lint: host
    def __init__(self, slots: int = 4, max_buckets: int = 4,
                 chunk: int = 16, max_cycles: int = 100_000,
                 queue_capacity: int = 64,
                 lane_depth: int = protocol.DEFAULT_LANE_DEPTH,
                 lane_weights: Optional[Dict[str, int]] = None,
                 clock=None, out_dir=None, keep_dumps: bool = True,
                 retain_results: int = protocol.DEFAULT_RETAIN_RESULTS,
                 recorder: Optional[recording.RecordingWriter] = None,
                 emitter: Optional[events.EventEmitter] = None,
                 burn: Optional[burnrate.BurnRateMonitor] = None,
                 device=None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_buckets < 1:
            raise ValueError(f"max_buckets must be >= 1, "
                             f"got {max_buckets}")
        if retain_results < 1:
            raise ValueError(f"retain_results must be >= 1, "
                             f"got {retain_results}")
        weights = dict(protocol.DEFAULT_LANE_WEIGHTS)
        if lane_weights:
            weights.update(lane_weights)
        self.device = _dev(device)
        self.slots = slots
        self.max_buckets = max_buckets
        self.chunk = chunk
        self.max_cycles = max_cycles
        self.queue_capacity = queue_capacity
        self.clock = clock if clock is not None else MonotonicClock()
        self.out_dir = (pathlib.Path(out_dir) if out_dir is not None
                        else None)
        self.keep_dumps = keep_dumps
        self.retain_results = retain_results
        self.recorder = recorder
        self.emitter = emitter
        self.burn = burn
        #: the socket layer's lock when a DaemonServer drives this core:
        #: ``pump`` releases it while a chunk runs (see there)
        self.lock = None
        self.t_start = self.clock.now()
        self.book = SpanBook(self.clock)
        self.lanes: Dict[str, _Lane] = {
            name: _Lane(name=name, weight=int(w), depth=int(lane_depth))
            for name, w in sorted(weights.items())}
        self.buckets: Dict[Tuple[str, int, int], _Bucket] = {}
        self.draining = False
        self.results: Dict[str, dict] = {}
        self._status: Dict[str, str] = {}
        self._hist: Dict[str, Dict[bucketing.Shape, int]] = {}
        self._max_shape: Optional[bucketing.Shape] = None
        self.samples: List[Tuple[float, int, int]] = []
        self.chunks = 0
        self.busy_s = 0.0
        self.mb_dropped = 0
        self.mid_wave_swaps = 0
        self.bucket_growths = 0
        self.queue_depth_peak = 0
        self.results_evicted = 0
        self.stats_seq = 0
        self.slo_alerts = 0
        self._lane_hist: Dict[str, object] = {}
        self._terminal_order: List[str] = []
        self._quiesced_total = 0
        self._real_total = 0
        self._budget_total = 0
        self._rejected_total = 0

    # lint: host
    def _emit(self, kind: str, job: Optional[str] = None,
              **fields) -> None:
        """One live-ops event (obs.events) at the CURRENT clock time,
        as an offset from core start. Always clock.now(), never a
        scheduled submit stamp: event time is when the scheduler acted
        (which also keeps the stream's t_s non-decreasing when an
        open-loop load generator back-stamps arrivals)."""
        if self.emitter is not None:
            self.emitter.emit(kind, self.clock.now() - self.t_start,
                              job, **fields)

    # -- admission-side API (called by the socket handlers) ---------------

    # lint: host
    def submit(self, spec: JobSpec, lane: str = "batch",
               t_submit: Optional[float] = None) -> dict:
        """Enqueue one job; returns the protocol response dict.
        ``t_submit`` lets an open-loop load generator stamp the SCHEDULED
        arrival time (coordinated-omission-free, the soak convention);
        the socket path stamps receipt time."""
        base = {"ok": True, "op": "submit", "job": spec.name,
                "lane": lane}
        if lane not in self.lanes:
            return protocol.error(
                "submit", f"unknown lane {lane!r} "
                          f"(one of {sorted(self.lanes)})")
        if (spec.name in self._status
                and self._status[spec.name] != "rejected"):
            return protocol.error(
                "submit", f"duplicate job name {spec.name!r}")
        ln = self.lanes[lane]
        if self.draining:
            ln.rejected += 1
            self._rejected_total += 1
            self._status[spec.name] = "rejected"
            self._emit("lane-reject", spec.name, lane=lane,
                       reason="draining")
            self._retire(spec.name)
            return {**base, "ok": False, "status": "rejected",
                    "reason": "draining"}
        if len(ln.queue) >= ln.depth:
            # bounded queue: explicit, attributable backpressure — the
            # client hears "rejected", the simulated machines never see
            # the job (mb_dropped stays zero)
            ln.rejected += 1
            self._rejected_total += 1
            self._status[spec.name] = "rejected"
            self._emit("lane-reject", spec.name, lane=lane,
                       reason="queue-full", depth=ln.depth)
            self._retire(spec.name)
            return {**base, "ok": False, "status": "rejected",
                    "reason": f"lane {lane!r} queue full "
                              f"(depth {ln.depth})"}
        t = self.book._t(t_submit)
        self.book.submit(spec.name, t)
        self.book.annotate(spec.name, lane=lane)
        ln.queue.append((spec, t))
        ln.submitted += 1
        self._status[spec.name] = "queued"
        self._hist.setdefault(spec.protocol, {})
        shape = (spec.nodes, spec.trace_len)
        h = self._hist[spec.protocol]
        h[shape] = h.get(shape, 0) + 1
        self._max_shape = (shape if self._max_shape is None
                           else bucketing.cover(self._max_shape, shape))
        self._sample()
        if self.recorder is not None:
            # every ACCEPTED submission is one recording row: the
            # full spec, the lane, the SCHEDULED arrival time on the
            # injected clock, and the queue depth at accept
            self.recorder.submit(
                spec, lane, t - self.t_start,
                sum(len(x.queue) for x in self.lanes.values()))
        self._emit("submit-accepted", spec.name, lane=lane,
                   depth=len(ln.queue))
        return {**base, "status": "queued"}

    # lint: host
    def status(self, job: str) -> dict:
        return {"ok": True, "op": "status", "job": job,
                "status": self._status.get(job, "unknown")}

    # lint: host
    def result(self, job: str) -> dict:
        st = self._status.get(job, "unknown")
        if st != "done":
            return {"ok": st not in ("unknown", "rejected"),
                    "op": "result", "job": job, "status": st}
        return {"ok": True, "op": "result", "job": job,
                "status": "done", **self.results[job]}

    # lint: host
    def drain(self) -> dict:
        """Stop admitting new jobs; the pump flushes what is queued
        and in flight. The socket layer responds once :meth:`idle`."""
        self.draining = True
        return {"ok": True, "op": "drain", "draining": True}

    # lint: host
    def idle(self) -> bool:
        return (not any(ln.queue for ln in self.lanes.values())
                and not any(b.busy() for b in self.buckets.values()))

    # lint: host
    def _retire(self, name: str) -> None:
        """Record a terminal (done/rejected) job and evict the oldest
        terminal jobs beyond ``retain_results`` — the result doc, the
        status entry, and the closed span all go, so a long-lived
        daemon's memory is bounded no matter how many jobs it serves.
        Evicted jobs answer ``unknown``; ``out_dir`` is the durable
        record. Lifetime counters are never evicted."""
        self._terminal_order.append(name)
        while len(self._terminal_order) > self.retain_results:
            old = self._terminal_order.pop(0)
            # a rejected name may have been resubmitted and be live
            # again (queued/running) — only terminal state is evictable
            if self._status.get(old) in ("done", "rejected"):
                del self._status[old]
                self.results.pop(old, None)
                self.results_evicted += 1
                self._emit("result-evicted", old,
                           retain=self.retain_results)
        self.book.prune(self.retain_results)

    # -- scheduler side ----------------------------------------------------

    # lint: host
    def _sample(self) -> None:
        queued = sum(len(ln.queue) for ln in self.lanes.values())
        busy = sum(b.busy() for b in self.buckets.values())
        self.queue_depth_peak = max(self.queue_depth_peak, queued)
        self.samples.append(
            (self.clock.now() - self.t_start, queued, busy))
        if len(self.samples) > _MAX_SAMPLES:
            del self.samples[:len(self.samples) - _MAX_SAMPLES]

    # lint: host
    def _next_lane(self, skip) -> Optional[Tuple[_Lane, int]]:
        """Smooth weighted round-robin over lanes with queued work:
        each eligible lane gains its weight in credit and the richest
        lane is picked; returns (lane, payback). The payback — the
        round's total credit issue — is debited by :meth:`_admit`
        only once the lane's head job actually lands in a slot, so a
        head-of-line-blocked lane is never charged for admissions
        that did not happen (it keeps its credit and catches up once
        unblocked, holding the configured share ratio)."""
        elig = [ln for ln in self.lanes.values()
                if ln.queue and ln.name not in skip]
        if not elig:
            return None
        for ln in elig:
            ln.credit += ln.weight
        best = max(elig, key=lambda ln: (ln.credit, ln.weight, ln.name))
        return best, sum(ln.weight for ln in elig)

    # lint: host
    def _bucket_count(self, proto: str) -> int:
        return sum(1 for (p, _, _) in self.buckets if p == proto)

    # lint: host
    def _bucket_for_job(self, spec: JobSpec) -> Optional[_Bucket]:
        """The bucket this job runs in, creating or growing one under
        the ≤ max_buckets-per-protocol class budget. None = no class
        can take it right now (the nearest bucket must drain before
        it can grow) — the job stays queued and admission retries."""
        shape = (spec.nodes, spec.trace_len)
        mine = {k: b for k, b in self.buckets.items()
                if k[0] == spec.protocol}
        fit = bucketing.bucket_for(shape,
                                   [b.shape for b in mine.values()])
        if fit is not None:
            return self.buckets[(spec.protocol, fit[0], fit[1])]
        if self._bucket_count(spec.protocol) < self.max_buckets:
            # choose the new class from the full shape histogram seen
            # so far, not the single job: with a bimodal mix the DP
            # proposes the small AND the large class up front, so the
            # classes stabilize after the first few admissions
            chosen = bucketing.choose_buckets(
                self._hist[spec.protocol], self.max_buckets)
            cls = bucketing.bucket_for(shape, chosen)
            b = _Bucket(cls, spec.protocol, self.slots,
                        self.queue_capacity, self.device)
            self.buckets[(spec.protocol, cls[0], cls[1])] = b
            return b
        # class budget spent and nothing covers: grow the bucket whose
        # cover costs least — but only once it is idle (growing means a
        # new slot config; swapping it under in-flight jobs would break
        # their bit parity)
        key = min(mine, key=lambda k: (
            bucketing.cover(mine[k].shape, shape)[0]
            * bucketing.cover(mine[k].shape, shape)[1], k))
        victim = mine[key]
        if victim.busy():
            return None
        grown = bucketing.cover(victim.shape, shape)
        del self.buckets[key]
        b = _Bucket(grown, spec.protocol, self.slots,
                    self.queue_capacity, self.device)
        # the grown class REPLACES the victim: carry its lifetime
        # counters so stats() keeps the retired bucket's history
        b.chunks = victim.chunks
        b.admitted = victim.admitted
        self.buckets[(spec.protocol, grown[0], grown[1])] = b
        self.bucket_growths += 1
        self._emit("bucket-growth", spec.name, bucket=b.label,
                   grown_from=victim.label)
        return b

    # lint: host
    def _admit(self) -> None:
        """Fill free slots from the lanes, weighted; stops when no
        eligible lane's head job can be placed."""
        from ue22cs343bb1_openmp_assignment_tpu_torch import state as st
        skip = set()
        while True:
            picked = self._next_lane(skip)
            if picked is None:
                return
            ln, payback = picked
            spec, _ = ln.queue[0]
            b = self._bucket_for_job(spec)
            slot = (None if b is None else
                    next((i for i, o in enumerate(b.occupant)
                          if o is None), None))
            if b is None or slot is None:
                # head-of-line blocked (bucket full / must drain to
                # grow): keep the lane FIFO, let other lanes admit —
                # and do NOT debit the payback (no admission happened)
                skip.add(ln.name)
                continue
            ln.queue.pop(0)
            ln.credit -= payback
            ln.admitted += 1
            b.occupant[slot] = spec
            b.lane_of[slot] = ln.name
            b.started_chunk[slot] = b.chunks
            b.admitted += 1
            jcfg = job_config(spec, self.queue_capacity)
            b.real_by_slot[slot] = int(np.sum(
                build_job_arrays(jcfg, spec, self.device)[3]))
            b.bstate = st.set_state(
                b.bstate, slot,
                build_job_state(b.scfg, jcfg, spec, self.device))
            if any(o is not None and b.started_chunk[j] < b.chunks
                   for j, o in enumerate(b.occupant) if j != slot):
                # the defining continuous-admission event: this slot
                # joins a wave other slots are already mid-flight in
                self.mid_wave_swaps += 1
            t = self.clock.now()
            self.book.admitted(spec.name, wave=b.chunks, slot=slot, t=t)
            self.book.running(spec.name, t)
            self.book.annotate(spec.name, bucket=b.label)
            self._status[spec.name] = "running"
            self._emit("admitted", spec.name, lane=ln.name,
                       bucket=b.label, wave=b.chunks, slot=slot)

    # lint: host
    def pump(self) -> bool:
        """One scheduler turn: admit, then run ONE chunk on every
        occupied bucket and extract/refill slots that resolved.
        Returns whether any chunk ran (False = fully idle)."""
        import torch
        self._sample()
        self._admit()
        ran = False
        for key in sorted(self.buckets):
            # the mid-loop _admit below can DELETE a snapshot key: a
            # freed slot admits a head-of-line-blocked job and the job
            # behind it grows an idle bucket (del + re-key in
            # _bucket_for_job) — the grown bucket runs next pump
            b = self.buckets.get(key)
            if b is None or not b.busy():
                continue
            from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
            t0 = self.clock.now()
            with self._unlocked():
                b.bstate, quiet_d, done_d = step.run_wave_chunk(
                    b.scfg, b.bstate, self.chunk, self.max_cycles, b.phase)
                # the chunk's one host read: the two [B] masks
                quiet, done = torch.stack([quiet_d, done_d]).cpu().numpy()
            self.clock.on_wave()
            t1 = self.clock.now()
            b.chunks += 1
            self.chunks += 1
            self.busy_s += t1 - t0
            ran = True
            finished = [i for i, spec in enumerate(b.occupant)
                        if spec is not None and bool(done[i])]
            # the batch comes to the host only when a slot finished
            host = host_state(b.bstate) if finished else None
            for i in finished:
                self._extract(b, i, bool(quiet[i]), t1, host)
            # continuous admission: refill the freed slots NOW, so the
            # next chunk (this pump or the next) runs them alongside
            # the still-unfinished occupants
            self._admit()
        return ran

    # lint: host
    @contextlib.contextmanager
    def _unlocked(self):
        """Release the socket layer's lock (if any) for a chunk. The
        port's chunk is host work: the scheduler thread issues every
        launch of ``chunk`` vmapped cycles from Python, tens of ms a
        cycle, where a jitted JAX chunk is one dispatch. Handlers then
        answer submits, polls and stats mid-chunk instead of waiting for
        it. Only the scheduler thread touches the buckets (admission and
        extraction run with the lock held), and the chunk reads and
        writes nothing but its bucket's batch."""
        if self.lock is None:
            yield
            return
        self.lock.release()
        try:
            yield
        finally:
            self.lock.acquire()

    # lint: host
    def _extract(self, b: _Bucket, i: int, ok: bool,
                 t_end: float, host=None) -> None:
        """Extract slot ``i`` from ``host`` (the bucket's batch copied to
        the host after the chunk; copied here when not given)."""
        from ue22cs343bb1_openmp_assignment_tpu_torch import state as st
        spec = b.occupant[i]
        lane = self.lanes[b.lane_of[i]]
        jstate = st.index_state(
            host if host is not None else host_state(b.bstate), i)
        jcfg = job_config(spec, self.queue_capacity)
        self.book.quiescent(spec.name, ok, t_end)
        metrics = job_metrics_doc(jstate)
        dropped = int(metrics["mb_dropped"] or 0)
        self.mb_dropped += dropped
        doc = {
            "spec": dataclasses.asdict(spec),
            "lane": lane.name,
            "bucket": b.label,
            "quiesced": ok,
            "cycles": int(jstate.cycle),
            "metrics": metrics,
        }
        dumps = job_dumps(b.scfg, jcfg, jstate)
        # the digest is computed HERE, from the dumps, before the
        # _retire below may evict this very doc: a recording's digest
        # column stays complete even for jobs a bounded daemon no
        # longer retains (lifetime counters were already exact; this
        # makes the byte-parity fingerprint exact too)
        doc["digest"] = recording.digest(dumps)
        if self.keep_dumps:
            doc["dumps"] = dumps
        if self.out_dir is not None:
            jdir = self.out_dir / spec.name
            jdir.mkdir(parents=True, exist_ok=True)
            for n, text in enumerate(dumps):
                (jdir / f"node{n}_dump.txt").write_text(text)
            (jdir / "metrics.json").write_text(
                json.dumps({k: v for k, v in doc.items()
                            if k != "dumps"}, indent=2) + "\n")
        self.book.extracted(spec.name)
        # spans() is in extraction order, so the span just closed by
        # extracted() is the last one — its e2e feeds the per-lane
        # mergeable histogram and the burn-rate monitor
        span = self.book._done[-1]
        e2e_s = float(span["e2e_s"])
        if lane.name not in self._lane_hist:
            from ue22cs343bb1_openmp_assignment_tpu_torch.obs import timeseries
            self._lane_hist[lane.name] = timeseries.LogHistogram()
        self._lane_hist[lane.name].observe(e2e_s * 1e3)
        if self.recorder is not None:
            self.recorder.result(spec.name, t_end - self.t_start, ok,
                                 doc["digest"], doc["cycles"], b.label)
        self._emit("quiesced", spec.name, lane=lane.name,
                   bucket=b.label, ok=ok, cycles=doc["cycles"],
                   e2e_ms=e2e_s * 1e3)
        if self.burn is not None:
            alert = self.burn.feed(t_end - self.t_start, e2e_s)
            if alert is not None:
                self.slo_alerts += 1
                self._emit("slo-alert", spec.name,
                           **{k: v for k, v in alert.items()
                              if k != "t_s"})
        self.results[spec.name] = doc
        self._status[spec.name] = "done"
        self._quiesced_total += int(ok)
        self._retire(spec.name)
        lane.done += 1
        self._real_total += b.real_by_slot[i]
        self._budget_total += b.shape[0] * b.shape[1]
        # the finished (quiescent = fixpoint) or budget-dead (masked)
        # state stays in the slot until set_state refills it — same
        # contract as serve.py
        b.occupant[i] = None
        b.lane_of[i] = None
        b.real_by_slot[i] = 0

    # -- reporting ---------------------------------------------------------

    # lint: host
    def record_config(self) -> dict:
        """The scheduler knobs a recording's header carries — enough
        for ``cache-sim replay`` to rebuild an equivalent core, so an
        in-proc replay of a VirtualClock session is bit-faithful by
        default."""
        return {
            "slots": self.slots, "max_buckets": self.max_buckets,
            "chunk": self.chunk, "max_cycles": self.max_cycles,
            "queue_capacity": self.queue_capacity,
            "lane_depth": max(ln.depth for ln in self.lanes.values()),
            "lane_weights": {name: ln.weight for name, ln
                             in sorted(self.lanes.items())},
        }

    # lint: host
    def stats(self) -> dict:
        """The validated ``cache-sim/daemon-stats/v1`` snapshot."""
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs import (
            schema, timeseries)
        done = sum(ln.done for ln in self.lanes.values())
        lane_lat = timeseries.lane_latency_summaries(self.book.spans())
        lanes = {}
        for name, ln in sorted(self.lanes.items()):
            hist = self._lane_hist.get(name)
            lanes[name] = {
                "weight": ln.weight, "depth": ln.depth,
                "queued": len(ln.queue), "submitted": ln.submitted,
                "admitted": ln.admitted, "rejected": ln.rejected,
                "done": ln.done, "latency": lane_lat.get(name),
                # unlike "latency" (a sliding window over RETAINED
                # spans), the histogram is lifetime-exact and
                # fleet-mergeable (fixed edges)
                "hist": None if hist is None else hist.to_doc(),
            }
        buckets = []
        for key in sorted(self.buckets):
            b = self.buckets[key]
            buckets.append({
                "bucket": b.label, "protocol": b.protocol,
                "nodes": b.shape[0], "trace_len": b.shape[1],
                "slots": b.slots, "busy": b.busy(),
                "admitted": b.admitted, "chunks": b.chunks,
            })
        # single-max-shape counterfactual: the budget the SAME done
        # jobs would have burned in one serve.py-style slot class at
        # the max submitted shape — the baseline bucketing must beat
        single = None
        if done and self._max_shape is not None:
            n, t = self._max_shape
            single = 1.0 - self._real_total / (done * n * t)
        # every snapshot gets the next seq — two stats docs from one
        # daemon are totally ordered even when uptime_s ties (virtual
        # clock, no wave between polls)
        self.stats_seq += 1
        doc = {
            "schema": schema.DAEMON_STATS_SCHEMA_ID,
            "clock": self.clock.kind,
            "uptime_s": self.clock.now() - self.t_start,
            "stats_seq": self.stats_seq,
            "draining": self.draining,
            "jobs": {
                "submitted": sum(ln.submitted
                                 for ln in self.lanes.values()),
                "rejected": self._rejected_total,
                "done": done,
                "quiesced": self._quiesced_total,
            },
            "lanes": lanes,
            "buckets": buckets,
            "chunks": self.chunks,
            "busy_s": self.busy_s,
            "drain_rate_jobs_per_s": (done / self.busy_s
                                      if self.busy_s > 0 else 0.0),
            "mb_dropped": self.mb_dropped,
            "mid_wave_swaps": self.mid_wave_swaps,
            "bucket_growths": self.bucket_growths,
            "queue_depth_peak": self.queue_depth_peak,
            "retain_results": self.retain_results,
            "results_evicted": self.results_evicted,
            "recording": (None if self.recorder is None else {
                "path": self.recorder.path,
                "submits": self.recorder.submits,
                "results": self.recorder.results,
            }),
            "events": (None if self.emitter is None else {
                "path": self.emitter.path,
                "ring": self.emitter.ring,
                "seq": self.emitter.seq,
                "dropped": self.emitter.dropped,
            }),
            "slo_alerts": self.slo_alerts,
            "burnrate": (None if self.burn is None
                         else self.burn.summary()),
            "padding_waste": (
                1.0 - self._real_total / self._budget_total
                if self._budget_total else None),
            "single_shape_padding_waste": single,
        }
        return schema.validate_daemon_stats(doc)

    # lint: host
    def trace_doc(self) -> dict:
        """Completed jobs as the validated serve-trace doc (spans
        carry the daemon's lane/bucket annotations)."""
        return serve_trace_doc(self.book.spans(), self.clock.kind)


# lint: host
def attach_recorder(core: DaemonCore,
                    path) -> recording.RecordingWriter:
    """Open a ``cache-sim/recording/v1`` writer on ``path`` (file or
    directory) and attach it to the core; every accepted submission
    and finished job from here on is streamed to it."""
    core.recorder = recording.RecordingWriter(
        path, core.clock.kind, core.record_config())
    return core.recorder


# lint: host
def attach_emitter(core: DaemonCore, path=None,
                   ring: int = events.DEFAULT_RING
                   ) -> events.EventEmitter:
    """Open a ``cache-sim/events/v1`` emitter (ring-only, or also
    streamed to ``path`` — the ``--events-dir`` artifact) and attach
    it to the core; every scheduler decision from here on is one
    structured event the ``watch`` verb can push to clients."""
    core.emitter = events.EventEmitter(
        core.clock.kind, ring=ring, path=path,
        config=core.record_config())
    return core.emitter


# lint: host
def drive(core: DaemonCore, arrivals) -> List[dict]:
    """Run an open-loop schedule ``[(t_offset_s, JobSpec, lane)]``
    directly through a core (no socket): release each job at its
    scheduled offset on the core's clock — submit stamped at the
    SCHEDULED time, coordinated-omission-free — and pump until idle.
    Under a VirtualClock the whole run is deterministic, which is how
    tests soak the daemon for minutes of virtual time in milliseconds
    of real time. Returns the submit responses in release order."""
    clock = core.clock
    t0 = clock.now()
    pending = sorted(
        ((t0 + dt, spec, lane) for dt, spec, lane in arrivals),
        key=lambda a: (a[0], a[1].name))
    responses = []
    while pending or not core.idle():
        now = clock.now()
        while pending and pending[0][0] <= now:
            t_arr, spec, lane = pending.pop(0)
            responses.append(core.submit(spec, lane=lane,
                                         t_submit=t_arr))
        if core.idle():
            if pending:
                clock.sleep(pending[0][0] - now)
            continue
        if not core.pump():
            if not pending:
                raise RuntimeError("daemon core wedged: queued jobs "
                                   "but no admissible bucket")
            clock.sleep(max(0.0, pending[0][0] - clock.now()))
    return responses
