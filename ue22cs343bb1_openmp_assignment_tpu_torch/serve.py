"""Batched multi-tenant serving: pack independent sim jobs into
fixed-shape waves and run them as one vmapped stepper.

The port of the JAX package's ``serve.py``. "Millions of users" for a
simulator means thousands of *independent* sims in flight, not one giant
sim. This module is the front door for that shape: a stream of (config,
trace) jobs is packed into ``slots`` fixed-shape batch positions, the
whole machine state — caches, directory, mailboxes, traces, metrics —
carries a leading job axis (``state.stack_states``), and each *wave*
runs every slot to quiescence through ``ops.step.run_wave_to_quiescence``:
one ``cycle`` under ``torch.func.vmap`` over the job axis, so a wave
cycle's launches do not grow with the slot count. Finished jobs are
swapped out between waves and queued jobs admitted in place
(``state.set_state``).

State lives on ``device`` (None means the card; the CPU only when asked
for). Each job's trace is drawn by the port's generators
(``models.workloads``, the threefry twin of jax.random: on the card its
kernel ``csrc/threefry.cu``), so a job's arrays, dumps and metrics equal
the JAX package's.

Slot-fit rules
--------------
Every job runs inside the *slot* config (``slot_nodes`` x
``slot_trace_len``), padded:

* trace padding: instructions [job_T, slot_T) are NOPs with
  ``instr_count`` unchanged, so the frontend never fetches them;
* node padding: nodes [job_N, slot_N) get ``instr_count == 0`` — born
  exhausted, they never issue and (being un-referenced by any job
  address) never receive traffic;
* address geometry: traces are generated with the JOB's own config, so
  job addresses/homes are independent of the slot size (the codec packs
  ``home << block_bits | block``).

The only place slot and job configs disagree observably is the
invalid-address sentinel (it depends on num_nodes), so extraction
remaps ``slot_cfg.invalid_address -> job_cfg.invalid_address`` and
slices the directory bitvec down to the job's word count. That makes a
padded batched run *bit-identical* per job to running the job solo.

Early exit: a quiescent state is a fixpoint of ``cycle`` apart from
the cycle counters, so the wave runner freezes finished slots with a
where-mask every cycle. Finished jobs therefore keep their *exact* solo
cycle count while stragglers run on.

Padding waste: every wave reports ``padding_waste``, the fraction of the
slot instruction budget (slots * slot_nodes * slot_trace_len) that is
padding rather than real job instructions.

Jobs of the table protocols (``moesi``, ``mesif``) step through the
table-compiled message phase (``protocol_phase``), under the same vmap.

Not ported yet (ROADMAP.md, Queue 1 item 6): ``devices > 1`` (the batch
axis sharded over several cards, ``batch_shardings``); it raises a
ValueError.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.obs.clock import MonotonicClock
from ue22cs343bb1_openmp_assignment_tpu_torch.types import Op

SCHEMA_ID = "cache-sim/serve/v1"

#: workloads the serve traffic mix cycles through (all N-generic)
DEFAULT_MIX = ("uniform", "false_sharing", "producer_consumer", "hotspot")


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One serving job: a workload trace under its own machine config."""

    name: str
    workload: str = "uniform"
    nodes: int = 4
    trace_len: int = 8
    seed: int = 0
    protocol: str = "mesi"

    @classmethod
    def from_dict(cls, d: dict) -> "JobSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"job spec has unknown keys {sorted(unknown)}")
        if "name" not in d:
            raise ValueError("job spec needs a 'name'")
        return cls(**d)


def load_jobs(path) -> List[JobSpec]:
    """Jobs from a .jsonl file (one spec per line) or a directory of
    .json files (sorted by filename)."""
    p = pathlib.Path(path)
    specs: List[JobSpec] = []
    if p.is_dir():
        for f in sorted(p.glob("*.json")):
            specs.append(JobSpec.from_dict(json.loads(f.read_text())))
    else:
        for line in p.read_text().splitlines():
            line = line.strip()
            if line:
                specs.append(JobSpec.from_dict(json.loads(line)))
    if not specs:
        raise ValueError(f"no jobs found under {path}")
    return specs


def job_config(spec: JobSpec, queue_capacity: int = 64) -> SystemConfig:
    return SystemConfig.scale(num_nodes=spec.nodes,
                              max_instrs=spec.trace_len,
                              queue_capacity=queue_capacity,
                              protocol=spec.protocol)


def slot_config(specs, slot_nodes: Optional[int] = None,
                slot_trace_len: Optional[int] = None,
                queue_capacity: int = 64,
                protocol: str = "mesi") -> SystemConfig:
    """The fixed batch-slot shape: defaults to the max over the jobs."""
    n = slot_nodes or max(s.nodes for s in specs)
    t = slot_trace_len or max(s.trace_len for s in specs)
    bad = [s.name for s in specs
           if s.nodes > n or s.trace_len > t]
    if bad:
        raise ValueError(f"jobs {bad} exceed slot shape ({n}x{t})")
    return SystemConfig.scale(num_nodes=n, max_instrs=t,
                              queue_capacity=queue_capacity,
                              protocol=protocol)


# one phase callable per protocol, built once (JAX ``serve.py:135``)
_PHASE_CACHE: Dict[str, object] = {}


def protocol_phase(protocol: str):
    """message_phase override for a protocol: None for MESI (the
    handler core *is* MESI); the table-compiled phase otherwise
    (``analysis/protocol_table.table_message_phase``), which the waves
    vmap like the handlers."""
    if protocol == "mesi":
        return None
    if protocol not in _PHASE_CACHE:
        from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
            protocol_table)
        _PHASE_CACHE[protocol] = protocol_table.table_message_phase(
            protocol_table.TABLES[protocol]())
    return _PHASE_CACHE[protocol]


# trace synthesis is deterministic in the spec, so repeated serve()
# passes over the same stream (bench reps) re-ingest for free; a real
# service receives traces as data, so synthesis is not serving cost.
# Keyed by (spec, device type): a card pass draws through the threefry
# kernel, a CPU pass through its plain version.
_ARRAYS_CACHE: Dict[tuple, tuple] = {}


def _dev(device):
    from ue22cs343bb1_openmp_assignment_tpu_torch import device as _device
    return _device.resolve(device)


def build_job_arrays(job_cfg: SystemConfig, spec: JobSpec, device=None):
    """The job's instr arrays at its OWN geometry (host numpy), drawn
    on ``device`` (None: the card)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.models import workloads
    dev = _dev(device)
    key = (spec, dev.type)
    if key in _ARRAYS_CACHE:
        return _ARRAYS_CACHE[key]
    if spec.workload not in workloads.GENERATORS:
        raise ValueError(f"unknown workload {spec.workload!r}")
    gen = workloads.GENERATORS[spec.workload]
    op, addr, val, count = gen(spec.seed, job_cfg, spec.trace_len,
                               device=dev)
    arrays = tuple(a.cpu().numpy() for a in (op, addr, val, count))
    _ARRAYS_CACHE[key] = arrays
    return arrays


def pad_arrays(slot_cfg: SystemConfig, arrays):
    """Pad (op, addr, val, count) from job geometry to the slot's
    [slot_N, slot_T]: NOP-fill ops, zero addr/val, zero count on pad
    nodes (born exhausted — the frontend never fetches for them)."""
    op, addr, val, count = arrays
    n, t = op.shape
    N, T = slot_cfg.num_nodes, slot_cfg.max_instrs
    opP = np.full((N, T), int(Op.NOP), np.int32)
    adP = np.zeros((N, T), np.int32)
    vaP = np.zeros((N, T), np.int32)
    cnP = np.zeros((N,), np.int32)
    opP[:n, :t] = op
    adP[:n, :t] = addr
    vaP[:n, :t] = val
    cnP[:n] = count
    return opP, adP, vaP, cnP


# slot-shaped initial states are never written (set_state copies them
# into the batch), so admission reuses them across waves and passes;
# keyed by (spec, slot config, device)
_STATE_CACHE: Dict[tuple, object] = {}


def build_job_state(slot_cfg: SystemConfig, job_cfg: SystemConfig,
                    spec: JobSpec, device=None):
    """Slot-shaped SimState carrying the job's (padded) trace, on
    ``device`` (None: the card)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import state as st
    dev = _dev(device)
    key = (spec, slot_cfg, str(dev))
    if key not in _STATE_CACHE:
        padded = pad_arrays(slot_cfg, build_job_arrays(job_cfg, spec, dev))
        _STATE_CACHE[key] = st.init_state(slot_cfg, instr_arrays=padded,
                                          device=dev)
    return _STATE_CACHE[key]


def empty_state(slot_cfg: SystemConfig, device=None):
    """The dummy slot filler: zero traces, instantly quiescent."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import state as st
    dev = _dev(device)
    key = ("empty", slot_cfg, str(dev))
    if key not in _STATE_CACHE:
        _STATE_CACHE[key] = st.init_state(slot_cfg, device=dev)
    return _STATE_CACHE[key]


def host_state(state):
    """A SimState (one job or a batch) copied to the host: one copy a
    leaf, so per-job extraction after a wave is slicing on the host. A
    copy on the CPU too: a later in-place ``set_state`` on the batch
    does not reach it."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import state as st
    return st.from_leaves(tuple(x.to("cpu", copy=True)
                                for x in st.state_leaves(state)))


def extract_job_view(slot_cfg: SystemConfig, job_cfg: SystemConfig,
                     job_state):
    """Slice a finished slot back down to the job's own geometry.

    Row-slices every per-node plane to the job's num_nodes, remaps the
    slot invalid-address sentinel to the job's, and trims the directory
    bitvec to the job's word count (as uint32, the dump's words). The
    result formats through utils.golden byte-identically to a solo run
    of the job."""
    import types as _types
    n, W = job_cfg.num_nodes, job_cfg.bitvec_words

    def g(x):
        return x.cpu().numpy()
    ca = g(job_state.cache_addr)[:n]
    ca = np.where(ca == slot_cfg.invalid_address,
                  job_cfg.invalid_address, ca).astype(ca.dtype)
    return _types.SimpleNamespace(
        memory=g(job_state.memory)[:n],
        dir_state=g(job_state.dir_state)[:n],
        dir_bitvec=g(job_state.dir_bitvec)[:n, :, :W].view(np.uint32),
        cache_addr=ca,
        cache_val=g(job_state.cache_val)[:n],
        cache_state=g(job_state.cache_state)[:n])


def job_dumps(slot_cfg: SystemConfig, job_cfg: SystemConfig,
              job_state) -> List[str]:
    """Per-node golden-format state dumps for one extracted job."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.utils import golden
    view = extract_job_view(slot_cfg, job_cfg, job_state)
    return [golden.format_node_dump(d)
            for d in golden.state_to_dumps(job_cfg, view)]


def job_metrics_doc(job_state) -> dict:
    """cache-sim/metrics/v1 report for one extracted job slot."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import schema
    from ue22cs343bb1_openmp_assignment_tpu_torch.state import (
        SIM_METRIC_FIELDS)
    m = job_state.metrics
    md = {f: getattr(m, f).cpu().numpy().tolist() for f in SIM_METRIC_FIELDS}
    return schema.from_async(md, engine="async")


def job_digest(dumps: List[str], metrics: dict) -> str:
    """sha256 of one job's result: its per-node dumps and its metrics
    doc (the per-job fingerprint ``chip_smoke.py`` holds the card's
    serving runs to, computed by the JAX package's ``serve`` on the CPU
    in ``scripts/serve_reference.py``)."""
    import hashlib
    blob = json.dumps({"dumps": list(dumps), "metrics": metrics},
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def read_job_dumps(jdir, nodes: int) -> List[str]:
    """The dumps ``serve(out_dir=...)`` wrote for one job."""
    jdir = pathlib.Path(jdir)
    return [(jdir / f"core_{n}_output.txt").read_text()
            for n in range(nodes)]


def solo_dumps(spec: JobSpec, chunk: int = 32, max_cycles: int = 100_000,
               queue_capacity: int = 64, device=None) -> List[str]:
    """Reference: the job run alone at its own geometry (the parity
    oracle for the batched path), on ``device`` (None: the card)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import state as st
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        dump_view)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    from ue22cs343bb1_openmp_assignment_tpu_torch.utils import golden
    dev = _dev(device)
    cfg = job_config(spec, queue_capacity)
    s0 = st.init_state(cfg, instr_arrays=build_job_arrays(cfg, spec, dev),
                       device=dev)
    final = step.run_chunked_to_quiescence(
        cfg, s0, chunk, max_cycles, message_phase=protocol_phase(spec.protocol))
    return [golden.format_node_dump(d)
            for d in golden.state_to_dumps(cfg, dump_view(final))]


class SpanBook:
    """Host-side assembly of Dapper-style job-lifecycle spans.

    One span per job, advanced through the lifecycle ``submit ->
    queued -> admitted(wave, slot) -> running -> quiescent ->
    extracted`` by the wave loop (serve) or the open-loop scheduler
    (soak). Every timestamp defaults to ``clock.now()`` of the ONE
    injected clock (obs.clock) — the same time base as the wave
    records — and the three segment durations are computed here, in
    one place, from the lifecycle timestamps::

        queue_wait_s = t_admitted  - t_submit
        run_s        = t_quiescent - t_admitted
        extract_s    = t_extracted - t_quiescent
        e2e_s        = queue_wait_s + run_s + extract_s

    so the decomposition invariant (segments sum EXACTLY to e2e, the
    obs.txntrace convention) holds by construction —
    obs.schema.validate_serve_trace re-checks it on every emitted doc.
    """

    def __init__(self, clock) -> None:
        self.clock = clock
        self._open: Dict[str, dict] = {}
        self._done: List[dict] = []

    def _t(self, t: Optional[float]) -> float:
        return float(self.clock.now() if t is None else t)

    def submit(self, job: str, t: Optional[float] = None) -> None:
        t = self._t(t)
        self._open[job] = {"job": job, "t_submit": t, "t_queued": t}

    def queued(self, job: str, t: Optional[float] = None) -> None:
        self._open[job]["t_queued"] = self._t(t)

    def admitted(self, job: str, wave: int, slot: int,
                 t: Optional[float] = None) -> None:
        s = self._open[job]
        s["wave"] = int(wave)
        s["slot"] = int(slot)
        s["t_admitted"] = self._t(t)

    def running(self, job: str, t: Optional[float] = None) -> None:
        self._open[job]["t_running"] = self._t(t)

    def quiescent(self, job: str, ok: bool,
                  t: Optional[float] = None) -> None:
        s = self._open[job]
        s["quiesced"] = bool(ok)
        s["t_quiescent"] = self._t(t)

    def extracted(self, job: str, t: Optional[float] = None) -> None:
        s = self._open.pop(job)
        s["t_extracted"] = self._t(t)
        s["queue_wait_s"] = s["t_admitted"] - s["t_submit"]
        s["run_s"] = s["t_quiescent"] - s["t_admitted"]
        s["extract_s"] = s["t_extracted"] - s["t_quiescent"]
        s["e2e_s"] = s["queue_wait_s"] + s["run_s"] + s["extract_s"]
        self._done.append(s)

    def annotate(self, job: str, **fields) -> None:
        """Attach optional span fields (``lane``, ``bucket`` — the
        daemon's tenancy annotations, obs.schema._SPAN_OPT_KEYS) to an
        open span."""
        self._open[job].update(fields)

    def spans(self) -> List[dict]:
        """Closed spans, in extraction order."""
        return list(self._done)

    def prune(self, keep: int) -> int:
        """Drop all but the newest ``keep`` closed spans (the serving
        daemon's result-retention bound — latency summaries over a
        pruned book are a sliding window); returns the drop count."""
        drop = len(self._done) - keep
        if drop > 0:
            del self._done[:drop]
        return max(drop, 0)


def weighted_padding_waste(waves: List[dict]) -> float:
    """Summary padding_waste over per-wave records, weighted by each
    wave's slot instruction budget::

        1 - sum(real_instrs) / sum(slot_instr_budget)

    An unweighted mean of the per-wave ``padding_waste`` fractions
    over-counts small waves: with shape bucketing (daemon/bucketing)
    waves run at DIFFERENT slot budgets, and a tiny well-packed bucket
    wave must not cancel a huge badly-packed one. serve/soak/daemon
    summaries all report THIS number.
    """
    budget = sum(w["slot_instr_budget"] for w in waves)
    real = sum(w["real_instrs"] for w in waves)
    return 1.0 - real / budget if budget else 0.0


def serve_trace_doc(spans: List[dict], clock_kind: str) -> dict:
    """Closed spans → the validated ``cache-sim/serve-trace/v1`` doc
    (the machine surface; the Perfetto rendering of the same spans is
    obs.perfetto.build_serve_trace)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import (schema,
                                                             timeseries)
    doc = {
        "schema": schema.SERVE_TRACE_SCHEMA_ID,
        "clock": clock_kind,
        "jobs": len(spans),
        "latency": timeseries.latency_summary(
            [s["e2e_s"] for s in spans]),
        "spans": spans,
    }
    return schema.validate_serve_trace(doc)


def _host_quiescent(host) -> np.ndarray:
    """SimState.quiescent() per batch slot of a host copy, as numpy."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import state as st
    return st.batch_quiescent(host).numpy()


def serve(specs, slots: int = 4, slot_nodes: Optional[int] = None,
          slot_trace_len: Optional[int] = None, chunk: int = 32,
          max_cycles: int = 100_000, queue_capacity: int = 64,
          out_dir=None, quiet: bool = True, devices: int = 1,
          clock=None, device=None) -> dict:
    """Run a stream of jobs through fixed-shape batch waves on
    ``device`` (None: the card).

    Jobs are grouped by protocol (each protocol is its own wave
    sequence). Within a group, the first ``slots`` jobs are stacked into
    a batch; each wave runs every slot to quiescence (or the cycle
    budget); finished jobs are extracted and their slots refilled from
    the queue via ``state.set_state``.

    ``devices`` must be 1: sharding the batch axis over several cards
    is ROADMAP.md, Queue 1 item 6.

    ALL serving timing reads the injected ``clock`` (obs.clock;
    default the production MonotonicClock) — wave ``wall_s`` and the
    per-job lifecycle spans share that one time base, and a
    VirtualClock makes every timestamp (hence the whole trace doc)
    deterministic. Spans are assembled host-side (SpanBook) and ride
    the summary as ``doc["trace"]``, a validated
    ``cache-sim/serve-trace/v1`` doc; with ``out_dir`` the Perfetto
    rendering (flow arrows per job, obs.perfetto.build_serve_trace)
    lands at ``<out_dir>/trace.perfetto.json``.

    Returns the ``cache-sim/serve/v1`` summary doc; per-job results
    (dumps + metrics docs) are in ``doc["jobs"]`` and, when ``out_dir``
    is given, streamed to ``<out_dir>/<job>/`` as they finish. Any
    wave that reports mailbox-overflow drops (``mb_dropped``) warns
    LOUDLY on stderr even under ``quiet``: a dropped reply can leave
    its requester blocked forever, so drops usually explain a
    non-quiescing job.
    """
    from ue22cs343bb1_openmp_assignment_tpu_torch import state as st
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    from ue22cs343bb1_openmp_assignment_tpu_torch.utils import golden

    if devices < 1:
        raise ValueError("devices must be >= 1")
    if devices > 1:
        raise ValueError(f"devices={devices}: sharding the batch axis "
                         f"over several cards is not ported yet "
                         f"(ROADMAP.md, Queue 1 item 6)")
    dev = _dev(device)

    clock = clock if clock is not None else MonotonicClock()
    t_start = clock.now()
    book = SpanBook(clock)
    by_proto: Dict[str, List[JobSpec]] = {}
    for s in specs:
        # the whole stream is present at serve() entry (closed loop) —
        # every job submits and queues at t_start; the open-loop
        # arrival schedule is the soak harness's job (soak.py)
        book.submit(s.name, t_start)
        by_proto.setdefault(s.protocol, []).append(s)

    out_path = pathlib.Path(out_dir) if out_dir is not None else None
    job_docs: Dict[str, dict] = {}
    waves: List[dict] = []
    mb_dropped_total = 0

    for protocol, queue in by_proto.items():
        scfg = slot_config(queue, slot_nodes, slot_trace_len,
                           queue_capacity, protocol)
        phase = protocol_phase(protocol)
        N, T = scfg.num_nodes, scfg.max_instrs
        empty = empty_state(scfg, dev)
        queue = list(queue)

        # slot i currently holds job `occupant[i]` (None = empty dummy)
        occupant: List[Optional[JobSpec]] = [None] * slots
        real_by_slot = [0] * slots   # real (unpadded) instrs per slot
        states = []
        for i in range(slots):
            if queue:
                spec = queue.pop(0)
                occupant[i] = spec
                real_by_slot[i] = int(np.sum(build_job_arrays(
                    job_config(spec, queue_capacity), spec, dev)[3]))
                states.append(build_job_state(
                    scfg, job_config(spec, queue_capacity), spec, dev))
                book.admitted(spec.name, wave=len(waves) + 1, slot=i)
            else:
                states.append(empty)
        bstate = st.stack_states(states)

        while any(o is not None for o in occupant):
            real = sum(real_by_slot)
            t0 = clock.now()
            for o in occupant:
                if o is not None:
                    book.running(o.name, t0)
            bstate = step.run_wave_to_quiescence(
                scfg, bstate, chunk, max_cycles, phase)
            # ONE device->host copy a wave; per-job extraction below is
            # slicing on this copy
            host = host_state(bstate)
            quiet_mask = _host_quiescent(host)
            clock.on_wave()
            t_wave_end = clock.now()
            wave_s = t_wave_end - t0
            budget = slots * N * T
            finished = [o.name for o in occupant if o is not None]
            # per-slot mailbox-overflow drop counts (cumulative per job —
            # each occupied slot resolves this wave, so this is the
            # finishing jobs' total)
            occ = np.array([o is not None for o in occupant])
            wave_dropped = int(np.sum(
                host.metrics.msgs_dropped.numpy()[occ]))
            waves.append({
                "protocol": protocol,
                "jobs": finished,
                "wall_s": wave_s,
                "slot_instr_budget": budget,
                "real_instrs": real,
                "padding_waste": 1.0 - real / budget,
                "mb_dropped": wave_dropped,
            })
            mb_dropped_total += wave_dropped
            if wave_dropped:
                # loud on purpose, quiet or not: a silently dropped
                # reply leaves its requester blocked forever
                import sys
                print(f"serve: WARNING wave {len(waves)} [{protocol}] "
                      f"dropped {wave_dropped} mailbox message(s) on "
                      f"overflow (quirk 6) — raise --queue-capacity; "
                      f"affected jobs: {', '.join(finished)}",
                      file=sys.stderr)
            if not quiet:
                print(f"serve: wave {len(waves)} [{protocol}] "
                      f"jobs={len(finished)} wall={wave_s:.3f}s "
                      f"padding_waste={waves[-1]['padding_waste']:.3f}")

            # every slot resolves per wave: quiescent, or over budget
            # (recorded as failed and evicted either way)
            for i, spec in enumerate(occupant):
                if spec is None:
                    continue
                jstate = st.index_state(host, i)
                jcfg = job_config(spec, queue_capacity)
                doc = job_metrics_doc(jstate)
                ok = bool(quiet_mask[i])
                book.quiescent(spec.name, ok, t_wave_end)
                job_docs[spec.name] = {
                    "spec": dataclasses.asdict(spec),
                    "quiesced": ok,
                    "cycles": int(jstate.cycle),
                    "metrics": doc,
                }
                if out_path is not None:
                    jdir = out_path / spec.name
                    jdir.mkdir(parents=True, exist_ok=True)
                    view = extract_job_view(scfg, jcfg, jstate)
                    golden.write_dumps(jcfg, view, jdir)
                    (jdir / "metrics.json").write_text(
                        json.dumps(job_docs[spec.name], indent=2) + "\n")
                book.extracted(spec.name)
                # swap out; admit the next queued job into this slot
                if queue:
                    nxt = queue.pop(0)
                    occupant[i] = nxt
                    real_by_slot[i] = int(np.sum(build_job_arrays(
                        job_config(nxt, queue_capacity), nxt, dev)[3]))
                    bstate = st.set_state(bstate, i, build_job_state(
                        scfg, job_config(nxt, queue_capacity), nxt, dev))
                    book.admitted(nxt.name, wave=len(waves) + 1,
                                  slot=i)
                else:
                    # no replacement: leave the finished (quiescent =
                    # fixpoint) or budget-dead (cycle >= max_cycles =
                    # masked) state in place — the wave ignores both
                    occupant[i] = None
                    real_by_slot[i] = 0

    wall = clock.now() - t_start
    n_jobs = len(job_docs)
    spans = book.spans()
    doc = {
        "schema": SCHEMA_ID,
        "slots": slots,
        "devices": devices,
        "mb_dropped": mb_dropped_total,
        "jobs_total": n_jobs,
        "jobs_quiesced": sum(1 for d in job_docs.values() if d["quiesced"]),
        "waves": waves,
        "wave_count": len(waves),
        "wall_s": wall,
        "jobs_per_sec": (n_jobs / wall) if wall > 0 else 0.0,
        "padding_waste": weighted_padding_waste(waves),
        "jobs": job_docs,
        "trace": serve_trace_doc(spans, clock.kind),
    }
    if out_path is not None:
        out_path.mkdir(parents=True, exist_ok=True)
        (out_path / "serve_summary.json").write_text(
            json.dumps(doc, indent=2) + "\n")
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs import perfetto
        trace = perfetto.validate_trace(perfetto.build_serve_trace(spans))
        perfetto.write_trace(str(out_path / "trace.perfetto.json"), trace)
    return doc


def mixed_jobs(n: int, nodes: int = 4, trace_len: int = 8,
               protocol: str = "mesi",
               mix: Tuple[str, ...] = DEFAULT_MIX) -> List[JobSpec]:
    """The fixed traffic mix: n jobs cycling through ``mix`` workloads
    with seeds 0..n-1 (the jobs/sec measurement protocol)."""
    return [JobSpec(name=f"job{i:03d}", workload=mix[i % len(mix)],
                    nodes=nodes, trace_len=trace_len, seed=i,
                    protocol=protocol)
            for i in range(n)]


def main(argv=None) -> int:
    """``cache-sim-torch serve`` entry point."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="cache-sim-torch serve",
        description="batched multi-tenant serving: run a stream of "
                    "(config, trace) jobs in fixed-shape waves")
    ap.add_argument("--jobs", required=True,
                    help=".jsonl file or directory of .json job specs")
    ap.add_argument("--slots", type=int, default=4,
                    help="batch slots per wave (default 4)")
    ap.add_argument("--slot-nodes", type=int, default=None,
                    help="slot node count (default: max over jobs)")
    ap.add_argument("--slot-trace-len", type=int, default=None,
                    help="slot trace length (default: max over jobs)")
    ap.add_argument("--queue-capacity", type=int, default=64)
    ap.add_argument("--devices", type=int, default=1,
                    help="shard the batch axis over N local devices "
                         "(slots must divide evenly; default 1)")
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--max-cycles", type=int, default=100_000)
    ap.add_argument("--out-dir", default=None,
                    help="stream per-job dumps + metrics docs here")
    ap.add_argument("--json", action="store_true",
                    help="print the full serve summary doc as JSON")
    ap.add_argument("--cpu", action="store_true",
                    help="run the waves on the CPU (the plain PyTorch "
                         "path) instead of the card")
    args = ap.parse_args(argv)

    specs = load_jobs(args.jobs)
    doc = serve(specs, slots=args.slots, slot_nodes=args.slot_nodes,
                slot_trace_len=args.slot_trace_len, chunk=args.chunk,
                max_cycles=args.max_cycles,
                queue_capacity=args.queue_capacity,
                out_dir=args.out_dir, quiet=False,
                devices=args.devices,
                device="cpu" if args.cpu else None)
    if args.json:
        print(json.dumps(doc, indent=2))
    else:
        print(f"serve: {doc['jobs_quiesced']}/{doc['jobs_total']} jobs "
              f"quiesced in {doc['wave_count']} waves, "
              f"{doc['jobs_per_sec']:.2f} jobs/sec, "
              f"padding_waste={doc['padding_waste']:.3f}")
    return 0 if doc["jobs_quiesced"] == doc["jobs_total"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
