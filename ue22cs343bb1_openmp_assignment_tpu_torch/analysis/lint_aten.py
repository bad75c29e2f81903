"""IR-level lint: check the aten op stream a call dispatches, not source.

The port's counterpart of the JAX package's ``analysis/lint_jaxpr.py``
(a torch package has no jaxpr; the file takes another name). The AST
linter (``analysis/lint_trace.py``) sees source; this module runs the
real hot-path entry points once each under the dispatch record of
``obs/roofline.dispatch_run`` (a ``TorchDispatchMode``) and audits the
aten ops they dispatch, where every decision PyTorch acts on is
explicit. Under ``torch.func.vmap`` (the wave chunk) the mode sees the
physical ops of the batching rules.

* ``wide_dtype`` — no float64 result anywhere. Int64 results are
  counted per target against :data:`INT64_BUDGETS`: torch index ops
  take int64 indices and the uint32 helpers compute in int64, so some
  are the design, and a new one has to move its pin on purpose.
* ``dynamic_shape`` — no op whose output shape depends on the data
  (``nonzero``, ``masked_select``, ``unique``, an index or
  ``index_put_`` by a boolean mask): each one is a host sync and keeps a
  chunk from being captured as one CUDA graph.
* ``primitive_budget`` — the aten ops one call dispatches stay under
  ``EQN_BUDGET`` / ``EQN_BUDGETS`` (the port's measured counts with
  headroom, as JAX's). The count is N-independent (the vectorized
  design); a per-node Python loop multiplies it by N.
* ``host_callback`` — no device-to-host read inside a target
  (``_local_scalar_dense``: ``.item()``, ``int()``/``bool()`` on a
  tensor; a copy from the card to the CPU). Only a function marked
  ``# lint: host`` (the runners' chunk boundaries) may read, and only
  as often as the target allows: once a chunk.
* ``index_budget`` — the index sites of a target (``analysis/
  indexcheck.py``) equal their exact pin in ``indexcheck.INDEX_BUDGETS``.

:func:`replay_guard` is the counterpart of JAX's ``recompile_guard``.
A CUDA graph of a chunk needs an aten op stream that is the same on
every call of the same shape, so two same-shape calls of each engine
(the async cycle, the sync and deep rounds, two heterogeneous waves of
one slot shape, two warm ``serve()`` runs) must give one op-stream
fingerprint (``roofline.hlo_fingerprint``); the native engine's
content-hash build cache must serve a second construction without
compiling; and on the card a second load of every kernel library the
main paths use must run ``nvcc`` 0 times.
"""
# lint: host

from __future__ import annotations

import dataclasses
import hashlib
import os
import pathlib
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig

SCHEMA = "cache-sim/jaxpr-lint/v1"

#: aten-op ceiling of a linted call (measured 692-711 for one async
#: cycle at N = 4..32; 1024 leaves headroom for growth and trips on any
#: O(N) unrolling)
EQN_BUDGET = 1024

#: per-target overrides of EQN_BUDGET. The runners are Python loops, so
#: their op streams are the cycle's times the cycle count; the rounds
#: are single calls whose plain folds loop over the window in Python.
#: Measured counts (N = 4..32, both inv_modes) in the comments; each pin
#: leaves about a third again of headroom and trips long before a
#: per-node loop would.
EQN_BUDGETS = {
    "step.run_cycles[8]": 8192,              # 5536-5688
    "step.run_cycles_ledger[8]": 8192,       # 5768-5920
    "step.run_cycles_profile[8]": 10240,     # 6604-6788
    "step.run_to_quiescence": 4096,          # 4 cycles: 2815-2899
    "step.run_wave_chunk[2x4]": 5120,        # 3471-3511
    "sync_engine.round_step": 4096,          # 3095
    "sync_engine.round_step[deep]": 20480,   # 15316
    "deep_round_kernel.fused_round": 20480,  # 15285
}

#: int64 results of a call, pinned at the most either inv_mode measured
#: (the uint32 helpers of state.py compute in int64; torch index ops take
#: int64 indices): a new int64 value has to move its pin on purpose
INT64_BUDGETS = {
    "step.cycle": 122,
    "mailbox.dequeue": 2,
    "step.run_cycles[8]": 976,
    "step.run_cycles_ledger[8]": 984,
    "step.run_cycles_profile[8]": 1064,
    "step.run_to_quiescence": 488,
    "step.run_wave_chunk[2x4]": 660,
    "sync_engine.round_step": 134,
    "sync_engine.round_step[deep]": 401,
    "deep_round_kernel.fused_round": 400,
    "rdma_comm.route": 16,
}

_PKG = pathlib.Path(__file__).resolve().parents[1]
#: frames of the recorder itself never name a site
_RECORDER = {str(_PKG / "analysis" / "lint_aten.py"),
             str(_PKG / "analysis" / "indexcheck.py"),
             str(_PKG / "obs" / "roofline.py")}

#: aten index ops (the JAX gather / scatter* / dynamic_slice family)
INDEX_OPS = frozenset({
    "index", "index_put", "index_put_", "_index_put_impl_", "gather",
    "scatter", "scatter_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_", "index_select", "index_add",
    "index_add_", "index_copy", "index_copy_", "index_fill",
    "index_fill_", "take", "take_along_dim", "put", "put_"})
#: the index ops that write their operand 0 (the scatters)
SCATTER_OPS = frozenset(o for o in INDEX_OPS if o.startswith(
    ("index_put", "_index_put", "scatter", "index_add", "index_copy",
     "index_fill", "put")))
#: ops whose output shape depends on the data
DYNAMIC_OPS = frozenset({"nonzero", "masked_select", "unique", "_unique",
                         "_unique2", "unique_dim", "unique_consecutive",
                         "unique_dim_consecutive", "argwhere"})
#: operand-0 passthrough ops for provenance: the result is (a rewrite
#: of) the first operand
_CHAIN_OPS = frozenset({"_to_copy", "clone", "copy", "lift_fresh",
                        "lift_fresh_copy", "detach", "alias",
                        "_unsafe_view", "fill_", "zero_",
                        "masked_fill", "masked_fill_"}) | INDEX_OPS


def _h(parts) -> str:
    return hashlib.sha256("\x1f".join(parts).encode()).hexdigest()[:12]


def _scalar(x) -> str:
    """A non-tensor argument in a device-independent form."""
    if isinstance(x, torch.device):
        return "device"
    return repr(x)


@dataclasses.dataclass
class _Value:
    roots: frozenset     # the named inputs it derives from
    term: str            # the buffer its operand-0 chain ends in
    sig: str             # structural hash of its producing sub-DAG


def _shape_str(t) -> str:
    short = {"int32": "i32", "int64": "i64", "int16": "i16", "int8": "i8",
             "uint8": "u8", "bool": "b1", "float32": "f32",
             "float64": "f64"}
    dt = str(t.dtype).replace("torch.", "")
    return f"{short.get(dt, dt)}[{','.join(str(d) for d in t.shape)}]"


def leaf_names(obj, prefix: str = "") -> list:
    """(name, tensor) of every tensor reachable from ``obj``: dataclass
    fields by name (``metrics.cycles``), dict keys, sequence positions
    and ``__slots__`` (a ``SyncMetrics``' buffer as ``metrics``)."""
    out = []
    if isinstance(obj, torch.Tensor):
        out.append((prefix or "arg", obj))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            out += leaf_names(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            out += leaf_names(v, f"{prefix}[{i}]")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            out += leaf_names(getattr(obj, f.name),
                              f"{prefix}.{f.name}" if prefix else f.name)
    elif hasattr(type(obj), "__slots__"):
        for s in type(obj).__slots__:
            out += leaf_names(getattr(obj, s, None), prefix)
    return out


def _host_marked(code) -> bool:
    """The ``lint_trace`` host mark of a function: ``# lint: host`` on
    its ``def`` line or the line above, or ``host-side`` in its
    docstring."""
    import linecache
    ln = code.co_firstlineno
    for i in (ln - 1, ln):
        if "lint: host" in linecache.getline(code.co_filename, i):
            return True
    doc = code.co_consts[0] if code.co_consts else None
    return isinstance(doc, str) and ("host-side" in doc.lower()
                                     or "host side" in doc.lower())


def _site():
    """(key, label, host_ok) of the current op: the port's frames on the
    stack (outermost first) as (file, function, bytecode offset), so one
    Python operation run in a loop is one site; the innermost frame as
    ``file:line function``; whether that frame is host-marked."""
    f = sys._getframe(2)
    frames = []
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(str(_PKG)) and fn not in _RECORDER:
            frames.append(f)
        f = f.f_back
    if not frames:
        return ("?",), "?", False
    key = tuple((os.path.relpath(fr.f_code.co_filename, _PKG),
                 fr.f_code.co_name, fr.f_lasti) for fr in reversed(frames))
    inner = frames[0]
    label = (f"{os.path.relpath(inner.f_code.co_filename, _PKG)}:"
             f"{inner.f_lineno} {inner.f_code.co_name}")
    return key, label, _host_marked(inner.f_code)


class AtenTrace:
    """The observer ``roofline.dispatch_run`` feeds: every aten op of
    one call with its provenance (the named inputs each value derives
    from, the buffer its operand-0 chain ends in, a structural hash of
    its producing sub-DAG: no tensor identity or device enters it), the
    index ops with their sites and shapes, the host reads, the dtype and
    dynamic-shape findings and the port's kernel launches."""

    def __init__(self, names=None):
        self.names = names       # callable(copied args) -> [(name, t)]
        self.vals: List[_Value] = []
        # tensor id -> value; no reference is kept (holding the outputs
        # would change what PyTorch dispatches: a kept factory result
        # comes back through a detach). An id freed and reused names a
        # new tensor only after the op that made it registered it.
        self.ref: Dict[int, int] = {}
        self.ops = 0
        self.int64 = 0
        self.wide: List[str] = []
        self.dynamic: List[str] = []
        self.host: List[dict] = []
        self.index: List[dict] = []
        self.kernels: Dict[str, int] = {}
        self._free = 0

    def start(self, args) -> None:
        named = self.names(args) if self.names else [
            x for i, a in enumerate(args)
            for x in leaf_names(a, "" if not hasattr(a, "shape")
                                else f"arg{i}")]
        for name, t in named:
            self._new(t, _Value(frozenset([name]), name,
                                _h(["in", name])))

    def _new(self, t, val: _Value) -> int:
        self.vals.append(val)
        i = self.ref[id(t)] = len(self.vals) - 1
        return i

    def _val(self, t) -> int:
        i = self.ref.get(id(t))
        if i is None:
            self._free += 1
            i = self._new(t, _Value(frozenset(["const"]),
                                    f"free#{self._free}",
                                    _h(["free", _shape_str(t)])))
        return i

    def _flat(self, xs, ins: list, parts: list) -> None:
        for x in xs:
            if isinstance(x, torch.Tensor):
                i = self._val(x)
                ins.append(i)
                parts.append(self.vals[i].sig)
            elif isinstance(x, (list, tuple)):
                parts.append("(")
                self._flat(x, ins, parts)
                parts.append(")")
            else:
                parts.append(_scalar(x))

    def kernel(self, name: str, launches: int) -> None:
        self.kernels[name] = self.kernels.get(name, 0) + launches

    def op(self, func, args, kwargs, out) -> None:
        self.ops += 1
        packet = func._schema.name.split("::")[-1]
        ins, parts = [], [packet, func._overloadname]
        self._flat(args, ins, parts)
        if kwargs:
            for k in sorted(kwargs):
                parts.append(k)
                self._flat((kwargs[k],), ins, parts)
        outs = [o for o in (out if isinstance(out, (list, tuple))
                            else (out,)) if isinstance(o, torch.Tensor)]
        vals = self.vals
        chain = func.is_view or packet in _CHAIN_OPS
        if chain and ins:
            roots, term = vals[ins[0]].roots, vals[ins[0]].term
        else:
            pick = ins[1:] if packet == "where" and len(ins) > 1 else ins
            roots = frozenset().union(*(vals[i].roots for i in pick)) \
                if pick else frozenset()
            term = f"{packet}@{self.ops}"
        sig = _h(parts)
        for pos, o in enumerate(outs):
            self._new(o, _Value(roots, term, sig if pos == 0
                                else _h([sig, str(pos)])))
            if o.dtype == torch.float64:
                self.wide.append(f"{packet} output {_shape_str(o)}")
            elif o.dtype == torch.int64:
                self.int64 += 1
        idx_tensors = _index_args(packet, args)
        if packet in DYNAMIC_OPS or (
                packet in ("index", "index_put", "index_put_",
                           "_index_put_impl_")
                and any(t.dtype == torch.bool for t in idx_tensors)) or (
                packet == "repeat_interleave"
                and "Tensor" in func._overloadname):
            self.dynamic.append(packet)
        if packet == "_local_scalar_dense" or (
                any(isinstance(a, torch.Tensor) and a.is_cuda
                    for a in args)
                and any(o.device.type == "cpu" for o in outs)):
            key, label, ok = _site()
            self.host.append({"op": packet, "site": label, "host_ok": ok})
        if packet in INDEX_OPS:
            key, label, _ = _site()
            self.index.append(self._index_record(packet, args, kwargs,
                                                 idx_tensors, key, label))

    def _index_record(self, packet, args, kwargs, idx, key, label) -> dict:
        operand = args[0]
        n = 1
        if idx:
            shape = torch.broadcast_shapes(*(t.shape for t in idx))
            for d in shape:
                n *= int(d)
        rec = {"primitive": packet, "key": key, "site": label,
               "operand": _shape_str(operand),
               "roots": sorted(self.vals[self.ref[id(operand)]].roots),
               "indices": n,
               "index_shape": ",".join(_shape_str(t) for t in idx),
               "index_sig": _h([self.vals[self._val(t)].sig for t in idx])}
        if packet in SCATTER_OPS:
            upd = _update_arg(packet, args, kwargs)
            rec["update"] = "-" if upd is None else _shape_str(upd)
            rec["dest"] = self.vals[self.ref[id(operand)]].term
        return rec

    def sites(self) -> List[dict]:
        """The index sites of the call in first-execution order, each with
        its trip weight (executions) and indices (summed over them); a
        kernel launch of the port is one opaque site per kernel."""
        by_key: Dict[tuple, dict] = {}
        for r in self.index:
            s = by_key.get(r["key"])
            if s is None:
                s = by_key[r["key"]] = dict(r, trip_weight=0, indices=0)
            s["trip_weight"] += 1
            s["indices"] += r["indices"]
        out = list(by_key.values())
        for k, n in sorted(self.kernels.items()):
            out.append({"primitive": "kernel", "key": ("kernel", k),
                        "site": f"kernel {k}", "operand": "-",
                        "roots": [], "indices": n, "index_shape": "-",
                        "index_sig": None, "trip_weight": n,
                        "kernel": k})
        return out


def _index_args(packet: str, args) -> list:
    """The index tensors of an index op (the ``indices`` list of
    ``index`` / ``index_put_``, the ``index`` of the others)."""
    if packet not in INDEX_OPS:
        return []
    if packet in ("index", "index_put", "index_put_", "_index_put_impl_"):
        return [t for t in args[1] if isinstance(t, torch.Tensor)]
    if packet in ("take", "put", "put_", "take_along_dim"):
        return [args[1]]
    return [a for a in args[1:] if isinstance(a, torch.Tensor)][:1]


def _update_arg(packet: str, args, kwargs):
    tens = [a for a in args[1:] if isinstance(a, torch.Tensor)]
    if packet in ("index_put", "index_put_", "_index_put_impl_"):
        return args[2]
    if len(tens) >= 2:
        return tens[1]
    for k in ("src", "source", "values", "value"):
        if isinstance((kwargs or {}).get(k), torch.Tensor):
            return kwargs[k]
    return None


@dataclasses.dataclass
class Call:
    """One linted target: ``fn(*args)``; ``names`` names the copied
    arguments' tensors (default: their leaf names); ``host_reads``
    gives, from the result, the host reads the call may make (default
    none)."""
    fn: Callable
    args: tuple
    names: Optional[Callable] = None
    host_reads: Optional[Callable] = None


def record(call: Call, cfg=None):
    """Run the call once under the dispatch record; ``(output, trace,
    fingerprint)``."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import roofline
    trace = AtenTrace(call.names)
    # the walkers count launches, not bytes: no kernel contract needed
    none = {k: (0, 0) for k in bench.counted_wrappers()}
    out, ctr, _, _ = roofline.dispatch_run(call.fn, call.args, cfg,
                                           contracts=none, observer=trace)
    return out, trace, roofline.hlo_fingerprint(ctr.text())


def _trivial_traces(cfg):
    return [[(0, 1, 0)]] * cfg.num_nodes


def _named_state(state_names):
    return lambda args: leaf_names(args[0]) if state_names is None \
        else state_names(args)


def targets(cfg: SystemConfig, device, probe_nodes: int) -> Dict[str, Call]:
    """The linted hot paths (JAX ``lint_jaxpr._targets``): the async
    cycle and its runners at ``cfg``, and at ``probe_nodes`` the
    engines of the index auditor (the sync and deep rounds, the deep
    round's host wrapper around the fused round, the routed delivery's
    router)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import indexcheck
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import mailbox, step
    from ue22cs343bb1_openmp_assignment_tpu_torch.state import init_state

    st = init_state(cfg, _trivial_traces(cfg), device=device)

    def on_state(fn, host_reads=None):
        return Call(fn, (st,), host_reads=host_reads)

    out = {
        "step.cycle": on_state(lambda s: step.cycle(cfg, s)),
        "mailbox.dequeue": on_state(lambda s: mailbox.dequeue(cfg, s)),
        "step.run_cycles[8]": on_state(
            lambda s: step.run_cycles(cfg, s, 8)),
        # the litmus / axiomatic capture path: the ledger planes with the
        # observed-value tape (with_obs) must stay as cheap as the runner
        "step.run_cycles_ledger[8]": on_state(
            lambda s: step.run_cycles_ledger(cfg, s, 8, None, True)),
        "step.run_cycles_profile[8]": on_state(
            lambda s: step.run_cycles_profile(cfg, s, 8)),
        # chunk 1: one quiescence read a cycle and one more at the end;
        # 4 cycles (the trivial traces need more at any N), so the op
        # stream is N-independent
        "step.run_to_quiescence": on_state(
            lambda s: step.run_to_quiescence(cfg, s, 4),
            host_reads=lambda out: int(out.cycle) + 1),
    }
    out.update(indexcheck.engine_targets("wave", cfg.num_nodes, device,
                                         cfg=cfg))
    for engine in ("sync", "deep", "fused"):
        out.update(indexcheck.engine_targets(engine, probe_nodes, device))
    out.update(indexcheck.route_target(probe_nodes, device))
    return out


def _audit(name: str, trace: AtenTrace, call: Call, result,
           findings: List[dict]) -> None:
    seen = set()
    for w in trace.wide:
        if w not in seen:
            seen.add(w)
            findings.append({"target": name, "rule": "wide_dtype",
                             "detail": w})
    pin = INT64_BUDGETS.get(name)
    if pin is not None and trace.int64 > pin:
        findings.append({"target": name, "rule": "wide_dtype",
                         "detail": f"{trace.int64} int64 results > "
                                   f"pinned {pin} (INT64_BUDGETS)"})
    for d in sorted(set(trace.dynamic)):
        findings.append({"target": name, "rule": "dynamic_shape",
                         "detail": f"{d}: output shape depends on the "
                                   "data"})
    allowed = call.host_reads(result) if call.host_reads else 0
    bad = [h for h in trace.host if not h["host_ok"]]
    for h in bad:
        findings.append({"target": name, "rule": "host_callback",
                         "detail": f"{h['op']} at {h['site']} (not a "
                                   "`# lint: host` boundary)"})
    if not bad and len(trace.host) > allowed:
        findings.append({"target": name, "rule": "host_callback",
                         "detail": f"{len(trace.host)} host reads > "
                                   f"{allowed} allowed (once a chunk)"})


def lint(cfg: Optional[SystemConfig] = None, device=None,
         probe_nodes: Optional[int] = None) -> dict:
    """Record and audit every hot-path target on ``device`` (None: the
    card); returns {targets: {name: aten ops}, findings, budget, ok}.
    ``cfg`` (default: the reference config) sizes the async targets;
    the engine probes run at the index auditor's size, or the config's
    when it is larger."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import device as _device
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import indexcheck

    cfg = cfg or SystemConfig.reference()
    dev = _device.resolve(device)
    if probe_nodes is None:
        probe_nodes = max(cfg.num_nodes, indexcheck.DEFAULT_NODES)
    findings: List[dict] = []
    counts, index_sites, int64, kernels, secs = {}, {}, {}, {}, {}
    for name, call in targets(cfg, dev, probe_nodes).items():
        t0 = time.perf_counter()
        out, trace, _ = record(call)
        secs[name] = round(time.perf_counter() - t0, 3)
        counts[name] = trace.ops
        int64[name] = trace.int64
        if trace.kernels:
            kernels[name] = dict(trace.kernels)
        budget = EQN_BUDGETS.get(name, EQN_BUDGET)
        if trace.ops > budget:
            findings.append({"target": name, "rule": "primitive_budget",
                             "detail": f"{trace.ops} aten ops > budget "
                                       f"{budget}"})
        _audit(name, trace, call, out, findings)
        ibudget = indexcheck.index_budget(name, cfg.inv_mode, dev.type)
        if ibudget is not None:
            sites = len(trace.sites())
            index_sites[name] = sites
            if sites != ibudget:
                findings.append({
                    "target": name, "rule": "index_budget",
                    "detail": (f"{sites} index sites != pinned {ibudget}"
                               " (aten index ops and kernel launches; run"
                               " `cache-sim-torch analyze --index` for the"
                               " plane-attributed inventory, then re-pin"
                               " analysis/indexcheck.INDEX_BUDGETS if"
                               " intended)")})
    return {"schema": SCHEMA, "num_nodes": cfg.num_nodes,
            "probe_nodes": probe_nodes, "device": dev.type,
            "budget": EQN_BUDGET, "budget_overrides": dict(EQN_BUDGETS),
            "index_budgets": dict(indexcheck.INDEX_BUDGETS),
            "targets": counts, "index_sites": index_sites,
            "int64_results": int64, "kernel_launches": kernels,
            "seconds": secs, "findings": findings, "ok": not findings}


def _fingerprint(fn, *args) -> str:
    return record(Call(fn, args))[2]


def replay_guard(cfg: Optional[SystemConfig] = None, device=None) -> dict:
    """Two same-shape calls of each engine must dispatch one op stream
    (the precondition of a CUDA graph of a chunk), the native build
    cache must serve a second engine, and on the card a second load of
    every main-path kernel library must run nvcc 0 times."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import device as _device
    from ue22cs343bb1_openmp_assignment_tpu_torch import serve as serve_mod
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import indexcheck
    from ue22cs343bb1_openmp_assignment_tpu_torch.native import bindings
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs.clock import (
        VirtualClock)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    from ue22cs343bb1_openmp_assignment_tpu_torch.state import (
        init_state, stack_states)

    cfg = cfg or SystemConfig.reference(num_nodes=2)
    dev = _device.resolve(device)
    traces = [[(1, 1, 7)], [(0, 1, 0)]][:cfg.num_nodes]
    traces += [[(0, 1, 0)]] * (cfg.num_nodes - len(traces))
    other = list(reversed(traces))

    def st(tr):
        return init_state(cfg, tr, device=dev)

    pairs, secs = {}, {}

    def pair(name, fn, a, b):
        t0 = time.perf_counter()
        pairs[name] = [_fingerprint(fn, a), _fingerprint(fn, b)]
        secs[name] = round(time.perf_counter() - t0, 3)

    pair("async", lambda s: step.cycle(cfg, s), st(traces), st(other))
    pair("sync", lambda s: se.round_step(cfg, s),
         se.from_sim_state(cfg, st(traces)),
         se.from_sim_state(cfg, st(other)))
    dcfg = indexcheck.engine_config("deep", max(cfg.num_nodes, 2))
    pair("deep", lambda s: se.round_step(dcfg, s),
         se.from_sim_state(dcfg, init_state(
             dcfg, _trivial_traces(dcfg), device=dev)),
         se.from_sim_state(dcfg, init_state(
             dcfg, [[(1, 0, 3)]] * dcfg.num_nodes, device=dev)))
    # two heterogeneous waves of one slot shape (serve.py's admission
    # loop swaps jobs into the same shape)
    pair("wave", lambda b: step.batched_wave_chunk(cfg, b, 4, 64),
         stack_states([st(traces), init_state(cfg, device=dev)]),
         stack_states([st(other), st(traces)]))
    # the serving layer end to end: serve() runs over one heterogeneous
    # stream on a virtual clock. The first run draws the jobs' traces
    # (serve keeps them for the next run of the same specs), so the
    # pair is the second and third run: a warm run must add nothing
    specs = [serve_mod.JobSpec(name=f"g{i:02d}", workload=wl,
                               nodes=cfg.num_nodes, trace_len=4)
             for i, wl in enumerate(("uniform", "hotspot", "uniform"))]

    def serve_run(_):
        return serve_mod.serve(specs, slots=2, chunk=6, max_cycles=50_001,
                               clock=VirtualClock(), device=dev)
    t0 = time.perf_counter()
    serve_run(None)
    secs["serve_warm"] = round(time.perf_counter() - t0, 3)
    pair("serve", serve_run, None, None)

    # the native build cache is content-hash keyed: a second engine must
    # reuse the compiled library (same path, mtime unmoved)
    t0 = time.perf_counter()
    eng1 = bindings.NativeEngine(cfg)
    path = bindings._lib_path()
    mtime = os.path.getmtime(path)
    eng2 = bindings.NativeEngine(cfg)
    n_ok = bindings._lib_path() == path and os.path.getmtime(path) == mtime
    del eng1, eng2
    secs["native"] = round(time.perf_counter() - t0, 3)

    nvcc_runs = None
    if dev.type == "cuda":
        from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
            kernelcheck)
        from ue22cs343bb1_openmp_assignment_tpu_torch.ops import kernel_build
        jobs = kernelcheck.library_jobs()
        kernel_build.build(jobs)
        before = kernel_build.build.nvcc_runs
        for lib, c in jobs:
            lib._loaded.clear()
            lib.load(c)
        nvcc_runs = kernel_build.build.nvcc_runs - before

    same = {k: v[0] == v[1] for k, v in pairs.items()}
    return {"fingerprints": pairs, "same_stream": same, "seconds": secs,
            "native_build_reused": bool(n_ok),
            "kernel_nvcc_runs": nvcc_runs,
            "ok": (all(same.values()) and bool(n_ok)
                   and nvcc_runs in (None, 0))}
