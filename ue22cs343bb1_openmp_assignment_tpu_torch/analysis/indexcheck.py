"""Index-pressure auditor: gather/scatter attribution per engine.

The port of the JAX package's ``analysis/indexcheck.py``, the analyze
prong behind ``cache-sim-torch analyze --index``. Where JAX walks the
closed jaxpr of each hot body for its index equations, this module runs
each hot body once under the dispatch record (``analysis/lint_aten``
over ``obs/roofline.dispatch_run``) and inventories the aten index ops
it dispatches (``index``, ``index_put_``, ``gather``, ``scatter*``,
``index_select``, ``index_add_``, ``take*``):

* **sites and shapes** — a site is one Python operation (the chain of
  the port's frames down to it, by bytecode offset): an op inside a
  Python loop is one site with a trip weight (its executions), as an
  equation inside a JAX ``scan`` is. Each site records its operand,
  index and update shapes and the indices it consumes (the broadcast
  size of its index tensors, summed over its executions). On the card a
  target that takes a kernel route launches the port's CUDA kernels,
  which the dispatcher cannot see into: each kernel is one opaque site,
  counted by its wrapper's launch counter (``bench.counted_wrappers``).
* **plane attribution** — each op's operand 0 is walked back through
  the recorded ops to the state leaves it derives from (operand-0
  chains through views, copies and scatters; unions at genuine fan-in;
  ``where``'s predicate ignored), and the leaf names map onto JAX's
  semantic planes: cache / directory / mailbox / arbitration /
  telemetry / frontend / window.
* **indices per retired instruction** — a small deterministic probe
  run per engine (uniform workload, seed 0) pins (steps, retired), the
  same integers as the JAX package's ``_probe``; the hot body's
  weighted index count a step divides through.
* **mergeable-scatter candidates** — scatter sites of one target whose
  index operands have the same structural signature (a hash of the
  producing ops down to the input names and the scalar arguments) and
  whose destinations are distinct buffers: the shape to pack into one
  row scatter.

:data:`INDEX_BUDGETS` pins each target's index sites exactly on the CPU
(:data:`CARD_INDEX_BUDGETS` the kernel-route targets' on the card),
enforced here and in ``lint_aten``'s ``index_budget`` rule. The seeded
mutation ``INDEX_MUTATIONS.split_packed_scatter`` flips
``ops.step._PACKED_COMMIT`` to a bit-identical per-plane commit: every
dynamic oracle stays green, and only this prong (a budget breach and
merge candidates naming the split planes) sees it.

``check()`` returns a findings-aggregated dict under :data:`SCHEMA`,
``render_text`` the human report; exit codes ride ``cache-sim-torch
analyze``'s 0/1/3 (a probe that hits its cycle budget before quiescence
is "budget exhausted, nothing proven").
"""
# lint: host

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig

SCHEMA = "cache-sim/indexcheck/v1"

#: engines the auditor covers; ``async`` also carries the routed
#: delivery's router
ENGINES = ("async", "sync", "deep", "wave", "fused")

#: canonical audit size: the budgets hold at this node count (and, the
#: sites being N-independent, at any other: tests/test_torch_indexcheck)
DEFAULT_NODES = 8

#: per-target index-site pins on the CPU (exact: a new index site fails
#: the gate; re-pin on purpose), at ``inv_mode="scatter"``
INDEX_BUDGETS = {
    "step.cycle": 23,
    "step.run_cycles[8]": 23,
    "step.run_wave_chunk[2x4]": 23,
    "sync_engine.round_step": 7,
    "sync_engine.round_step[deep]": 9,
    "deep_round_kernel.fused_round": 8,
    "rdma_comm.route": 9,
}

#: the targets that take a kernel route on the card, pinned there: the
#: aten index sites around the launches plus one opaque site a kernel
#: (the deep round's 9 aten sites and the three fold kernels; the fused
#: round's window build has none; the router's 9 and the ring kernel)
CARD_INDEX_BUDGETS = {
    "sync_engine.round_step[deep]": 12,
    "deep_round_kernel.fused_round": 1,
    "rdma_comm.route": 10,
}

#: sites are N-independent but not inv_mode-independent: the reference
#: config's ``inv_mode="mailbox"`` (where ``lint_aten`` lints the async
#: targets) sends invalidations through the mailbox instead of the
#: cycle's scatter-mode INV lookups
_MAILBOX_DELTA = {
    "step.cycle": -2,
    "step.run_cycles[8]": -2,
    "step.run_wave_chunk[2x4]": -2,
}


def index_budget(target: str, inv_mode: str = "scatter",
                 device_type: str = "cpu"):
    """Pinned index-site count of ``target`` under ``inv_mode`` on a
    ``device_type`` device, or None when the target has no pin."""
    table = INDEX_BUDGETS
    if device_type == "cuda" and target in CARD_INDEX_BUDGETS:
        table = CARD_INDEX_BUDGETS
    b = table.get(target)
    if b is not None and inv_mode == "mailbox":
        b += _MAILBOX_DELTA.get(target, 0)
    return b


_PLANE_EXACT = {
    "memory": "directory", "dir_state": "directory",
    "dir_bitvec": "directory", "dm": "directory", "dm0": "directory",
    "arb_rank": "arbitration", "order_rank": "arbitration",
    "seed": "arbitration", "issue_delay": "arbitration",
    "issue_period": "arbitration", "params": "arbitration",
    "round": "arbitration",
    "hor": "window", "horizon": "window",
}

_PLANE_PREFIX = (
    ("cache", "cache"), ("ca_t", "cache"), ("cv_t", "cache"),
    ("cs_t", "cache"),
    ("mb_", "mailbox"), ("msg", "mailbox"),
    ("metrics", "telemetry"), ("obs", "telemetry"),
    ("lat", "telemetry"),
    ("instr", "frontend"), ("cur_", "frontend"), ("idx", "frontend"),
    ("waiting", "frontend"),
    ("w_", "window"),
)


def plane_of(root: str) -> str:
    head = root.lstrip(".").split(".", 1)[0].split("[", 1)[0]
    if head in _PLANE_EXACT:
        return _PLANE_EXACT[head]
    for prefix, plane in _PLANE_PREFIX:
        if head.startswith(prefix):
            return plane
    return "other"


def planes(roots) -> List[str]:
    ps = sorted({plane_of(r) for r in roots if r not in ("const",)})
    if len(ps) > 3:
        return ["mixed"]          # genuine fan-in of most of the state
    return ps or ["other"]


def inventory(trace, target: str) -> List[dict]:
    """The index sites of one recorded call (``lint_aten.AtenTrace``),
    in first-execution order (no tensor identity anywhere: stable across
    runs and devices)."""
    ops = []
    for s in trace.sites():
        rec = {"primitive": s["primitive"], "scope": target,
               "site": s["site"],
               "plane": "+".join(planes(s["roots"])),
               "operand": s["operand"], "trip_weight": s["trip_weight"],
               "indices": s["indices"]}
        if s["primitive"] == "kernel":
            rec["plane"] = "kernel"
        else:
            rec["index_shape"] = s["index_shape"]
            rec["index_sig"] = s["index_sig"]
        if "update" in s:
            rec["update"] = s["update"]
            rec["roots"] = s["roots"][:6]
            rec["dest"] = s["dest"]
        ops.append(rec)
    return ops


def merge_candidates(ops: List[dict]) -> List[dict]:
    """Scatter sites sharing one structural index signature in one
    scope, writing distinct destination buffers: pack the planes and
    commit one row scatter. Writes chained into one buffer share a
    destination and are excluded (one logical write stream)."""
    groups: Dict[tuple, List[dict]] = {}
    for rec in ops:
        if "dest" not in rec:
            continue
        key = (rec["scope"], rec.get("index_sig"), rec.get("update"))
        groups.setdefault(key, []).append(rec)
    out = []
    for (scope, sig, update), members in sorted(
            groups.items(), key=lambda kv: tuple(map(str, kv[0]))):
        if sig is None or len(members) < 2:
            continue
        kept, seen = [], set()
        for m in members:
            if m["dest"] in seen:
                continue
            seen.add(m["dest"])
            kept.append(m)
        if len(kept) < 2:
            continue
        pls = sorted({m["plane"] for m in kept})
        dests = sorted(m["dest"] for m in kept)
        out.append({
            "kind": "merge_candidate", "scope": scope,
            "index_sig": sig, "count": len(kept),
            "planes": pls, "dests": dests, "update": update,
            "detail": (f"{len(kept)} scatters in {scope} share index "
                       f"sig {sig} with distinct dests "
                       f"[{', '.join(dests)}] — pack the planes and "
                       f"commit one row scatter"),
        })
    return out


# ---------------------------------------------------------------------------
# engine targets + probes
# ---------------------------------------------------------------------------

def engine_config(engine: str, nodes: int) -> SystemConfig:
    """The config each engine is audited at (JAX ``engine_config``)."""
    if engine in ("async", "wave"):
        return SystemConfig.scale(num_nodes=nodes)
    if engine == "sync":
        return SystemConfig.scale(num_nodes=nodes, drain_depth=4,
                                  txn_width=3)
    # deep / fused: the lint probe family (valid at small N)
    return dataclasses.replace(
        SystemConfig.scale(num_nodes=nodes, drain_depth=2, txn_width=2),
        deep_window=True, deep_slots=4, deep_ownerval_slots=2)


def _trivial_traces(cfg):
    return [[(0, 1, 0)]] * cfg.num_nodes


#: the fused round's argument names (JAX ``trace_targets``' fused names)
_ROUND_NAMES = ["params", "dm", "ca_t", "cv_t", "cs_t", "w_oa", "w_val",
                "w_live", "hor"]


def engine_targets(engine: str, nodes: int, device,
                   cfg: Optional[SystemConfig] = None) -> dict:
    """name -> ``lint_aten.Call`` of one engine's hot bodies (JAX
    ``trace_targets``); ``cfg`` overrides the engine's config."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis.lint_aten import (
        Call, leaf_names)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    from ue22cs343bb1_openmp_assignment_tpu_torch.state import (
        init_state, stack_states)

    cfg = cfg or engine_config(engine, nodes)
    st = init_state(cfg, _trivial_traces(cfg), device=device)
    if engine == "async":
        return {"step.cycle": Call(lambda s: step.cycle(cfg, s), (st,)),
                "step.run_cycles[8]": Call(
                    lambda s: step.run_cycles(cfg, s, 8), (st,))}
    if engine == "wave":
        b = stack_states([st, init_state(cfg, device=device)])
        return {"step.run_wave_chunk[2x4]": Call(
            lambda s: step.batched_wave_chunk(cfg, s, 4, 64), (b,))}
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    sst = se.from_sim_state(cfg, st)
    if engine in ("sync", "deep"):
        name = ("sync_engine.round_step" if engine == "sync"
                else "sync_engine.round_step[deep]")
        return {name: Call(lambda s: se.round_step(cfg, s), (sst,))}
    if engine == "fused":
        from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
            deep_round_kernel as drk)
        return {"deep_round_kernel.fused_round": Call(
            lambda *a: drk.fused_round(cfg, *a),
            drk.round_inputs(cfg, sst)[1:],
            names=lambda args: [(n, t) for n, (_, t) in
                                zip(_ROUND_NAMES, leaf_names(args))])}
    raise ValueError(f"unknown engine {engine!r}")


def route_target(nodes: int, device, shards: int = 2) -> dict:
    """The routed delivery's router (``parallel/rdma_comm``) over
    ``shards`` virtual shards, on lanes built as JAX's probe builds them:
    the ring kernel on the card, its plain version on the CPU."""
    import torch

    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis.lint_aten import (
        Call)
    from ue22cs343bb1_openmp_assignment_tpu_torch.parallel import (
        mesh, rdma_comm)

    cfg = dataclasses.replace(SystemConfig.scale(num_nodes=nodes),
                              transport="rdma")
    layout = mesh.make_layout(cfg.num_nodes, shards, device)
    router = rdma_comm.make_rdma_router(cfg, layout)
    N, S, Fw = cfg.num_nodes, cfg.out_slots, 6 + cfg.msg_bitvec_words
    I32 = torch.int32
    ctype = torch.ones((N, S), dtype=I32, device=device)
    recv = torch.arange(N, dtype=I32, device=device)[:, None].repeat(1, S)
    prio = torch.arange(N * S, dtype=I32, device=device).reshape(N, S)
    fields = torch.zeros((N, S, Fw), dtype=I32, device=device)
    return {"rdma_comm.route": Call(
        router, (ctype, recv, prio, fields),
        names=lambda args: list(zip(
            ["msg_type", "msg_recv", "msg_prio", "msg_fields"], args)))}


#: the hot body whose per-step index count defines each engine's
#: indices/instr headline
HOT_BODY = {
    "async": "step.cycle",
    "wave": "step.run_wave_chunk[2x4]",
    "sync": "sync_engine.round_step",
    "deep": "sync_engine.round_step[deep]",
    "fused": "deep_round_kernel.fused_round",
}


def _probe(engine: str, nodes: int, budget: int, device=None) -> dict:
    """One deterministic small run (uniform workload, seed 0): pins
    (steps, retired, quiesced) for the indices/instr denominator, as the
    JAX package's ``_probe`` does."""
    import torch

    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    from ue22cs343bb1_openmp_assignment_tpu_torch.state import stack_states

    cfg = engine_config(engine, nodes)
    sys_ = CoherenceSystem.from_workload(cfg, "uniform", trace_len=16,
                                         seed=0, device=device)
    if engine == "async":
        final = step.run_to_quiescence(cfg, sys_.state, budget)
        return {"steps": int(final.cycle),
                "retired": int(final.metrics.instrs_retired),
                "quiesced": bool(final.quiescent())}
    if engine == "wave":
        other = CoherenceSystem.from_workload(cfg, "uniform", trace_len=16,
                                              seed=1, device=device)
        b = stack_states([sys_.state, other.state])
        chunks, done = 0, False
        while not done and chunks * 4 < budget:
            b, _, done_v = step.run_wave_chunk(cfg, b, 4, budget)
            done = bool(torch.all(done_v))
            chunks += 1
        return {"steps": chunks,
                "retired": int(b.metrics.instrs_retired.sum()),
                "quiesced": done}
    # sync / deep / fused share the round engine's retire rate (the
    # fused round is one deep round; its probe runs the same engine)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    sst = se.from_sim_state(cfg, sys_.state)
    out = se.run_sync_to_quiescence(cfg, sst, chunk=8,
                                    max_rounds=max(budget, 8))
    rounds = int(out.round)
    return {"steps": rounds,
            "retired": int(out.metrics.instrs_retired),
            "quiesced": rounds < max(budget, 8)}


def trace_targets(engine: str, nodes: int, device) -> dict:
    """name -> ``lint_aten.AtenTrace`` of one engine's hot bodies, each
    recorded once."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import lint_aten
    calls = engine_targets(engine, nodes, device)
    if engine == "async":
        calls.update(route_target(nodes, device))
    return {name: lint_aten.record(call)[1] for name, call in calls.items()}


# ---------------------------------------------------------------------------
# the prong
# ---------------------------------------------------------------------------

def check(engines: Optional[Sequence[str]] = None,
          nodes: int = DEFAULT_NODES, probe: bool = True,
          probe_budget: int = 4096, device=None) -> dict:
    """Run the audit on ``device`` (None: the card); returns the
    findings-aggregated report dict."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import device as _device
    dev = _device.resolve(device)
    engines = list(ENGINES) if engines is None else list(engines)
    findings: List[dict] = []
    exhausted = False
    eng_out: Dict[str, dict] = {}
    cross: Dict[str, Dict[str, int]] = {}

    for engine in engines:
        targets = {}
        candidates: List[dict] = []
        for name, trace in trace_targets(engine, nodes, dev).items():
            ops = inventory(trace, name)
            sites = len(ops)
            by_plane: Dict[str, dict] = {}
            for rec in ops:
                row = by_plane.setdefault(rec["plane"],
                                          {"ops": 0, "indices": 0})
                row["ops"] += 1
                row["indices"] += rec["indices"]
            candidates.extend(merge_candidates(ops))
            targets[name] = {
                "index_sites": sites,
                "indices_per_call": sum(r["indices"] for r in ops),
                "by_plane": by_plane,
                "kernel_launches": dict(trace.kernels),
                "ops": ops,
            }
            budget = index_budget(name, "scatter", dev.type)
            if budget is not None and nodes == DEFAULT_NODES \
                    and sites > budget:
                findings.append({
                    "pass": "budget", "kind": "index_budget",
                    "target": name,
                    "detail": f"{sites} index sites > budget {budget} "
                              f"(aten index ops and kernel launches; "
                              f"INDEX_BUDGETS pins the shipped count "
                              f"exactly)"})
        hot = HOT_BODY[engine]
        per_step = targets[hot]["indices_per_call"] if hot in targets \
            else 0
        rec = {"config": {"num_nodes": nodes}, "targets": targets,
               "merge_candidates": candidates,
               "hot_body": hot, "indices_per_step": per_step,
               "probe": None, "indices_per_instr": None}
        if probe:
            pr = _probe(engine, nodes, probe_budget, dev)
            rec["probe"] = pr
            if not pr["quiesced"]:
                exhausted = True
            elif pr["retired"]:
                rec["indices_per_instr"] = round(
                    per_step * pr["steps"] / pr["retired"], 3)
        for plane, row in targets.get(hot, {}).get("by_plane",
                                                   {}).items():
            cross.setdefault(plane, {})[engine] = row["indices"]
        eng_out[engine] = rec

    return {"schema": SCHEMA, "nodes": nodes,
            "default_nodes": DEFAULT_NODES, "device": dev.type,
            "budgets": {k: index_budget(k, "scatter", dev.type)
                        for k in sorted(INDEX_BUDGETS)},
            "budgets_enforced": nodes == DEFAULT_NODES,
            "engines": eng_out, "cross_engine": cross,
            "findings": findings, "budget_exhausted": exhausted,
            "ok": not findings}


def render_text(rep: dict) -> List[str]:
    verdict = "ok" if rep["ok"] else "FAIL"
    if rep["ok"] and rep.get("budget_exhausted"):
        verdict = "BUDGET EXHAUSTED (probe never quiesced — not a pass)"
    lines = [f"== index audit: {verdict} [N={rep['nodes']}, "
             f"engines: {', '.join(rep['engines'])}]"]
    for engine, er in rep["engines"].items():
        ipi = er["indices_per_instr"]
        ipi_s = "n/a" if ipi is None else f"{ipi:.3f}"
        pr = er.get("probe") or {}
        lines.append(
            f"   {engine}: {er['indices_per_step']} indices/step "
            f"({er['hot_body']}), {ipi_s} indices/instr"
            + (f" [{pr['steps']} steps, {pr['retired']} retired]"
               if pr else ""))
        for name, t in er["targets"].items():
            pls = ", ".join(f"{p}={v['indices']}" for p, v in
                            sorted(t["by_plane"].items()))
            lines.append(f"      {name}: {t['index_sites']} sites, "
                         f"{t['indices_per_call']} indices/call "
                         f"[{pls}]")
        for c in er["merge_candidates"]:
            lines.append(f"   ~ merge candidate: {c['detail']}")
        if not er["merge_candidates"]:
            lines.append(f"   {engine}: no mergeable-scatter pairs "
                         "under the shared-index/distinct-dest "
                         "pattern")
    for f in rep["findings"]:
        lines.append(f"  ! {f['pass']}/{f['kind']}: "
                     f"[{f.get('target', '?')}] {f['detail']}")
    return lines


def index_row(engine: str = "async", nodes: int = DEFAULT_NODES,
              device=None) -> dict:
    """The perf-report block (``doc['index']``, rendered by
    ``obs/roofline.render_text``): the hot body's per-step inventory
    and plane split, no probe run (the report pins its own steps and
    retired)."""
    rep = check(engines=[engine], nodes=nodes, probe=False, device=device)
    er = rep["engines"][engine]
    hot = er["hot_body"]
    return {"engine": engine, "target": hot, "nodes": nodes,
            "indices_per_step": er["indices_per_step"],
            "index_sites": er["targets"][hot]["index_sites"],
            "by_plane": {p: v["indices"] for p, v in
                         er["targets"][hot]["by_plane"].items()},
            "merge_candidates": len(er["merge_candidates"])}
