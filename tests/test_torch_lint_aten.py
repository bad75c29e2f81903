"""The aten-level IR lint and replay guard (``analysis/lint_aten.py``).

The port's counterpart of the JAX package's ``lint_jaxpr`` is held to
its own pinned contracts (an aten op stream is not a jaxpr): the shipped
tree lints clean, every budget covers a fresh count, the counts do not
depend on N, each rule fires on a synthetic target built to break it,
host reads are allowed only at ``# lint: host`` boundaries, and the
replay guard passes. The whole lint runs once a session (a file lock in
the shared pytest temp dir) and the tests read its report.
"""

from __future__ import annotations

import json
import os

import pytest
import torch
from filelock import FileLock

from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
    indexcheck, lint_aten)
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import roofline
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
from ue22cs343bb1_openmp_assignment_tpu_torch.state import init_state

import tests.torch_parity  # noqa: F401,E402  (one torch thread a process)

CPU = torch.device("cpu")


def _shared(tmp_path_factory, name: str, compute):
    """compute() through a JSON round trip, once a session across the
    xdist workers (the first computes it behind a file lock)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"torch_lint_aten_{name}.json"
    with FileLock(str(path) + ".lock"):
        if not path.exists():
            path.write_text(json.dumps(compute()))
        return json.loads(path.read_text())


@pytest.fixture
def report(tmp_path_factory):
    return _shared(tmp_path_factory, "lint",
                   lambda: lint_aten.lint(device="cpu"))


def test_shipped_tree_is_clean(report):
    assert report["ok"], report["findings"]
    assert report["schema"] == "cache-sim/jaxpr-lint/v1"
    assert set(report["targets"]) == set(lint_aten.INT64_BUDGETS)
    assert report["num_nodes"] == 4 and report["probe_nodes"] == 8
    assert report["kernel_launches"] == {}


def test_budgets_cover_fresh_counts(report):
    for name, ops in report["targets"].items():
        assert ops <= lint_aten.EQN_BUDGETS.get(name, lint_aten.EQN_BUDGET)
        assert report["int64_results"][name] <= \
            lint_aten.INT64_BUDGETS[name]
    # the async targets lint at the reference config (mailbox INV): the
    # index pins resolve through indexcheck's mailbox delta
    for name, sites in report["index_sites"].items():
        assert sites == indexcheck.index_budget(
            name, "mailbox" if name.startswith("step.") else "scatter")


def _counts(cfg, names):
    calls = lint_aten.targets(cfg, CPU, max(cfg.num_nodes, 8))
    out = {}
    for name in names:
        _, tr, _ = lint_aten.record(calls[name])
        out[name] = (tr.ops, tr.int64, len(tr.sites()))
    return out


@pytest.mark.parametrize("names", [
    ("step.cycle", "mailbox.dequeue", "step.run_to_quiescence",
     "step.run_wave_chunk[2x4]"),
    ("sync_engine.round_step", "rdma_comm.route"),
    ("sync_engine.round_step[deep]",)], ids=["async", "sync", "deep"])
def test_counts_same_at_8_and_32_nodes(names):
    """Aten ops, int64 results and index sites do not depend on N (the
    vectorized design), so the pins hold at any size."""
    assert _counts(SystemConfig.scale(8), names) == \
        _counts(SystemConfig.scale(32), names)


def _x():
    return torch.arange(8, dtype=torch.int32)


@pytest.mark.parametrize("fn,rule", [
    (lambda x: (x * 2).to(torch.float64), "wide_dtype"),
    (lambda x: torch.nonzero(x > 3), "dynamic_shape"),
    (lambda x: x[x > 3], "dynamic_shape"),
    (lambda x: x.sum().item(), "host_callback"),
    (lambda x: int(x.max()), "host_callback"),
], ids=["float64", "nonzero", "bool-mask", "item", "int"])
def test_synthetic_target_is_flagged(fn, rule):
    call = lint_aten.Call(fn, (_x(),))
    out, trace, _ = lint_aten.record(call)
    findings = []
    lint_aten._audit("synthetic", trace, call, out, findings)
    assert rule in {f["rule"] for f in findings}, findings


def test_int64_pin_is_enforced():
    call = lint_aten.Call(lambda x: x.to(torch.int64) + 1, (_x(),))
    out, trace, _ = lint_aten.record(call)
    findings = []
    lint_aten._audit("mailbox.dequeue", trace, call, out, findings)
    assert trace.int64 == 2 and findings == []
    trace.int64 = lint_aten.INT64_BUDGETS["mailbox.dequeue"] + 1
    lint_aten._audit("mailbox.dequeue", trace, call, out, findings)
    assert [f["rule"] for f in findings] == ["wide_dtype"]


def test_host_reads_only_at_marked_boundaries():
    cfg = SystemConfig.reference()
    call = lint_aten.targets(cfg, CPU, 8)["step.run_to_quiescence"]
    out, trace, _ = lint_aten.record(call)
    # chunk 1 over 4 cycles: one read before each cycle and one after
    assert int(out.cycle) == 4 and len(trace.host) == 5
    assert {h["site"].split(":")[0] for h in trace.host} == {"ops/step.py"}
    assert all(h["host_ok"] for h in trace.host)
    findings = []
    lint_aten._audit("step.run_to_quiescence", trace, call, out, findings)
    assert findings == []
    # a runner that read every cycle past its allowance is flagged
    tight = lint_aten.Call(call.fn, call.args, host_reads=lambda o: 4)
    lint_aten._audit("step.run_to_quiescence", trace, tight, out, findings)
    assert [f["rule"] for f in findings] == ["host_callback"]


def test_replay_guard_passes(tmp_path_factory):
    guard = _shared(tmp_path_factory, "guard",
                    lambda: lint_aten.replay_guard(device="cpu"))
    assert guard["ok"], guard
    assert set(guard["same_stream"]) == {"async", "sync", "deep", "wave",
                                         "serve"}
    assert guard["native_build_reused"] and guard["kernel_nvcc_runs"] is None


def test_replay_guard_sees_a_changed_stream():
    """Same-shape calls of a data-dependent target give two fingerprints:
    what the guard is there to catch."""
    def branchy(x):
        return x + 1 if bool(x.sum() > 10) else x * 2
    a = lint_aten._fingerprint(branchy, _x())
    b = lint_aten._fingerprint(branchy, torch.zeros(8, dtype=torch.int32))
    assert a != b


def test_observer_leaves_the_dispatch_record_unchanged():
    cfg = SystemConfig.scale(8)
    st = init_state(cfg, [[(0, 1, 0)]] * 8, device=CPU)
    plain = roofline.kernel_record("step.cycle", step.cycle, cfg, st)
    _, ctr, _, _ = roofline.dispatch_run(step.cycle, (cfg, st),
                                         observer=lint_aten.AtenTrace())
    assert plain["hlo_fingerprint"] == roofline.hlo_fingerprint(ctr.text())
    assert plain["ops"] == ctr.ops


def test_index_budget_rule_catches_the_split_commit():
    cfg = SystemConfig.reference()
    call = lint_aten.targets(cfg, CPU, 8)["step.cycle"]
    old = step._PACKED_COMMIT
    step._PACKED_COMMIT = False
    try:
        _, trace, _ = lint_aten.record(call)
    finally:
        step._PACKED_COMMIT = old
    assert len(trace.sites()) == indexcheck.index_budget(
        "step.cycle", "mailbox") + 12
