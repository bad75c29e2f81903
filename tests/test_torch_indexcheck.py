"""The index-pressure auditor (``analysis/indexcheck.py``) and the
``_PACKED_COMMIT`` seam of ``ops/step.py``.

Held to the JAX package where the two can agree: the probe runs'
``(steps, retired)`` equal the JAX package's ``indexcheck._probe`` for
async, sync and deep at N = 8 (the JAX probes run once a session, each
behind a file lock), and the report's schema string, keys and exit codes
(0 / 1 / 3) are JAX's. The rest is the port's own contract: every pin
equals a fresh count at N = 8 and N = 32, the split commit is
bit-identical to the shipped one on several seeds and is caught only by
this prong, and the merge detector names the split planes.
"""

from __future__ import annotations

import json
import os

import pytest
import torch
from filelock import FileLock

from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
    indexcheck, model_check, runner)
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
    CoherenceSystem)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
from ue22cs343bb1_openmp_assignment_tpu_torch.state import state_leaves

import tests.torch_parity  # noqa: F401,E402  (one torch thread a process)


def _shared(tmp_path_factory, name: str, compute):
    """compute() through a JSON round trip, once a session across the
    xdist workers (the first computes it behind a file lock)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"torch_indexcheck_{name}.json"
    with FileLock(str(path) + ".lock"):
        if not path.exists():
            path.write_text(json.dumps(compute()))
        return json.loads(path.read_text())


def _run(capsys, *argv) -> tuple:
    rc = runner.main(["--cpu", "--skip-model-check", "--skip-lint",
                      *argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


def _projection(rep: dict) -> dict:
    keys = ("primitive", "site", "plane", "operand", "index_shape",
            "update", "trip_weight", "index_sig")
    return {name: [tuple(op.get(k) for k in keys) for op in t["ops"]]
            for er in rep["engines"].values()
            for name, t in er["targets"].items()}


@pytest.mark.parametrize("engine", indexcheck.ENGINES)
def test_pins_equal_fresh_counts_at_8_and_32(engine):
    at8 = indexcheck.check([engine], 8, probe=False, device="cpu")
    at32 = indexcheck.check([engine], 32, probe=False, device="cpu")
    assert at8["ok"] and at8["budgets_enforced"]
    assert not at32["budgets_enforced"]
    for name, t in at8["engines"][engine]["targets"].items():
        assert t["index_sites"] == indexcheck.INDEX_BUDGETS[name], name
        assert t["index_sites"] == \
            at32["engines"][engine]["targets"][name]["index_sites"]
    # the sites, their planes, shapes but N and trip weights agree
    strip = {n: [(p, s, pl) for p, s, pl, *_ in ops]
             for n, ops in _projection(at8).items()}
    assert strip == {n: [(p, s, pl) for p, s, pl, *_ in ops]
                     for n, ops in _projection(at32).items()}


def test_report_shape_and_render():
    rep = indexcheck.check(["async"], 8, probe=False, device="cpu")
    assert rep["schema"] == "cache-sim/indexcheck/v1"
    assert set(rep) >= {"nodes", "default_nodes", "budgets",
                        "budgets_enforced", "engines", "cross_engine",
                        "findings", "budget_exhausted", "ok"}
    er = rep["engines"]["async"]
    assert er["hot_body"] == "step.cycle"
    assert er["indices_per_step"] == \
        er["targets"]["step.cycle"]["indices_per_call"] > 0
    cycle = er["targets"]["step.cycle"]
    planes = {op["plane"] for op in cycle["ops"]}
    assert {"cache", "directory", "mailbox"} <= planes
    # run_cycles[8] has the cycle's sites, eight times each
    r8 = er["targets"]["step.run_cycles[8]"]
    assert r8["index_sites"] == cycle["index_sites"]
    assert r8["indices_per_call"] == 8 * cycle["indices_per_call"]
    lines = indexcheck.render_text(rep)
    assert lines[0] == "== index audit: ok [N=8, engines: async]"
    assert any("step.cycle: 23 sites" in ln for ln in lines)


def test_plane_attribution_names_jax_planes():
    assert indexcheck.plane_of("cache_addr") == "cache"
    assert indexcheck.plane_of("dir_bitvec") == "directory"
    assert indexcheck.plane_of("metrics.cycles") == "telemetry"
    assert indexcheck.plane_of("mb_head") == "mailbox"
    assert indexcheck.plane_of("instr_op") == "frontend"
    assert indexcheck.plane_of("w_oa") == "window"
    assert indexcheck.plane_of("dm") == "directory"
    assert indexcheck.planes(["cache_addr", "dm", "mb_head", "idx",
                              "const"]) == ["mixed"]


def test_merge_candidates_group_shared_index_distinct_dests():
    def rec(dest, sig="s", update="i32[8]", plane="cache"):
        return {"primitive": "index_put_", "scope": "t", "plane": plane,
                "index_sig": sig, "update": update, "dest": dest}
    ops = [rec("a"), rec("b"), rec("b"), rec("c", sig="other"),
           rec("d", update="i32[8,1]")]
    cands = indexcheck.merge_candidates(ops)
    assert [(c["count"], c["dests"]) for c in cands] == [(2, ["a", "b"])]
    assert indexcheck.merge_candidates([rec("a"), rec("a")]) == []


@pytest.mark.parametrize("seed", range(3))
def test_split_commit_bit_identical(seed):
    """The seam's mutant path writes exactly what the shipped commit
    writes: every leaf equal after 40 cycles of a racy workload."""
    for cfg in (SystemConfig.scale(8), SystemConfig.reference()):
        s0 = CoherenceSystem.from_workload(cfg, "uniform", trace_len=16,
                                           seed=seed, device="cpu").state
        want = state_leaves(step.run_cycles(cfg, s0, 40))
        step._PACKED_COMMIT = False
        try:
            got = state_leaves(step.run_cycles(cfg, s0, 40))
        finally:
            step._PACKED_COMMIT = True
        assert all(torch.equal(a, b) for a, b in zip(want, got))


def test_split_commit_killed_only_by_the_index_prong(capsys):
    rc, out, _ = _run(capsys, "--index", "--mutation",
                      "split_packed_scatter", "--json", "/dev/null")
    assert rc == 1 and out.splitlines()[-1] == "analyze: FAIL"
    assert "index_budget" in out
    assert "3 scatters in step.cycle share index sig" in out
    assert "[cache_addr, cache_state, cache_val]" in out
    assert "[dir_state, memory]" in out
    assert step._PACKED_COMMIT
    # the model checker sees nothing
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import mutations
    with mutations.split_packed_scatter():
        rep = model_check.check_scope(model_check.builtin_scopes()["2n1a"],
                                      device="cpu")
    assert rep["ok"]


def test_runner_index_prong_exit_codes(capsys, tmp_path):
    path = tmp_path / "r.json"
    rc, out, _ = _run(capsys, "--index", "--json", str(path))
    assert rc == 0 and out.splitlines()[-1] == "analyze: PASS"
    rep = json.loads(path.read_text())["index"]
    assert set(rep["engines"]) == set(indexcheck.ENGINES)
    assert all(er["probe"]["quiesced"] for er in rep["engines"].values())
    # the probe's cycle budget exhausted before quiescence: 3
    rc, out, _ = _run(capsys, "--index", "--index-engine", "async",
                      "--max-states", "16")
    assert rc == 3
    assert out.splitlines()[-1] == ("analyze: BUDGET EXHAUSTED (no "
                                    "finding — not a pass)")
    # a mutation of another prong fails as in JAX
    with pytest.raises(SystemExit, match="unknown mutation"):
        _run(capsys, "--index", "--mutation", "widen_min_chunk")


@pytest.mark.parametrize("engine", ["async", "sync", "deep"])
def test_probe_equals_jax(engine, tmp_path_factory):
    """(steps, retired, quiesced) of the probe run: the same integers
    the JAX package's ``indexcheck._probe`` pins."""
    def jax_probe():
        from ue22cs343bb1_openmp_assignment_tpu.analysis import (
            indexcheck as j_ix)
        return j_ix._probe(engine, 8, 4096)
    want = _shared(tmp_path_factory, f"probe_{engine}", jax_probe)
    assert indexcheck._probe(engine, 8, 4096, device="cpu") == want


def test_index_row():
    row = indexcheck.index_row("sync", 8, device="cpu")
    assert row == {"engine": "sync", "target": "sync_engine.round_step",
                   "nodes": 8, "indices_per_step": row["indices_per_step"],
                   "index_sites": 7, "by_plane": row["by_plane"],
                   "merge_candidates": 0}
    assert sum(row["by_plane"].values()) == row["indices_per_step"]
