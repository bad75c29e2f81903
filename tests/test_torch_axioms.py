"""The port's axiomatic checker and the litmus suite's fuzz half against
the JAX package's, exactly.

``axioms.check_case`` captures a case's message ledger on the CPU in
both packages; the reports (violations, skips, stats and the event list)
are compared as ``json.dumps(sort_keys=True)`` on every litmus seed case.
The checker's host arithmetic is also held to JAX's on a hand-built
violation, and ``check_run_outcome`` on a forged forbidden outcome.
"""

from __future__ import annotations

import json

import jax
import pytest

from ue22cs343bb1_openmp_assignment_tpu.analysis import (
    axioms as j_ax, fuzz as j_fz, litmus as j_lit)
from ue22cs343bb1_openmp_assignment_tpu.state import init_state as j_init
from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
    axioms, fuzz, litmus)
from ue22cs343bb1_openmp_assignment_tpu_torch.state import init_state

import tests.torch_parity  # noqa: F401,E402  (one torch thread a process)

jax.config.update("jax_platforms", "cpu")


def _dumps(x) -> str:
    return json.dumps(x, sort_keys=True)


def _report(rep: dict) -> dict:
    """The comparable part of a check_case report (the final state is a
    package's own SimState)."""
    return {k: v for k, v in rep.items() if k != "final_state"}


def test_seed_order_and_seed_cases_equal_jax():
    assert litmus.SEED_ORDER == j_lit.SEED_ORDER
    assert sorted(litmus.SEED_ORDER) == sorted(litmus.BUILTIN)
    got = [c.to_dict() for c in litmus.seed_cases(len(litmus.SEED_ORDER))]
    want = [c.to_dict() for c in j_lit.seed_cases(len(j_lit.SEED_ORDER))]
    assert _dumps(got) == _dumps(want)
    assert [c.litmus for c in litmus.seed_cases(3)] == list(
        litmus.SEED_ORDER[:3])
    for name, test in litmus.BUILTIN.items():
        assert litmus.to_fuzz_case(test, 7) == fuzz.case_from_dict(
            j_lit.to_fuzz_case(j_lit.BUILTIN[name], 7).to_dict())


@pytest.mark.parametrize("name", litmus.SEED_ORDER)
def test_check_case_equals_jax(name):
    """The ledger capture of a litmus seed case on the CPU, its events
    and the axioms' verdict, equal to JAX's."""
    case = litmus.to_fuzz_case(litmus.BUILTIN[name], 0)
    got = axioms.check_case(case, device="cpu")
    want = j_ax.check_case(j_fz.case_from_dict(case.to_dict()))
    assert got["events"], name
    for e in got["events"]:
        assert all(type(v) is int for k, v in e.items()
                   if k != "kind" and not (k == "val" and v is None)), e
    assert _dumps(_report(got)) == _dumps(_report(want))
    assert not got["violations"]
    assert int(got["final_state"].cycle) == int(want["final_state"].cycle)
    # the outcome-membership check on the run, as the fuzzer makes it
    cfg, j_cfg = case.config(), j_fz.case_from_dict(case.to_dict()).config()
    assert litmus.check_run_outcome(
        litmus.BUILTIN[name], cfg, got["events"], got["final_state"]) == \
        j_lit.check_run_outcome(j_lit.BUILTIN[name], j_cfg,
                                want["events"], want["final_state"])


def _ev(node, idx, t, kind, addr, obs, val=None):
    return {"node": node, "idx": idx, "t": t, "kind": kind, "addr": addr,
            "obs": obs, "val": val}


@pytest.mark.parametrize("history", ["corr_backwards", "sc_ordered",
                                     "unresolved", "ghosts"])
def test_check_events_equals_jax(history):
    """The hand-built histories of the JAX package's tests
    (tests/test_litmus.py): CoRR backwards closes an SC-per-location
    cycle, its SC-ordered version is clean; a value nothing produced is
    ``rf_unresolved``; ghost reads and writes taint their address."""
    events = {
        "corr_backwards": [_ev(0, 0, 5, "W", 0x01, 65, val=65),
                           _ev(1, 0, 10, "R", 0x01, 65),
                           _ev(1, 1, 12, "R", 0x01, 1)],
        "sc_ordered": [_ev(1, 0, 3, "R", 0x01, 1),
                       _ev(0, 0, 5, "W", 0x01, 65, val=65),
                       _ev(1, 1, 12, "R", 0x01, 65)],
        "unresolved": [_ev(0, 0, 5, "W", 0x01, 65, val=65),
                       _ev(1, 0, 9, "R", 0x01, 77)],
        "ghosts": [_ev(0, 0, 5, "W", 0x01, 65, val=65),
                   _ev(1, 0, 9, "R", 0x01, 0),
                   _ev(1, 1, 11, "W", 0x10, 66, val=66),
                   _ev(0, 1, 14, "R", 0x10, -1),
                   _ev(0, 2, 15, "W", 0x11, 67, val=67),
                   _ev(0, 3, 16, "W", 0x11, 0, val=68)],
    }[history]
    got = axioms.check_events(litmus.litmus_cfg(2), events)
    want = j_ax.check_events(j_lit.litmus_cfg(2), events)
    assert _dumps(got) == _dumps(want)
    checks = [v["check"] for v in got["violations"]]
    assert checks == {"corr_backwards": ["sc_per_location"],
                      "sc_ordered": [], "unresolved": ["rf_unresolved"],
                      "ghosts": []}[history]
    if history == "sc_ordered":
        assert got["pristine"]
    if history == "corr_backwards":
        wit = got["violations"][0]["witness"]
        assert len(wit) == 3 and any("-rf->" in w for w in wit)


def test_check_run_outcome_on_a_forged_outcome_equals_jax():
    """An MP run whose reader saw the flag but not the data: JAX's finding
    dict, with a cold final state from each package."""
    test = litmus.BUILTIN["mp"]
    case = litmus.to_fuzz_case(test, 0)
    cfg = case.config()
    j_case = j_fz.case_from_dict(case.to_dict())
    conc = litmus.concretize(test, cfg)
    reader = [n for n, tr in enumerate(conc["traces"])
              if all(op == 0 for op, _, _ in tr)][0]
    flag_val = max(v for tr in conc["traces"] for op, _, v in tr if op)
    data_init = litmus.init_val(cfg, conc["traces"][reader][1][1])
    events = [_ev(reader, 0, 10, "R", conc["traces"][reader][0][1],
                  flag_val),
              _ev(reader, 1, 12, "R", conc["traces"][reader][1][1],
                  data_init)]
    got = litmus.check_run_outcome(test, cfg, events,
                                   init_state(cfg, case.trace_lists(),
                                              device="cpu"))
    want = j_lit.check_run_outcome(j_lit.BUILTIN["mp"], j_case.config(),
                                   events,
                                   j_init(j_case.config(),
                                          j_case.trace_lists()))
    assert want is not None and want["check"] == "litmus_outcome"
    assert _dumps(got) == _dumps(want)
