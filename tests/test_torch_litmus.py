"""The port's litmus suite against the JAX package's (slice 15).

Both sides enumerate every reachable outcome of a test on the CPU
(the model checker in litmus mode) and the reports are compared as
``json.dumps(sort_keys=True)``: the ten MESI tests other than ``iriw``,
and the two consistency mutations on the shapes that kill them. ``iriw``
(15590 states) and the MOESI/MESIF sweeps are in the slow tier, as in the
JAX package's tests/test_litmus.py.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import pytest

from ue22cs343bb1_openmp_assignment_tpu.analysis import (
    litmus as j_lit, mutations as j_mut)
from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (litmus,
                                                               mutations)

jax.config.update("jax_platforms", "cpu")

FAST = sorted(n for n in litmus.BUILTIN if n != "iriw")


def _same(a, b) -> None:
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_suite_definitions_equal_jax():
    assert sorted(litmus.BUILTIN) == sorted(j_lit.BUILTIN)
    for name, test in litmus.BUILTIN.items():
        assert dataclasses.astuple(test) == dataclasses.astuple(
            j_lit.BUILTIN[name])
        cfg = litmus.litmus_cfg(test.num_nodes)
        j_cfg = j_lit.litmus_cfg(test.num_nodes)
        want = j_lit.concretize(j_lit.BUILTIN[name], j_cfg)
        got = litmus.concretize(test, cfg)
        assert got["traces"] == want["traces"]
        assert got["allowed"] == want["allowed"]
        assert got["final_addrs"] == want["final_addrs"]


@pytest.mark.parametrize("name", FAST)
def test_mesi_litmus_equals_jax(name):
    rep = litmus.run_suite([name], device="cpu")
    assert rep["mesi"][name]["ok"], rep
    _same(j_lit.run_suite([name]), rep)


@pytest.mark.parametrize("mutation", sorted(mutations.CONSISTENCY_MUTATIONS))
def test_consistency_mutation_equals_jax(mutation):
    fn, test, axiom, delays, periods = mutations.CONSISTENCY_MUTATIONS[
        mutation]
    assert j_mut.CONSISTENCY_MUTATIONS[mutation][1:] == (test, axiom, delays,
                                                          periods)
    rep = litmus.run_suite([test], message_phase=fn, device="cpu")
    assert rep["mesi"][test]["ok"] is False
    assert rep["mesi"][test]["unexpected"]
    _same(j_lit.run_suite(
        [test], message_phase=j_mut.CONSISTENCY_MUTATIONS[mutation][0]), rep)


def test_budget_exhaustion_is_reported_not_raised():
    rep = litmus.run_suite(["mp"], max_states=5, device="cpu")
    assert rep["mesi"]["mp"]["budget_exhausted"] is True
    _same(j_lit.run_suite(["mp"], max_states=5), rep)


@pytest.mark.slow
def test_iriw_equals_jax():
    rep = litmus.run_suite(["iriw"], device="cpu")
    assert rep["mesi"]["iriw"]["ok"]
    _same(j_lit.run_suite(["iriw"]), rep)


@pytest.mark.slow
@pytest.mark.parametrize("protocol", ["moesi", "mesif"])
def test_variant_protocol_sweep_equals_jax(protocol):
    rep = litmus.run_suite(FAST, protocols=(protocol,), device="cpu")
    assert all(r["ok"] for r in rep[protocol].values())
    _same(j_lit.run_suite(FAST, protocols=(protocol,)), rep)
