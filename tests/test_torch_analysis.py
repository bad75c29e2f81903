"""The port's analysis gate against the JAX package's (slice 15).

Both sides run on the CPU. The protocol tables row by row, their static
verification, the table mutations, the compiled table phase against the
JAX compiled phase and the port's handlers on seeded random states, the
model checker's reports on every builtin scope, every handler mutation
and the MOESI/MESIF variants, conformance on 2n2h (all compared as
``json.dumps(sort_keys=True)``), the runner's exit codes, and serving
jobs of the table protocols.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import tempfile

import jax
import numpy as np
import pytest
import torch

from ue22cs343bb1_openmp_assignment_tpu.analysis import (
    conformance as j_conf, litmus as j_lit, model_check as j_mc,
    mutations as j_mut, protocol_table as j_pt, verify_table as j_vt)
from ue22cs343bb1_openmp_assignment_tpu.ops import mailbox as j_mb
from ue22cs343bb1_openmp_assignment_tpu_torch import convert
from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
    conformance, litmus, model_check, mutations, protocol_table, runner,
    verify_table)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import handlers, mailbox
from ue22cs343bb1_openmp_assignment_tpu_torch.state import init_state
from ue22cs343bb1_openmp_assignment_tpu_torch.types import (CacheState,
                                                            Msg)

from tests.torch_parity import as_numpy, cfg_pair, jax_sim_state

jax.config.update("jax_platforms", "cpu")


def _same(a, b) -> None:
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def _row_fields(row) -> tuple:
    """A table row as plain data: its fields, effects by class name."""
    return (row.name, row.msg, dataclasses.astuple(row.guard),
            tuple((type(e).__name__, dataclasses.astuple(e))
                  for e in row.effects),
            row.anchor, row.quirks, dataclasses.astuple(row.assumes))


@pytest.mark.parametrize("name", ["mesi", "moesi", "mesif"])
def test_table_rows_equal_jax(name):
    want, got = j_pt.TABLES[name](), protocol_table.TABLES[name]()
    assert (want.name, want.protocol, want.domains, want.cache_states) == (
        got.name, got.protocol, got.domains, got.cache_states)
    assert [_row_fields(r) for r in want.rows] == [
        _row_fields(r) for r in got.rows]
    assert protocol_table.ATOM_DOMAINS == j_pt.ATOM_DOMAINS


def test_anchor_registry_equals_jax():
    from ue22cs343bb1_openmp_assignment_tpu.ops import handlers as j_h
    assert handlers.TRANSITION_ANCHORS == j_h.TRANSITION_ANCHORS
    assert handlers.QUIRKS == j_h.QUIRKS


@pytest.mark.parametrize("name", ["mesi", "moesi", "mesif"])
def test_verify_table_equals_jax(name):
    rep = verify_table.verify(protocol_table.TABLES[name]())
    assert rep["ok"]
    _same(j_vt.verify(j_pt.TABLES[name]()), rep)


@pytest.mark.parametrize("mutation", sorted(mutations.TABLE_MUTATIONS))
def test_table_mutation_caught_as_jax(mutation):
    fn, kind = mutations.TABLE_MUTATIONS[mutation]
    j_fn, j_kind = j_mut.TABLE_MUTATIONS[mutation]
    assert kind == j_kind
    rep = verify_table.verify(fn(protocol_table.mesi_table()))
    assert not rep["ok"] and kind in [f["kind"] for f in rep["findings"]]
    _same(j_vt.verify(j_fn(j_pt.mesi_table())), rep)


# ---------------------------------------------------------------------------
# the compiled table phase on seeded random staged states
# ---------------------------------------------------------------------------

def _random_state(cfg, seed: int):
    """A port SimState with random caches, directories and one random
    head message a node (types, senders, addresses, carried sharers)."""
    rng = np.random.default_rng(seed)
    N, C, M, Q = (cfg.num_nodes, cfg.cache_size, cfg.mem_size,
                  cfg.queue_capacity)
    st = init_state(cfg, device="cpu")

    def addrs(shape):
        home = rng.integers(0, N, shape)
        block = rng.integers(0, M, shape)
        return (home << cfg.block_bits) | block

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32))
    cache_addr = np.where(rng.random((N, C)) < 0.2, cfg.invalid_address,
                          addrs((N, C)))
    states = np.asarray(cfg.allowed_cache_states)
    sharers = rng.integers(0, 1 << N, (N, M, 1)).astype(np.int64)
    mb = np.zeros((7, N, Q), np.int64)
    mb[0] = int(Msg.NONE)
    head = rng.integers(0, Q, N)
    rows = np.arange(N)
    mb[0, rows, head] = rng.integers(0, 13, N)
    mb[1, rows, head] = rng.integers(0, N, N)
    mb[2, rows, head] = addrs(N)
    mb[3, rows, head] = rng.integers(0, 256, N)
    mb[4, rows, head] = rng.integers(0, N, N)
    mb[5, rows, head] = rng.integers(0, 3, N)
    mb[6, rows, head] = rng.integers(0, 1 << N, N)
    return st.replace(
        cache_addr=t(cache_addr), cache_val=t(rng.integers(0, 256, (N, C))),
        cache_state=t(states[rng.integers(0, len(states), (N, C))]),
        memory=t(rng.integers(0, 256, (N, M))),
        dir_state=t(rng.integers(0, 3, (N, M))),
        dir_bitvec=t(sharers),
        cur_val=t(rng.integers(0, 256, N)),
        waiting=torch.as_tensor(rng.random(N) < 0.5),
        mb_pack=t(mb), mb_head=t(head),
        mb_count=t((rng.random(N) < 0.8).astype(np.int64)))


def _observable(parts) -> dict:
    """The phase output at its observable positions: masks and stats in
    full, masked update values where their mask is set, candidate
    fields where their type is not NONE."""
    upd, cand, inv_scatter, stats = parts
    out = {"cache_idx": as_numpy(upd["cache_idx"]),
           "wait_clear": as_numpy(upd["wait_clear"])}
    for k in ("cache_state", "cache_addr", "cache_val"):
        m, v = (as_numpy(x) for x in upd[k])
        out[k] = (m, np.where(m, v, 0))
    for k in ("mem", "dir_state", "dir_bv"):
        m, i, v = (as_numpy(x) for x in upd[k])
        mm = m.reshape(m.shape + (1,) * (v.ndim - m.ndim))
        out[k] = (m, np.where(m, i, 0), np.where(mm, v, 0))
    for k in ("pri", "sec", "inv", "ev"):
        if cand[k][0] is None:
            out[k] = None
            continue
        ty = as_numpy(cand[k][0])
        live = ty != int(Msg.NONE)
        fields = []
        for x in cand[k][1:]:
            x = as_numpy(x)
            lv = live.reshape(live.shape + (1,) * (x.ndim - live.ndim))
            fields.append(np.where(lv, x, 0))
        out[k] = (ty, *fields)
    out["inv_scatter"] = None if inv_scatter is None else tuple(
        as_numpy(x) for x in inv_scatter)
    for k, v in stats.items():
        out["stats." + k] = tuple(as_numpy(x) for x in v) \
            if isinstance(v, tuple) else as_numpy(v)
    return out


def _assert_observable_equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = a[k], b[k]
        if x is None:
            assert y is None, k
            continue
        xs = x if isinstance(x, tuple) else (x,)
        ys = y if isinstance(y, tuple) else (y,)
        for i, (p, q) in enumerate(zip(xs, ys)):
            assert np.array_equal(np.asarray(p).astype(np.int64),
                                  np.asarray(q).astype(np.int64)), (k, i)


@pytest.mark.parametrize("nodes,inv_mode", [(4, "mailbox"), (8, "mailbox"),
                                            (4, "scatter"), (8, "scatter")])
@pytest.mark.parametrize("protocol", ["mesi", "moesi", "mesif"])
def test_table_phase_matches_jax_and_handlers(nodes, inv_mode, protocol):
    j_cfg, cfg = cfg_pair(nodes, cache_size=2, mem_size=4,
                          queue_capacity=4, inv_mode=inv_mode,
                          protocol=protocol)
    phase = protocol_table.table_message_phase(
        protocol_table.TABLES[protocol]())
    j_phase = jax.jit(j_pt.table_message_phase(j_pt.TABLES[protocol]()),
                      static_argnums=0)
    for seed in range(6):
        st = _random_state(cfg, seed)
        mv, _, _ = mailbox.dequeue(cfg, st)
        got = _observable(phase(cfg, st, mv))
        j_st = jax_sim_state(convert.sim_numpy_leaves(st))
        j_mv, _, _ = j_mb.dequeue(j_cfg, j_st)
        _assert_observable_equal(_observable(j_phase(j_cfg, j_st, j_mv)),
                                 got)
        if protocol == "mesi":
            _assert_observable_equal(
                _observable(handlers.message_phase(cfg, st, mv)), got)


def test_table_phase_runs_under_vmap():
    """The compiled phase is batchable: vmapped over 3 states it equals
    the per-state calls."""
    _, cfg = cfg_pair(4, cache_size=2, mem_size=4, queue_capacity=4,
                      inv_mode="mailbox", protocol="moesi")
    phase = protocol_table.table_message_phase(protocol_table.moesi_table())
    sts = [_random_state(cfg, s) for s in range(3)]
    from ue22cs343bb1_openmp_assignment_tpu_torch import state as S

    def one(*leaves):
        st = S.from_leaves(leaves)
        mv, _, _ = mailbox.dequeue(cfg, st)
        upd, cand, _, _ = phase(cfg, st, mv)
        return upd["cache_state"][1], cand["pri"][0], upd["dir_bv"][2]
    batched = torch.func.vmap(one)(*S.state_leaves(S.stack_states(sts)))
    for i, st in enumerate(sts):
        for got, want in zip(batched, one(*S.state_leaves(st))):
            assert torch.equal(got[i], want)


# ---------------------------------------------------------------------------
# the model checker and conformance against the JAX package's
# ---------------------------------------------------------------------------

SCOPES = sorted(model_check.builtin_scopes())


@pytest.mark.parametrize("scope", SCOPES)
def test_model_check_report_equals_jax(scope):
    ck = model_check.ModelChecker(model_check.builtin_scopes()[scope],
                                  device="cpu")
    rep = ck.run()
    assert rep["ok"] and ck.batches > 0
    _same(j_mc.check_scope(j_mc.builtin_scopes()[scope]), rep)


@pytest.mark.parametrize("mutation", sorted(mutations.MUTATIONS))
def test_handler_mutation_report_equals_jax(mutation):
    fn, scope, expected = mutations.MUTATIONS[mutation]
    assert j_mut.MUTATIONS[mutation][1:] == (scope, expected)
    rep = model_check.check_scope(model_check.builtin_scopes()[scope],
                                  message_phase=fn, device="cpu")
    assert not rep["ok"]
    assert expected in [v["name"] for v in rep["violations"]]
    _same(j_mc.check_scope(j_mc.builtin_scopes()[scope],
                           message_phase=j_mut.MUTATIONS[mutation][0]), rep)


@pytest.mark.parametrize("protocol", ["moesi", "mesif"])
def test_variant_protocol_model_check_equals_jax(protocol):
    scope = conformance.variant_scope(model_check.builtin_scopes()["2n2a"],
                                      protocol)
    rep = model_check.check_scope(
        scope, message_phase=litmus.message_phase_for(protocol),
        device="cpu")
    assert rep["ok"]
    _same(j_mc.check_scope(
        j_conf.variant_scope(j_mc.builtin_scopes()["2n2a"], protocol),
        message_phase=j_lit.message_phase_for(protocol)), rep)


def test_conformance_2n2h_equals_jax():
    rep = conformance.check_conformance(
        conformance.conformance_scopes()["2n2h"],
        protocol_table.mesi_table(), device="cpu")
    assert rep["ok"] and rep["stats"]["rows_covered"] == 13
    _same(j_conf.check_conformance(j_conf.conformance_scopes()["2n2h"],
                                   j_pt.mesi_table()), rep)


def test_conformance_catches_a_handler_mutant_as_jax():
    """A handler mutant diverges from the MESI table, with the leaf
    labels the JAX gate prints (``.dir_bitvec``)."""
    fn, scope, _ = mutations.MUTATIONS["skip_em_bitvec_clear"]
    rep = conformance.check_conformance(
        conformance.conformance_scopes()[scope],
        protocol_table.mesi_table(), message_phase=fn, device="cpu")
    assert [f["check"] for f in rep["findings"]] == ["divergence"]
    assert rep["findings"][0]["fields"] == [".dir_bitvec"]
    _same(j_conf.check_conformance(
        j_conf.conformance_scopes()[scope], j_pt.mesi_table(),
        message_phase=j_mut.MUTATIONS["skip_em_bitvec_clear"][0]), rep)


def test_report_numbers_are_python_ints():
    rep = model_check.check_scope(model_check.builtin_scopes()["2n1a_r"],
                                  device="cpu")

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            assert x is None or type(x) in (int, bool, str), type(x)
    walk(rep)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def _run(capsys, *argv) -> tuple:
    rc = runner.main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("argv,rc", [
    (("--cpu", "--scopes", "2n1a_r"), 0),
    (("--cpu", "--scopes", "2n1a_r", "--mutation",
      "no_wait_clear_on_reply_rd", "--skip-lint"), 1),
    (("--cpu", "--scopes", "2n2a", "--max-states", "10", "--skip-lint"), 3),
    (("--cpu", "--skip-model-check", "--skip-lint", "--table",
      "--mutation", "table_drop_row"), 1),
    (("--cpu", "--skip-model-check", "--skip-lint", "--litmus",
      "--mutation", "stale_fill_from_invalid"), 1),
])
def test_runner_exit_codes(capsys, argv, rc):
    got, out, err = _run(capsys, *argv)
    assert got == rc, out + err
    assert out.splitlines()[-1] == {0: "analyze: PASS", 1: "analyze: FAIL",
                                    3: "analyze: BUDGET EXHAUSTED (no "
                                       "finding — not a pass)"}[rc]


def test_runner_usage_error_exits_2(capsys):
    with pytest.raises(SystemExit) as e:
        runner.main(["--no-such-flag"])
    assert e.value.code == 2


@pytest.mark.parametrize("argv", [
    ("--mutation", "narrow_ladder_gap"), ("--jaxpr",), ("--kernel",),
    ("--index",),
    ("--mutation", "widen_min_chunk"), ("--mutation", "split_packed_scatter"),
])
def test_runner_waiting_prongs_exit_2(capsys, argv):
    """The JAX runner's last three prongs and their mutations, which
    once waited for a later slice: each prong now runs and passes on the
    shipped tree (0); a mutation with no prong that reads it runs
    nothing, as in the JAX runner (its exit code on the same flags)."""
    flags = ("--skip-model-check", "--skip-lint")
    rc, out, err = _run(capsys, "--cpu", *flags, *argv)
    if argv[0] == "--mutation":
        from ue22cs343bb1_openmp_assignment_tpu.analysis import (
            runner as j_runner)
        want = j_runner.main([*flags, *argv])
        capsys.readouterr()
    else:
        want = 0
    assert rc == want == 0, out + err
    assert out.splitlines()[-1] == "analyze: PASS"


def test_runner_needs_the_card_unless_cpu(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(capsys, "--scopes", "2n1a_r")
    assert rc == 1 and "no CUDA device" in err and "== scope" not in out


def test_analyze_verb_and_module_entry(capsys):
    from ue22cs343bb1_openmp_assignment_tpu_torch import cli
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
        __main__ as entry)
    assert entry.main is runner.main
    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "r.json")
        rc = cli.main(["analyze", "--cpu", "--scopes", "2n1a", "--json",
                       path, "-q"])
        assert rc == 0
        doc = json.loads(pathlib.Path(path).read_text())
    assert capsys.readouterr().out == "analyze: PASS\n"
    assert doc["ok"] and doc["lint"]["findings"] == []
    assert set(doc["prongs"]) == {"model_check", "lint"}
    assert doc["prongs"]["model_check"]["oracle_batches"] > 0


# ---------------------------------------------------------------------------
# serving jobs of the table protocols
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("protocol", ["moesi", "mesif"])
def test_serve_table_protocol_jobs_equal_jax(protocol):
    from ue22cs343bb1_openmp_assignment_tpu import serve as j_serve
    from ue22cs343bb1_openmp_assignment_tpu_torch import serve

    def digests(mod, **kw):
        specs = mod.mixed_jobs(6, nodes=4, trace_len=6, protocol=protocol)
        with tempfile.TemporaryDirectory() as tmp:
            doc = mod.serve(specs, slots=3, chunk=8, queue_capacity=64,
                            out_dir=tmp, **kw)
            return doc, [serve.job_digest(
                serve.read_job_dumps(pathlib.Path(tmp) / s.name, 4),
                doc["jobs"][s.name]["metrics"]) for s in specs]
    doc, got = digests(serve, device="cpu")
    assert doc["jobs_quiesced"] == 6
    assert serve.protocol_phase(protocol) is serve.protocol_phase(protocol)
    assert got == digests(j_serve)[1]


def test_cache_states_of_variant_protocols_reach_the_caches():
    """A moesi run demotes a WRITEBACK_INT-ed owner to OWNED: the table
    phase, not the MESI handlers, stepped the jobs."""
    _, cfg = cfg_pair(2, cache_size=1, mem_size=2, queue_capacity=16,
                      max_instrs=4, inv_mode="mailbox", protocol="moesi")
    from ue22cs343bb1_openmp_assignment_tpu_torch import codec
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    from ue22cs343bb1_openmp_assignment_tpu_torch.serve import (
        protocol_phase)
    a = codec.make_address(cfg, 0, 0)
    st = init_state(cfg, traces=[[(1, a, 5)], [(0, a, 0)]], device="cpu")
    st = step.run_to_quiescence(cfg, st, 200,
                                message_phase=protocol_phase("moesi"))
    assert int(CacheState.OWNED) in st.cache_state.flatten().tolist()
