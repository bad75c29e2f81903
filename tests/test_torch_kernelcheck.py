"""The CUDA kernel-contract verifier (``analysis/kernelcheck.py``).

An atomicMin is not an f32 exponent ladder, so only the report's shape,
its schema string and the runner's exit codes and usage messages are
held to the JAX package; the passes are held to the port's own
contracts: the packed words' budgets derived in exact integers match
the config's caps, the key function's extremes agree in int32 and in
Python big ints, the fused round's plain version at the extremes, the
ptxas parser and the residency arithmetic on fixture text, the resource
contract on the capture from the card, the gates, and each kernel
mutant killed with its finding kind. The card-only checks are in
tests/test_torch_cuda.py.
"""

from __future__ import annotations

import dataclasses

import pytest

from ue22cs343bb1_openmp_assignment_tpu.analysis import (
    kernelcheck as j_kc)
from ue22cs343bb1_openmp_assignment_tpu.analysis import runner as j_runner
from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
    kernelcheck as kc)
from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
    mutations, runner)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import kernel_build
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se

import tests.torch_parity  # noqa: F401,E402  (one torch thread a process)


def _run(capsys, *argv) -> tuple:
    rc = runner.main(["--cpu", "--skip-model-check", "--skip-lint",
                      *argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_layouts_equal_the_config_caps():
    cfg = kc.headline_config()
    b = kc.derived_bounds(cfg)
    # the caps SystemConfig enforces are exactly what the fields hold
    assert b["node_cap"] == 1 << 16 == b["req_sentinel"] + 1
    assert b["storm_node_cap"] == (1 << 15) - 1 < b["req_sentinel"]
    assert b["req_bits"] == 16 and b["req_word_max"] < 1 << 31
    # the claim key uses int32's positive range to the bit
    assert b["prio_bits"] == 12 and b["slot_bits"] == 0
    assert b["claim_max_rounds"] == se.claim_max_rounds(cfg)
    assert b["thresh_max"] == 1 << 30 and b["key_max"] < 1 << 30
    assert b["act_max"] == (se.claim_max_rounds(cfg) << 11) | 0x7FF
    assert b["sync_thresh_max"] == 1 << 30
    # at the 2**20 round cap (small machines) DM_ACT's round field is
    # what binds: 20 + 11 bits
    small = kc.derived_bounds(kc.headline_config(16))
    assert small["claim_max_rounds"] == (1 << 20) - 1
    assert small["act_max"] == (1 << 31) - 1
    assert kc.layout_findings(cfg) == []


@pytest.mark.parametrize("cfg", [
    kc.headline_config(), kc.headline_config(16),
    kc.headline_config(65536),
    dataclasses.replace(kc.headline_config(8192), deep_waves=3),
    dataclasses.replace(kc.headline_config(256), deep_read_storm=True,
                        deep_ownerval_slots=2)],
    ids=["headline", "16", "65536", "waves3", "storm"])
def test_key_extremes_agree_in_int32_and_big_ints(cfg):
    ex = kc.check_exactness(cfg)
    assert ex["ok"], ex["findings"]
    keys = ex["key_extremes"]
    cmr = se.claim_max_rounds(cfg)
    assert {k["round"] for k in keys if k["key"] == "deep"} == {0, cmr - 1}
    assert {cfg.num_nodes - 1, 0} <= {k["node"] for k in keys}
    assert all(k["big"] == k["int32"] for k in keys)


def test_extreme_rounds_run_the_plain_round_on_cpu():
    r = kc.extreme_rounds(kc.headline_config(16), "cpu")
    cmr = se.claim_max_rounds(kc.headline_config(16))
    assert r["equal"] and [x["round"] for x in r["rounds"]] == [0, cmr - 1]
    assert all(x["retired"] > 0 for x in r["rounds"])


def test_shared_memory_layouts():
    rows = kc.vmem_rows(kc.headline_config())
    got = {r["kernel"]: (r["resident_in_bytes"], r["resident_out_bytes"])
           for r in rows}
    # 7 tables x 16 entries x 64 threads; plus the directory span, the
    # own-lane codes and 3 words a thread in the round
    assert got == {"deep.fold": (28672, 0), "deep.round_fused": (62720, 0)}
    assert all(r["vmem_bytes"] == 227 * 1024 and r["ok"] for r in rows)
    sync = kc.smem_layout("sync.multi_round_fused", kc.headline_config())
    assert (sync["dynamic"], sync["static"]) == (0, 80)
    # 32 entries a node take 124,160 B a block (deep_round.cu's note)
    wide = dataclasses.replace(kc.headline_config(), mem_size=32)
    assert kc.smem_layout("deep.round_fused", wide)["dynamic"] == 124160


_PTXAS = """\
ptxas info    : Compiling entry function '_Z16deep_round_kernel9RoundArgs' for 'sm_90a'
ptxas info    : Function properties for _Z16deep_round_kernel9RoundArgs
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z17sync_round_kernelPKi' for 'sm_90a'
ptxas info    : Function properties for _Z17sync_round_kernelPKi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 80 bytes smem, 448 bytes cmem[0]
"""


def test_ptxas_parsing_and_residency_on_fixture_text():
    got = kernel_build.parse_ptxas(_PTXAS, {r"deep_round_kernel": "round",
                                            r"sync_round_kernel": "sync"})
    assert got == {"round": {"smem": 0, "stack": 8, "spill_stores": 4,
                             "spill_loads": 4, "registers": 255},
                   "sync": {"smem": 80, "stack": 0, "spill_stores": 0,
                            "spill_loads": 0, "registers": 64}}
    # 255 registers -> 256 a thread, 8 warps an SM: 4 blocks of 64; the
    # shared memory (62,720 + 1,024 reserved) allows 3
    occ = kc.blocks_per_sm(255, 64, 62720)
    assert (occ["by_registers"], occ["by_smem"], occ["blocks"]) == (4, 3, 3)
    assert kc.coop_grid(3, None, 64, 4096) == 64
    assert kc.coop_grid(3, None, 64, 1 << 20) == 3 * 132
    occ = kc.blocks_per_sm(64, 64, 80)
    assert occ["blocks"] == 16 and kc.coop_grid(16, 4, 64, 1 << 20) == 528
    assert kc.blocks_per_sm(96, 64, 80)["by_registers"] == 10
    # the spill is a finding; a missing library is reported
    rep = kc.check_resources(4096, {"deep_round": _PTXAS})
    kinds = {f["kind"] for f in rep["findings"]}
    assert {"spill", "ptxas_missing"} <= kinds
    assert rep["kernels"]["deep_round/round"]["grids"]["4096"] == \
        {"derived": 64}


def test_resource_contract_on_the_card_capture():
    fx = kc.load_fixture()
    assert "H100" in fx["card"]
    rep = kc.check_resources(
        4096, {k: v["log"] for k, v in fx["libraries"].items()},
        stems={k: v["stem"] for k, v in fx["libraries"].items()})
    assert rep["ok"], rep["findings"]
    assert set(rep["kernels"]) == {f"{a}/{b}" for a, b in kc.RESOURCE_PINS}
    for name in ("deep_round/round", "sync_round/round",
                 "sync_multi_round/multi_round"):
        assert rep["kernels"][name]["blocks_per_sm"]["blocks"] >= 1


def test_a_changed_source_makes_the_capture_stale():
    fx = kc.load_fixture()
    stems = {k: v["stem"] for k, v in fx["libraries"].items()}
    stems["deep_round"] = "deep_round-0000000000000000"
    rep = kc.check_resources(
        4096, {k: v["log"] for k, v in fx["libraries"].items()},
        stems=stems)
    assert [f["kind"] for f in rep["findings"]] == ["ptxas_stale"]


def test_gates_agree_on_jax_probes_and_mask_edges():
    g = kc.check_gates()
    assert g["ok"], g["findings"]
    assert [n for n, _ in j_kc._probe_configs()] == list(g["probes"])[:6]
    assert g["probes"]["storm_256"] == {"supported": False,
                                        "analyzer": False,
                                        "legacy_product_bound": False,
                                        "widened": False}
    for edge in ("deep_slots", "cache_size", "entries"):
        ok, past = [n for n in g["probes"] if n.startswith(edge)]
        assert g["probes"][ok]["supported"] and \
            not g["probes"][past]["supported"]
    # the CUDA kernel takes what the TPU kernel's contender cap refused
    assert g["probes"]["cap_boundary_16384"]["widened"]


def test_report_keys_are_jax_keys():
    rep = kc.check(trace=False)
    assert set(rep) == {"schema", "config", "traced", "exactness", "vmem",
                        "lowerability", "gates", "findings", "ok"}
    assert rep["schema"] == j_kc.SCHEMA and rep["ok"]
    assert rep["config"] == {"num_nodes": 4096, "deep_slots": 3,
                             "deep_waves": 1, "drain_depth": 13,
                             "txn_width": 3}
    assert rep["lowerability"]["ok"] is None
    h, jh = kc.headline_config(), j_kc.headline_config()
    assert (h.num_nodes, h.deep_slots, h.drain_depth, h.txn_width,
            h.deep_horizon_slack) == (jh.num_nodes, jh.deep_slots,
                                      jh.drain_depth, jh.txn_width,
                                      jh.deep_horizon_slack)


@pytest.mark.parametrize("name", sorted(mutations.KERNEL_MUTATIONS))
def test_kernel_mutant_killed_with_its_kind(name, capsys, tmp_path):
    path = tmp_path / "k.json"
    rc, out, _ = _run(capsys, "--kernel", "--mutation", name, "--json",
                      str(path))
    import json
    rep = json.loads(path.read_text())["kernel"]
    kind = mutations.KERNEL_MUTATIONS[name][1]
    assert rc == 1 and out.splitlines()[-1] == "analyze: FAIL"
    assert rep["mutant_killed"] and rep["expected_kind"] == kind
    assert kind in {f["kind"] for f in rep["findings"]}
    assert not rep["traced"]
    # the seeded parameter is restored
    assert kc.check(trace=False)["ok"]


def test_runner_kernel_prong_exit_0(capsys):
    rc, out, _ = _run(capsys, "--kernel")
    assert rc == 0 and out.splitlines()[-1] == "analyze: PASS"
    assert "resource contract (fixture" in out
    rc, out, _ = _run(capsys, "--kernel", "--kernel-static")
    assert rc == 0 and "resource contract" not in out


@pytest.mark.parametrize("name", ["widen_min_chunk", "split_packed_scatter",
                                  "no_such_mutation"])
def test_mutation_usage_messages_are_jax_messages(name):
    """A kernel or index mutation given to the protocol prongs stops with
    the JAX runner's message, and an unknown name lists the same
    mutations of each kind."""
    with pytest.raises(SystemExit) as want:
        j_runner._resolve_mutation(name)
    with pytest.raises(SystemExit) as got:
        runner._resolve_mutation(name)
    assert str(got.value) == str(want.value)
