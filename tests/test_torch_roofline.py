"""The port's roofline and profiler (``obs/roofline.py``,
``obs/profiler.py``) against the JAX package, exactly.

The host arithmetic of ``obs/roofline.py`` is a copy: on the same seeded
inputs every copied function returns what JAX's returns. The port's own
parts are pinned here too: the ``h100`` row of the peak table, the
transport row over the port's ``wire_bytes``, the dispatch record (the
port's stand-in for XLA's cost model: deterministic, leaves its inputs
alone, counts the port's kernel launches at their I/O contracts), the
timer self-check, ``torch.profiler`` capture and the cost report's keys.
"""

import json

import numpy as np
import pytest

from ue22cs343bb1_openmp_assignment_tpu.obs import profiler as jax_profiler
from ue22cs343bb1_openmp_assignment_tpu.obs import roofline as jax_roofline
from ue22cs343bb1_openmp_assignment_tpu_torch import convert
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import profiler, roofline
from ue22cs343bb1_openmp_assignment_tpu_torch.obs.phases import PhaseTimer

from tests.torch_parity import cfg_pair

H100 = "NVIDIA H100 80GB HBM3"


def _records(seed: int) -> list:
    """Seeded kernel records: four cost-model rows, an io-contract row and
    one whose cost is unavailable."""
    rng = np.random.default_rng(seed)
    recs = [{"name": f"k{i}", "flops": float(rng.integers(0, 10**9)),
             "hbm_bytes": float(rng.integers(1, 10**9)),
             "output_bytes": float(rng.integers(0, 10**8)),
             "cost_available": True, "hlo_fingerprint": f"{i:016x}"}
            for i in range(4)]
    recs.append({"name": "fused[io-contract]", "flops": 0.0,
                 "hbm_bytes": float(rng.integers(1, 10**6)),
                 "output_bytes": 1.0, "cost_available": True,
                 "hlo_fingerprint": None, "basis": "io-contract"})
    recs.append({"name": "gone", "flops": None, "hbm_bytes": None,
                 "output_bytes": None, "cost_available": False,
                 "hlo_fingerprint": None, "error": "no cost model"})
    return recs


def _doc(mod, seed: int, timing: bool):
    """A perf-report document built by ``mod``'s build_report, with the
    optional blocks render_text draws."""
    recs = _records(seed)
    doc = mod.build_report("deep", {"nodes": 64, "workload": "uniform"},
                           recs, "k0", 96, 4096, device_kind="TPU v5e")
    doc["fused"] = {"kernel": "fused[io-contract]", "basis": "io-contract",
                    "bytes_per_instr": 12.5,
                    "unfused_bytes_per_instr": doc["bytes_per_instr"]}
    doc["transport"] = {"basis": "wire-shape", "n_shards": 8,
                        "lane_cap": 64, "savings_frac": 0.1,
                        "rdma_strictly_fewer": True,
                        "bytes_per_round": {"all_to_all": 9000,
                                            "rdma": 8100}}
    doc["vmem"] = [{"kernel": "round", "basis": "block-table", "ok": True,
                    "resident_in_bytes": 2**20, "resident_out_bytes": 2**19,
                    "headroom_bytes": 2**18, "required_bytes": 2**21,
                    "vmem_bytes": 16 * 2**20, "device_kind": "TPU v5e"}]
    doc["index"] = {"target": "round", "index_sites": 7,
                    "indices_per_step": 100, "indices_per_instr": 2.5,
                    "by_plane": {"dm": 60, "cache": 40},
                    "merge_candidates": 2}
    if timing:
        doc["timing"] = mod.timing_section(
            {"phases": {"execute_dispatch": {"seconds": 0.3, "count": 3},
                        "device_get_sync": {"seconds": 0.6, "count": 3}}},
            doc["kernels"], 96, 4096, [0.31, 0.29, 0.35])
    return doc


def _case(name: str, mod):
    """What ``mod``'s copy of one function returns on the seeded inputs of
    case ``name``."""
    if name == "normalize_cost":
        return [mod.normalize_cost(c) for c in (
            {"flops": 10, "bytes accessed": 40.0}, None, [], "junk",
            [{"flops": 10.0}, {"flops": 5.0, "bytes accessed": 8}],
            [{"flops": "n/a"}, 7])]
    if name == "device_peaks":
        kinds = [k for k, _ in jax_roofline.PEAKS]
        kinds += ["TPU v5 lite", "TPU v6e", "Cpu", "quantum-abacus-9000"]
        return [mod.device_peaks(k) for k in kinds]
    if name == "io_contract_record":
        return [mod.io_contract_record("r", 1234, 567),
                mod.io_contract_record("s", 8.0, 0.5, flops=3.0)]
    if name == "classify":
        peaks = mod.device_peaks("TPU v4")
        recs = _records(1) + [dict(_records(2)[0], hbm_bytes=0.0)]
        return [mod.classify(r, peaks) for r in recs]
    if name == "cost_vector":
        recs = _records(3)
        return [mod.cost_vector(recs[0], recs[1], 96, 4096),
                mod.cost_vector(recs[0], None, 96, 0),
                mod.cost_vector(recs[5], recs[2], 7, 100)]
    if name == "build_report":
        return [mod.build_report("async", {"nodes": 8}, _records(4), "k2",
                                 12, 64, device_kind="cpu"),
                _doc(mod, 5, timing=True)]
    if name == "timing_section":
        doc = _doc(mod, 6, timing=False)
        phases = {"phases": {"execute_dispatch": {"seconds": 1.0,
                                                  "count": 2}}}
        return [mod.timing_section(phases, doc["kernels"], 96, 4096,
                                   [0.5, 0.4]),
                mod.timing_section(phases, doc["kernels"], 96, 0, [0.5]),
                mod.timing_section({}, doc["kernels"], 96, 4096, [])]
    if name == "render_text":
        return [mod.render_text(_doc(mod, 7, timing=True)),
                mod.render_text(mod.build_report(
                    "sync", {"nodes": 4}, [_records(8)[5]], "gone", 1,
                    1, device_kind="cpu"))]
    if name == "hlo_fingerprint":
        return [mod.hlo_fingerprint(t) for t in ("", "aten.add.Tensor",
                                                 "x" * 1000)]
    raise KeyError(name)


COPIES = ("normalize_cost", "device_peaks", "io_contract_record",
          "classify", "cost_vector", "build_report", "timing_section",
          "render_text", "hlo_fingerprint")


@pytest.mark.parametrize("name", COPIES)
def test_copied_functions_match_jax(name):
    assert _case(name, roofline) == _case(name, jax_roofline)


def test_h100_row_classifies_the_card():
    p = roofline.device_peaks(H100)
    assert p["source"] == "static_table" and p["kind"] == H100
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert p["flops_per_s"] == 67e12 / 4
    assert p["vmem_bytes"] == 227 * 1024
    assert p["ridge_flops_per_byte"] == pytest.approx(5.0)
    # JAX has no such row: its generic fallback
    assert jax_roofline.device_peaks(H100)["source"] == "generic_fallback"
    # the rows JAX has classify as JAX classifies them
    assert [roofline.device_peaks(k) for k, _ in jax_roofline.PEAKS] == \
        [jax_roofline.device_peaks(k) for k, _ in jax_roofline.PEAKS]
    assert roofline.detect_device_kind("cpu") == "cpu"


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_transport_section_matches_jax(shards):
    jcfg, pcfg = cfg_pair(64)
    assert roofline.transport_section(pcfg, shards) == \
        jax_roofline.transport_section(jcfg, shards)


@pytest.fixture(scope="module")
def machine():
    from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    cfg = SystemConfig.scale(num_nodes=8)
    sysm = CoherenceSystem.from_workload(cfg, "uniform", trace_len=8,
                                         seed=0, device="cpu")
    return sysm.cfg, sysm.state


def test_dispatch_record_of_a_cycle(machine):
    """Deterministic (records and fingerprints equal), leaves its input
    state bit-identical, moves bytes, HBM-bound on the CPU and the card."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    cfg, st0 = machine
    before = convert.sim_numpy_leaves(st0)
    a = roofline.kernel_record("step.cycle", step.cycle, cfg, st0)
    b = roofline.kernel_record("step.cycle", step.cycle, cfg, st0)
    after = convert.sim_numpy_leaves(st0)
    assert a == b and a["hlo_fingerprint"] == b["hlo_fingerprint"]
    assert all(np.array_equal(before[k], after[k]) for k in before)
    assert a["cost_available"] and a["basis"] == "aten-dispatch"
    assert a["hbm_bytes"] > 0 and 0 < a["output_bytes"] < a["hbm_bytes"]
    assert a["ops"] > 0 and a["launches"] == {} and a["flops"] > 0
    for kind in ("cpu", H100):
        assert roofline.classify(a, roofline.device_peaks(kind))[
            "bound"] == "hbm"
    # a step later is another call on the same shapes: the same program
    c = roofline.kernel_record("step.cycle", step.cycle, cfg,
                               step.cycle(cfg, st0))
    assert c["hlo_fingerprint"] == a["hlo_fingerprint"]
    bad = roofline.kernel_record("x", step.cycle, cfg, None)
    assert bad["cost_available"] is False and bad["error"]
    assert bad["hbm_bytes"] is None


def test_dispatch_record_counts_kernel_launches(machine):
    """A launch seen as a counter delta adds the wrapper's I/O contract
    (a ctypes launch never passes the dispatcher); a kernel whose
    contract the config does not fix needs it passed."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_fold_kernel as dfk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_round_kernel as drk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.parallel import ring_kernel
    from tests.torch_parity import BENCH_DEEP
    _, cfg = cfg_pair(16, **BENCH_DEEP)
    saved = (drk.fused_round.launches, dfk.fold_pre.launches,
             ring_kernel.exchange.launches)

    def fake(cfg, x, ring=False):
        drk.fused_round.launches += 2
        y = x + 1
        dfk.fold_pre.launches += 1
        if ring:
            ring_kernel.exchange.launches += 1
        return y

    import torch
    x = torch.zeros(4, dtype=torch.int32)
    try:
        rec = roofline.kernel_record("fake", fake, cfg, x)
        plain = roofline.kernel_record("plain", lambda c, t: t + 1, cfg, x)
        rows_in, rows_out = dfk.io_rows(cfg, "pre")
        want = (2 * sum(drk.io_contract_bytes(cfg))
                + 4 * 16 * (rows_in + sum(rows_out)))
        assert rec["launches"] == {"pre": 1, "round": 2}
        assert rec["hbm_bytes"] == plain["hbm_bytes"] + want
        assert rec["output_bytes"] == plain["output_bytes"] + \
            2 * drk.io_contract_bytes(cfg)[1] + 4 * 16 * sum(rows_out)
        assert rec["flops"] == plain["flops"]
        assert rec["hlo_fingerprint"] != plain["hlo_fingerprint"]
        bad = roofline.kernel_record("ring", fake, cfg, x, True)
        assert not bad["cost_available"] and "contract" in bad["error"]
        ok = roofline.kernel_record("ring", fake, cfg, x, True,
                                    contracts={"ring": (10, 10)})
        assert ok["hbm_bytes"] == rec["hbm_bytes"] + 20
    finally:
        (drk.fused_round.launches, dfk.fold_pre.launches,
         ring_kernel.exchange.launches) = saved


def test_timer_self_check_trusts_the_cpu_barrier(machine):
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    cfg, st0 = machine
    chk = profiler.timer_self_check(lambda: step.cycle(cfg, st0), reps=2)
    assert chk["barrier_trustworthy"] is True
    assert chk["device_get_tail_s"] >= 0.0 and chk["reps"] == 2
    assert chk["verdict"] == "block_until_ready is a real barrier here"


def test_capture_writes_a_trace_and_passes_none_through(tmp_path, machine):
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    cfg, st0 = machine
    with profiler.capture(None) as st:
        pass
    assert st == {"enabled": False, "out_dir": None, "error": None}
    out = tmp_path / "prof"
    with profiler.capture(str(out), quiet=True) as st:
        step.cycle(cfg, st0)
    assert st["enabled"] and st["error"] is None
    trace = json.loads((out / profiler.TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)


def test_kernel_cost_report_has_the_jax_keys(machine):
    import jax
    import jax.numpy as jnp
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    cfg, st0 = machine
    want = jax_profiler.kernel_cost_report(jax.jit(lambda x: x * 2),
                                           jnp.ones(8, jnp.int32))
    rep = profiler.kernel_cost_report(step.cycle, cfg, st0)
    assert set(want) <= set(rep) and rep["available"]
    assert rep["cost_unavailable"] is False
    assert set(rep["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes"}
    assert rep["cost"] == {
        jax_roofline._FLOPS_KEY: rep["cost"]["flops"],
        jax_roofline._BYTES_KEY: rep["cost"]["bytes accessed"],
        jax_roofline._OUT_BYTES_KEY: rep["cost"]["bytes accessedout{}"]}
    rec = roofline.kernel_record("c", step.cycle, cfg, st0)
    assert rep["cost"]["bytes accessed"] == rec["hbm_bytes"]
    assert rep["hlo_fingerprint"] == rec["hlo_fingerprint"]
    timer = PhaseTimer()
    timer.add("run", 0.5)
    got = profiler.attach_kernel_costs(timer, step.cycle, cfg, st0)
    assert timer.report()["kernels"] is got
