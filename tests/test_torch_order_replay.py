"""The port's interleaving replay against the JAX package's.

``utils/order_replay.py`` of both packages parse the recorded
``instruction_order.txt`` of tests/fixtures/mini into equal records and
equal ``order_rank`` arrays; an async run gated by that order ends in
equal states (every leaf) and byte-identical dumps, and issues the
instructions in the recorded order. Mismatched and absent logs are
refused with the same errors.
"""

import pathlib

import numpy as np
import pytest

from ue22cs343bb1_openmp_assignment_tpu.config import (
    SystemConfig as JaxConfig)
from ue22cs343bb1_openmp_assignment_tpu.ops import step as jstep
from ue22cs343bb1_openmp_assignment_tpu.state import init_state as jinit
from ue22cs343bb1_openmp_assignment_tpu.utils import (
    eventlog as jeventlog, golden as jgolden, order_replay as jreplay,
    trace as jtrace)
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
from ue22cs343bb1_openmp_assignment_tpu_torch.state import init_state
from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
    dump_view)
from ue22cs343bb1_openmp_assignment_tpu_torch.utils import (
    eventlog, golden, order_replay, trace)

from tests.torch_parity import assert_sim_states_equal

MINI = pathlib.Path(__file__).resolve().parent / "fixtures" / "mini"
JCFG, CFG = JaxConfig.reference(), SystemConfig.reference()


def _lines():
    return [ln.strip() for ln in
            (MINI / "instruction_order.txt").read_text().splitlines()
            if ln.strip()]


def test_records_and_ranks_equal_the_jax_package():
    lines = _lines()
    assert order_replay.parse_order_log(lines) == jreplay.parse_order_log(
        lines)
    traces = trace.load_test_dir(str(MINI))
    want = jreplay.load_order_rank(JCFG, str(MINI),
                                   jtrace.load_test_dir(str(MINI)))
    got = order_replay.load_order_rank(CFG, str(MINI), traces)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # node-major order: another valid interleaving, another rank array
    recs = order_replay.parse_order_log(lines)
    alt = [lines[g] for g in sorted(range(len(recs)),
                                    key=lambda g: (recs[g][0], g))]
    np.testing.assert_array_equal(
        order_replay.order_rank_from_log(CFG, alt, traces),
        jreplay.order_rank_from_log(JCFG, alt, traces))


def test_replayed_run_equals_the_jax_package():
    traces = trace.load_test_dir(str(MINI))
    order = order_replay.load_order_rank(CFG, str(MINI), traces)
    j, jev = jstep.run_cycles_traced(JCFG, jinit(JCFG, traces,
                                                 order_rank=order), 64)
    t, tev = step.run_cycles_traced(
        CFG, init_state(CFG, traces, order_rank=order, device="cpu"), 64)
    assert bool(t.quiescent())
    assert_sim_states_equal(j, t)
    want = [jgolden.format_node_dump(d)
            for d in jgolden.state_to_dumps(JCFG, j)]
    got = [golden.format_node_dump(d)
           for d in golden.state_to_dumps(CFG, dump_view(t))]
    assert got == want
    lines = eventlog.to_lines({k: v.cpu().numpy() for k, v in tev.items()})
    assert lines == jeventlog.to_lines({k: np.asarray(v)
                                        for k, v in jev.items()})
    assert lines == _lines()


def test_mismatched_and_absent_logs_are_refused_alike(tmp_path):
    traces = trace.load_test_dir(str(MINI))
    lines = _lines()
    errors = []
    for mod, cfg in ((jreplay, JCFG), (order_replay, CFG)):
        with pytest.raises(ValueError, match="trace") as e:
            mod.order_rank_from_log(cfg, lines[:-1], traces)
        errors.append(str(e.value))
        bad = list(lines)
        bad[0] = bad[0].replace("type=W", "type=R")
        with pytest.raises(ValueError, match="trace") as e:
            mod.order_rank_from_log(cfg, bad, traces)
        errors.append(str(e.value))
        with pytest.raises(ValueError, match="unparseable") as e:
            mod.parse_order_log(["Processor 0 did something"])
        errors.append(str(e.value))
        with pytest.raises(FileNotFoundError):
            mod.load_order_rank(cfg, str(tmp_path), traces)
        (tmp_path / "instruction_order.txt").write_text("\n")
        with pytest.raises(ValueError, match="empty") as e:
            mod.load_order_rank(cfg, str(tmp_path), traces)
        errors.append(str(e.value))
        (tmp_path / "instruction_order.txt").unlink()
    half = len(errors) // 2
    assert errors[half:] == errors[:half]
