"""scripts/sync_reference.py, which pins the states ``chip_smoke.py``
holds the fused sync rounds' runs to quiescence to (SYNC_REFERENCE):
at small copies of its two configs on the CPU, its rounds, retired
instructions and digest equal the JAX package's
``run_sync_to_quiescence`` of the same config, and the pinned
reference names the config that the card's run uses.
"""

import importlib.util
import pathlib

import pytest

from ue22cs343bb1_openmp_assignment_tpu.ops import sync_engine as jse
from ue22cs343bb1_openmp_assignment_tpu_torch import convert

from tests.torch_parity import cfg_pair

ROOT = pathlib.Path(__file__).resolve().parents[1]
NODES, LENGTH, CHUNK = 64, 24, 8


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("txn_width", [3, 1])
def test_sync_reference_is_the_jax_run(txn_width):
    script = _load("sync_reference", ROOT / "scripts" / "sync_reference.py")
    got = script.reference(NODES, LENGTH, CHUNK, txn_width, "cpu")
    drain = 16 if txn_width == 1 else 4
    jcfg, _ = cfg_pair(NODES, drain_depth=drain, txn_width=txn_width,
                       procedural="uniform", max_instrs=1,
                       proc_local_permille=800)
    want = jse.run_sync_to_quiescence(
        jcfg, jse.procedural_state(jcfg, LENGTH), CHUNK, 100_000)
    assert bool(want.quiescent())
    assert got == {
        "rounds": int(want.metrics.rounds),
        "instrs_retired": NODES * LENGTH,
        "digest": convert.leaves_digest(convert.to_numpy(want))}


def test_chip_smoke_pins_the_sync_reference_of_its_run():
    smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    assert set(smoke.SYNC_REFERENCE) == {3, 1}
    for k, ref in smoke.SYNC_REFERENCE.items():
        cfg = smoke.sync_cfg(smoke.BENCH["num_nodes"], k)
        assert ref["instrs_retired"] == (smoke.BENCH["num_nodes"]
                                         * smoke.BENCH["trace_len"])
        assert ref["rounds"] % smoke.BENCH["chunk"] == 0
        assert len(ref["digest"]) == 64
        assert cfg.drain_depth == (16 if k == 1 else 4)
