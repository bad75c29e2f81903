"""The PyTorch port imports neither JAX nor the JAX package.

The port keeps its own copies of the jax-free modules it needs; these
tests pin that by importing every port module in a fresh interpreter,
by a static scan of the sources, and by the device rule of the entry
points (no card: raise unless the caller asks for the CPU).
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from ue22cs343bb1_openmp_assignment_tpu_torch import device
from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional import (
    TransactionalSystem)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se

from tests.torch_parity import cfg_pair, BENCH_DEEP

PKG = "ue22cs343bb1_openmp_assignment_tpu_torch"
ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "ue22cs343bb1_openmp_assignment_tpu")


def _port_modules():
    for path in sorted((ROOT / PKG).rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts), path


def test_importing_the_port_loads_no_jax():
    mods = [m for m, _ in _port_modules()] + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_scans_cover_the_copied_modules():
    """The port's copies of the JAX package's jax-free modules are among
    the modules both checks above import and scan."""
    mods = {m for m, _ in _port_modules()}
    for copy in ("utils.search", "utils.eventlog", "utils.golden",
                 "utils.trace", "config", "types", "codec"):
        assert f"{PKG}.{copy}" in mods, copy


@pytest.mark.parametrize("path", [p for _, p in _port_modules()]
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: p.name)
def test_static_scan_finds_no_jax_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.name}:{node.lineno} imports {name}")


def test_entry_points_need_the_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = cfg_pair(16, **BENCH_DEEP)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransactionalSystem.procedural(cfg, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        se.procedural_state(cfg, 8)
    assert device.resolve("cpu") == torch.device("cpu")
    st = TransactionalSystem.procedural(cfg, 8, device="cpu").state
    assert st.dm.device.type == "cpu"


def test_non_deep_configs_name_the_later_slice():
    """Non-deep configs run since the sync window engine was ported, the
    deep round's event record and the ensembles since slice 8; what
    still waits for a later slice says so, or is absent."""
    _, cfg = cfg_pair(8, procedural="uniform", max_instrs=1)
    st = se.procedural_state(cfg, 4, device="cpu")
    assert int(se.round_step(cfg, st).round) == 1
    _, deep = cfg_pair(8, **BENCH_DEEP)
    out, ev = se.round_step(deep, se.procedural_state(deep, 4, device="cpu"),
                            with_events=True)
    assert int(out.round) == 1 and ev["retired"].shape == (8, 16)
    for ported in ("make_ensemble", "run_ensemble_to_quiescence",
                   "from_sim_state"):
        assert hasattr(se, ported)
    assert not hasattr(se, "run_sync_profile")
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        step.cycle(cfg, None, with_telemetry=True)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No card: non-zero exit and no result line; alone in a directory
    (no package beside it) it fails the same way."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    for cwd in (ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
            text=True, timeout=120,
            env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
        assert out.returncode != 0
        assert '"ok"' not in out.stdout and "FAIL" in out.stdout


def test_async_entry_points_need_the_card_unless_asked_for_cpu(monkeypatch):
    """The message-level engine's entry points (slice 4) follow the same
    device rule: None means the card."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    from ue22cs343bb1_openmp_assignment_tpu_torch.parallel import mesh
    from ue22cs343bb1_openmp_assignment_tpu_torch.state import init_state
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = cfg_pair(16, max_instrs=4)
    for make in (lambda: CoherenceSystem.from_workload(
                     cfg, "procedural_uniform"),
                 lambda: CoherenceSystem.from_test_dir(
                     str(ROOT / "tests" / "fixtures" / "mini")),
                 lambda: init_state(cfg),
                 lambda: mesh.make_layout(16, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    sys_ = CoherenceSystem.from_workload(cfg, "procedural_uniform",
                                         device="cpu")
    assert sys_.state.mb_pack.device.type == "cpu"
    assert mesh.make_layout(16, 4, device="cpu").device == torch.device(
        "cpu")
