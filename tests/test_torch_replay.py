"""The port's ``replay`` (recording and soak-incident kinds) against the
JAX package's, exactly.

A recording made on the CPU by the port's ``DaemonCore`` with a
``RecordingWriter`` on a VirtualClock is byte-identical to the JAX
package's for the same arrivals; each package replays the other's
recording in process with every dump digest matching, and the two replay
documents, stdout and latency entries are equal. ``detect`` names every
artifact as JAX's does. A soak incident replays, ``--slo`` exits 4 and a
tampered digest exits 1; a hang incident without a repro, ``--shrink``
without ``--slo`` and garbage exit 2 as in JAX. (Fixtures, fuzz
incidents and ``--shrink`` against JAX: tests/test_torch_fuzz.py.)
"""

import json

import pytest

from ue22cs343bb1_openmp_assignment_tpu import replay as jreplay
from ue22cs343bb1_openmp_assignment_tpu import soak as jsoak
from ue22cs343bb1_openmp_assignment_tpu.daemon import core as jcore
from ue22cs343bb1_openmp_assignment_tpu.obs.clock import (
    VirtualClock as JaxClock)
from ue22cs343bb1_openmp_assignment_tpu_torch import cli as port_cli
from ue22cs343bb1_openmp_assignment_tpu_torch import replay, soak
from ue22cs343bb1_openmp_assignment_tpu_torch.daemon import core as tcore
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import recording
from ue22cs343bb1_openmp_assignment_tpu_torch.obs.clock import (
    VirtualClock as PortClock)

import tests.torch_parity  # noqa: F401,E402  (one torch thread a process)


def _arrivals(soak_mod, n, rate=60.0, nodes=2, trace_len=4, seed=2):
    """The JAX test's schedule (tests/test_recording.py): n seeded soak
    arrivals alternating over two lanes."""
    arr = soak_mod.soak_stream(rate, max(0.05, n / rate), nodes=nodes,
                               trace_len=trace_len, seed=seed)[:n]
    return [(t, s, ("interactive", "batch")[i % 2])
            for i, (t, s) in enumerate(arr)]


def _record(path, core_mod, soak_mod, Clock, n, **extra):
    core = core_mod.DaemonCore(slots=2, chunk=16, clock=Clock(wave_s=1e-3),
                               **extra)
    core_mod.attach_recorder(core, str(path))
    core_mod.drive(core, _arrivals(soak_mod, n))
    core.recorder.close()
    return path


def _record_port(path, n):
    return _record(path, tcore, soak, PortClock, n, device="cpu")


def test_detect_matrix_equals_jax(tmp_path):
    """Every artifact kind, and each refusal, named as JAX names it."""
    rec = tmp_path / "rec"
    rec.mkdir()
    (rec / recording.FILENAME).write_text(json.dumps(
        {"schema": recording.SCHEMA_ID, "clock": "virtual"}) + "\n")
    cases = [rec, rec / recording.FILENAME]
    for name, doc, fname in (
            ("soak_inc", {"schema": soak.INCIDENT_SCHEMA_ID},
             "incident.json"),
            ("flight_inc", {"schema": "cache-sim/incident/v1"},
             "incident.json"),
            ("odd_inc", {"schema": "cache-sim/other/v1"}, "incident.json"),
            ("fix", {"schema": "cache-sim/repro/v1"}, "repro.json")):
        (tmp_path / name).mkdir()
        (tmp_path / name / fname).write_text(json.dumps(doc))
        cases.append(tmp_path / name)
    cases.append(tmp_path / "fix" / "repro.json")
    (tmp_path / "fixture.json").write_text(
        json.dumps({"schema": "cache-sim/repro/v1"}) + "\n")
    (tmp_path / "other.json").write_text(
        json.dumps({"schema": "cache-sim/other/v1"}) + "\n")
    (tmp_path / "garbage.jsonl").write_text("not json at all\n")
    (tmp_path / "empty").mkdir()
    cases += [tmp_path / n for n in ("fixture.json", "other.json",
                                     "garbage.jsonl", "empty", "missing")]
    seen = []
    for path in cases:
        got = []
        for mod in (replay, jreplay):
            try:
                got.append(mod.detect(path))
            except ValueError as e:
                got.append(f"ValueError: {e}")
        assert got[0] == got[1], path.name
        seen.append(got[0])
    kinds = ["recording", "recording", "soak-incident", "flight-incident",
             None, "fixture", "fixture", "fixture", None, None, None, None]
    assert [None if s.startswith("ValueError") else s for s in seen] == kinds


def test_later_kinds_and_shrink_exit_2(tmp_path, capsys):
    """Where the JAX verb exits 2, so does the port's: a ``--flight-dir``
    hang incident from the CLI has no repro.json (nothing to re-execute),
    ``--shrink`` without ``--slo`` is a usage error, and garbage is not a
    replayable artifact."""
    port_cli.main(["--workload", "uniform", "--nodes", "4", "--trace-len",
                   "8", "--cpu", "--max-cycles", "6", "--flight-dir",
                   str(tmp_path / "fl")])
    assert "incident dumped" in capsys.readouterr().err
    inc = tmp_path / "fl" / "incident_hang"
    assert replay.detect(inc) == "flight-incident"
    assert port_cli.main(["replay", str(inc), "--cpu"]) == 2
    out = capsys.readouterr().out
    assert "has no repro.json" in out
    assert jreplay.main([str(inc)]) == 2
    assert capsys.readouterr().out == out
    for mod in (replay, jreplay):
        with pytest.raises(SystemExit) as e:
            mod.main([str(inc), "--shrink"])
        assert e.value.code == 2
        assert "--shrink needs --slo" in capsys.readouterr().err
    assert replay.main([str(tmp_path / "garbage")]) == 2
    assert jreplay.main([str(tmp_path / "garbage")]) == 2


def _normalized(out: str, *paths) -> str:
    for p in paths:
        out = out.replace(str(p), "{artifact}")
    return out


def test_recording_and_replay_equal_jax(tmp_path, capsys):
    """One schedule recorded by both packages: the recordings are
    byte-identical; the port replays the JAX recording and JAX the
    port's, with every digest matching, and the replay documents, stdout,
    exit codes and latency entries are equal; ``bench-diff --latency``
    of the recorded against the replayed entry passes."""
    port_rec = _record_port(tmp_path / "port_rec", 6)
    jax_rec = _record(tmp_path / "jax_rec", jcore, jsoak, JaxClock, 6)
    assert (port_rec / recording.FILENAME).read_bytes() == \
        (jax_rec / recording.FILENAME).read_bytes()

    rc = port_cli.main(["replay", str(jax_rec), "--cpu", "--out",
                        str(tmp_path / "port_out")])
    out = _normalized(capsys.readouterr().out, jax_rec, tmp_path / "port_out")
    rc_jax = jreplay.main([str(port_rec), "--out", str(tmp_path / "jax_out")])
    out_jax = _normalized(capsys.readouterr().out, port_rec,
                          tmp_path / "jax_out")
    assert (rc, out) == (rc_jax, out_jax) == (0, out)
    docs = []
    for side, rec in (("port_out", jax_rec), ("jax_out", port_rec)):
        doc = json.loads((tmp_path / side / "replay.json").read_text())
        assert doc.pop("recording_path") == str(rec / recording.FILENAME)
        docs.append(doc)
        for name in ("recorded.entry.json", "replayed.entry.json"):
            docs.append((tmp_path / side / name).read_text())
    assert docs[:3] == docs[3:]
    doc = docs[0]
    assert doc["transport"] == "replay"
    assert doc["digests_matched"] == doc["jobs_total"] == 6
    assert doc["digest_mismatches"] == []
    assert doc["latency"]["samples_ms"] == \
        doc["recorded_latency"]["samples_ms"]
    assert port_cli.main(["bench-diff", "--latency",
                          str(tmp_path / "port_out" / "recorded.entry.json"),
                          str(tmp_path / "port_out" / "replayed.entry.json")
                          ]) == 0
    capsys.readouterr()


def test_soak_incident_replays_and_slo_breach_exits_4(tmp_path, capsys):
    """``--slo`` on a replay that breaches exits 4 and dumps an incident
    whose recording slice replays through the same front door; a
    recorded digest that no longer matches exits 1."""
    rec = _record_port(tmp_path / "rec", 4)
    inc = tmp_path / "inc"
    assert replay.main([str(rec), "--cpu", "--wave-s", "0.05", "--slo",
                        "p95=1", "--incident-dir", str(inc)]) == \
        soak.EXIT_SLO_BREACH == 4
    assert "SLO BREACH p95" in capsys.readouterr().err
    assert soak.load_incident(str(inc))["schema"] == soak.INCIDENT_SCHEMA_ID
    assert replay.detect(inc) == "soak-incident"
    assert replay.main([str(inc), "--cpu", "--wave-s", "0.05", "--json"]) == 0
    out = capsys.readouterr().out
    doc = json.loads(out[out.index("{"):])
    assert doc["digests_matched"] == doc["recorded_jobs"] >= 1
    assert replay.main([str(rec), "--cpu", "--burn-slo",
                        "0.000001ms,fast=60,slow=300,factor=2",
                        "--incident-dir", str(tmp_path / "burn")]) == 4
    assert "BURN-RATE ALERT" in capsys.readouterr().err

    path = rec / recording.FILENAME
    rows = [json.loads(x) for x in path.read_text().splitlines()]
    for row in rows:
        if row.get("event") == "result":
            row["digest"] = "0" * 16
    path.write_text("".join(json.dumps(r, sort_keys=True) + "\n"
                            for r in rows))
    assert replay.main([str(rec), "--cpu"]) == 1
    assert "DIVERGENT" in capsys.readouterr().out


def test_replay_needs_the_card_unless_asked_for_cpu(monkeypatch, tmp_path,
                                                    capsys):
    """Without ``--cpu`` the in-process replay runs on the card: with no
    card it exits 1 with the port CLI's error."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec = tmp_path / "rec"
    rec.mkdir()
    (rec / recording.FILENAME).write_text(json.dumps(
        {"schema": recording.SCHEMA_ID, "clock": "virtual"}) + "\n")
    assert replay.main([str(rec)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
