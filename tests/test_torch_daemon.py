"""The port's daemon against the JAX package's, exactly.

``DaemonCore`` driven with one schedule into both packages' cores under a
VirtualClock gives byte-identical stats, trace docs, results, recordings
and event streams (the scenarios of the JAX package's
tests/test_daemon.py: mid-wave swap, bucket budget, lanes, backpressure,
drain, retention, bucket growth). Over a unix socket, a port server
answers the JAX package's client and the port's alike, and the port's
client the JAX server. Socket paths live under ``tmp_path``, every wait
has its own timeout, server threads are joined in ``finally``.
"""

import json
import pathlib
import threading

from ue22cs343bb1_openmp_assignment_tpu import serve as jserve
from ue22cs343bb1_openmp_assignment_tpu.daemon import core as jcore
from ue22cs343bb1_openmp_assignment_tpu.daemon.client import (
    DaemonClient as JaxClient)
from ue22cs343bb1_openmp_assignment_tpu.daemon.server import (
    DaemonServer as JaxServer)
from ue22cs343bb1_openmp_assignment_tpu.obs.clock import (
    VirtualClock as JaxClock)
from ue22cs343bb1_openmp_assignment_tpu_torch import serve as tserve
from ue22cs343bb1_openmp_assignment_tpu_torch.daemon import core as tcore
from ue22cs343bb1_openmp_assignment_tpu_torch.daemon.client import (
    DaemonClient as PortClient)
from ue22cs343bb1_openmp_assignment_tpu_torch.daemon.server import (
    DaemonServer as PortServer)
from ue22cs343bb1_openmp_assignment_tpu_torch.obs.clock import (
    VirtualClock as PortClock)

SIDES = {"jax": (jcore, jserve.JobSpec, JaxClock, {}),
         "port": (tcore, tserve.JobSpec, PortClock, {"device": "cpu"})}


def _spec(JobSpec, name, nodes=2, trace_len=4, workload="uniform", seed=0):
    return JobSpec(name=name, workload=workload, nodes=nodes,
                   trace_len=trace_len, seed=seed)


def _bimodal(JobSpec, n, small=(2, 4), big=(8, 16)):
    out = []
    for i in range(n):
        nodes, tl = small if i % 2 == 0 else big
        out.append(_spec(JobSpec, f"bi{i:03d}", nodes=nodes, trace_len=tl,
                         workload=("uniform", "hotspot")[i % 2], seed=i))
    return out


def _dumps(x) -> str:
    return json.dumps(x, sort_keys=True)


def _both(scenario, tmp_path=None, **core_kw):
    """Run ``scenario(core, mod, JobSpec)`` on a fresh core of each
    package (recorder and emitter attached when ``tmp_path`` is given)
    and hold everything it exposes equal; returns the port's core."""
    seen = {}
    for name, (mod, JobSpec, Clock, extra) in SIDES.items():
        core = mod.DaemonCore(clock=Clock(), **core_kw, **extra)
        if tmp_path is not None:
            for sub in ("rec", "ev"):
                (tmp_path / name / sub).mkdir(parents=True)
            mod.attach_recorder(core, tmp_path / name / "rec")
            mod.attach_emitter(core, path=tmp_path / name / "ev")
        resp = scenario(core, mod, JobSpec)
        if tmp_path is not None:
            core.recorder.close()
            core.emitter.close()
        stats = core.stats()
        if tmp_path is not None:
            for k in ("recording", "events"):
                stats[k]["path"] = stats[k]["path"].replace(
                    str(tmp_path / name), "{tmp}")
        seen[name] = (_dumps(resp), _dumps(stats), _dumps(core.trace_doc()),
                      _dumps(core.results),
                      {k: core.status(k) for k in sorted(core._status)})
        if name == "port":
            port = core
    assert seen["port"][0] == seen["jax"][0], "responses differ"
    assert seen["port"][1] == seen["jax"][1], "stats differ"
    assert seen["port"][2] == seen["jax"][2], "trace docs differ"
    assert seen["port"][3] == seen["jax"][3], "results differ"
    assert seen["port"][4] == seen["jax"][4], "statuses differ"
    if tmp_path is not None:
        for sub in ("rec", "ev"):
            fj = {p.name: p.read_bytes() for p in
                  (tmp_path / "jax" / sub).iterdir()}
            fp = {p.name: p.read_bytes() for p in
                  (tmp_path / "port" / sub).iterdir()}
            assert fp == fj, sub
    return port


def test_core_mid_wave_swap_parity(tmp_path):
    """5 mixed-shape jobs through 2 slots of ONE bucket: a job swapped
    in mid-wave; every response, stats and trace doc, result (dumps
    included), recording and event stream equal the JAX core's."""
    def scenario(core, mod, JobSpec):
        return mod.drive(core, [
            (0.0, s, ("interactive", "batch")[i % 2])
            for i, s in enumerate(_bimodal(JobSpec, 5))])
    core = _both(scenario, tmp_path, slots=2, max_buckets=1, chunk=8)
    assert core.mid_wave_swaps >= 1
    for s in _bimodal(tserve.JobSpec, 5)[:2]:
        assert core.result(s.name)["dumps"] == tserve.solo_dumps(
            s, device="cpu")


def test_core_bucket_budget_parity():
    def scenario(core, mod, JobSpec):
        return mod.drive(core, [(0.001 * i, s, "batch") for i, s in
                                enumerate(_bimodal(JobSpec, 8))])
    core = _both(scenario, slots=2, max_buckets=2, chunk=8,
                 keep_dumps=False)
    st = core.stats()
    assert {b["bucket"] for b in st["buckets"]} == {"mesi:2x4", "mesi:8x16"}
    assert st["padding_waste"] < st["single_shape_padding_waste"]


def test_core_lanes_backpressure_drain_parity():
    """Both lanes on one slot (weighted admission), a full lane's
    explicit rejects and a retry, and a drain that flushes then
    rejects."""
    def lanes(core, mod, JobSpec):
        arr = []
        for i in range(6):
            arr.append((0.0, _spec(JobSpec, f"i{i:02d}", seed=i),
                        "interactive"))
            arr.append((0.0, _spec(JobSpec, f"b{i:02d}", seed=10 + i),
                        "batch"))
        return mod.drive(core, arr)
    core = _both(lanes, slots=1, max_buckets=1, chunk=8, keep_dumps=False)
    st = core.stats()
    assert (st["lanes"]["interactive"]["latency"]["p95_ms"]
            < st["lanes"]["batch"]["latency"]["p95_ms"])

    def backpressure(core, mod, JobSpec):
        resp = [core.submit(_spec(JobSpec, f"j{i}", seed=i), lane="batch")
                for i in range(5)]
        while not core.idle():
            core.pump()
        resp.append(core.submit(_spec(JobSpec, "j2", seed=2)))
        core.drain()
        resp.append(core.submit(_spec(JobSpec, "late")))
        while not core.idle():
            core.pump()
        return resp
    core = _both(backpressure, slots=1, max_buckets=1, chunk=8,
                 lane_depth=2, keep_dumps=False)
    st = core.stats()
    assert st["jobs"]["rejected"] == 4 and st["mb_dropped"] == 0
    assert st["draining"] is True


def test_core_retention_and_bucket_growth_parity():
    def retention(core, mod, JobSpec):
        return mod.drive(core, [(0.0, _spec(JobSpec, f"r{i}", seed=i),
                                 "batch") for i in range(6)])
    core = _both(retention, slots=1, max_buckets=1, chunk=8,
                 keep_dumps=False, retain_results=3)
    assert core.results_evicted == 3 and len(core.results) == 3

    def growth(core, mod, JobSpec):
        # the mid-pump growth of tests/test_daemon.py: an idle (4, 2)
        # bucket grown to (4, 3) while (2, 4) admits a blocked job
        resp = [core.submit(_spec(JobSpec, "jb", nodes=4, trace_len=2))]
        while not core.idle():
            core.pump()
        for name, n, tl in (("ja", 2, 4), ("j3", 2, 4), ("j4", 4, 3)):
            resp.append(core.submit(_spec(JobSpec, name, nodes=n,
                                          trace_len=tl, seed=7)))
        while not core.idle():
            core.pump()
        return resp
    core = _both(growth, slots=1, max_buckets=2, chunk=8)
    assert core.bucket_growths == 1


def _serve_in_thread(server):
    th = threading.Thread(target=server.run, daemon=True)
    th.start()
    return th


def _round_trip(Client, sock, spec, lane):
    with Client(sock, timeout_s=60.0) as c:
        c.wait_up(timeout_s=30.0)
        assert c.ping()["ok"]
        assert c.submit(spec, lane=lane)["status"] == "queued"
        r = c.wait(spec.name, timeout_s=120.0)
        stats = c.stats()
        trace = c.trace()
        bad = c.request(op="nope")
    return r, stats, trace, bad


def test_port_server_answers_both_clients(tmp_path):
    """A port DaemonServer on a unix socket: the JAX package's client and
    the port's each submit, wait, read stats and the trace; the results
    are the solo runs' dumps; drain and shutdown end the thread."""
    sock = str(tmp_path / "d.sock")
    server = PortServer(tcore.DaemonCore(slots=2, chunk=8, keep_dumps=True,
                                         device="cpu"), sock, quiet=True)
    th = _serve_in_thread(server)
    try:
        for i, Client in enumerate((JaxClient, PortClient)):
            spec = _spec(tserve.JobSpec, f"net{i}", seed=i)
            r, stats, trace, bad = _round_trip(
                Client, sock, spec, ("interactive", "batch")[i])
            assert r["status"] == "done" and r["quiesced"]
            assert r["dumps"] == tserve.solo_dumps(spec, device="cpu")
            assert stats["jobs"]["done"] == i + 1
            assert trace["spans"][-1]["bucket"] == "mesi:2x4"
            assert bad["ok"] is False and "unknown op" in bad["error"]
        with JaxClient(sock, timeout_s=60.0) as c:
            d = c.drain()
            assert d["drained"] and d["jobs_done"] == 2
            c.shutdown()
        th.join(30.0)
        assert not th.is_alive()
        assert not pathlib.Path(sock).exists()
    finally:
        server.stop()
        th.join(30.0)


def test_port_client_drives_the_jax_server(tmp_path):
    """The wire format is shared: the port's client against a JAX
    server gets the same result doc the port's server gives."""
    spec = _spec(tserve.JobSpec, "x0", seed=3)
    docs = {}
    for name, Server, mod, extra in (
            ("jax", JaxServer, jcore, {}),
            ("port", PortServer, tcore, {"device": "cpu"})):
        sock = str(tmp_path / f"{name}.sock")
        server = Server(mod.DaemonCore(slots=2, chunk=8, keep_dumps=True,
                                       clock=(JaxClock if name == "jax"
                                              else PortClock)(), **extra),
                        sock, quiet=True)
        th = _serve_in_thread(server)
        try:
            with PortClient(sock, timeout_s=60.0) as c:
                c.wait_up(timeout_s=30.0)
                c.submit(spec, lane="interactive")
                docs[name] = c.wait(spec.name, timeout_s=120.0)
                c.shutdown()
            th.join(30.0)
        finally:
            server.stop()
            th.join(30.0)
    assert _dumps(docs["port"]) == _dumps(docs["jax"])


def test_soak_daemon_through_a_port_server(tmp_path):
    """``soak_daemon`` of the port over the socket: every job done and
    quiesced, no rejection, lanes on both sides of the latency block,
    and the JAX soak_daemon reads the same server's traffic the same
    way (structure, not wall-clock numbers)."""
    from ue22cs343bb1_openmp_assignment_tpu import soak as jsoak
    from ue22cs343bb1_openmp_assignment_tpu_torch import soak as tsoak
    sock = str(tmp_path / "d.sock")
    server = PortServer(tcore.DaemonCore(slots=2, chunk=8, device="cpu"),
                        sock, quiet=True)
    th = _serve_in_thread(server)
    try:
        for name, mod in (("port", tsoak), ("jax", jsoak)):
            arrivals = mod.soak_stream(40.0, 0.2, nodes=2, trace_len=4,
                                       seed=3)
            doc = mod.soak_daemon(arrivals, sock, arrival_rate=40.0,
                                  prefix=f"{name}.", timeout_s=120.0)
            assert doc["transport"] == "daemon"
            assert doc["jobs_quiesced"] == doc["jobs_total"] == len(arrivals)
            assert doc["rejected"] == [] and doc["mb_dropped"] == 0
            assert set(doc["lane_latency"]) == {"interactive", "batch"}
            assert all(s["job"].startswith(("port.", "jax."))
                       for s in doc["trace"]["spans"])
    finally:
        server.stop()
        th.join(30.0)


def test_socket_stress_many_clients_while_chunks_run(tmp_path):
    """The core releases the server's lock while a chunk runs, so
    handlers touch the core's queues and counters beside the scheduler
    thread: 16 client threads (more than this box's cores) submit and
    wait at once under a short switch interval; no submission or result
    is lost and the lifetime counters add up."""
    import sys
    sock = str(tmp_path / "d.sock")
    server = PortServer(tcore.DaemonCore(slots=8, chunk=4, lane_depth=64,
                                         device="cpu"), sock, quiet=True)
    th = _serve_in_thread(server)
    errors, done = [], []
    old = sys.getswitchinterval()

    def client(k):
        try:
            with PortClient(sock, timeout_s=60.0) as c:
                c.wait_up(timeout_s=30.0)
                names = []
                for j in range(2):
                    spec = _spec(tserve.JobSpec, f"c{k}.{j}", seed=k + j)
                    assert c.submit(spec, lane=("interactive", "batch")[
                        (k + j) % 2])["status"] == "queued"
                    names.append(spec.name)
                for name in names:
                    r = c.wait(name, timeout_s=120.0)
                    assert r["status"] == "done" and r["quiesced"], r
                    done.append(name)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    sys.setswitchinterval(1e-4)
    workers = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(16)]
    try:
        for w in workers:
            w.start()
        for w in workers:
            w.join(180.0)
        assert not any(w.is_alive() for w in workers)
        assert errors == [] and len(done) == 32, errors
        with PortClient(sock, timeout_s=60.0) as c:
            st = c.stats()
            c.shutdown()
        th.join(30.0)
        assert not th.is_alive()
        assert st["jobs"] == {"submitted": 32, "rejected": 0, "done": 32,
                              "quiesced": 32}
        assert sum(ln["done"] for ln in st["lanes"].values()) == 32
    finally:
        sys.setswitchinterval(old)
        server.stop()
        th.join(30.0)
