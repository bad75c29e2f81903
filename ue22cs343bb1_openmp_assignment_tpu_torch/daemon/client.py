"""The thin daemon client: one socket, newline-delimited JSON.

:class:`DaemonClient` is the programmatic surface (the soak harness's
``--daemon`` transport and the tests use it); :func:`main` is the
``cache-sim submit`` CLI around it. The client is dependency-free on
purpose — socket + json, no torch — so submitting a job never pays the
accelerator-runtime import.

The port's copy of the JAX package's ``daemon/client.py``, unchanged apart from its import paths and its program names.
"""
# lint: host

from __future__ import annotations

import json
import socket
import time
from typing import Optional

from ue22cs343bb1_openmp_assignment_tpu_torch.daemon import protocol


class DaemonClient:
    """One persistent connection to a serving daemon."""

    # lint: host
    def __init__(self, addr: str, timeout_s: float = 30.0):
        self.addr = addr
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self._file = None

    # lint: host
    def connect(self) -> "DaemonClient":
        family, target = protocol.parse_addr(self.addr)
        s = socket.socket(family, socket.SOCK_STREAM)
        s.settimeout(self.timeout_s)
        s.connect(target)
        self._sock = s
        self._file = s.makefile("rwb")
        return self

    # lint: host
    def close(self) -> None:
        for h in (self._file, self._sock):
            if h is not None:
                try:
                    h.close()
                except OSError:
                    pass
        self._file = self._sock = None

    # lint: host
    def __enter__(self) -> "DaemonClient":
        # Lazy: request() connects on first use, so wait_up() can own
        # the retry loop during the daemon startup race.
        return self

    # lint: host
    def __exit__(self, *exc) -> None:
        self.close()

    # lint: host
    def request(self, **msg) -> dict:
        """One request line out, one response line back, in order."""
        if self._sock is None:
            self.connect()
        self._file.write(protocol.encode(msg))
        self._file.flush()
        line = self._file.readline()
        if not line:
            raise ConnectionError(
                f"daemon at {self.addr} closed the connection")
        return protocol.decode(line)

    # lint: host
    def wait_up(self, timeout_s: float = 10.0,
                poll_s: float = 0.05) -> dict:
        """Retry connect+ping until the daemon answers (startup
        race); raises ConnectionError after ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        last = None
        while time.monotonic() < deadline:
            try:
                self.close()
                self.connect()
                return self.ping()
            except (ConnectionError, OSError, ValueError) as e:
                last = e
                time.sleep(poll_s)
        raise ConnectionError(
            f"daemon at {self.addr} not up after {timeout_s}s: {last}")

    # lint: host
    def ping(self) -> dict:
        return self.request(op="ping")

    # lint: host
    def submit(self, spec, lane: str = "batch") -> dict:
        """``spec`` is a JobSpec dataclass or a plain spec dict."""
        if hasattr(spec, "__dataclass_fields__"):
            import dataclasses
            spec = dataclasses.asdict(spec)
        return self.request(op="submit", spec=spec, lane=lane)

    # lint: host
    def status(self, job: str) -> dict:
        return self.request(op="status", job=job)

    # lint: host
    def result(self, job: str) -> dict:
        return self.request(op="result", job=job)

    # lint: host
    def wait(self, job: str, timeout_s: float = 60.0,
             poll_s: float = 0.002) -> dict:
        """Poll ``result`` until the job resolves (done or rejected)."""
        deadline = time.monotonic() + timeout_s
        while True:
            r = self.result(job)
            if r.get("status") in ("done", "rejected", "unknown"):
                return r
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"job {job!r} not done after {timeout_s}s "
                    f"(last status {r.get('status')!r})")
            time.sleep(poll_s)

    # lint: host
    def stats(self) -> dict:
        return self.request(op="stats")["stats"]

    # lint: host
    def watch(self, interval_s: Optional[float] = None,
              max_rows: Optional[int] = None,
              max_s: Optional[float] = None):
        """Generator over the ``watch`` stream: yields the pushed
        rows (``type`` ``"stats"`` / ``"event"``) and returns after
        the terminal ``"end"`` row (also yielded), leaving the
        connection usable for plain requests again."""
        if self._sock is None:
            self.connect()
        req = {"op": "watch"}
        if interval_s is not None:
            req["interval_s"] = float(interval_s)
        if max_rows is not None:
            req["max_rows"] = int(max_rows)
        if max_s is not None:
            req["max_s"] = float(max_s)
        self._file.write(protocol.encode(req))
        self._file.flush()
        ack = protocol.decode(self._file.readline() or b"null")
        if not ack.get("ok") or not ack.get("streaming"):
            raise ConnectionError(f"watch not acked: {ack}")
        while True:
            line = self._file.readline()
            if not line:
                raise ConnectionError(
                    f"daemon at {self.addr} closed the watch stream")
            row = protocol.decode(line)
            yield row
            if row.get("type") == "end":
                return

    # lint: host
    def trace(self) -> dict:
        return self.request(op="trace")["trace"]

    # lint: host
    def drain(self) -> dict:
        return self.request(op="drain")

    # lint: host
    def shutdown(self) -> dict:
        return self.request(op="shutdown")


# lint: host
def main(argv=None) -> int:
    """``cache-sim submit`` entry point: submit jobs to a running
    daemon and optionally wait; also the control surface for ping /
    stats / drain / shutdown."""
    import argparse
    import sys
    ap = argparse.ArgumentParser(
        prog="cache-sim-torch submit",
        description="submit jobs to a running cache-sim daemon over "
                    "its socket (see `cache-sim daemon`)")
    ap.add_argument("--addr", required=True,
                    help="daemon address: unix socket path or "
                         "tcp:HOST:PORT")
    ap.add_argument("--job", action="append", default=[],
                    metavar="JSON",
                    help="one job spec as JSON (repeatable); an "
                         'extra "lane" key overrides --lane per job')
    ap.add_argument("--jobs", default=None,
                    help=".jsonl file or directory of .json specs "
                         "(serve.load_jobs format)")
    ap.add_argument("--lane", default="batch",
                    choices=sorted(protocol.LANES),
                    help="priority lane (default batch)")
    ap.add_argument("--wait", action="store_true",
                    help="poll until every submitted job resolves")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="--wait bound per job in seconds (default 60)")
    ap.add_argument("--wait-up", type=float, default=None,
                    metavar="S",
                    help="retry-connect for up to S seconds first "
                         "(daemon startup race)")
    ap.add_argument("--ping", action="store_true",
                    help="liveness probe")
    ap.add_argument("--stats", action="store_true",
                    help="print the daemon-stats snapshot as JSON")
    ap.add_argument("--drain", action="store_true",
                    help="stop admission and flush in-flight jobs")
    ap.add_argument("--shutdown", action="store_true",
                    help="stop the daemon (after --drain if both)")
    ap.add_argument("--json", action="store_true",
                    help="print raw response docs as JSON")
    args = ap.parse_args(argv)

    jobs = []
    for j in args.job:
        d = json.loads(j)
        lane = d.pop("lane", args.lane)
        jobs.append((d, lane))
    if args.jobs:
        from ue22cs343bb1_openmp_assignment_tpu_torch.serve import load_jobs
        import dataclasses
        jobs += [(dataclasses.asdict(s), args.lane)
                 for s in load_jobs(args.jobs)]
    if not (jobs or args.ping or args.stats or args.drain
            or args.shutdown):
        ap.error("nothing to do: give --job/--jobs or a control flag")

    rc = 0
    with DaemonClient(args.addr) as client:
        if args.wait_up is not None:
            client.wait_up(args.wait_up)
        if args.ping:
            r = client.ping()
            print(json.dumps(r) if args.json
                  else f"daemon at {args.addr}: "
                       f"{'up' if r.get('ok') else 'DOWN'}")
        submitted = []
        for spec, lane in jobs:
            r = client.submit(spec, lane=lane)
            if args.json:
                print(json.dumps(r))
            else:
                print(f"submit {spec.get('name')!r} [{lane}]: "
                      f"{r.get('status', r.get('error'))}")
            if r.get("status") == "queued":
                submitted.append(spec["name"])
            else:
                rc = 1
        if args.wait:
            for name in submitted:
                r = client.wait(name, timeout_s=args.timeout)
                if args.json:
                    print(json.dumps(r))
                else:
                    print(f"result {name!r}: {r.get('status')} "
                          f"quiesced={r.get('quiesced')} "
                          f"cycles={r.get('cycles')} "
                          f"bucket={r.get('bucket')}")
                if not (r.get("status") == "done"
                        and r.get("quiesced")):
                    rc = 1
        if args.stats:
            print(json.dumps(client.stats(), indent=2))
        if args.drain:
            r = client.drain()
            if not args.json:
                print(f"drained: {r.get('jobs_done')} job(s) done",
                      file=sys.stderr)
        if args.shutdown:
            client.shutdown()
            if not args.json:
                print("daemon stopping", file=sys.stderr)
    return rc


# lint: host
def main_watch(argv=None) -> int:
    """``cache-sim watch`` entry point: follow one daemon's live ops
    stream (stats deltas + structured events) over its socket."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="cache-sim-torch watch",
        description="stream a running daemon's live ops plane: "
                    "stats-deltas plus every scheduler event "
                    "(cache-sim/events/v1) as they happen")
    ap.add_argument("--addr", required=True,
                    help="daemon address: unix socket path or "
                         "tcp:HOST:PORT")
    ap.add_argument("--interval", type=float, default=None,
                    metavar="S",
                    help="server poll cadence in seconds (default "
                         f"{protocol.DEFAULT_WATCH_INTERVAL_S})")
    ap.add_argument("--max-rows", type=int, default=None, metavar="N",
                    help="stop after N pushed rows")
    ap.add_argument("--max-s", type=float, default=None, metavar="S",
                    help="stop after S seconds")
    ap.add_argument("--wait-up", type=float, default=None, metavar="S",
                    help="retry-connect for up to S seconds first")
    ap.add_argument("--json", action="store_true",
                    help="print the raw NDJSON rows instead of the "
                         "human one-liners")
    args = ap.parse_args(argv)

    alerts = 0
    # blocking socket: an idle daemon pushes nothing between deltas,
    # so a read timeout would tear the stream down mid-watch
    with DaemonClient(args.addr, timeout_s=None) as client:
        if args.wait_up is not None:
            client.wait_up(args.wait_up)
        for row in client.watch(interval_s=args.interval,
                                max_rows=args.max_rows,
                                max_s=args.max_s):
            if args.json:
                print(json.dumps(row, sort_keys=True), flush=True)
                continue
            kind = row.get("type")
            if kind == "stats":
                s = row["stats"]
                jobs = s["jobs"]
                print(f"[stats #{s.get('stats_seq', '?')}] "
                      f"up={s['uptime_s']:.3f}s "
                      f"submitted={jobs['submitted']} "
                      f"done={jobs['done']} "
                      f"rejected={jobs['rejected']} "
                      f"chunks={s['chunks']} "
                      f"alerts={s.get('slo_alerts', 0)}", flush=True)
            elif kind == "event":
                ev = dict(row["event"])
                seq = ev.pop("seq")
                t_s = ev.pop("t_s")
                k = ev.pop("kind")
                job = ev.pop("job", None)
                alerts += int(k == "slo-alert")
                extra = " ".join(f"{n}={v}" for n, v
                                 in sorted(ev.items()))
                print(f"[{t_s:9.3f}s #{seq}] {k:<15} "
                      f"{job or '-':<16} {extra}", flush=True)
            else:
                print(f"[end] {row.get('reason')} "
                      f"({row.get('rows')} rows)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
