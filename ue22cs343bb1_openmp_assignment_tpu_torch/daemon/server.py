"""The daemon socket layer: transport around DaemonCore.

Threading model (deliberately boring): the thread that calls
:meth:`DaemonServer.run` IS the scheduler — it owns every device call
(``pump``). An acceptor thread hands each connection to a handler
thread, and handlers only translate wire lines into core method calls
under the ONE server lock; they never touch device state. A submit
notifies the scheduler's condition variable so an idle daemon wakes
immediately instead of on the poll tick. ``drain`` blocks its handler
on the same condition until the core reports idle; ``shutdown``
responds first, then stops the scheduler after the current chunk and
removes the socket — a clean exit the check.sh smoke verifies leaves
no orphaned process. In the port a chunk is host work (every launch of
its vmapped cycles is issued from Python), so the core releases the
lock while a chunk runs (``DaemonCore._unlocked``): handlers answer
mid-chunk.

The one exception to one-line-in-one-line-out is ``watch``: the
handler thread acks, then PUSHES stats-deltas and live-ops events
(obs.events ring, always attached) on its own connection until the
client's bound hits — snapshots are taken under the server lock, the
poll sleep is not, so a slow watcher falls behind the ring instead of
stalling the scheduler.

The port's copy of the JAX package's ``daemon/server.py``, unchanged apart from its import paths, its program name, ``--cpu``,
which runs the waves on the CPU instead of the card (the daemon's
default), and the lock the core releases while a chunk runs.
"""
# lint: host

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Optional

from ue22cs343bb1_openmp_assignment_tpu_torch.daemon import protocol
from ue22cs343bb1_openmp_assignment_tpu_torch.daemon.core import (
    DaemonCore, attach_emitter, attach_recorder)
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import burnrate, events
from ue22cs343bb1_openmp_assignment_tpu_torch.serve import JobSpec

#: scheduler poll tick when idle (seconds); submits wake it earlier
IDLE_TICK_S = 0.01


class DaemonServer:
    """Serve a DaemonCore over a unix or tcp socket."""

    # lint: host
    def __init__(self, core: DaemonCore, addr: str,
                 quiet: bool = True):
        self.core = core
        self.quiet = quiet
        self.lock = threading.RLock()
        core.lock = self.lock         # released while a chunk runs
        self.wake = threading.Condition(self.lock)
        self._stop = threading.Event()
        self.family, target = protocol.parse_addr(addr)
        self._unix_path: Optional[str] = (
            target if self.family == socket.AF_UNIX else None)
        if self._unix_path and os.path.exists(self._unix_path):
            os.unlink(self._unix_path)      # stale socket from a kill
        self.sock = socket.socket(self.family, socket.SOCK_STREAM)
        if self.family == socket.AF_INET:
            self.sock.setsockopt(socket.SOL_SOCKET,
                                 socket.SO_REUSEADDR, 1)
        self.sock.bind(target)
        self.sock.listen(16)
        self.addr = (self._unix_path if self._unix_path else
                     "tcp:%s:%d" % self.sock.getsockname())

    # lint: host
    def stop(self) -> None:
        self._stop.set()
        with self.wake:
            self.wake.notify_all()

    # lint: host
    def run(self) -> int:
        """The scheduler loop; returns 0 on a clean shutdown."""
        acceptor = threading.Thread(target=self._accept_loop,
                                    daemon=True, name="daemon-accept")
        acceptor.start()
        if not self.quiet:
            print(f"daemon: listening on {self.addr}", flush=True)
        try:
            while not self._stop.is_set():
                with self.wake:
                    ran = self.core.pump() if not self.core.idle() \
                        else False
                    # progress may have flushed a drain or finished a
                    # polled job — let blocked handlers re-check
                    self.wake.notify_all()
                    if not ran and not self._stop.is_set():
                        self.wake.wait(IDLE_TICK_S)
        finally:
            self._close()
        if not self.quiet:
            print("daemon: shut down cleanly", flush=True)
        return 0

    # lint: host
    def _close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
        if self._unix_path and os.path.exists(self._unix_path):
            os.unlink(self._unix_path)

    # lint: host
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return                       # socket closed on stop
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="daemon-conn").start()

    # lint: host
    def _serve_conn(self, conn) -> None:
        f = conn.makefile("rwb")
        try:
            for line in f:
                if not line.strip():
                    continue
                try:
                    req = protocol.decode(line)
                    if req.get("op") == "watch":
                        # the one long-lived op: ack + push rows on
                        # this connection, then fall back into the
                        # plain request/response loop
                        self._watch(req, f)
                        continue
                    resp = self._handle(req)
                except Exception as e:  # noqa: BLE001 — wire boundary
                    resp = protocol.error(None, str(e))
                f.write(protocol.encode(resp))
                f.flush()
                if self._stop.is_set():
                    break
        except (OSError, ValueError):
            pass                             # client went away
        finally:
            try:
                f.close()
                conn.close()
            except OSError:
                pass

    # lint: host
    def _stats_sig(self) -> tuple:
        """A cheap change-signature over the core's lifetime counters
        — computed WITHOUT calling stats(), so idle watch polls never
        bump ``stats_seq`` (a stats row is pushed only when something
        actually moved)."""
        c = self.core
        return (sum(ln.submitted for ln in c.lanes.values()),
                c._rejected_total,
                sum(ln.done for ln in c.lanes.values()),
                sum(len(ln.queue) for ln in c.lanes.values()),
                c.chunks, c.bucket_growths, c.results_evicted,
                c.slo_alerts, c.draining)

    # lint: host
    def _watch(self, req: dict, f) -> None:
        """Stream stats-deltas + live-ops events to one client until
        its ``max_rows``/``max_s`` bound hits or the daemon stops.
        Holds the server lock only to snapshot; the sleep is unlocked,
        so a slow watcher never stalls the scheduler — it just falls
        behind the ring and sees a ``seq`` gap."""
        interval = float(req.get("interval_s",
                                 protocol.DEFAULT_WATCH_INTERVAL_S))
        interval = max(0.01, interval)
        max_rows = req.get("max_rows")
        max_s = req.get("max_s")
        with self.lock:
            if self.core.emitter is None:
                attach_emitter(self.core)    # ring-only, late client
            em = self.core.emitter
            cursor = em.seq                  # new events only
            sig = self._stats_sig()
            stats = self.core.stats()        # the baseline snapshot
        f.write(protocol.encode({"ok": True, "op": "watch",
                                 "streaming": True,
                                 "interval_s": interval,
                                 "cursor": cursor}))
        f.write(protocol.encode({"ok": True, "op": "watch",
                                 "type": "stats", "stats": stats}))
        f.flush()
        rows = 1
        t0 = time.monotonic()
        reason = "stopped"
        while not self._stop.is_set():
            if max_rows is not None and rows >= int(max_rows):
                reason = "max-rows"
                break
            if (max_s is not None
                    and time.monotonic() - t0 >= float(max_s)):
                reason = "max-s"
                break
            self._stop.wait(interval)
            with self.lock:
                evs = em.since(cursor)
                if evs:
                    cursor = evs[-1]["seq"] + 1
                new_sig = self._stats_sig()
                stats = (self.core.stats() if new_sig != sig
                         else None)
                sig = new_sig
            for ev in evs:
                f.write(protocol.encode({"ok": True, "op": "watch",
                                         "type": "event",
                                         "event": ev}))
                rows += 1
            if stats is not None:
                f.write(protocol.encode({"ok": True, "op": "watch",
                                         "type": "stats",
                                         "stats": stats}))
                rows += 1
            if evs or stats is not None:
                f.flush()
        f.write(protocol.encode({"ok": True, "op": "watch",
                                 "type": "end", "reason": reason,
                                 "rows": rows, "cursor": cursor}))
        f.flush()

    # lint: host
    def _handle(self, req: dict) -> dict:
        op = req.get("op")
        if op not in protocol.OPS:
            return protocol.error(op, f"unknown op {op!r} "
                                      f"(one of {protocol.OPS})")
        if op == "ping":
            return {"ok": True, "op": "ping"}
        if op == "submit":
            try:
                spec = JobSpec.from_dict(req.get("spec") or {})
            except (TypeError, ValueError) as e:
                return protocol.error("submit", f"bad job spec: {e}")
            with self.wake:
                resp = self.core.submit(spec,
                                        lane=req.get("lane", "batch"))
                self.wake.notify_all()       # wake an idle scheduler
            return resp
        if op == "status":
            with self.lock:
                return self.core.status(req.get("job", ""))
        if op == "result":
            with self.lock:
                return self.core.result(req.get("job", ""))
        if op == "stats":
            with self.lock:
                return {"ok": True, "op": "stats",
                        "stats": self.core.stats()}
        if op == "trace":
            with self.lock:
                return {"ok": True, "op": "trace",
                        "trace": self.core.trace_doc()}
        if op == "watch":
            # unreachable via _serve_conn (special-cased there); keep
            # a direct _handle("watch") from falling into shutdown
            return protocol.error(
                "watch", "watch is a streaming op, handled on the "
                         "connection")
        if op == "drain":
            with self.wake:
                self.core.drain()
                self.wake.notify_all()
                while not self.core.idle() and not self._stop.is_set():
                    self.wake.wait(IDLE_TICK_S)
                done = sum(ln.done for ln in self.core.lanes.values())
            return {"ok": True, "op": "drain", "drained": True,
                    "jobs_done": done}
        # shutdown: respond, then stop after the current chunk
        self.stop()
        return {"ok": True, "op": "shutdown", "stopping": True}


# lint: host
def parse_lane_weights(spec: str) -> dict:
    """``"interactive=4,batch=1"`` → weight dict (ints >= 1)."""
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad lane weight {part!r} "
                             f"(want lane=N)")
        name, w = part.split("=", 1)
        weight = int(w)
        if weight < 1:
            raise ValueError(f"lane weight must be >= 1, got {w}")
        out[name.strip()] = weight
    if not out:
        raise ValueError(f"empty lane-weight spec {spec!r}")
    return out


# lint: host
def main(argv=None) -> int:
    """``cache-sim daemon`` entry point."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="cache-sim-torch daemon",
        description="persistent serving daemon: accept jobs over a "
                    "unix/tcp socket with continuous admission, "
                    "shape bucketing, and priority lanes")
    ap.add_argument("--addr", required=True,
                    help="listen address: a unix socket path, or "
                         "tcp:HOST:PORT")
    ap.add_argument("--slots", type=int, default=4,
                    help="batch slots per shape bucket (default 4)")
    ap.add_argument("--max-buckets", type=int, default=4,
                    help="slot shape classes per protocol (default 4)")
    ap.add_argument("--chunk", type=int, default=16,
                    help="cycles per admission chunk (default 16) — "
                         "the continuous-admission granularity")
    ap.add_argument("--max-cycles", type=int, default=100_000)
    ap.add_argument("--queue-capacity", type=int, default=64)
    ap.add_argument("--lane-depth", type=int,
                    default=protocol.DEFAULT_LANE_DEPTH,
                    help="per-lane admission queue bound (default "
                         f"{protocol.DEFAULT_LANE_DEPTH}); a full "
                         "lane rejects explicitly")
    ap.add_argument("--lane-weights", default=None,
                    help='admission weights, e.g. '
                         '"interactive=4,batch=1" (the default)')
    ap.add_argument("--retain", type=int,
                    default=protocol.DEFAULT_RETAIN_RESULTS,
                    metavar="N",
                    help="keep only the newest N finished/rejected "
                         "jobs' results, statuses, and spans in "
                         "memory (default "
                         f"{protocol.DEFAULT_RETAIN_RESULTS}) — "
                         "bounds a long-lived daemon; evicted jobs "
                         "answer 'unknown'")
    ap.add_argument("--keep-dumps", action="store_true",
                    help="retain per-node dumps in memory so `result` "
                         "returns them over the socket (off by "
                         "default for a long-lived daemon; --out-dir "
                         "streams dumps to disk either way)")
    ap.add_argument("--out-dir", default=None,
                    help="also stream per-job dumps + metrics here")
    ap.add_argument("--record", default=None, metavar="DIR",
                    help="record mode: stream every ACCEPTED "
                         "submission (full spec, lane, scheduled "
                         "arrival time) and every finished job's "
                         "dump digest into DIR/recording.jsonl "
                         "(cache-sim/recording/v1) — replay the "
                         "captured traffic later with "
                         "`cache-sim replay DIR`")
    ap.add_argument("--events-dir", default=None, metavar="DIR",
                    help="also stream every live-ops event "
                         "(cache-sim/events/v1: submit-accepted, "
                         "admitted, quiesced, lane-reject, "
                         "result-evicted, bucket-growth, slo-alert) "
                         "to DIR/events.jsonl; the in-memory ring "
                         "that feeds `watch` clients is always on")
    ap.add_argument("--events-ring", type=int,
                    default=events.DEFAULT_RING, metavar="N",
                    help="in-memory event ring bound (default "
                         f"{events.DEFAULT_RING} rows); a watch "
                         "client that falls behind sees a seq gap")
    ap.add_argument("--burn-slo", default=None, metavar="SPEC",
                    help="continuous burn-rate SLO, e.g. "
                         '"5ms,objective=0.99,fast=60,slow=300,'
                         'factor=2": every finished job is one '
                         "sample; when BOTH windows burn the error "
                         "budget at factor x, one slo-alert event is "
                         "injected into the stream")
    ap.add_argument("--virtual-clock", action="store_true",
                    help="run the scheduler on the deterministic "
                         "VirtualClock (time advances per wave, not "
                         "by wall time) — recordings and trace docs "
                         "then carry virtual timestamps; tests/CI")
    ap.add_argument("--wave-s", type=float, default=1e-3,
                    help="virtual seconds charged per wave chunk "
                         "under --virtual-clock (default 1e-3)")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run the waves on the CPU (the plain PyTorch "
                         "path) instead of the card")
    args = ap.parse_args(argv)
    weights = (parse_lane_weights(args.lane_weights)
               if args.lane_weights else None)
    clock = None
    if args.virtual_clock:
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs.clock import (
            VirtualClock)
        clock = VirtualClock(wave_s=args.wave_s)
    core = DaemonCore(slots=args.slots, max_buckets=args.max_buckets,
                      chunk=args.chunk, max_cycles=args.max_cycles,
                      queue_capacity=args.queue_capacity,
                      lane_depth=args.lane_depth, lane_weights=weights,
                      clock=clock, out_dir=args.out_dir,
                      keep_dumps=args.keep_dumps,
                      retain_results=args.retain,
                      device="cpu" if args.cpu else None)
    if args.record:
        recorder = attach_recorder(core, args.record)
        if not args.quiet:
            print(f"daemon: recording traffic to {recorder.path}",
                  flush=True)
    # the event ring is always on (watch clients need it); --events-dir
    # additionally streams every row to disk
    emitter = attach_emitter(core, args.events_dir,
                             ring=args.events_ring)
    if args.events_dir and not args.quiet:
        print(f"daemon: streaming events to {emitter.path}",
              flush=True)
    if args.burn_slo:
        core.burn = burnrate.monitor_from_spec(args.burn_slo)
    server = DaemonServer(core, args.addr, quiet=args.quiet)
    try:
        return server.run()
    except KeyboardInterrupt:
        server.stop()
        return 0
    finally:
        if core.recorder is not None:
            core.recorder.close()
        if core.emitter is not None:
            core.emitter.close()


if __name__ == "__main__":
    raise SystemExit(main())
