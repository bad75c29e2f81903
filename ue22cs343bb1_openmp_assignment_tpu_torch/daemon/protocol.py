"""The daemon wire protocol: newline-delimited JSON over unix/tcp.

One request per line, one response per line, strictly in order on
each connection — the framing a thin client can speak with nothing
but a socket and ``json``. Requests are ``{"op": <op>, ...}``;
responses always carry ``"ok"`` (bool) and echo ``"op"``. Errors are
``{"ok": false, "op": ..., "error": "<message>"}`` and never close
the connection — a client can recover from its own malformed line.

Ops
---
``submit``   ``{"op": "submit", "spec": {<JobSpec dict>},
             "lane": "interactive"|"batch"}`` →
             ``{"ok": true, "status": "queued", "job": <name>,
             "lane": ...}`` or the explicit backpressure response
             ``{"ok": false, "status": "rejected", "reason": ...}``
             (bounded lane queue — never a silent drop).
``status``   ``{"op": "status", "job": <name>}`` → lifecycle state
             (``queued`` / ``running`` / ``done`` / ``rejected`` /
             ``unknown``).
``result``   ``{"op": "result", "job": <name>}`` → the finished job
             doc (metrics, cycles, per-node dumps, lane, bucket) or
             ``{"ok": true, "status": <pending state>}`` to poll.
             Only the newest ``DEFAULT_RETAIN_RESULTS`` terminal jobs
             are retained; older jobs answer ``unknown``.
``stats``    → the validated ``cache-sim/daemon-stats/v1`` snapshot.
             Under ``daemon --record`` its ``recording`` block
             carries the live capture counters (artifact path,
             accepted submissions streamed, result digests written);
             ``recording`` is null when record mode is off.
``trace``    → the ``cache-sim/serve-trace/v1`` doc of completed jobs.
``watch``    ``{"op": "watch", "interval_s": <poll>, "max_s": <stop
             after>, "max_rows": <stop after>}`` — the ONE
             long-lived op: the server acks
             ``{"ok": true, "op": "watch", "streaming": true}`` and
             then pushes NDJSON rows on the same connection —
             ``{"op": "watch", "type": "event", "event": <cache-
             sim/events/v1 row>}`` for every live-ops event and
             ``{"op": "watch", "type": "stats", "stats": <stats
             doc>}`` whenever the counters changed at a poll tick —
             until the bound hits or the daemon stops, then one
             ``{"op": "watch", "type": "end", "reason": ...}`` row,
             after which the connection speaks plain request/response
             again. Rows ride the event ring: a slow client sees a
             ``seq`` gap, never a stalled scheduler.
``drain``    → stop admitting, flush queued + in-flight jobs, respond
             when idle.
``shutdown`` → respond, then stop the scheduler after the current
             chunk and close the socket.
``ping``     → liveness probe.

Addresses
---------
``parse_addr`` accepts ``tcp:HOST:PORT`` for TCP and anything else
(optionally ``unix:PATH``) as a unix-domain socket path — serving
defaults to unix sockets, the same-host fast path.

The port's copy of the JAX package's ``daemon/protocol.py``, unchanged apart from its import paths: the wire format is
the JAX package's, so either package's client talks to either package's
server.
"""
# lint: host

from __future__ import annotations

import json
import socket
from typing import Tuple

#: every request op the server understands
OPS = ("submit", "status", "result", "stats", "trace", "watch",
       "drain", "shutdown", "ping")

#: default watch-stream poll cadence (seconds): how often the server
#: checks the event ring / stats counters for a watching client
DEFAULT_WATCH_INTERVAL_S = 0.25

#: the priority lanes and their default admission weights: the
#: scheduler picks lanes by smooth weighted round-robin, so at full
#: contention interactive jobs are admitted ~4x as often as batch
LANES = ("interactive", "batch")
DEFAULT_LANE_WEIGHTS = {"interactive": 4, "batch": 1}

#: default bound on each lane's admission queue (backpressure: a
#: submit beyond this is rejected explicitly, never silently dropped)
DEFAULT_LANE_DEPTH = 64

#: default result-retention bound: only the newest N terminal jobs
#: keep their result doc / status entry / closed span in memory, so a
#: long-lived daemon never grows with jobs served (evicted jobs
#: answer ``unknown``; ``--out-dir`` is the durable record)
DEFAULT_RETAIN_RESULTS = 1024


def encode(msg: dict) -> bytes:
    """One protocol message → one wire line (sorted keys, so virtual
    runs are byte-stable end to end)."""
    return (json.dumps(msg, sort_keys=True) + "\n").encode("utf-8")


def decode(line: bytes) -> dict:
    """One wire line → the message dict; raises ValueError on
    anything that is not a JSON object."""
    msg = json.loads(line.decode("utf-8"))
    if not isinstance(msg, dict):
        raise ValueError(f"protocol message must be a JSON object, "
                         f"got {type(msg).__name__}")
    return msg


def error(op, detail: str) -> dict:
    return {"ok": False, "op": op, "error": detail}


def parse_addr(addr: str) -> Tuple[int, object]:
    """``tcp:HOST:PORT`` → (AF_INET, (host, port)); anything else —
    optionally prefixed ``unix:`` — is a unix socket path."""
    if addr.startswith("tcp:"):
        rest = addr[len("tcp:"):]
        if ":" not in rest:
            raise ValueError(f"tcp address must be tcp:HOST:PORT, "
                             f"got {addr!r}")
        host, port = rest.rsplit(":", 1)
        return socket.AF_INET, (host or "127.0.0.1", int(port))
    if addr.startswith("unix:"):
        addr = addr[len("unix:"):]
    if not addr:
        raise ValueError("empty daemon address")
    return socket.AF_UNIX, addr
