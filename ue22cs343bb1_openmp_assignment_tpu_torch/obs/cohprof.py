"""Coherence profiler: per-line contention attribution host-side.

The device side (ops/step.py ``with_profile`` / run_cycles_profile,
ops/deep_engine.run_deep_profile, ops/sync_engine.run_sync_profile)
accumulates per-(node, address) counter planes inside the engines' own
one-dispatch scans — misses split by cause, invalidation fan-out,
writebacks, ownership migrations, and for the deep engine the
per-address abort attribution that turns PERF.md's "~2/3 of poison
flags are ghosts" hand estimate into a measured number. This module is
everything after the device fetch: a sharing-pattern classifier that
labels each block private / read-shared / migratory / producer-consumer
/ false-sharing (the block-vs-variable granularity signal — logically
disjoint write-mostly variables colliding on one coherence unit), the
top-K contended-line table, and the validated ``cache-sim/profile/v1``
doc that ``cache-sim profile`` emits, flight-recorder incidents embed
and the dashboard renders.

Miss-taxonomy lineage: Hill & Smith's 3C classification (PAPERS.md)
with capacity/conflict collapsed (direct-mapped cache) and the two
classes a directory protocol adds — coherence-invalidation misses and
upgrades (permission misses).

Classifier thresholds are module constants, pinned by the workload
fingerprint matrix in tests/test_cohprof.py: every builtin generator
must classify as its known dominant pattern (false_sharing_vars_padded
must come out private — the padding fix made *observable*).

The port's copy of the JAX package's ``obs/cohprof.py``: the same code;
the ``capture_*`` functions read the captured planes to the host
(``.cpu()``) once, since the port's captures may live on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

SCHEMA_ID = "cache-sim/profile/v1"

#: sharing patterns in classification-precedence order (earlier rules
#: win; ``dominant`` ties also resolve in this order)
PATTERNS = ("private", "read_shared", "producer_consumer",
            "false_sharing", "migratory")

#: miss-taxonomy columns — MUST match ops.step.PROFILE_MISS_CLASSES
MISS_CLASSES = ("cold", "conflict_eviction", "coherence_invalidation",
                "upgrade")

#: deep abort-attribution columns — MUST match
#: ops.deep_engine.PROFILE_ABORT_CLASSES
ABORT_CLASSES = ("poison_ghost", "poison_real", "mark", "lane_loss",
                 "probe")

#: deep window-stop columns — MUST match
#: ops.deep_engine.PROFILE_STOP_CLASSES
STOP_CLASSES = ("over_q", "over_g", "dup", "dep", "live")

#: read-shared threshold: writes at most this fraction of a line's
#: total accesses (lock-free read-mostly data; a few init writes
#: don't disqualify)
READ_SHARED_WF = 0.05

#: false-sharing threshold: >= 2 writers whose MEAN per-writer write
#: fraction is at least this — each node treats its slice of the line
#: as a write-mostly private variable (the false_sharing_vars shape,
#: write_frac 0.75), unlike migratory read-modify-write sharing
#: (fractions near 0.5) or producer-consumer (reader/writer split)
FALSE_SHARING_WF = 0.65

_TOP_KEYS = ("schema", "engine", "nodes", "addr_space", "steps",
             "step_unit", "accesses", "miss_classes", "invalidations",
             "writebacks", "ownership_migrations", "sharing",
             "top_contended", "abort_anatomy", "extra")

_TOP_LINE_KEYS = ("addr", "home", "block", "pattern", "nodes",
                  "readers", "writers", "reads", "writes", "score")


# -- classifier -------------------------------------------------------------

# lint: host
def classify(rd, wr) -> np.ndarray:
    """Label every address with a sharing pattern.

    ``rd``/``wr`` are [N, A] per-(node, address) access counts; returns
    an [A] int array of indices into PATTERNS, -1 for untouched
    addresses. Precedence: a single-accessor line is private; a shared
    line with (almost) no writes is read-shared; disjoint writer and
    reader sets are producer-consumer; multiple write-mostly writers
    are false-sharing (block-granularity collisions of logically
    private variables); everything else shared is migratory
    (read-modify-write ownership hand-off).
    """
    rd = np.asarray(rd, dtype=np.int64)
    wr = np.asarray(wr, dtype=np.int64)
    tot_r, tot_w = rd.sum(axis=0), wr.sum(axis=0)
    tot = tot_r + tot_w
    acc = (rd + wr) > 0
    n_acc = acc.sum(axis=0)
    writers, readers = wr > 0, rd > 0
    n_wr = writers.sum(axis=0)
    n_rw = (writers & readers).sum(axis=0)
    n_rd_only = (readers & ~writers).sum(axis=0)
    # mean per-writer write fraction (how write-mostly each writer is)
    with np.errstate(divide="ignore", invalid="ignore"):
        wf_node = np.where(writers, wr / np.maximum(rd + wr, 1), 0.0)
    mean_wf = wf_node.sum(axis=0) / np.maximum(n_wr, 1)

    pat = np.full(tot.shape, -1, dtype=np.int64)
    used = tot > 0
    pat[used & (n_acc == 1)] = PATTERNS.index("private")
    shared = used & (n_acc >= 2)

    def free(extra):
        return shared & (pat == -1) & extra

    pat[free(tot_w <= READ_SHARED_WF * tot)] = \
        PATTERNS.index("read_shared")
    pat[free((n_wr >= 1) & (n_rw == 0) & (n_rd_only >= 1))] = \
        PATTERNS.index("producer_consumer")
    pat[free((n_wr >= 2) & (mean_wf >= FALSE_SHARING_WF))] = \
        PATTERNS.index("false_sharing")
    pat[free(np.ones_like(shared))] = PATTERNS.index("migratory")
    return pat


# lint: host
def sharing_section(rd, wr, pat) -> dict:
    """The doc's ``sharing`` block: per-pattern line/access counts and
    the accesses-weighted dominant pattern (None if nothing was
    touched; ties resolve in PATTERNS order)."""
    tot = np.asarray(rd, dtype=np.int64).sum(axis=0) \
        + np.asarray(wr, dtype=np.int64).sum(axis=0)
    by = {}
    best, best_acc = None, -1
    for i, name in enumerate(PATTERNS):
        m = pat == i
        lines, accesses = int(m.sum()), int(tot[m].sum())
        by[name] = {"lines": lines, "accesses": accesses}
        if accesses > best_acc:
            best, best_acc = name, accesses
    classified = int((pat >= 0).sum())
    return {"classified_lines": classified,
            "by_pattern": by,
            "dominant": best if classified else None}


# lint: host
def top_contended(block_bits: int, rd, wr, pat, k: int = 8,
                  miss_addr=None, inv_addr=None, mig_addr=None,
                  abort_addr=None) -> list:
    """Top-k contended lines, most contended first.

    The contention score of a line is its access total if 2+ nodes
    touch it (a private line cannot contend), plus every per-address
    protocol-event count that was measured (misses, invalidations,
    migrations, deep aborts) — so protocol churn outranks plain volume
    at equal traffic. Deterministic: ties break on lower address.
    """
    rd = np.asarray(rd, dtype=np.int64)
    wr = np.asarray(wr, dtype=np.int64)
    tot_r, tot_w = rd.sum(axis=0), wr.sum(axis=0)
    n_acc = ((rd + wr) > 0).sum(axis=0)
    score = np.where(n_acc >= 2, tot_r + tot_w, 0)
    extras = {}
    for name, arr in (("misses", miss_addr), ("invalidations", inv_addr),
                      ("migrations", mig_addr), ("aborts", abort_addr)):
        if arr is not None:
            arr = np.asarray(arr, dtype=np.int64)
            if arr.ndim == 2:          # per-class planes: sum classes
                arr = arr.sum(axis=1)
            extras[name] = arr
            score = score + arr
    order = np.lexsort((np.arange(score.shape[0]), -score))
    out = []
    for a in order[:k]:
        if score[a] <= 0:
            break
        a = int(a)
        row = {
            "addr": a,
            "home": a >> block_bits,
            "block": a & ((1 << block_bits) - 1),
            "pattern": PATTERNS[pat[a]] if pat[a] >= 0 else None,
            "nodes": int(n_acc[a]),
            "readers": int((rd[:, a] > 0).sum()),
            "writers": int((wr[:, a] > 0).sum()),
            "reads": int(tot_r[a]),
            "writes": int(tot_w[a]),
            "score": int(score[a]),
        }
        for name, arr in extras.items():
            row[name] = int(arr[a])
        out.append(row)
    return out


# -- doc builders -----------------------------------------------------------

# lint: host
def _fanout_doc(counts) -> dict:
    """Fan-out histogram doc: power-of-two buckets (bucket_lo 0, 1, 2,
    4, ... like the latency histogram; bucket 0 is structurally always
    zero — no-victim broadcasts record nothing — but kept so counts
    align with ops.step.FANOUT_BUCKETS)."""
    counts = [int(c) for c in np.asarray(counts)]
    lo = [0] + [1 << (b - 1) for b in range(1, len(counts))]
    return {"bucket_lo": lo, "counts": counts}


# lint: host
def _base_doc(engine: str, nodes: int, addr_space: int, steps: int,
              step_unit: str, rd, wr) -> dict:
    pat = classify(rd, wr)
    return {
        "schema": SCHEMA_ID,
        "engine": engine,
        "nodes": int(nodes),
        "addr_space": int(addr_space),
        "steps": int(steps),
        "step_unit": step_unit,
        "accesses": {"reads": int(np.asarray(rd, np.int64).sum()),
                     "writes": int(np.asarray(wr, np.int64).sum())},
        "miss_classes": None,
        "invalidations": None,
        "writebacks": None,
        "ownership_migrations": None,
        "sharing": sharing_section(rd, wr, pat),
        "top_contended": [],
        "abort_anatomy": None,
        "extra": {},
    }, pat


# lint: host
def from_async(cfg, prof, steps: int, k: int = 8) -> dict:
    """Build the v1 doc from an async run_cycles_profile plane."""
    rd, wr = np.asarray(prof["rd"]), np.asarray(prof["wr"])
    doc, pat = _base_doc("async", cfg.num_nodes,
                         cfg.num_nodes << cfg.block_bits, steps,
                         "cycles", rd, wr)
    ma = np.asarray(prof["miss_addr"], dtype=np.int64)
    doc["miss_classes"] = {
        name: int(ma[:, i].sum()) for i, name in enumerate(MISS_CLASSES)}
    doc["invalidations"] = {
        "applied": int(np.asarray(prof["inv_addr"], np.int64).sum()),
        "fanout_hist": _fanout_doc(prof["inv_fanout"]),
    }
    doc["writebacks"] = int(np.asarray(prof["wb_addr"], np.int64).sum())
    doc["ownership_migrations"] = int(
        np.asarray(prof["mig_addr"], np.int64).sum())
    doc["top_contended"] = top_contended(
        cfg.block_bits, rd, wr, pat, k, miss_addr=ma,
        inv_addr=prof["inv_addr"], mig_addr=prof["mig_addr"])
    return doc


# lint: host
def from_sync(cfg, rd, wr, steps: int, k: int = 8) -> dict:
    """Build the v1 doc from a sync run_sync_profile capture: access
    planes and the classifier only (None = not measured for the
    message-level counters, per the schema's optional-block rule)."""
    doc, pat = _base_doc("sync", cfg.num_nodes,
                         cfg.num_nodes << cfg.block_bits, steps,
                         "rounds", rd, wr)
    doc["top_contended"] = top_contended(cfg.block_bits, rd, wr, pat, k)
    return doc


# lint: host
def from_deep(cfg, prof, steps: int, k: int = 8) -> dict:
    """Build the v1 doc from a deep run_deep_profile plane, including
    the measured abort anatomy (the ghost-poison fraction is
    1 - committed/raised, None when no poison flag was raised)."""
    rd, wr = np.asarray(prof["rd"]), np.asarray(prof["wr"])
    doc, pat = _base_doc("deep", cfg.num_nodes,
                         cfg.num_nodes << cfg.block_bits, steps,
                         "rounds", rd, wr)
    ab_node = np.asarray(prof["abort_node"], dtype=np.int64)
    stops = np.asarray(prof["stops"], dtype=np.int64)
    raised = int(np.asarray(prof["poison_raised"]))
    committed = int(np.asarray(prof["poison_committed"]))
    nn = max(int(cfg.num_nodes) * max(int(steps), 1), 1)
    doc["abort_anatomy"] = {
        "rounds": int(steps),
        "aborts": {name: int(ab_node[:, i].sum())
                   for i, name in enumerate(ABORT_CLASSES)},
        "window_stops": {name: int(stops[i].sum())
                         for i, name in enumerate(STOP_CLASSES)},
        "poison_flags": {
            "raised": raised,
            "committed": committed,
            "ghost_fraction": (round(1.0 - committed / raised, 6)
                               if raised else None),
        },
        "aborts_per_node_round": {
            name: round(float(ab_node[:, i].sum()) / nn, 6)
            for i, name in enumerate(ABORT_CLASSES)},
        "retired": int(np.asarray(prof["n_ret"], np.int64).sum()),
    }
    doc["top_contended"] = top_contended(
        cfg.block_bits, rd, wr, pat, k, abort_addr=prof["abort_addr"])
    return doc


# -- validation -------------------------------------------------------------

# lint: host
def _nonneg_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and v >= 0


# lint: host
def _check_class_dict(d, keys, where: str, errs) -> None:
    if not isinstance(d, dict) or set(d) != set(keys):
        errs.append(f"{where} must be a dict with keys {keys}")
        return
    for kk, v in d.items():
        if not _nonneg_int(v):
            errs.append(f"{where}[{kk!r}] must be a non-negative int, "
                        f"got {v!r}")


# lint: host
def validate(doc: dict) -> dict:
    """Check a profile doc against cache-sim/profile/v1; returns the
    doc, raises ValueError listing every violation. Dependency-free
    like obs.schema — the container has no jsonschema."""
    errs = []
    if not isinstance(doc, dict):
        raise ValueError(f"profile must be a dict, "
                         f"got {type(doc).__name__}")
    for k in _TOP_KEYS:
        if k not in doc:
            errs.append(f"missing key: {k}")
    for k in doc:
        if k not in _TOP_KEYS:
            errs.append(f"unknown key: {k}")
    if doc.get("schema") != SCHEMA_ID:
        errs.append(f"schema must be {SCHEMA_ID!r}, "
                    f"got {doc.get('schema')!r}")
    if doc.get("engine") not in ("async", "sync", "deep"):
        errs.append(f"engine must be async|sync|deep, "
                    f"got {doc.get('engine')!r}")
    if doc.get("step_unit") not in ("cycles", "rounds"):
        errs.append(f"step_unit must be cycles|rounds, "
                    f"got {doc.get('step_unit')!r}")
    for k in ("nodes", "addr_space", "steps"):
        if not _nonneg_int(doc.get(k)):
            errs.append(f"{k} must be a non-negative int, "
                        f"got {doc.get(k)!r}")
    acc = doc.get("accesses")
    if not isinstance(acc, dict) or set(acc) != {"reads", "writes"} \
            or not all(_nonneg_int(v) for v in acc.values()):
        errs.append("accesses must be {reads, writes} of "
                    "non-negative ints")
    if doc.get("miss_classes") is not None:
        _check_class_dict(doc["miss_classes"], MISS_CLASSES,
                          "miss_classes", errs)
    inv = doc.get("invalidations")
    if inv is not None:
        if not isinstance(inv, dict) \
                or set(inv) != {"applied", "fanout_hist"}:
            errs.append("invalidations must be None or "
                        "{applied, fanout_hist}")
        else:
            if not _nonneg_int(inv["applied"]):
                errs.append("invalidations.applied must be a "
                            "non-negative int")
            h = inv["fanout_hist"]
            if (not isinstance(h, dict)
                    or set(h) != {"bucket_lo", "counts"}
                    or len(h.get("bucket_lo", [])) !=
                    len(h.get("counts", []))
                    or h.get("bucket_lo", []) !=
                    sorted(set(h.get("bucket_lo", [1])))
                    or not all(_nonneg_int(c)
                               for c in h.get("counts", [None]))):
                errs.append("invalidations.fanout_hist must be "
                            "{bucket_lo, counts} with strictly "
                            "increasing bucket_lo and non-negative "
                            "counts of the same length")
    for k in ("writebacks", "ownership_migrations"):
        v = doc.get(k)
        if v is not None and not _nonneg_int(v):
            errs.append(f"{k} must be None or a non-negative int, "
                        f"got {v!r}")
    sh = doc.get("sharing")
    if not isinstance(sh, dict) \
            or set(sh) != {"classified_lines", "by_pattern", "dominant"}:
        errs.append("sharing must be "
                    "{classified_lines, by_pattern, dominant}")
    else:
        if not _nonneg_int(sh["classified_lines"]):
            errs.append("sharing.classified_lines must be a "
                        "non-negative int")
        bp = sh["by_pattern"]
        if not isinstance(bp, dict) or set(bp) != set(PATTERNS):
            errs.append(f"sharing.by_pattern must have keys {PATTERNS}")
        else:
            for p, ent in bp.items():
                if (not isinstance(ent, dict)
                        or set(ent) != {"lines", "accesses"}
                        or not all(_nonneg_int(v)
                                   for v in ent.values())):
                    errs.append(f"sharing.by_pattern[{p!r}] must be "
                                "{lines, accesses} of non-negative "
                                "ints")
        if sh["dominant"] is not None and sh["dominant"] not in PATTERNS:
            errs.append(f"sharing.dominant must be None or one of "
                        f"{PATTERNS}, got {sh['dominant']!r}")
    tc = doc.get("top_contended")
    if not isinstance(tc, list):
        errs.append("top_contended must be a list")
    else:
        for i, row in enumerate(tc):
            if not isinstance(row, dict) \
                    or any(k not in row for k in _TOP_LINE_KEYS):
                errs.append(f"top_contended[{i}] must carry "
                            f"{_TOP_LINE_KEYS}")
            elif row["pattern"] is not None \
                    and row["pattern"] not in PATTERNS:
                errs.append(f"top_contended[{i}].pattern must be None "
                            f"or one of {PATTERNS}")
    ab = doc.get("abort_anatomy")
    if ab is not None:
        want = {"rounds", "aborts", "window_stops", "poison_flags",
                "aborts_per_node_round", "retired"}
        if not isinstance(ab, dict) or set(ab) != want:
            errs.append(f"abort_anatomy must be None or a dict with "
                        f"keys {tuple(sorted(want))}")
        else:
            for k in ("rounds", "retired"):
                if not _nonneg_int(ab[k]):
                    errs.append(f"abort_anatomy.{k} must be a "
                                "non-negative int")
            _check_class_dict(ab["aborts"], ABORT_CLASSES,
                              "abort_anatomy.aborts", errs)
            _check_class_dict(ab["window_stops"], STOP_CLASSES,
                              "abort_anatomy.window_stops", errs)
            pf = ab["poison_flags"]
            if (not isinstance(pf, dict)
                    or set(pf) != {"raised", "committed",
                                   "ghost_fraction"}
                    or not _nonneg_int(pf.get("raised"))
                    or not _nonneg_int(pf.get("committed"))):
                errs.append("abort_anatomy.poison_flags must be "
                            "{raised, committed, ghost_fraction} with "
                            "non-negative int counts")
            else:
                gf = pf["ghost_fraction"]
                if pf["raised"] == 0:
                    if gf is not None:
                        errs.append("ghost_fraction must be None when "
                                    "no poison flag was raised")
                elif (not isinstance(gf, (int, float))
                      or isinstance(gf, bool)
                      or not 0.0 <= float(gf) <= 1.0):
                    errs.append("ghost_fraction must be a float in "
                                f"[0, 1], got {gf!r}")
            ar = ab["aborts_per_node_round"]
            if (not isinstance(ar, dict)
                    or set(ar) != set(ABORT_CLASSES)
                    or not all(isinstance(v, (int, float))
                               and not isinstance(v, bool) and v >= 0
                               for v in ar.values())):
                errs.append("abort_anatomy.aborts_per_node_round must "
                            f"map {ABORT_CLASSES} to non-negative "
                            "numbers")
    if not isinstance(doc.get("extra"), dict):
        errs.append("extra must be a dict")
    if errs:
        raise ValueError("invalid profile doc:\n  " + "\n  ".join(errs))
    return doc


# -- capture orchestration --------------------------------------------------

# lint: host
def _host_planes(prof: dict) -> dict:
    from ue22cs343bb1_openmp_assignment_tpu_torch.convert import host
    return {k: host(v) for k, v in prof.items()}


# lint: host
def capture_async(cfg, state0, cycles: int, message_phase=None,
                  k: int = 8) -> dict:
    """Profiled deterministic replay of `cycles` async cycles from
    `state0` (the flight recorder's replay-from-initial-state
    discipline: same engine, same cycle count, profile plane on)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    _, prof = step.run_cycles_profile(cfg, state0, cycles,
                                      message_phase)
    return validate(from_async(cfg, _host_planes(prof), cycles, k))


# lint: host
def capture_sync(cfg, st0, rounds: int, k: int = 8) -> dict:
    """Profiled replay of `rounds` sync rounds from SyncState `st0`."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.convert import host
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine
    _, rd, wr = sync_engine.run_sync_profile(cfg, st0, rounds)
    return validate(from_sync(cfg, host(rd), host(wr), rounds, k))


# lint: host
def capture_deep(cfg, st0, rounds: int, k: int = 8) -> dict:
    """Profiled replay of `rounds` deep rounds from SyncState `st0`,
    with the measured abort anatomy (the plain fold; JAX: its XLA fold)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import deep_engine
    _, prof = deep_engine.run_deep_profile(cfg, st0, rounds)
    return validate(from_deep(cfg, _host_planes(prof), rounds, k))


# -- rendering --------------------------------------------------------------

# lint: host
def render_text(doc: dict) -> str:
    """One-screen plain-text rendering (the `cache-sim profile` default
    and the perf-report/dashboard block)."""
    lines = [f"coherence profile [{doc['engine']}] — "
             f"{doc['steps']} {doc['step_unit']}, "
             f"{doc['nodes']} nodes, addr space {doc['addr_space']}"]
    acc = doc["accesses"]
    lines.append(f"  accesses: {acc['reads']} rd / {acc['writes']} wr")
    mc = doc["miss_classes"]
    if mc is not None:
        tot = sum(mc.values())
        parts = ", ".join(f"{k} {v}" for k, v in mc.items())
        lines.append(f"  misses ({tot}): {parts}")
    inv = doc["invalidations"]
    if inv is not None:
        h = inv["fanout_hist"]
        nz = [f"[{lo}+]x{c}" for lo, c in zip(h["bucket_lo"],
                                              h["counts"]) if c]
        lines.append(f"  invalidations: {inv['applied']} applied; "
                     f"fan-out {' '.join(nz) if nz else '-'}")
    if doc["writebacks"] is not None:
        lines.append(f"  writebacks: {doc['writebacks']}  "
                     f"migrations: {doc['ownership_migrations']}")
    sh = doc["sharing"]
    by = ", ".join(
        f"{p} {sh['by_pattern'][p]['lines']}"
        for p in PATTERNS if sh["by_pattern"][p]["lines"])
    lines.append(f"  sharing ({sh['classified_lines']} lines, "
                 f"dominant {sh['dominant']}): {by if by else '-'}")
    ab = doc["abort_anatomy"]
    if ab is not None:
        a = ab["aborts"]
        parts = ", ".join(f"{k} {v}" for k, v in a.items() if v)
        gf = ab["poison_flags"]["ghost_fraction"]
        lines.append(f"  aborts: {parts if parts else '-'}; "
                     f"poison flags {ab['poison_flags']['raised']} "
                     f"raised / {ab['poison_flags']['committed']} "
                     f"committed"
                     + (f" (ghost fraction {gf})" if gf is not None
                        else ""))
        st = ab["window_stops"]
        parts = ", ".join(f"{k} {v}" for k, v in st.items() if v)
        lines.append(f"  window stops: {parts if parts else '-'}")
    if doc["top_contended"]:
        lines.append("  top contended lines:")
        for row in doc["top_contended"]:
            extras = "".join(
                f" {k}={row[k]}" for k in ("misses", "invalidations",
                                           "migrations", "aborts")
                if k in row)
            lines.append(
                f"    addr {row['addr']} (home {row['home']} block "
                f"{row['block']}): {row['pattern']}, "
                f"{row['nodes']} nodes ({row['writers']}w/"
                f"{row['readers']}r), {row['reads']}rd+"
                f"{row['writes']}wr score {row['score']}{extras}")
    return "\n".join(lines)
