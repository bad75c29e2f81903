"""Static kernel-contract verifier for the port's CUDA kernels.

The port of the JAX package's ``analysis/kernelcheck.py`` (the
``--kernel`` prong of ``cache-sim-torch analyze``), with its report
keys (``schema``, ``config``, ``traced``, ``exactness``, ``vmem``,
``lowerability``, ``gates``, ``findings``, ``ok``), ``headline_config``
and ``check(cfg, trace=...)``. The TPU kernel's contracts were an f32
exponent ladder, VMEM residency and Mosaic lowerability; the CUDA
kernels' real constraints, which otherwise live in prose and
``static_assert``s, are these four passes:

1. **exactness** — the bit budgets of the deep engine's packed int32
   words, derived in exact integer arithmetic from the parameters the
   port routes with (``sync_engine.claim_max_rounds`` and
   ``deep_engine.slot_bits``, ``deep_engine.REQ_BITS``), never from
   their constants: the claim key ``(countdown << (pb+1+SB+ST)) |
   (prio << (1+SB)) | (slot << 1) | ev`` and its fresh-key threshold
   (``csrc/deep_round.cu`` ``Keys``), ``DM_ACT`` ``(round << 11) |
   (act_h << 9) | (promo << 8) | (kw << 4) | dw``, ``DM_REQ`` ``node |
   rv << REQ_BITS`` with the all-ones storm sentinel, the fan-out's line
   word, and the sync rounds' key ``(countdown << pb) | prio``. Then it
   machine-checks the key function (``sync_engine._round_key_rs``) at
   its extremes (round 0, the last round before ``claim_max_rounds``,
   the largest node id and the largest priority) composed in torch's
   int32 against Python big ints, and the config's own caps (the
   largest ``num_nodes`` ``SystemConfig`` admits, with and without the
   read storm) against every field. On the card it also runs one round
   at those extremes through the fused kernel and through its plain
   version on a contended machine (every node's window on one entry):
   the two must be bit-identical, the counterpart of JAX's adversarial
   contender multisets in real float32. Finding kinds: ``key_range``
   (a key or threshold leaves int32), ``field_width`` (a field cannot
   hold what the caps admit, or a real node id is the sentinel),
   ``extreme_round`` (kernel and plain round differ).
2. **vmem → shared memory** — each kernel's shared memory a block from
   its layout formula (the constants read from the ``.cu`` sources),
   against the peak table's ``vmem_bytes`` (``obs/roofline.PEAKS``:
   227 KiB on the H100). ``vmem_rows`` feeds perf-report. On the card
   the derived value must equal the library's own ``*_smem_bytes()`` /
   ``*_static_smem_bytes()`` entry (``smem_entry``); where ptxas text is
   read, its static figure too. Kind ``vmem_budget`` over budget.
3. **lowerability → resource contract** — for every library the ptxas
   figures (registers, stack, spills) against :data:`RESOURCE_PINS`
   and the 255-register ceiling (``register_budget``, ``spill``); for
   the three cooperative kernels (``deep_round``, ``sync_round``,
   ``sync_multi_round``) the blocks a multiprocessor from registers,
   shared memory and threads under the H100's per-SM limits
   (:data:`SM_LIMITS`), and the grid a launch can keep co-resident; on
   the card that grid must equal the runtime's entry (``deep_round_grid``
   and the others; ``residency``). On the card the libraries are built
   and their ptxas logs read; on the CPU the pass reads ptxas text
   given to it, by default the fixture captured on the card
   (``ptxas_h100.json`` beside this module; ``ptxas_stale`` when a
   source changed since).
4. **gates** — ``deep_round_kernel.supported`` against the analyzer's
   own admission on JAX's six probe configs and on each edge of the
   kernel's 32-bit masks (``deep_slots``, ``cache_size``, ``1 <<
   block_bits`` at 32 and past it): ``gate_divergence``.

Seeded mutants in ``analysis/mutations.KERNEL_MUTATIONS`` perturb those
parameters and must each be caught statically at the headline config.
"""
# lint: host

from __future__ import annotations

import dataclasses
import functools
import json
import pathlib
import re
from typing import List, Optional

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig

SCHEMA = "cache-sim/kernelcheck/v1"

INT32_MAX = (1 << 31) - 1
#: the kernels' slot, line and entry masks are one 32-bit word
MASK_BITS = 32

#: H100 SXM (sm_90) per-SM limits the residency pass derives blocks a
#: multiprocessor with (CUDA's occupancy rules: registers allocated a
#: warp in units of 256 and split over 4 sub-partitions, shared memory
#: in 128-byte units plus 1 KiB reserved a block)
SM_LIMITS = {"sms": 132, "regs_per_sm": 65536, "sub_partitions": 4,
             "reg_unit": 256, "max_regs_per_thread": 255,
             "threads_per_sm": 2048, "blocks_per_sm": 32,
             "smem_per_sm": 233472, "smem_unit": 128,
             "smem_reserved_per_block": 1024, "warp": 32}

#: ptxas figures each kernel is held to (registers a thread at most,
#: spill bytes exactly), at the contract configs of ``library_jobs``:
#: the figures of the H100 builds (PERF.md section 6)
RESOURCE_PINS = {
    ("deep_fold", "pre"): {"registers": 80, "spill_stores": 0},
    ("deep_fold", "flags"): {"registers": 96, "spill_stores": 0},
    ("deep_fold", "replay"): {"registers": 120, "spill_stores": 0},
    ("deep_round", "round"): {"registers": 255, "spill_stores": 0},
    ("sync_window", "window"): {"registers": 72, "spill_stores": 0},
    ("sync_window", "replay"): {"registers": 68, "spill_stores": 0},
    ("sync_burst", "burst"): {"registers": 46, "spill_stores": 0},
    ("sync_round", "round"): {"registers": 64, "spill_stores": 0},
    ("sync_multi_round", "multi_round"): {"registers": 96,
                                          "spill_stores": 0},
    ("ring_exchange", "ring_exchange"): {"registers": 32,
                                         "spill_stores": 0},
    ("threefry", "threefry"): {"registers": 20, "spill_stores": 0},
    ("threefry", "threefry_pair"): {"registers": 22, "spill_stores": 0},
}

#: the cooperative kernels: (library, kernel) -> (the .cu holding the
#: launch, its per-SM cap constant or None)
COOPERATIVE = {("deep_round", "round"): ("deep_round.cu", None),
               ("sync_round", "round"): ("sync_round.cu",
                                         "MAX_BLOCKS_PER_SM"),
               ("sync_multi_round", "multi_round"): (
                   "sync_multi_round.cu", "MAX_BLOCKS_PER_SM")}

#: node counts at which the residency pass compares grids: one that
#: fits the resident blocks and one that does not
GRID_NODES = (4096, 1 << 20)

FIXTURE = pathlib.Path(__file__).with_name("ptxas_h100.json")


# ---------------------------------------------------------------------------
# the sources' constants
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _source(name: str) -> str:
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import kernel_build
    return (kernel_build.CSRC / name).read_text()


def cu_const(name: str, const: str) -> int:
    """The integer a ``constexpr`` of ``csrc/<name>`` sets ``const`` to."""
    m = re.search(rf"constexpr\s[^;]*?\b{const}\s*=\s*(\d+)", _source(name))
    if m is None:
        raise ValueError(f"csrc/{name} defines no constexpr {const}")
    return int(m.group(1))


# ---------------------------------------------------------------------------
# pass 1: exactness — the packed words' bit budgets
# ---------------------------------------------------------------------------

def _prio_bits(num_nodes: int) -> int:
    return max(1, (num_nodes - 1).bit_length())


@functools.lru_cache(maxsize=None)
def _largest_admitted(**kw) -> int:
    """The largest ``num_nodes`` SystemConfig admits with ``kw`` (binary
    search over its own validation): the config's cap, read from the
    config rather than restated."""
    def ok(n):
        try:
            SystemConfig.scale(num_nodes=n, **kw)
            return True
        except ValueError:
            return False
    lo, hi = 1, 1 << 24
    if ok(hi):
        return hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if ok(mid) else (lo, mid)
    return lo


def derived_bounds(cfg: SystemConfig) -> dict:
    """The packed words' layouts at ``cfg``, in exact integers: field
    widths and the largest value each word takes."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import deep_engine
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    N = cfg.num_nodes
    pb = _prio_bits(N)
    sb = deep_engine.slot_bits(cfg)
    st = 1 if cfg.deep_read_storm else 0
    cmr = se.claim_max_rounds(cfg)
    shift = pb + 1 + sb + st
    slot_max = (cfg.deep_slots - 1) if sb else 0
    key_max = ((cmr << shift) | (st << (pb + 1 + sb))
               | (((1 << pb) - 1) << (1 + sb)) | (slot_max << 1) | 1)
    rb = deep_engine.REQ_BITS
    waves = cfg.deep_waves + (1 if cfg.deep_read_storm else 0)
    sync_cfg = dataclasses.replace(cfg, deep_window=False,
                                   deep_read_storm=False)
    s_cmr = se.claim_max_rounds(sync_cfg)
    return {
        "prio_bits": pb, "slot_bits": sb, "storm_bit": st,
        "claim_max_rounds": cmr, "key_shift": shift,
        "key_max": key_max, "thresh_max": (cmr + 1) << shift,
        "slot_field_max": (1 << sb) - 1 if sb else 0,
        "slot_max": slot_max,
        "act_max": (cmr << 11) | 0x7FF, "stamp_max": waves,
        "req_bits": rb, "req_sentinel": (1 << rb) - 1,
        "req_word_max": (0x3FF << rb) | ((1 << rb) - 1),
        "fan_word_max": (0xFFF << rb) | ((1 << rb) - 1),
        "node_max": N - 1,
        "node_cap": _largest_admitted(deep_window=True),
        "storm_node_cap": _largest_admitted(deep_window=True,
                                            deep_read_storm=True),
        "sync_claim_max_rounds": s_cmr,
        "sync_thresh_max": (s_cmr + 1) << pb,
    }


def _key_extremes(cfg: SystemConfig, b: dict) -> List[dict]:
    """The deep claim key and the sync key at round 0 and at the last
    round before claim_max_rounds, for node 0, the largest node id and
    the largest priority: ``_round_key_rs`` evaluated, the lane key
    composed in torch int32 as ``deep_engine.deep_round_core`` composes
    it, against the same composition in Python big ints."""
    import torch

    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    I32 = torch.int32
    N, pb, sb, st = cfg.num_nodes, b["prio_bits"], b["slot_bits"], \
        b["storm_bit"]
    shift = pb + 1 + sb + st
    rows = torch.arange(N, dtype=I32)
    out = []
    for label, kcfg, cmr in (("deep", cfg, b["claim_max_rounds"]),
                             ("sync", dataclasses.replace(
                                 cfg, deep_window=False,
                                 deep_read_storm=False),
                              b["sync_claim_max_rounds"])):
        for rnd in sorted({0, max(cmr - 1, 0)}):
            rk = se._round_key_rs(kcfg, torch.tensor(rnd, dtype=I32),
                                  torch.tensor(0, dtype=I32), rows)
            prio = rk & ((1 << pb) - 1)
            nodes = sorted({0, N - 1, int(torch.argmax(prio))})
            for node in nodes:
                cd_big = max(cmr - rnd, 0)
                p_big = int(prio[node])
                cd = torch.tensor(cd_big, dtype=I32)
                if label == "deep":
                    big = ((cd_big << shift) | (p_big << (1 + sb))
                           | (b["slot_max"] << 1) | 1)
                    t32 = ((cd << shift) | (p_big << (1 + sb))
                           | (b["slot_max"] << 1) | 1)
                    th_big = (cd_big + 1) << shift
                    th32 = (cd + 1) << shift
                else:
                    big, t32 = int(rk[node]), rk[node]
                    th_big = (cd_big + 1) << pb
                    th32 = (cd + 1) << pb
                out.append({"key": label, "round": rnd, "node": node,
                            "big": big, "int32": int(t32),
                            "thresh_big": th_big, "thresh_int32": int(th32),
                            "ok": (big == int(t32) and big <= INT32_MAX
                                   and th_big == int(th32)
                                   and th_big <= INT32_MAX)})
    return out


def layout_findings(cfg: SystemConfig, b: Optional[dict] = None) -> list:
    """The exactness findings of ``cfg``'s layouts (no run)."""
    b = b or derived_bounds(cfg)
    out = []

    def find(kind, detail):
        out.append({"pass": "exactness", "kind": kind, "detail": detail})

    if b["thresh_max"] > INT32_MAX or b["key_max"] > INT32_MAX:
        find("key_range",
             f"claim key: countdown {b['claim_max_rounds']} << "
             f"{b['key_shift']} (prio {b['prio_bits']}, slot "
             f"{b['slot_bits']}, storm {b['storm_bit']} bits) reaches "
             f"key {b['key_max']:#x} / threshold {b['thresh_max']:#x}, "
             f"past int32's {INT32_MAX:#x}")
    if b["slot_max"] > b["slot_field_max"]:
        find("field_width", f"claim key: slot {b['slot_max']} does not "
                            f"fit {b['slot_bits']} slot bits")
    if b["sync_thresh_max"] > INT32_MAX:
        find("key_range", f"sync key: threshold "
                          f"{b['sync_thresh_max']:#x} past int32")
    if b["act_max"] > INT32_MAX:
        find("key_range", f"DM_ACT: round {b['claim_max_rounds']} << 11 "
                          f"reaches {b['act_max']:#x}, past int32")
    if b["stamp_max"] > 15:
        find("field_width", f"DM_ACT: wave stamp {b['stamp_max']} does "
                            "not fit its 4-bit field")
    mask = b["req_sentinel"]
    if b["node_cap"] - 1 > mask:
        find("field_width",
             f"DM_REQ: SystemConfig admits deep_window num_nodes up to "
             f"{b['node_cap']}, but the {b['req_bits']}-bit requester "
             f"field holds ids up to {mask}")
    if b["storm_node_cap"] - 1 >= mask:
        find("field_width",
             f"DM_REQ: read-storm configs admit node id "
             f"{b['storm_node_cap'] - 1}, the 'matches nobody' sentinel "
             f"is {mask}: a real node id equals the sentinel")
    if cfg.deep_window and (b["node_max"] > mask or (
            cfg.deep_read_storm and b["node_max"] >= mask)):
        find("field_width",
             f"DM_REQ: node id {b['node_max']} at this config against "
             f"the {b['req_bits']}-bit field (sentinel {mask})")
    if b["req_word_max"] > INT32_MAX or b["fan_word_max"] > INT32_MAX:
        find("field_width",
             f"DM_REQ / fan-out word: {b['req_bits']}-bit requester "
             f"under 10 round-value or 12 action bits passes int32")
    return out


def extreme_rounds(cfg: SystemConfig, device=None) -> dict:
    """One round at round 0 and at the last round before
    claim_max_rounds through ``deep_round_kernel.fused_round`` (the
    kernel on a CUDA device) and through ``plain_round`` on the same
    inputs, on a contended machine: every node's window holds writes to
    one entry. ``{"rounds": [...], "equal": bool}``."""
    import torch

    from ue22cs343bb1_openmp_assignment_tpu_torch import device as _device
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_round_kernel as drk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    from ue22cs343bb1_openmp_assignment_tpu_torch.state import init_state

    dev = _device.resolve(device)
    cfg = dataclasses.replace(cfg, fused_round=True)
    W = cfg.drain_depth + cfg.txn_width
    traces = [[(1, 0, node + k) for k in range(W)]
              for node in range(cfg.num_nodes)]
    st0 = se.from_sim_state(cfg, init_state(cfg, traces, device=dev))
    cmr = se.claim_max_rounds(cfg)
    rows, equal = [], True
    for rnd in (0, cmr - 1):
        st = st0.replace(round=torch.tensor(rnd, dtype=torch.int32,
                                            device=dev))
        args = drk.round_inputs(cfg, st)
        got = drk.fused_round(*args)
        want = drk.plain_round(*args)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        retired = int(want[2].sum())
        rows.append({"round": rnd, "equal": same, "retired": retired})
        equal &= same
    return {"device": dev.type, "num_nodes": cfg.num_nodes,
            "rounds": rows, "equal": equal}


def check_exactness(cfg: SystemConfig, device=None,
                    extremes: bool = False) -> dict:
    """Pass 1: the layouts' budgets, the key extremes and the caps;
    with ``extremes`` on a CUDA device, the kernel at the extremes."""
    b = derived_bounds(cfg)
    findings = layout_findings(cfg, b)
    keys = _key_extremes(cfg, b)
    for k in keys:
        if not k["ok"]:
            findings.append({
                "pass": "exactness", "kind": "key_range",
                "detail": f"{k['key']} key at round {k['round']}, node "
                          f"{k['node']}: int32 {k['int32']:#x} (threshold "
                          f"{k['thresh_int32']:#x}) against big int "
                          f"{k['big']:#x} (threshold {k['thresh_big']:#x})"})
    lemmas = {"claim_key_extremes": all(k["ok"] for k in keys
                                        if k["key"] == "deep"),
              "sync_key_extremes": all(k["ok"] for k in keys
                                       if k["key"] == "sync"),
              "config_caps": not any(f["kind"] == "field_width"
                                     for f in findings)}
    rounds = None
    if extremes:
        rounds = extreme_rounds(cfg, device)
        lemmas["extreme_round_bit_identical"] = rounds["equal"]
        if not rounds["equal"]:
            findings.append({"pass": "exactness", "kind": "extreme_round",
                             "detail": f"fused round != plain round at "
                                       f"the key extremes: "
                                       f"{rounds['rounds']}"})
    return {"bounds": b, "key_extremes": keys, "lemmas": lemmas,
            "extreme_rounds": rounds, "findings": findings,
            "ok": not findings}


# ---------------------------------------------------------------------------
# pass 2: shared memory
# ---------------------------------------------------------------------------

def smem_layout(kernel: str, cfg: SystemConfig) -> dict:
    """{"dynamic", "static", "threads"} bytes a block of ``kernel`` at
    ``cfg``, from its layout formula over the source's constants."""
    S = 1 << cfg.block_bits
    if kernel == "deep.fold":
        block = cu_const("deep_fold.cu", "BLOCK")
        tables = cu_const("deep_fold.cuh", "N_TABLES")
        return {"dynamic": tables * S * block * 4, "static": 0,
                "threads": block}
    if kernel == "deep.round_fused":
        block = cu_const("deep_round.cu", "BLOCK")
        tables = cu_const("deep_fold.cuh", "N_TABLES")
        cols = cu_const("deep_round.cu", "DM_COLS")
        sw = cu_const("deep_round.cu", "SW_WORDS")
        row, crow = S * cols + 1, S + 1
        words = tables * S * block + block * row + block * crow \
            + sw * block
        return {"dynamic": words * 4, "static": 0, "threads": block}
    src = {"sync.round_fused": "sync_round.cu",
           "sync.multi_round_fused": "sync_multi_round.cu"}[kernel]
    block = cu_const(src, "BLOCK")
    # flush_counters' part[WARPS][N_DELTAS] (csrc/sync_round.cuh)
    deltas = cu_const("sync_round.cuh", "N_DELTAS")
    return {"dynamic": cu_const(src, "SMEM_BYTES"),
            "static": (block // 32) * deltas * 4, "threads": block}


#: kernel -> (library name, ptxas kernel name, runtime entries)
SMEM_KERNELS = {
    "deep.fold": ("deep_fold", "pre", "deep_fold_smem_bytes", None),
    "deep.round_fused": ("deep_round", "round", "deep_round_smem_bytes",
                         None),
    "sync.round_fused": ("sync_round", "round", "sync_round_smem_bytes",
                         "sync_round_static_smem_bytes"),
    "sync.multi_round_fused": ("sync_multi_round", "multi_round",
                               "sync_multi_round_smem_bytes",
                               "sync_multi_round_static_smem_bytes"),
}


def vmem_verdict(dynamic: int, static: int, vmem_bytes: int) -> dict:
    """JAX's row shape with the CUDA meaning: resident_in is the dynamic
    shared memory a block, resident_out the static; one block, no
    double-buffer headroom; failing strictly over budget."""
    required = dynamic + static
    return {"resident_in_bytes": int(dynamic),
            "resident_out_bytes": int(static), "peak_bytes": None,
            "grid_steps": 1, "headroom_bytes": 0,
            "required_bytes": int(required),
            "vmem_bytes": int(vmem_bytes), "ok": required <= vmem_bytes}


def vmem_rows(cfg: SystemConfig, device_kind: Optional[str] = None,
              kernels=("deep.fold", "deep.round_fused")) -> list:
    """Shared memory rows of ``kernels`` at ``cfg`` against the peak
    table's ``vmem_bytes`` for ``device_kind`` (default the H100 the
    kernels are built for): the block the perf report embeds."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import roofline
    peaks = roofline.device_peaks(device_kind or "h100")
    rows = []
    for k in kernels:
        lay = smem_layout(k, cfg)
        row = vmem_verdict(lay["dynamic"], lay["static"],
                           peaks["vmem_bytes"])
        row.update(kernel=k, device_kind=peaks["kind"],
                   block_threads=lay["threads"], basis="layout-formula")
        rows.append(row)
    return rows


def check_vmem(configs: dict, device_kind: Optional[str] = None,
               ptxas: Optional[dict] = None, libs: Optional[dict] = None
               ) -> dict:
    """Pass 2 over ``configs`` ({kernel: cfg}); ``ptxas`` ({library:
    parsed summary}) cross-checks the static figure, ``libs`` ({library:
    loaded CDLL}, the card) the libraries' own entries."""
    rows, findings = [], []
    for k, cfg in configs.items():
        row = vmem_rows(cfg, device_kind, (k,))[0]
        lib_name, pk, dyn_entry, static_entry = SMEM_KERNELS[k]
        if ptxas is not None and lib_name in ptxas:
            got = ptxas[lib_name].get(pk, {}).get("smem")
            row["ptxas_static_bytes"] = got
            if got is not None and got != row["resident_out_bytes"]:
                findings.append({"pass": "vmem", "kind": "smem_entry",
                                 "detail": f"{k}: ptxas reports {got} B "
                                           f"static, the layout "
                                           f"{row['resident_out_bytes']}"})
        if libs is not None and lib_name in libs:
            lib = libs[lib_name]
            row["library_dynamic_bytes"] = int(getattr(lib, dyn_entry)())
            want = [("dynamic", row["resident_in_bytes"],
                     row["library_dynamic_bytes"])]
            if static_entry:
                row["library_static_bytes"] = int(
                    getattr(lib, static_entry)())
                want.append(("static", row["resident_out_bytes"],
                             row["library_static_bytes"]))
            for what, derived, entry in want:
                if derived != entry:
                    findings.append({
                        "pass": "vmem", "kind": "smem_entry",
                        "detail": f"{k}: derived {what} shared memory "
                                  f"{derived} B != the library's {entry} B"})
        if not row["ok"]:
            findings.append({"pass": "vmem", "kind": "vmem_budget",
                             "detail": f"{k}: required "
                                       f"{row['required_bytes']} B > "
                                       f"{row['vmem_bytes']} B of shared "
                                       f"memory a block on "
                                       f"{row['device_kind']}"})
        rows.append(row)
    return {"rows": rows, "findings": findings, "ok": not findings}


# ---------------------------------------------------------------------------
# pass 3: the resource contract
# ---------------------------------------------------------------------------

def blocks_per_sm(registers: int, threads: int, smem_bytes: int,
                  limits: dict = SM_LIMITS) -> dict:
    """Blocks of one kernel a multiprocessor keeps resident, by each
    limit and overall (CUDA's occupancy rules for sm_90)."""
    L = limits
    warps = -(-threads // L["warp"])
    regs_warp = -(-max(registers, 1) * L["warp"] // L["reg_unit"]) \
        * L["reg_unit"]
    per_sub = L["regs_per_sm"] // L["sub_partitions"] // regs_warp
    by_regs = per_sub * L["sub_partitions"] // warps
    smem = -(-smem_bytes // L["smem_unit"]) * L["smem_unit"] \
        + L["smem_reserved_per_block"]
    by_smem = L["smem_per_sm"] // smem
    by_threads = L["threads_per_sm"] // (warps * L["warp"])
    return {"by_registers": by_regs, "by_smem": by_smem,
            "by_threads": by_threads, "by_blocks": L["blocks_per_sm"],
            "blocks": min(by_regs, by_smem, by_threads,
                          L["blocks_per_sm"])}


def coop_grid(blocks_sm: int, cap: Optional[int], threads: int,
              n: int, limits: dict = SM_LIMITS) -> int:
    """The grid a cooperative launch of one machine of ``n`` nodes uses:
    one node a thread while they fit the resident blocks, else all of
    them (``grid_for`` in the sources)."""
    per_sm = min(blocks_sm, cap) if cap else blocks_sm
    resident = per_sm * limits["sms"]
    return min(-(-n // threads), resident)


def library_jobs(nodes: int = 4096) -> list:
    """(Library, cfg) of every kernel library the main paths use, at its
    contract config: the deep bench config at ``nodes`` (fold and fused
    round), the sync bench configs (txn_width 3 window and multi round,
    txn_width 1 burst and round), the ring and threefry libraries."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_fold_kernel, deep_round_kernel, sync_burst_kernel,
        sync_multi_round_kernel, sync_round_kernel, sync_window_kernel,
        threefry_kernel)
    from ue22cs343bb1_openmp_assignment_tpu_torch.parallel import (
        ring_kernel)
    deep = bench.deep_config(nodes)
    k3 = bench.sync_config(nodes, 3, window_kernels=True)
    k1 = bench.sync_config(nodes, 1, window_kernels=True)
    return [(deep_fold_kernel.LIBRARY, deep),
            (deep_round_kernel.LIBRARY,
             dataclasses.replace(deep, fused_round=True)),
            (sync_window_kernel.LIBRARY, k3), (sync_burst_kernel.LIBRARY, k1),
            (sync_round_kernel.LIBRARY, k1),
            (sync_multi_round_kernel.LIBRARY, k3),
            (ring_kernel.LIBRARY, None), (threefry_kernel.LIBRARY, None)]


def _smem_configs(nodes: int) -> dict:
    jobs = {lib.name: c for lib, c in library_jobs(nodes)}
    return {"deep.fold": jobs["deep_fold"],
            "deep.round_fused": jobs["deep_round"],
            "sync.round_fused": jobs["sync_round"],
            "sync.multi_round_fused": jobs["sync_multi_round"]}


def load_fixture(path=None) -> dict:
    """The ptxas capture: {"card", "libraries": {name: {"stem", "log"}}}."""
    return json.loads(pathlib.Path(path or FIXTURE).read_text())


def capture_ptxas(path, nodes: int = 4096) -> dict:
    """Build every library of ``library_jobs`` (on a machine with nvcc)
    and write their ptxas logs to ``path``: the fixture the CPU pass
    reads."""
    import subprocess

    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import kernel_build
    jobs = library_jobs(nodes)
    kernel_build.build(jobs)
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        card = "unknown"
    doc = {"card": card, "nodes": nodes, "libraries": {
        lib.name: {"stem": lib.library_path(c).stem,
                   "log": lib.ptxas_log(c)} for lib, c in jobs}}
    pathlib.Path(path).write_text(json.dumps(doc, indent=1,
                                             sort_keys=True) + "\n")
    return doc


def check_resources(nodes: int, logs: dict, libs: Optional[dict] = None,
                    stems: Optional[dict] = None) -> dict:
    """Pass 3 over ptxas ``logs`` ({library: text}); ``stems`` ({library:
    the build stem the logs came from}) flags a stale capture; ``libs``
    ({library: CDLL}, the card) compares the derived grids with the
    runtime's entries."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import kernel_build
    findings, kernels = [], {}
    jobs = library_jobs(nodes)
    parsed = {}
    for lib, c in jobs:
        if lib.name not in logs:
            findings.append({"pass": "lowerability", "kind": "ptxas_missing",
                             "detail": f"no ptxas text for {lib.name}"})
            continue
        if stems is not None and stems.get(lib.name) != \
                lib.library_path(c).stem:
            findings.append({"pass": "lowerability", "kind": "ptxas_stale",
                             "detail": f"{lib.name}: the ptxas capture is "
                                       f"of build {stems.get(lib.name)}, the "
                                       f"sources now build "
                                       f"{lib.library_path(c).stem}; "
                                       "capture it again on the card "
                                       "(kernelcheck.capture_ptxas)"})
        parsed[lib.name] = kernel_build.parse_ptxas(logs[lib.name],
                                                    lib.kernels)
    cfgs = {lib.name: c for lib, c in jobs}
    for (lname, kname), pin in sorted(RESOURCE_PINS.items()):
        info = parsed.get(lname, {}).get(kname)
        if info is None:
            if lname in parsed:
                findings.append({"pass": "lowerability",
                                 "kind": "ptxas_missing",
                                 "detail": f"{lname}: no entry {kname}"})
            continue
        row = dict(info)
        regs = info.get("registers", 0)
        spills = info.get("spill_stores", 0) + info.get("spill_loads", 0)
        if regs > min(pin["registers"],
                      SM_LIMITS["max_regs_per_thread"]):
            findings.append({"pass": "lowerability",
                             "kind": "register_budget",
                             "detail": f"{lname}/{kname}: {regs} registers "
                                       f"> pinned {pin['registers']}"})
        if spills > pin["spill_stores"]:
            findings.append({"pass": "lowerability", "kind": "spill",
                             "detail": f"{lname}/{kname}: {spills} spill "
                                       f"bytes > pinned "
                                       f"{pin['spill_stores']}"})
        coop = COOPERATIVE.get((lname, kname))
        if coop is not None:
            src, cap_name = coop
            cfg = cfgs[lname]
            kern = {"deep_round": "deep.round_fused",
                    "sync_round": "sync.round_fused",
                    "sync_multi_round": "sync.multi_round_fused"}[lname]
            lay = smem_layout(kern, cfg)
            occ = blocks_per_sm(regs, lay["threads"],
                                lay["dynamic"] + lay["static"])
            cap = cu_const(src, cap_name) if cap_name else None
            row["blocks_per_sm"] = occ
            row["per_sm_cap"] = cap
            row["grids"] = {}
            if occ["blocks"] < 1:
                findings.append({"pass": "lowerability",
                                 "kind": "residency",
                                 "detail": f"{lname}/{kname}: no block fits "
                                           f"a multiprocessor ({occ})"})
            for n in GRID_NODES:
                g = {"derived": coop_grid(occ["blocks"], cap,
                                          lay["threads"], n)}
                if libs is not None and lname in libs:
                    entry = getattr(libs[lname], f"{lname}_grid")
                    g["runtime"] = int(entry(n) if lname == "deep_round"
                                      else entry(1, n))
                    if g["runtime"] != g["derived"]:
                        findings.append({
                            "pass": "lowerability", "kind": "residency",
                            "detail": f"{lname}/{kname} at {n} nodes: "
                                      f"derived grid {g['derived']} != "
                                      f"the runtime's {g['runtime']}"})
                row["grids"][str(n)] = g
        kernels[f"{lname}/{kname}"] = row
    return {"kernels": kernels, "parsed": parsed, "findings": findings,
            "ok": not findings}


# ---------------------------------------------------------------------------
# pass 4: gate consistency
# ---------------------------------------------------------------------------

def _probe_configs() -> list:
    """JAX's six probe configs (the headline, single- and multi-wave
    deep@8192, the deep@16384 cap boundary, a storm config, a non-deep
    config) and each edge of the kernel's 32-bit masks."""
    mk = lambda n, dd, tw, **kw: dataclasses.replace(  # noqa: E731
        SystemConfig.scale(num_nodes=n, drain_depth=dd, txn_width=tw),
        **{"deep_window": True, "deep_ownerval_slots": 1, **kw})
    probes = [
        ("headline_4096", mk(4096, 13, 3, deep_slots=3)),
        ("widened_8192_q3_w1", mk(8192, 2, 2, deep_slots=3)),
        ("multiwave_8192_q3_w2",
         mk(8192, 2, 2, deep_slots=3, deep_waves=2)),
        ("cap_boundary_16384", mk(16384, 2, 2, deep_slots=2)),
        ("storm_256", mk(256, 2, 2, deep_slots=2,
                         deep_read_storm=True, deep_ownerval_slots=2)),
        ("xla_only_256", dataclasses.replace(
            SystemConfig.scale(num_nodes=256, drain_depth=2,
                               txn_width=2), deep_window=False)),
    ]
    for v in (MASK_BITS, MASK_BITS + 1):
        probes.append((f"deep_slots_{v}", mk(256, 13, 3, deep_slots=v)))
        probes.append((f"cache_size_{v}", mk(256, 13, 3, deep_slots=3,
                                             cache_size=v)))
    for v in (MASK_BITS, 2 * MASK_BITS):   # 1 << block_bits: 32, then 64
        probes.append((f"entries_{v}", mk(256, 13, 3, deep_slots=3,
                                          mem_size=v)))
    return probes


def analyzer_admits(cfg: SystemConfig) -> bool:
    """The analyzer's own verdict: deep-window configs without the read
    storm (duplicate storm rows stay on the fold path), whose slot, line
    and entry masks fit one 32-bit word and whose packed words fit their
    fields."""
    if not cfg.deep_window or cfg.deep_read_storm:
        return False
    if max(cfg.deep_slots, cfg.cache_size, 1 << cfg.block_bits) \
            > MASK_BITS:
        return False
    return not layout_findings(cfg)


def check_gates() -> dict:
    """Pass 4: ``deep_round_kernel.supported`` must agree with
    ``analyzer_admits`` on every probe (``gate_divergence``). Records
    the TPU kernel's contender bound (``deep_slots * num_nodes < 2**14``)
    as ``legacy_product_bound``: ``widened`` marks what the CUDA kernel
    takes beyond it."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_round_kernel as drk)
    findings, probes = [], {}
    for name, cfg in _probe_configs():
        sup = bool(drk.supported(cfg))
        adm = analyzer_admits(cfg)
        legacy = bool(cfg.deep_window and not cfg.deep_read_storm
                      and cfg.deep_slots * cfg.num_nodes < (1 << 14))
        probes[name] = {"supported": sup, "analyzer": adm,
                        "legacy_product_bound": legacy,
                        "widened": sup and not legacy}
        if sup != adm:
            findings.append({
                "pass": "gates", "kind": "gate_divergence",
                "detail": f"{name}: supported()={sup} but the "
                          f"derivation says {adm}"})
    return {"probes": probes, "findings": findings, "ok": not findings}


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

def headline_config(num_nodes: int = 4096) -> SystemConfig:
    """The deep-engine headline config (the bench's and perf-report's
    deep defaults) the default ``analyze --kernel`` run verifies."""
    return dataclasses.replace(
        SystemConfig.scale(num_nodes=num_nodes, drain_depth=13,
                           txn_width=3),
        deep_window=True,
        deep_slots=2 if num_nodes >= 32768 else 3,
        deep_ownerval_slots=1, deep_horizon_slack=4)


def check(cfg: Optional[SystemConfig] = None, trace: bool = True,
          device_kind: Optional[str] = None, device=None,
          ptxas: Optional[dict] = None) -> dict:
    """Run the four passes. ``trace=False`` keeps to the arithmetic:
    the layouts, the gates and the layout-formula shared memory (no
    ptxas, no build, no launch). With ``trace`` on a CUDA ``device``
    the libraries are built, their ptxas logs and runtime entries read,
    and the extreme round launched; on the CPU the resource pass reads
    ``ptxas`` ({library: text}) or the committed capture."""
    cfg = headline_config() if cfg is None else cfg
    on_card = False
    if trace and device is not None:
        import torch
        on_card = torch.device(device).type == "cuda"
    ex = check_exactness(cfg, device, extremes=on_card)
    gates = check_gates()
    libs = parsed = None
    low = {"kernels": None, "findings": [], "ok": None}
    if trace:
        stems = None
        if on_card:
            from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
                kernel_build)
            jobs = library_jobs(cfg.num_nodes)
            kernel_build.build(jobs)
            logs = {lib.name: lib.ptxas_log(c) for lib, c in jobs}
            libs = {lib.name: lib.load(c) for lib, c in jobs}
            source = "build"
        elif ptxas is not None:
            logs, source = dict(ptxas), "given"
        else:
            fx = load_fixture()
            logs = {k: v["log"] for k, v in fx["libraries"].items()}
            stems = {k: v["stem"] for k, v in fx["libraries"].items()}
            source = f"fixture ({fx['card']})"
        low = check_resources(cfg.num_nodes, logs, libs, stems)
        low["source"] = source
        parsed = low.pop("parsed")
    vm = check_vmem(_smem_configs(cfg.num_nodes), device_kind, parsed,
                    libs)
    findings = (ex["findings"] + vm["findings"] + low["findings"]
                + gates["findings"])
    return {"schema": SCHEMA,
            "config": {"num_nodes": cfg.num_nodes,
                       "deep_slots": cfg.deep_slots,
                       "deep_waves": cfg.deep_waves,
                       "drain_depth": cfg.drain_depth,
                       "txn_width": cfg.txn_width},
            "traced": bool(trace),
            "exactness": ex, "vmem": vm, "lowerability": low,
            "gates": gates,
            "findings": findings, "ok": not findings}


def render_text(rep: dict) -> list:
    """One line a pass plus the findings: the runner's print format."""
    b = rep["exactness"]["bounds"]
    c = rep["config"]
    lines = [
        f"== kernel contracts: {'ok' if rep['ok'] else 'FAIL'} "
        f"[deep@{c['num_nodes']} q{c['deep_slots']} "
        f"w{c['deep_waves']}; traced={rep['traced']}]",
        f"   exactness: claim key {b['prio_bits']}b prio + "
        f"{b['slot_bits']}b slot, countdown {b['claim_max_rounds']} -> "
        f"key {b['key_max']:#x}, threshold {b['thresh_max']:#x}; DM_ACT "
        f"{b['act_max']:#x}; DM_REQ {b['req_bits']}b ids (sentinel "
        f"{b['req_sentinel']:#x}, caps {b['node_cap']} / storm "
        f"{b['storm_node_cap']})",
    ]
    er = rep["exactness"].get("extreme_rounds")
    if er:
        lines.append(f"   extreme rounds on {er['device']}: "
                     + ", ".join(f"round {r['round']} "
                                 f"{'equal' if r['equal'] else 'DIFFER'}"
                                 for r in er["rounds"]))
    for r in rep["vmem"]["rows"]:
        lines.append(
            f"   smem[{r['kernel']}] ({r['basis']}): "
            f"{r['resident_in_bytes']} B dynamic + "
            f"{r['resident_out_bytes']} B static a block of "
            f"{r['block_threads']}, budget {r['vmem_bytes']} B "
            f"({r['device_kind']})")
    low = rep["lowerability"]
    if low["ok"] is not None:
        for name, k in low["kernels"].items():
            occ = k.get("blocks_per_sm")
            lines.append(
                f"   ptxas[{name}]: {k.get('registers')} registers, "
                f"{k.get('spill_stores', 0)} B spilled"
                + (f"; {occ['blocks']} blocks/SM, grids "
                   + ", ".join(f"{n}: {g['derived']}"
                               + (f" (runtime {g['runtime']})"
                                  if "runtime" in g else "")
                               for n, g in k["grids"].items())
                   if occ else ""))
        lines.append(f"   resource contract ({low['source']}): "
                     f"{'clean' if low['ok'] else 'FAIL'}")
    w = [n for n, p in rep["gates"]["probes"].items() if p["widened"]]
    lines.append(f"   gates: {len(rep['gates']['probes'])} probes, "
                 f"widened vs the TPU kernel's product bound: "
                 f"{', '.join(w) if w else 'none'}")
    for f in rep["findings"]:
        lines.append(f"  ! {f['pass']}/{f['kind']}: {f['detail']}")
    return lines
