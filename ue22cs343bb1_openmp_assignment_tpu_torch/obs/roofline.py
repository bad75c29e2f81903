"""Roofline + memory-traffic attribution: which kernel moves the bytes.

The port of the JAX package's ``obs/roofline.py``. The model is
Williams, Waterman & Patterson's roofline (CACM 2009, PAPERS.md): a
kernel with arithmetic intensity ``AI = flops / HBM bytes`` below the
machine's ridge point ``peak_flops / peak_bw`` is bound by memory
bandwidth, not compute. The inputs are a cost record per kernel and a
static per-device peak table (detected device kind, generic fallback),
reduced to two headline scalars:

- **bytes / simulated instruction** — per-step kernel HBM bytes ×
  steps / instructions retired. Steps and retired are deterministic
  integers of the run and the cost record is deterministic for a fixed
  build, config and route, so this number is *exact*: it can gate CI
  with zero reps and zero statistics (``cache-sim-torch bench-diff
  --bytes``).
- **ns / instruction by phase** — the wall-clock decomposition
  (PhaseTimer dispatch/device_get split + the roofline model time per
  kernel). Timing is nondeterministic, so it is opt-in (``--timing``);
  the default report is byte-identical across runs on the same build.

The host arithmetic (:func:`normalize_cost`, :func:`hlo_fingerprint`,
:func:`io_contract_record`, :func:`classify`, :func:`cost_vector`,
:func:`build_report`, :func:`timing_section`, :func:`render_text`) is the
JAX module's code unchanged; :func:`transport_section` reads the port's
``parallel/rdma_comm.wire_bytes``. The peak table adds an ``h100`` row.

**The dispatch record** (:func:`kernel_record`) stands where JAX asks
XLA's ``cost_analysis()`` of a compiled program. PyTorch has no cost
model, so the record counts what one call does: it runs ``fn`` once, on
a copy of every tensor argument (the caller's state is untouched),
under a ``TorchDispatchMode`` that sees every aten op dispatched.

- ``hbm_bytes``: over every op that is not a view and not an allocation
  (``aten.empty*``), the ``nbytes`` of its tensor inputs and outputs;
  plus, for each of the port's CUDA kernels launched in the call (a
  ctypes launch never passes through the dispatcher), its launches
  (deltas of the wrappers' counters, ``bench.launch_counts``) times its
  I/O contract: each input read once, each output written once, from
  the wrapper's ``io_contract_bytes`` / ``io_rows``.
- ``output_bytes``: the same sum over outputs only.
- ``flops``: the output elements of those ops, one integer operation an
  element; a kernel adds 0 (``io_contract_record``'s default).
- ``ops``: the number of those ops; ``launches``: ``{kernel:
  launches}``.
- ``hlo_fingerprint``: :func:`hlo_fingerprint` of the op text, one line
  an op (every op, views and allocations included: aten name, input
  and output shapes and dtypes) with each kernel launch as a line of
  its own where the dispatcher saw it happen.
- ``cost_available``: true unless ``fn`` raised; ``basis``:
  ``"aten-dispatch"``.

It differs from XLA's model in being unfused: every intermediate is
counted at its full size, as eager PyTorch writes it and reads it back,
where XLA's fusions keep intermediates out of HBM. An in-place op on a
large tensor counts the whole tensor. Scalar arguments are not in the
fingerprint, so it names the program, not its data; a data-dependent
loop (a chunk's quiescence read) makes the record a property of the
run's inputs as well, deterministic for fixed inputs. The records of
one run on the card and on the CPU differ by design: on the card the
port's kernels replace plain ops.
"""
# lint: host

from __future__ import annotations

import hashlib
from typing import Optional

SCHEMA_ID = "cache-sim/perfreport/v1"

#: cost_analysis() metric names for the three numbers a roofline needs
_FLOPS_KEY = "flops"
_BYTES_KEY = "bytes accessed"
_OUT_BYTES_KEY = "bytes accessedout{}"

#: static peak table: device_kind substring (lowercased, first match
#: wins) -> nominal peak dense-compute flops/s, HBM bytes/s and
#: per-core VMEM capacity. These are ceilings for *classification*,
#: not marketing claims — the bound verdict only needs the ridge
#: point's order of magnitude. Sources: published TPU spec sheets; the
#: cpu row is a nominal 1-core AVX box so CPU-tier smoke runs still
#: classify. ``vmem_bytes`` is the budget analysis/kernelcheck's
#: static VMEM pass referees fused kernels against: ~16 MiB/core on
#: v4/v5 parts, doubled on v6e; the cpu row carries the 16 MiB
#: as-if-TPU budget so interpret-mode CI runs gate against the
#: smallest real target instead of not gating at all.
#:
#: The ``h100`` row (first, so an NVIDIA H100's name matches it before
#: any other row): ``hbm_bytes_per_s`` is the H100 SXM's HBM3 rate,
#: 3.35e12 B/s; ``flops_per_s`` is its int32 rate, 67e12 / 4 = 16.75e12
#: operations/s (a quarter of the FP32 vector rate, the same constant
#: ``chip_smoke.py`` bounds its kernels with), because the port counts
#: integer operations; ``vmem_bytes`` is the most dynamic shared memory
#: one block can have on sm_90, 227 KiB, the on-chip memory a fused
#: kernel's resident state must fit.
PEAKS = (
    ("h100", {"flops_per_s": 67e12 / 4, "hbm_bytes_per_s": 3.35e12,
              "vmem_bytes": 227 * 2**10}),
    ("v6e", {"flops_per_s": 918e12, "hbm_bytes_per_s": 1.64e12,
             "vmem_bytes": 32 * 2**20}),
    ("v5p", {"flops_per_s": 459e12, "hbm_bytes_per_s": 2.76e12,
             "vmem_bytes": 16 * 2**20}),
    ("v5e", {"flops_per_s": 197e12, "hbm_bytes_per_s": 819e9,
             "vmem_bytes": 16 * 2**20}),
    ("v5 lite", {"flops_per_s": 197e12, "hbm_bytes_per_s": 819e9,
                 "vmem_bytes": 16 * 2**20}),
    ("v4", {"flops_per_s": 275e12, "hbm_bytes_per_s": 1.2e12,
            "vmem_bytes": 16 * 2**20}),
    ("cpu", {"flops_per_s": 1e11, "hbm_bytes_per_s": 4e10,
             "vmem_bytes": 16 * 2**20}),
)

#: unknown device kinds classify against this generic accelerator
#: ceiling rather than failing — the report must degrade, not die
_FALLBACK_PEAKS = {"flops_per_s": 2e14, "hbm_bytes_per_s": 1e12,
                   "vmem_bytes": 16 * 2**20}


# lint: host
def detect_device_kind(device=None) -> str:
    """The device kind of ``device`` as ``bench --record`` writes it:
    the card's name for a CUDA device, ``"cpu"`` for the CPU; with no
    device, the first card's name, or ``"cpu"`` without one. Never
    raises."""
    try:
        import torch
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        device = torch.device(device)
        if device.type == "cuda":
            return str(torch.cuda.get_device_name(device))
        return device.type
    except Exception:
        return "unknown"


# lint: host
def device_peaks(kind: Optional[str] = None) -> dict:
    """Peak specs for a device kind from the static table.

    Returns ``{"kind", "flops_per_s", "hbm_bytes_per_s", "vmem_bytes",
    "ridge_flops_per_byte", "source"}`` — ``source`` is
    ``"static_table"`` on a match, ``"generic_fallback"`` otherwise.
    """
    kind = detect_device_kind() if kind is None else str(kind)
    low = kind.lower()
    for sub, spec in PEAKS:
        if sub in low:
            peaks, source = spec, "static_table"
            break
    else:
        peaks, source = _FALLBACK_PEAKS, "generic_fallback"
    return {"kind": kind,
            "flops_per_s": peaks["flops_per_s"],
            "hbm_bytes_per_s": peaks["hbm_bytes_per_s"],
            "vmem_bytes": peaks["vmem_bytes"],
            "ridge_flops_per_byte": (peaks["flops_per_s"]
                                     / peaks["hbm_bytes_per_s"]),
            "source": source}


# lint: host
def normalize_cost(cost) -> dict:
    """Collapse ``cost_analysis()``'s shape variance to one flat
    ``{metric: float}`` dict.

    Backends return a dict, a list of per-computation dicts, ``None``,
    or an empty list (the CPU backend under some versions); anything
    unusable collapses to ``{}`` — callers mark that as
    ``cost_unavailable`` rather than KeyError-ing (the tier-1
    degradation path).
    """
    if cost is None:
        return {}
    if isinstance(cost, dict):
        parts = [cost]
    elif isinstance(cost, (list, tuple)):
        parts = [c for c in cost if isinstance(c, dict)]
    else:
        return {}
    out: dict = {}
    for part in parts:
        for k, v in part.items():
            try:
                out[str(k)] = out.get(str(k), 0.0) + float(v)
            except (TypeError, ValueError):
                continue
    return out


# lint: host
def hlo_fingerprint(text: str) -> str:
    """Stable 16-hex-digit fingerprint of a lowered program's text —
    the comparability key recorded in bench history: two entries with
    the same fingerprint ran the same compiled program."""
    return hashlib.sha256(text.encode("utf-8")).hexdigest()[:16]


# -- the dispatch record ------------------------------------------------------

# lint: host
def tensor_leaves(obj) -> list:
    """Every tensor reachable from ``obj`` through tuples, lists, dicts,
    dataclass fields and ``__slots__`` (a ``SyncMetrics``' buffer), in a
    fixed order."""
    import dataclasses

    import torch
    out = []
    stack = [obj]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(reversed([getattr(x, f.name)
                                   for f in dataclasses.fields(x)]))
        elif hasattr(type(x), "__slots__"):
            stack.extend(reversed([getattr(x, s, None)
                                   for s in type(x).__slots__]))
    return out


# lint: host
def contract_bytes(cfg, kernel: str, contracts: Optional[dict] = None):
    """(input_bytes, output_bytes) of one launch of the port's kernel
    ``kernel`` (a ``bench.launch_counts`` key) at ``cfg``, from its
    wrapper; ``contracts`` ({kernel: (in, out)}) gives those whose
    operands the config does not fix (the ring exchange's D and lane
    cap, threefry's counter count). Raises ValueError for a kernel with
    no contract here."""
    if contracts and kernel in contracts:
        i, o = contracts[kernel]
        return int(i), int(o)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_fold_kernel as dfk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_round_kernel as drk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        sync_burst_kernel as sbk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        sync_multi_round_kernel as smk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        sync_round_kernel as srk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        sync_window_kernel as swk)
    if cfg is None:
        raise ValueError(f"kernel {kernel!r} launched, but the record "
                         "was given no SystemConfig to size its contract")
    if kernel in dfk.WRAPPERS:
        rows_in, rows_out = dfk.io_rows(cfg, kernel)
        return 4 * cfg.num_nodes * rows_in, 4 * cfg.num_nodes * sum(rows_out)
    table = {"round": lambda: drk.io_contract_bytes(cfg),
             "sync_burst": lambda: sbk.io_contract_bytes(cfg),
             "sync_round": lambda: srk.io_contract_bytes(cfg),
             "sync_multi_round": lambda: smk.io_contract_bytes(cfg),
             "sync_window": lambda: swk.io_contract_bytes(cfg, "window"),
             "sync_replay": lambda: swk.io_contract_bytes(cfg, "replay")}
    if kernel not in table:
        raise ValueError(f"kernel {kernel!r} launched: its I/O contract "
                         "depends on the call's operands; pass it in "
                         "contracts")
    i, o = table[kernel]()
    return int(i), int(o)


def _sig(flat) -> str:
    return ",".join(f"{str(flat[j]).replace('torch.', '')}{list(flat[j + 1])}"
                    for j in range(0, len(flat), 2))


class _DispatchCounter:
    """The counting state of one record: the op lines of the
    fingerprint (each distinct line interned once) and the sums of the
    non-view, non-allocating ops."""

    def __init__(self, wrappers: dict, observer=None):
        import torch
        self.tensor = torch.Tensor
        self.observer = observer
        self.names = list(wrappers)
        self.wrappers = list(wrappers.values())
        self.start = self.last = self.launch_vector()
        self.funcs = {}       # op -> (name, counted)
        self.interned = {}    # line key -> index
        self.keys = []
        self.seq = []
        self.ops = 0
        self.hbm = 0
        self.out = 0
        self.flops = 0

    def launch_vector(self) -> tuple:
        return tuple(w.launches for w in self.wrappers)

    def _line(self, key) -> None:
        i = self.interned.get(key)
        if i is None:
            i = self.interned[key] = len(self.keys)
            self.keys.append(key)
        self.seq.append(i)

    def kernels(self) -> None:
        now = self.launch_vector()
        if now != self.last:
            for k, a, b in zip(self.names, self.last, now):
                if b != a:
                    self._line(("kernel", k, b - a))
                    if self.observer is not None:
                        self.observer.kernel(k, b - a)
            self.last = now

    def launches(self) -> dict:
        return {k: b - a for k, a, b in zip(self.names, self.start,
                                             self.last) if b != a}

    def _flat(self, xs, sig: list) -> int:
        """Append (dtype, shape) of each tensor of ``xs`` (tensors, or
        lists and tuples of them) to ``sig``; their bytes."""
        T = self.tensor
        nb = 0
        for x in xs:
            if isinstance(x, T):
                sig.append(x.dtype)
                sig.append(x.shape)
                nb += x.nbytes
            elif isinstance(x, (list, tuple)):
                nb += self._flat(x, sig)
        return nb

    def op(self, func, args, kwargs, out) -> None:
        self.kernels()
        info = self.funcs.get(func)
        if info is None:
            info = self.funcs[func] = (str(func), not (
                func.is_view
                or func.__name__.startswith(("empty", "new_empty"))))
        sig_in = []
        nb_in = self._flat(args, sig_in)
        if kwargs:
            nb_in += self._flat(kwargs.values(), sig_in)
        sig_out = []
        nb_out = self._flat((out,), sig_out)
        self._line((info[0], tuple(sig_in), tuple(sig_out)))
        if info[1]:
            self.ops += 1
            self.hbm += nb_in + nb_out
            self.out += nb_out
            self.flops += sum(sh.numel() for sh in sig_out[1::2])

    def text(self) -> str:
        texts = [f"kernel {k[1]} x{k[2]}" if k[0] == "kernel"
                 else f"{k[0]} ({_sig(k[1])}) -> ({_sig(k[2])})"
                 for k in self.keys]
        return "\n".join(texts[i] for i in self.seq)


def _find_cfg(args):
    from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
    return next((a for a in args if isinstance(a, SystemConfig)), None)


# lint: host
def dispatch_run(fn, args, cfg=None, contracts: Optional[dict] = None,
                 memory: bool = False, observer=None):
    """Run ``fn(*copied args)`` once under the counting dispatch mode:
    ``(output, counter, launches, temp_bytes)``. ``launches`` is
    ``{kernel: launches}`` of the call; ``temp_bytes`` (``memory`` on a
    CUDA call only, else None) the peak device memory the call
    allocated above what was live before it.

    ``observer`` (the analysis gate's aten walkers) sees the same
    stream: ``observer.start(copied_args)`` before the call, then
    ``observer.op(func, args, kwargs, out)`` for every aten op and
    ``observer.kernel(name, launches)`` where the port's kernels
    launched between two ops."""
    import copy

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from ue22cs343bb1_openmp_assignment_tpu_torch import bench
    args = copy.deepcopy(args)
    cfg = cfg if cfg is not None else _find_cfg(args)
    ctr = _DispatchCounter(bench.counted_wrappers(), observer)
    if observer is not None:
        observer.start(args)

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            ctr.op(func, a, kw, out)
            if observer is not None:
                observer.op(func, a, kw, out)
            return out

    on_card = any(t.is_cuda for t in tensor_leaves(args))
    temp = None
    if memory and on_card:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    with _Mode():
        out = fn(*args)
    ctr.kernels()
    if memory and on_card:
        torch.cuda.synchronize()
        temp = int(torch.cuda.max_memory_allocated() - base)
    launches = ctr.launches()
    for k, n in launches.items():
        i, o = contract_bytes(cfg, k, contracts)
        ctr.hbm += n * (i + o)
        ctr.out += n * o
    return out, ctr, launches, temp


# lint: host
def kernel_record(name: str, fn, *args, cfg=None,
                  contracts: Optional[dict] = None) -> dict:
    """The dispatch record of one call ``fn(*args)`` (module docstring):
    ``{name, flops, hbm_bytes, output_bytes, cost_available,
    hlo_fingerprint, basis, ops, launches, error?}``.

    ``cfg`` sizes the kernels' contracts (default: the first
    ``SystemConfig`` among ``args``). ``cost_available=False`` (with the
    numbers at ``None``) when ``fn`` raised — ``error`` says why.
    """
    rec = {"name": str(name), "flops": None, "hbm_bytes": None,
           "output_bytes": None, "cost_available": False,
           "hlo_fingerprint": None, "basis": "aten-dispatch",
           "ops": None, "launches": None}
    try:
        _, ctr, launches, _ = dispatch_run(fn, args, cfg, contracts)
    except Exception as e:
        rec["error"] = str(e)
        return rec
    rec.update(flops=float(ctr.flops), hbm_bytes=float(ctr.hbm),
               output_bytes=float(ctr.out), cost_available=True,
               hlo_fingerprint=hlo_fingerprint(ctr.text()),
               ops=int(ctr.ops), launches=launches)
    return rec


# lint: host
def io_contract_record(name: str, input_bytes: float,
                       output_bytes: float,
                       flops: float = 0.0) -> dict:
    """A kernel_record built from a kernel's I/O *contract* instead of
    XLA's cost model.

    For a fused Pallas kernel whose working state is VMEM-resident
    (ops/pallas_round), the HBM bytes a real device moves per launch
    are exactly the kernel's operand + result bytes — XLA's cost model
    cannot see through the ``pallas_call`` custom call (and on non-TPU
    backends attributes the interpreter, not the kernel), so the
    contract IS the honest number. Records carry ``basis:
    "io-contract"`` so reports can label them distinctly from
    ``xla-cost-model`` rows; they are pure arithmetic on static shapes
    and therefore deterministic."""
    return {"name": str(name), "flops": float(flops),
            "hbm_bytes": float(input_bytes) + float(output_bytes),
            "output_bytes": float(output_bytes),
            "cost_available": True, "hlo_fingerprint": None,
            "basis": "io-contract"}


# lint: host
def classify(rec: dict, peaks: dict) -> dict:
    """Fold device peaks into a kernel record: arithmetic intensity,
    attainable ceiling fraction, model step time, and the bound
    verdict.

    - ``arith_intensity`` = flops / HBM bytes (flops per byte).
    - ``bound`` = ``"hbm"`` when AI < ridge point (bandwidth is the
      roof), ``"compute"`` otherwise, ``"cost_unavailable"`` when the
      backend has no cost model.
    - ``ceiling_frac`` = min(1, AI / ridge): the fraction of peak
      compute the roofline permits at this intensity — how far under
      the compute roof the bandwidth roof sits.
    - ``model_time_s`` = max(bytes/bw, flops/peak): the best case for
      one invocation; measured time far above it means dispatch/host
      overhead, not the device (the --timing dispatch check).

    Deterministic: pure arithmetic on the deterministic cost vector.
    """
    out = dict(rec)
    if not rec.get("cost_available"):
        out.update(arith_intensity=None, ceiling_frac=None,
                   model_time_s=None, bound="cost_unavailable")
        return out
    flops = rec["flops"] or 0.0
    hbm = rec["hbm_bytes"] or 0.0
    ridge = peaks["ridge_flops_per_byte"]
    ai = (flops / hbm) if hbm > 0 else float("inf")
    ceiling = min(1.0, ai / ridge) if ridge > 0 else 1.0
    model_t = max(hbm / peaks["hbm_bytes_per_s"],
                  flops / peaks["flops_per_s"])
    out.update(arith_intensity=round(ai, 6),
               ceiling_frac=round(ceiling, 6),
               model_time_s=model_t,
               bound="hbm" if ai < ridge else "compute")
    return out


# lint: host
def cost_vector(per_step: dict, runner: Optional[dict],
                steps: int, retired: int) -> dict:
    """The deterministic cost vector recorded into bench history.

    ``per_step`` is the kernel_record of the engine's one-step kernel
    (cycle / round), ``runner`` the whole quiescence runner (XLA
    counts a while body once, so its cost ≈ one chunk). bytes/instr =
    per-step HBM bytes × steps / retired — exact for a fixed build,
    the number the ``--bytes`` gate compares.
    """
    kernels = {}
    for rec in (per_step, runner):
        if rec is not None:
            kernels[rec["name"]] = {
                "flops": rec["flops"], "hbm_bytes": rec["hbm_bytes"],
                "output_bytes": rec["output_bytes"],
                "cost_available": bool(rec["cost_available"]),
            }
    avail = bool(per_step.get("cost_available")) and retired > 0
    bpi = fpi = None
    if avail:
        bpi = per_step["hbm_bytes"] * steps / retired
        fpi = per_step["flops"] * steps / retired
    return {"per_step_kernel": per_step["name"],
            "steps": int(steps), "retired": int(retired),
            "bytes_per_instr": (round(bpi, 6) if bpi is not None
                                else None),
            "flops_per_instr": (round(fpi, 6) if fpi is not None
                                else None),
            "cost_available": avail,
            "kernels": kernels}


# lint: host
def build_report(engine: str, config: dict, records: list,
                 per_step_name: str, steps: int, retired: int,
                 device_kind: Optional[str] = None,
                 timing: Optional[dict] = None) -> dict:
    """Assemble the ``cache-sim/perfreport/v1`` document.

    ``records`` are kernel_records (the per-step kernel named by
    ``per_step_name`` must be among them); classification, traffic
    totals and the headline bytes/instr are computed here. ``timing``
    (nondeterministic) is attached verbatim only when given — the
    default document is deterministic per build.
    """
    peaks = device_peaks(device_kind)
    kernels = [classify(r, peaks) for r in records]
    for k in kernels:
        k["per_step"] = (k["name"] == per_step_name)
    # HBM traffic ranking: the "which kernel moves the bytes" order
    kernels.sort(key=lambda k: (-(k["hbm_bytes"] or 0.0), k["name"]))
    per_step = next((k for k in kernels if k["name"] == per_step_name),
                    None)
    if per_step is None:
        raise ValueError(f"per-step kernel {per_step_name!r} not in "
                         f"records {[k['name'] for k in kernels]}")
    vec = cost_vector(per_step, None, steps, retired)
    avail = [k for k in kernels if k["cost_available"]]
    top = avail[0] if avail else None
    doc = {
        "schema": SCHEMA_ID,
        "engine": engine,
        "config": dict(config),
        "device": peaks,
        "steps": int(steps),
        "retired": int(retired),
        "cost_available": vec["cost_available"],
        "bytes_per_instr": vec["bytes_per_instr"],
        "flops_per_instr": vec["flops_per_instr"],
        "per_step_kernel": per_step_name,
        "bound": per_step["bound"],
        "top_hbm_kernel": (top["name"] if top else None),
        "kernels": kernels,
    }
    if timing is not None:
        doc["timing"] = timing
    return doc


# lint: host
def timing_section(phases: dict, kernels: list, steps: int,
                   retired: int, rep_times_s: list) -> dict:
    """The opt-in nondeterministic half: ns/instr decomposed by phase
    and (via the roofline model) by kernel.

    ``by_phase`` splits the measured median rep into the PhaseTimer
    buckets (execute dispatch vs device_get sync); ``by_kernel``
    attributes the model's share — per-step model time × steps — so a
    measured/model ratio far above 1 reads as dispatch-bound: the
    device is idle waiting on the host, and no amount of kernel diet
    fixes that (PERF.md's ~0.1 s fixed dispatch tax).
    """
    med = sorted(rep_times_s)[len(rep_times_s) // 2] if rep_times_s \
        else None
    out = {"rep_times_s": [round(t, 6) for t in rep_times_s],
           "ns_per_instr": None, "by_phase": {}, "by_kernel": {},
           "dispatch_bound": None}
    if med is None or retired <= 0:
        return out
    out["ns_per_instr"] = round(med / retired * 1e9, 3)
    ph = (phases or {}).get("phases", {})
    reps = max(1, len(rep_times_s))
    for name in ("execute_dispatch", "device_get_sync"):
        if name in ph:
            out["by_phase"][name] = round(
                ph[name]["seconds"] / reps / retired * 1e9, 3)
    model_total = 0.0
    for k in kernels:
        if k.get("model_time_s") is not None:
            t = k["model_time_s"] * (steps if k.get("per_step") else 1)
            out["by_kernel"][k["name"]] = round(t / retired * 1e9, 3)
            model_total = max(model_total, t)
    if model_total > 0:
        # the dispatch check: measured time >> roofline best case
        # means the host/dispatch path, not the device, is the bound
        out["measured_over_model"] = round(med / model_total, 2)
        out["dispatch_bound"] = bool(med > 10.0 * model_total)
    return out


# lint: host
def transport_section(cfg, n_shards: int,
                      lane_cap: Optional[int] = None) -> dict:
    """Per-transport bytes-on-wire row for the async engine's sharded
    delivery (parallel.rdma_comm.wire_bytes — pure shape arithmetic,
    deterministic per config). NOT a kernel record: the transports move
    interconnect bytes, not HBM bytes, so the row lives beside the
    roofline table instead of inside it (and must never carry an
    io-contract basis — cmd_perfreport's fused lookup keys on that).
    """
    from ue22cs343bb1_openmp_assignment_tpu_torch.parallel import rdma_comm
    per = {t: rdma_comm.wire_bytes(cfg, n_shards, lane_cap, transport=t)
           for t in ("all_to_all", "rdma")}
    L = cfg.num_nodes // n_shards
    return {
        "basis": "wire-shape",
        "n_shards": int(n_shards),
        "lane_cap": int(lane_cap if lane_cap is not None
                        else L * cfg.out_slots),
        "bytes_per_round": per,
        "rdma_strictly_fewer": bool(per["rdma"] < per["all_to_all"]),
        "savings_frac": round(1.0 - per["rdma"] / per["all_to_all"], 4),
    }


_BOUND_TEXT = {"hbm": "HBM-bound", "compute": "compute-bound",
               "cost_unavailable": "cost unavailable"}


# lint: host
def render_text(doc: dict) -> str:
    """The one-screen answer to "where does the 5x go"."""
    dev = doc["device"]
    lines = [
        f"perf-report: {doc['engine']} engine, "
        f"{doc['config'].get('nodes', '?')} nodes "
        f"({dev['kind']}, peaks {dev['flops_per_s']:.3g} flop/s / "
        f"{dev['hbm_bytes_per_s']:.3g} B/s, "
        f"ridge {dev['ridge_flops_per_byte']:.2f} flop/B, "
        f"{dev['source']})",
        f"  steps={doc['steps']} retired={doc['retired']} "
        f"per-step kernel={doc['per_step_kernel']}",
    ]
    if doc["cost_available"]:
        lines.append(
            f"  bytes/instr = {doc['bytes_per_instr']:.2f}   "
            f"flops/instr = {doc['flops_per_instr']:.2f}   "
            f"bound: {_BOUND_TEXT[doc['bound']]}")
        lines.append(
            f"  top HBM-traffic kernel: {doc['top_hbm_kernel']}")
    else:
        lines.append("  cost model unavailable on this backend "
                     "(cost_unavailable); traffic attribution "
                     "degrades to kernel names only")
    lines.append("")
    lines.append(f"  {'kernel':<28} {'flops':>12} {'HBM bytes':>12} "
                 f"{'AI f/B':>8} {'ceil%':>6}  bound")
    for k in doc["kernels"]:
        if k["cost_available"]:
            lines.append(
                f"  {k['name']:<28} {k['flops']:>12.0f} "
                f"{k['hbm_bytes']:>12.0f} "
                f"{k['arith_intensity']:>8.3f} "
                f"{100 * k['ceiling_frac']:>5.1f}%  "
                f"{_BOUND_TEXT[k['bound']]}")
        else:
            why = k.get("error", "cost_unavailable")
            lines.append(f"  {k['name']:<28} -- {why}")
    f = doc.get("fused")
    if f:
        ratio = (f["unfused_bytes_per_instr"] / f["bytes_per_instr"]
                 if f["bytes_per_instr"] else float("inf"))
        lines.append("")
        lines.append(
            f"  fused round ({f['basis']}): bytes/instr = "
            f"{f['bytes_per_instr']:.2f} vs xla-cost-model "
            f"{f['unfused_bytes_per_instr']:.2f} "
            f"({ratio:,.0f}x less HBM traffic)")
    vm = doc.get("vmem")
    if vm:
        lines.append("")
        for r in vm:
            verdict = "fits" if r["ok"] else "OVER BUDGET"
            lines.append(
                f"  vmem[{r['kernel']}] ({r['basis']}): resident "
                f"{(r['resident_in_bytes'] + r['resident_out_bytes']) / 2**20:.2f}"
                f" MiB + headroom {r['headroom_bytes'] / 2**20:.2f} MiB"
                f" = required {r['required_bytes'] / 2**20:.2f} MiB vs "
                f"{r['vmem_bytes'] / 2**20:.0f} MiB VMEM "
                f"({r['device_kind']}): {verdict}")
    ix = doc.get("index")
    if ix:
        planes = ", ".join(f"{p}={v}"
                           for p, v in sorted(ix["by_plane"].items()))
        lines.append("")
        lines.append(
            f"  index pressure ({ix['target']}, static jaxpr audit): "
            f"{ix['index_sites']} sites, "
            f"{ix['indices_per_step']} indices/step"
            + (f", {ix['indices_per_instr']} indices/instr"
               if "indices_per_instr" in ix else ""))
        lines.append(f"    by plane: {planes}")
        if ix.get("merge_candidates"):
            lines.append(
                f"    ~ {ix['merge_candidates']} mergeable-scatter "
                "candidate(s) — run `cache-sim analyze --index` for "
                "the worklist")
    tr = doc.get("transport")
    if tr:
        per = tr["bytes_per_round"]
        verdict = ("rdma moves strictly fewer bytes"
                   if tr["rdma_strictly_fewer"] else
                   "WARNING: rdma does NOT move fewer bytes")
        lines.append("")
        lines.append(
            f"  transport ({tr['basis']}, {tr['n_shards']} shards, "
            f"lane cap {tr['lane_cap']}): bytes on wire per round — "
            f"all_to_all {per['all_to_all']:,} vs rdma {per['rdma']:,} "
            f"({100 * tr['savings_frac']:.1f}% less; {verdict})")
    t = doc.get("timing")
    if t:
        lines.append("")
        lines.append(f"  timing (nondeterministic): ns/instr = "
                     f"{t['ns_per_instr']}")
        for name, v in t["by_phase"].items():
            lines.append(f"    {name:<22} {v:>10} ns/instr")
        for name, v in t["by_kernel"].items():
            lines.append(f"    model:{name:<16} {v:>10} ns/instr")
        if t.get("dispatch_bound") is not None:
            lines.append(
                f"    measured/model = {t.get('measured_over_model')}"
                + ("  => DISPATCH-BOUND (host overhead dominates; "
                   "kernel diet won't move the headline)"
                   if t["dispatch_bound"] else
                   "  (device-bound regime)"))
    return "\n".join(lines) + "\n"
