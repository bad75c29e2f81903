"""Kernel-level profiling: trace capture, cost attribution, and the
timer self-check.

The port of the JAX package's ``obs/profiler.py``. Three instruments,
all host-side:

- :func:`capture` wraps ``torch.profiler`` (CPU activity, and the CUDA
  activity where a card is present) around any engine run and writes a
  Chrome trace into a directory, with the same degrade-gracefully
  guard as the JAX module — a benchmark must never die because its
  profiler did.
- :func:`kernel_cost_report` is the dispatch record
  (``obs.roofline.kernel_record``: aten ops, bytes and the port's
  kernel launches of one call) plus the call's memory sizes, and —
  through ``PhaseTimer.attach("kernels", ...)`` — folds that
  attribution into the same report as the wall-clock phases.
- :func:`timer_self_check` asks whether the block barrier
  (``torch.cuda.synchronize()``; a no-op on the CPU, where a call
  returns finished) is a real barrier: it times the barrier and then
  the ``.item()`` tail of the first output tensor behind it; a fat tail
  means the barrier returned before the work was done and only
  host-read timings are trustworthy.
"""
# lint: host

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager
from typing import Iterator, Optional

#: a host-read tail longer than this (seconds) AND dominating the
#: block barrier marks the barrier untrustworthy — generous against
#: scheduler jitter (the JAX module's constant)
_TAIL_BUDGET_S = 0.025

#: the Chrome trace's file name inside ``capture``'s directory
TRACE_FILE = "trace.json"


# lint: host
@contextmanager
def capture(out_dir: Optional[str],
            quiet: bool = False) -> Iterator[dict]:
    """Guarded ``torch.profiler`` capture into ``out_dir``
    (``trace.json``, a Chrome trace).

    Yields a status dict (``enabled``, and ``error`` when capture
    failed or was disabled; ``trace``, the file written). ``out_dir=
    None`` is a no-op pass-through so call sites don't need their own
    conditional.
    """
    status = {"enabled": False, "out_dir": out_dir, "error": None}
    if not out_dir:
        yield status
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        os.makedirs(out_dir, exist_ok=True)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception as e:  # no CUPTI on the machine, a read-only dir
        status["error"] = str(e)
        if not quiet:
            print(f"warning: profiler capture failed: {e}",
                  file=sys.stderr)
        yield status
        return
    status["enabled"] = True
    try:
        yield status
    finally:
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            path = os.path.join(out_dir, TRACE_FILE)
            prof.export_chrome_trace(path)
            status["trace"] = path
            if not quiet:
                print(f"profiler trace written to {out_dir}",
                      file=sys.stderr)
        except Exception as e:
            status["enabled"] = False
            status["error"] = str(e)
            if not quiet:
                print(f"warning: profiler finalize failed: {e}",
                      file=sys.stderr)


# lint: host
def kernel_cost_report(fn, *args, cfg=None,
                       contracts: Optional[dict] = None) -> dict:
    """Cost attribution of one call ``fn(*args)``, run once on copies
    of its tensors.

    Returns ``{"available", "cost", "memory", "cost_unavailable"}`` as
    the JAX module does, plus the dispatch record's ``basis``, ``ops``,
    ``launches`` and ``hlo_fingerprint``: ``cost`` holds ``flops``,
    ``bytes accessed`` and ``bytes accessedout{}`` (XLA's metric names)
    of the dispatch record; ``memory`` the tensors' sizes
    (``argument_size_in_bytes``, ``output_size_in_bytes``) and, on the
    card, ``temp_size_in_bytes``, the peak device memory the call
    allocated above what was live before it. ``available=False`` with
    ``error`` (never an exception) when the call raised.
    """
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import roofline
    rep = {"available": False, "cost": {}, "memory": {},
           "cost_unavailable": True, "basis": "aten-dispatch"}
    try:
        out, ctr, launches, temp = roofline.dispatch_run(
            fn, args, cfg, contracts, memory=True)
    except Exception as e:
        rep["error"] = str(e)
        return rep
    rep["cost"] = {roofline._FLOPS_KEY: float(ctr.flops),
                   roofline._BYTES_KEY: float(ctr.hbm),
                   roofline._OUT_BYTES_KEY: float(ctr.out)}
    rep["memory"] = {
        "argument_size_in_bytes": sum(
            t.nbytes for t in roofline.tensor_leaves(args)),
        "output_size_in_bytes": sum(
            t.nbytes for t in roofline.tensor_leaves(out))}
    if temp is not None:
        rep["memory"]["temp_size_in_bytes"] = temp
    rep.update(available=True, cost_unavailable=False, ops=int(ctr.ops),
               launches=launches,
               hlo_fingerprint=roofline.hlo_fingerprint(ctr.text()))
    return rep


# lint: host
def attach_kernel_costs(timer, fn, *args, **kwargs) -> dict:
    """kernel_cost_report folded into a PhaseTimer report (under the
    "kernels" key)."""
    rep = kernel_cost_report(fn, *args, **kwargs)
    timer.attach("kernels", rep)
    return rep


# lint: host
def _block(out) -> None:
    """The block barrier: ``torch.cuda.synchronize()`` when the output
    lives on a card; on the CPU a call returns finished (no-op)."""
    import torch

    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import roofline
    if any(t.is_cuda for t in roofline.tensor_leaves(out)):
        torch.cuda.synchronize()


# lint: host
def _scalar_sync(out) -> float:
    """The real barrier: materialize one scalar on the host. Unlike the
    block barrier this cannot return before the bytes exist."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import roofline
    leaves = [t for t in roofline.tensor_leaves(out) if t.numel()]
    if not leaves:
        return 0.0
    return float(leaves[0].reshape(-1)[0].item())


# lint: host
def timer_self_check(fn, *args, reps: int = 3) -> dict:
    """Is the block barrier a real barrier here?

    Runs ``fn(*args)`` ``reps`` times (after one warmup), timing per
    run: dispatch (call returns), block (``torch.cuda.synchronize()``
    returns), then the host-read tail (first scalar materialized on the
    host). If the barrier is honest the tail is bounded by host copy
    cost; if it lies, the computation finishes inside the tail and the
    tail dominates.

    Returns medians plus ``barrier_trustworthy`` — when False, only
    host-read-synced timings from this environment should be believed.
    The keys and verdict strings are the JAX module's.
    """
    _scalar_sync(fn(*args))  # warmup: build and cache outside the clock
    dispatch, block, tail = [], [], []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        out = fn(*args)
        t1 = time.perf_counter()
        _block(out)
        t2 = time.perf_counter()
        _scalar_sync(out)
        t3 = time.perf_counter()
        dispatch.append(t1 - t0)
        block.append(t2 - t1)
        tail.append(t3 - t2)
    med = (lambda xs: sorted(xs)[len(xs) // 2])
    d_med, b_med, t_med = med(dispatch), med(block), med(tail)
    trustworthy = t_med <= max(_TAIL_BUDGET_S, 0.25 * b_med)
    return {
        "reps": max(1, reps),
        "dispatch_s": round(d_med, 6),
        "block_until_ready_s": round(b_med, 6),
        "device_get_tail_s": round(t_med, 6),
        "barrier_trustworthy": trustworthy,
        "verdict": ("block_until_ready is a real barrier here"
                    if trustworthy else
                    "block_until_ready LIES on this link: the run "
                    "completes inside the device_get tail; trust only "
                    "device_get-synced timings (PERF.md)"),
    }
