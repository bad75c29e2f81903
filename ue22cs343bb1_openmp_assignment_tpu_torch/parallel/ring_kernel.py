"""The routed transport's lane exchange as a CUDA kernel for Hopper, and
its wrapper.

``csrc/ring_exchange.cu`` replaces the JAX package's Pallas kernel
``parallel/rdma_comm.py:_ring_exchange``: D shards' outbox lanes, each
shard's ``[D, cap, W]`` int32, become their inbox lanes with
``inbox[d][s] = outbox[s][d]``. One launch copies every lane.

Two forms:

- ``exchange(ob)``: the D shards are virtual shards in one device's
  memory, stacked as ``ob [D, D, cap, W]`` (sender, lane); returns the
  stacked inboxes. This is what the routed delivery runs each cycle.
- ``exchange_across(obs)``: one shard per card (``obs[s]`` on card s),
  peer access on; one launch per sender on its own card stores into the
  receivers' inboxes through their pointers. Every sender's stream waits
  for the receivers' allocations, and every receiver's stream waits on
  every sender's event before the inbox is used.

For CUDA tensors each wrapper launches the kernel on the current stream
or raises (``check_operand``, a non-zero CUDA error); it never gives way
to the plain version. For CPU tensors it runs ``plain_exchange`` /
``plain_exchange_across``, the plain versions beside it, and
``impl="plain"`` forces them anywhere. ``exchange.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.ops import kernel_build

_KERNEL = "ring exchange kernel"
#: the most shards one launch takes (its pointer tables are kernel
#: parameters)
MAX_SHARDS = 8


def _defines(_cfg=None) -> tuple:
    return (("RING_MAX_D", MAX_SHARDS),)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ring_exchange.argtypes = [p, p, i, i, i, ctypes.c_longlong, i, p]
    lib.ring_exchange.restype = i
    lib.ring_enable_peer.argtypes = [i, i]
    lib.ring_enable_peer.restype = i


#: one library serves every (D, cap, W): shapes are run-time arguments
LIBRARY = kernel_build.Library("ring_exchange", "ring_exchange.cu", (),
                               _defines, _bind,
                               {r"ring_exchange_kernel": "ring_exchange"})


def io_contract_bytes(D: int, cap: int, width: int) -> tuple:
    """(input_bytes, output_bytes) of one exchange: every outbox word
    read once, every inbox word written once."""
    n = 4 * D * D * cap * width
    return n, n


def plain_exchange(ob: torch.Tensor) -> torch.Tensor:
    """The exchange in plain PyTorch: swap the sender and lane axes of
    the stacked ``[D, D, ...]`` lanes."""
    return ob.transpose(0, 1).contiguous()


def plain_exchange_across(obs) -> list:
    """The exchange across devices in plain PyTorch: one ``copy_`` per
    (sender, receiver) pair."""
    D = len(obs)
    ibs = [torch.empty_like(obs[d]) for d in range(D)]
    for s in range(D):
        for d in range(D):
            ibs[d][s].copy_(obs[s][d])
    return ibs


def _pointer_table(tensors) -> ctypes.Array:
    table = (ctypes.c_void_p * MAX_SHARDS)()
    for i, t in enumerate(tensors):
        table[i] = t.data_ptr()
    return table


def _check_shards(D: int) -> None:
    if not 1 <= D <= MAX_SHARDS:
        raise ValueError(f"{_KERNEL}: {D} shards; one launch takes 1 to "
                         f"{MAX_SHARDS}")


# lint: host
def _launch(lib, obs, ibs, s_first: int, s_count: int, lane_words: int,
            dev: torch.device) -> None:
    err = lib.ring_exchange(
        _pointer_table(obs), _pointer_table(ibs), ctypes.c_int(len(ibs)),
        ctypes.c_int(s_first), ctypes.c_int(s_count),
        ctypes.c_longlong(lane_words), ctypes.c_int(dev.index),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: CUDA error {err}")
    exchange.launches += 1


def exchange(ob: torch.Tensor, impl: str = "kernel") -> torch.Tensor:
    """Stacked lanes ``ob [D, D, cap, W]`` int32 (sender, lane) of D
    virtual shards on one device -> their inboxes ``[D, D, cap, W]``
    (receiver, lane = sender). The kernel for a CUDA tensor, the plain
    version for a CPU tensor or ``impl="plain"``."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', not {impl!r}")
    if impl == "plain" or not ob.is_cuda:
        return plain_exchange(ob)
    D = ob.shape[0]
    _check_shards(D)
    if ob.dim() != 4:
        raise ValueError(f"{_KERNEL}: lanes must be [D, D, cap, W], got "
                         f"{tuple(ob.shape)}")
    kernel_build.check_operand(_KERNEL, "outboxes", ob,
                               (D, D) + tuple(ob.shape[2:]), ob.device)
    ib = torch.empty_like(ob)
    _launch(LIBRARY.load(None), list(ob.unbind(0)), list(ib.unbind(0)), 0,
            D, ob.shape[2] * ob.shape[3], ob.device)
    return ib


exchange.launches = 0


# lint: host
def enable_peer_access(devices) -> None:
    """Let every card of ``devices`` store into every other's memory;
    raises if a pair cannot."""
    lib = LIBRARY.load(None)
    for a in devices:
        for b in devices:
            if a != b:
                err = lib.ring_enable_peer(a.index, b.index)
                if err != 0:
                    raise RuntimeError(
                        f"{_KERNEL}: peer access {a} -> {b} failed: CUDA "
                        f"error {err}")


def exchange_across(obs, impl: str = "kernel") -> list:
    """One shard per device: ``obs[s]`` is shard s's ``[D, cap, W]``
    outbox on its own device; returns the inboxes, ``ibs[d]`` on shard
    d's device. One launch per sender (the kernel) or per-pair copies
    (the plain version, for CPU tensors or ``impl="plain"``)."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', not {impl!r}")
    if impl == "plain" or not obs[0].is_cuda:
        return plain_exchange_across(obs)
    D = len(obs)
    _check_shards(D)
    devs = [o.device for o in obs]
    if len(set(devs)) != D or any(d.type != "cuda" for d in devs):
        raise ValueError(f"{_KERNEL}: exchange_across takes one CUDA "
                         f"device per shard, got {devs}")
    shape = tuple(obs[0].shape)
    if len(shape) != 3 or shape[0] != D:
        raise ValueError(f"{_KERNEL}: outboxes must be [D, cap, W], got "
                         f"{shape}")
    for s, o in enumerate(obs):
        kernel_build.check_operand(_KERNEL, f"outbox {s}", o, shape,
                                   devs[s])
    lib = LIBRARY.load(None)
    enable_peer_access(devs)
    ibs = [torch.empty(shape, dtype=torch.int32, device=d) for d in devs]
    streams = [torch.cuda.current_stream(d) for d in devs]
    ready = [torch.cuda.Event() for _ in devs]
    for r, st in enumerate(streams):
        ready[r].record(st)                 # the inbox is free to write
    sent = []
    for s in range(D):
        for r in range(D):
            streams[s].wait_event(ready[r])
        _launch(lib, obs, ibs, s, 1, shape[1] * shape[2], devs[s])
        ev = torch.cuda.Event()
        ev.record(streams[s])
        sent.append(ev)
    # every later use (and the free) of an inbox is ordered on its own
    # device's stream, after every sender's writes
    for r in range(D):
        for ev in sent:
            streams[r].wait_event(ev)
    return ibs
