"""The threefry2x32 block of the jax.random twin as a CUDA kernel for
Hopper, and its wrapper.

``csrc/threefry.cu`` ciphers the counters 0 .. n - 1 under a [2] key that
lies on the card, one thread a counter, and writes the 32-bit draws
``y0 ^ y1`` (``utils.random.random_bits``) or both words (the keys of
``utils.random.split``). It is no TPU kernel's port: on a TPU the JAX
package's draws lower to XLA's threefry2x32.

``block(key, n, pair)`` launches the kernel for a CUDA key, on the
current stream, or raises (``check_operand``, a non-zero CUDA error); it
never gives way to the plain version. For a CPU key it runs
``utils.random.plain_block``. ``block.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.ops import kernel_build
from ue22cs343bb1_openmp_assignment_tpu_torch.utils import random as _random

_KERNEL = "threefry kernel"


def _defines(_cfg=None) -> tuple:
    return ()


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.threefry.argtypes = [p, p, ll, i, i, p]
    lib.threefry.restype = i
    lib.threefry_grid.argtypes = [ll]
    lib.threefry_grid.restype = i


#: one library serves every key, count and mode (all run-time arguments)
LIBRARY = kernel_build.Library(
    "threefry", "threefry.cu", (), _defines, _bind,
    {r"threefry_kernelILb0E": "threefry", r"threefry_kernelILb1E":
     "threefry_pair"})


def io_contract_bytes(n: int, pair: bool = False) -> tuple:
    """(input_bytes, output_bytes) of one block: the key read once, each
    counter's word (or pair) written once."""
    return 8, 4 * n * (2 if pair else 1)


def block(key: torch.Tensor, n: int, pair: bool = False) -> torch.Tensor:
    """The cipher of counters 0 .. n - 1 under ``key`` ([2] int32 bit
    patterns): the draws [n], or with ``pair`` the words [n, 2], as
    int32 bit patterns on the key's device. The kernel for a CUDA key,
    the plain version for a CPU key."""
    n = int(n)
    if not key.is_cuda:
        return _random.plain_block(key, n, pair)
    kernel_build.check_operand(_KERNEL, "key", key, (2,), key.device)
    out = torch.empty((n, 2) if pair else (n,), dtype=torch.int32,
                      device=key.device)
    if n == 0:
        return out
    err = LIBRARY.load(None).threefry(
        ctypes.c_void_p(key.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_longlong(n), ctypes.c_int(int(pair)),
        ctypes.c_int(key.device.index),
        ctypes.c_void_p(torch.cuda.current_stream(key.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: CUDA error {err}")
    block.launches += 1
    return out


block.launches = 0
