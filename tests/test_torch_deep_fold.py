"""The port's plain folds equal the JAX package's, mode by mode.

``deep_fold_kernel.fold_pre``/``fold_flags``/``fold_replay`` take the
plain PyTorch fold for CPU tensors (the CUDA kernel is held to it on the
card by chip_smoke.py and tests/test_torch_cuda.py). Here they are held
against JAX ``deep_engine._fold_deep``, which tests/test_pallas_deep.py
pins equal to the Pallas kernels, on mid-run inputs: a state a few
rounds into a run, and the own-lane codes and slot verdicts that the
round middle hands the later folds. Exact comparison of every output.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ue22cs343bb1_openmp_assignment_tpu.ops import deep_engine as jde
from ue22cs343bb1_openmp_assignment_tpu_torch import convert
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    deep_fold_kernel as dfk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as tse

from chip_smoke import fold_inputs
from tests.torch_parity import BENCH_DEEP, cfg_pair, jax_state

MODES = ("pre", "flags", "replay")


@functools.lru_cache(maxsize=None)
def _jax_fold(jcfg):
    """JAX _fold_deep, jitted once per config: the pre-pass and the
    flag pass are the replay fold with zero verdicts / zero codes,
    which is exactly how _fold_deep fills bad=None / ocode=None."""
    def f(hor, ca, cv, cs, d0, d1, d2, d3, w_oa, w_val, w_live, bad,
          ocode):
        st = types.SimpleNamespace(horizon=hor)
        return jde._fold_deep(jcfg, st, (ca, cv, cs, (d0, d1, d2, d3)),
                              w_oa, w_val, w_live, bad=bad, ocode=ocode)
    return jax.jit(f)


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _mid_run_inputs(num_nodes, rounds, seed, **kw):
    """Fold inputs a few rounds into a port run (plain folds, CPU); the
    state crosses to the JAX side through convert.to_numpy."""
    jcfg, tcfg = cfg_pair(num_nodes, **kw)
    st = tse.procedural_state(tcfg, 4096, seed=seed, device="cpu")
    st = tse.run_rounds(tcfg, st, rounds)
    # the same state rebuilt from its numpy leaves (the carry path)
    st = convert.from_numpy(tcfg, convert.to_numpy(st), device="cpu")
    return jcfg, tcfg, fold_inputs(tcfg, st)


def _check_mode(jcfg, mode, args):
    cfg, st, tiles, w_oa, w_val, w_live, *extra = args
    ca, cv, cs, dm4 = tiles
    N, Q, S = cfg.num_nodes, cfg.deep_slots, 1 << cfg.block_bits
    bad = extra[0] if mode == "replay" else np.zeros((Q, N), np.int32)
    ocode = extra[-1] if mode != "pre" else np.zeros((S, N), np.int32)
    tensors = [st.horizon, ca, cv, cs, *dm4, w_oa, w_val, w_live, bad,
               ocode]
    fin = _jax_fold(jcfg)(*[jnp.asarray(np.asarray(t)) for t in tensors])
    got = _flat(dfk.WRAPPERS[mode](*args))
    want = _flat(fin)
    assert got, mode
    for name, t in got.items():
        np.testing.assert_array_equal(
            np.asarray(want[name]), t.numpy(), err_msg=f"{mode}.{name}")
    return got


@pytest.mark.parametrize("num_nodes,rounds,seed,kw", [
    (16, 6, 0, {}),
    (64, 5, 1, dict(proc_local_permille=500)),
    (16, 6, 2, dict(deep_waves=3, deep_read_storm=True,
                    proc_local_permille=300)),
], ids=["n16-bench", "n64-local50", "n16-waves3-storm"])
def test_plain_folds_match_jax(num_nodes, rounds, seed, kw):
    jcfg, tcfg, args = _mid_run_inputs(num_nodes, rounds, seed,
                                       **dict(BENCH_DEEP, **kw))
    outs = {mode: _check_mode(jcfg, mode, args[mode]) for mode in MODES}
    # the inputs exercise the truncation paths, not only the trivial fold
    assert int(args["replay"][6].sum()) > 0, "no bad slot verdicts"
    assert int(args["flags"][6].sum()) > 0, "no own-lane codes"
    assert int(outs["replay"]["n_ret"].sum()) > 0
    dfk.reset_launch_counts()


def test_wrappers_take_the_plain_fold_only_on_cpu():
    _, tcfg, args = _mid_run_inputs(16, 2, 0, **BENCH_DEEP)
    dfk.reset_launch_counts()
    for mode in MODES:
        dfk.WRAPPERS[mode](*args[mode])
        with pytest.raises(ValueError, match="not CUDA"):
            dfk.launch(mode, *args[mode])
    assert dfk.launch_counts() == {m: 0 for m in MODES}


def test_kernel_io_contract():
    _, tcfg = cfg_pair(4096, **BENCH_DEEP)
    assert dfk.io_rows(tcfg, "pre") == (125, [9, 16])
    assert dfk.io_rows(tcfg, "replay") == (144, [28, 112, 12, 2, 7])
    defs = dict(dfk.defines(tcfg))
    assert defs == dict(DF_C=4, DF_S=16, DF_BLOCK_BITS=4, DF_Q=3, DF_G=1,
                        DF_W=16, DF_WAVES1=1, DF_STORM=0)
    _, big = cfg_pair(64, **dict(BENCH_DEEP, deep_slots=40))
    with pytest.raises(ValueError, match="32-bit masks"):
        dfk.defines(big)


@pytest.mark.slow
def test_plain_folds_match_pallas_interpret():
    """One tiny-window case against the Pallas kernels themselves
    (ops/pallas_deep in interpret mode on the CPU)."""
    from ue22cs343bb1_openmp_assignment_tpu.ops import pallas_deep
    kw = dict(BENCH_DEEP, drain_depth=2, txn_width=2, deep_slots=4,
              deep_ownerval_slots=2, proc_local_permille=500)
    jcfg, tcfg, args = _mid_run_inputs(8, 6, 4, **kw)
    cfg, st, tiles, w_oa, w_val, w_live = args["replay"][:6]
    bad, ocode = args["replay"][6:]
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    jst = jax_state(convert.to_numpy(st))
    jtiles = (j(tiles[0]), j(tiles[1]), j(tiles[2]),
              tuple(j(t) for t in tiles[3]))
    jwin = (j(w_oa), j(w_val), j(w_live))
    want = {
        "pre": pallas_deep.fold_pre(jcfg, jst, jtiles, *jwin),
        "flags": pallas_deep.fold_flags(jcfg, jst, jtiles, *jwin,
                                        j(ocode)),
        "replay": pallas_deep.fold_replay(jcfg, jst, jtiles, *jwin,
                                          j(bad), j(ocode)),
    }
    for mode in MODES:
        got = _flat(dfk.WRAPPERS[mode](*args[mode]))
        w = _flat(want[mode])
        for name, t in got.items():
            np.testing.assert_array_equal(np.asarray(w[name]), t.numpy(),
                                          err_msg=f"{mode}.{name}")
