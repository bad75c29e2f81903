"""The port's copy of ``obs/schema.py`` against the JAX package's.

For the same counter dicts the adapters of both copies return equal
reports, and ``validate`` accepts and refuses the same documents with
the same messages: the current v1.2 reports, v1 and v1.1 documents,
and mutants of each kind the validator knows.
"""

import copy

import numpy as np
import pytest

from ue22cs343bb1_openmp_assignment_tpu.obs import schema as jschema
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import schema
from ue22cs343bb1_openmp_assignment_tpu_torch.state import (
    LAT_BUCKETS, SIM_METRIC_FIELDS)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
from ue22cs343bb1_openmp_assignment_tpu_torch.types import MSG_NAMES

RNG = np.random.default_rng(11)


def _async_metrics():
    m = {f: int(RNG.integers(0, 1000)) for f in SIM_METRIC_FIELDS}
    m["msgs_processed"] = RNG.integers(0, 50, len(MSG_NAMES)).tolist()
    m["lat_hist"] = RNG.integers(0, 9, LAT_BUCKETS).tolist()
    return m


def _sync_metrics():
    return {f: int(RNG.integers(0, 1000)) for f in se.METRIC_FIELDS}


def _native_metrics():
    return {k: int(RNG.integers(0, 1000)) for k in (
        "cycles", "instrs_retired", "read_hits", "write_hits",
        "read_misses", "write_misses", "upgrades", "msgs_dropped",
        "invalidations", "evictions")}


def _docs():
    docs = []
    for _ in range(3):
        docs += [schema.from_async(_async_metrics()),
                 schema.from_async(_async_metrics(), "routed"),
                 schema.from_sync(_sync_metrics()),
                 schema.from_sync(_sync_metrics(), "deep"),
                 schema.from_native(_native_metrics())]
    return docs


def test_adapters_equal_the_jax_package():
    for _ in range(5):
        a, s, n = _async_metrics(), _sync_metrics(), _native_metrics()
        assert schema.from_async(a) == jschema.from_async(a)
        assert schema.from_sync(s, "deep") == jschema.from_sync(s, "deep")
        assert schema.from_native(n) == jschema.from_native(n)
        doc = schema.from_async(a)
        assert (schema.coverage_signature(doc, {"U": 3})
                == jschema.coverage_signature(doc, {"U": 3}))
    assert schema.latency_histogram([0, 2, 1]) == (
        jschema.latency_histogram([0, 2, 1]))
    for name in ("SCHEMA_ID", "SCHEMA_V1", "SCHEMA_V1_1", "CORE_COUNTERS"):
        assert getattr(schema, name) == getattr(jschema, name)


def _mutants(doc):
    """Documents the validator must refuse (or, for the older schema
    ids, accept), one change each."""
    out = []

    def edit(fn):
        d = copy.deepcopy(doc)
        fn(d)
        out.append(d)
    edit(lambda d: d.pop("mb_dropped"))
    edit(lambda d: d.update(mb_dropped=-1))
    edit(lambda d: d.update(schema="cache-sim/metrics/v9"))
    edit(lambda d: d.update(schema=schema.SCHEMA_V1))
    edit(lambda d: (d.update(schema=schema.SCHEMA_V1), d.pop("mb_dropped")))
    edit(lambda d: (d.update(schema=schema.SCHEMA_V1_1),
                    d.pop("mb_dropped")))
    edit(lambda d: d.update(txn_latency={"spans": 2, "open": 0,
                                         "by_type": {}, "segments_total":
                                         {"queue": 3}}))
    edit(lambda d: d.update(txn_latency={"spans": -1, "by_type": []}))
    edit(lambda d: d.update(bogus=1))
    edit(lambda d: d.update(engine=3, step_unit="ticks"))
    edit(lambda d: d.update(steps=True, instrs_retired=-2))
    edit(lambda d: d.update(messages=[]))
    edit(lambda d: d["messages"].pop("by_type"))
    edit(lambda d: d["messages"].update(processed_total=-1))
    edit(lambda d: d["messages"].update(by_type={"X": 1},
                                        processed_total=2))
    edit(lambda d: d.update(queue_depth_peak=-3))
    edit(lambda d: d.update(latency_cycles={"bucket_lo": [2, 1],
                                            "counts": [0, 0]}))
    edit(lambda d: d.update(latency_cycles={"counts": []}))
    edit(lambda d: d.update(extra=None))
    return out


@pytest.mark.parametrize("doc", _docs() + ["not a dict"])
def test_validate_accepts_and_refuses_alike(doc):
    for d in ([doc] + _mutants(doc) if isinstance(doc, dict) else [doc]):
        verdicts = []
        for mod in (jschema, schema):
            try:
                mod.validate(copy.deepcopy(d))
                verdicts.append("ok")
            except ValueError as e:
                verdicts.append(str(e))
        assert verdicts[1] == verdicts[0], d
    if isinstance(doc, dict):
        assert schema.validate(doc) is doc
