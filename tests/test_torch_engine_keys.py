"""Row keys of the port's engine equal the JAX package's bit for bit: the
same canonical encoding and the same XXH64, without ``xxhash``. The cross-
package parity tests compare tables by row id, so every key path is held
here: ``hash_values`` / ``ref_scalar`` on scalars, the C++ column loop and
its Python path, and the XXH64 digest in its C++ and Python forms."""

import datetime
import os

import numpy as np
import pytest
import xxhash
from hypothesis import given, settings
from hypothesis import strategies as st

from pathway_tpu.engine import value as JV
from pathway_tpu.internals.json import Json as JJson
from pathway_tpu_torch import native
from pathway_tpu_torch.engine import value as TV
from pathway_tpu_torch.engine.xxh64 import xxh64_intdigest
from pathway_tpu_torch.internals.json import Json as TJson

# a neutral description of a value, materialized per package (Pointer and
# Json are each package's own classes)
_leaf = st.one_of(
    st.none(),
    st.booleans(),
    st.integers(min_value=-(2**70), max_value=2**70),
    st.floats(allow_nan=False),
    st.text(max_size=12),
    st.binary(max_size=12),
    st.integers(min_value=0, max_value=2**64 - 1).map(lambda v: ("ptr", v)),
    st.dictionaries(st.text(max_size=4), st.integers(-5, 5), max_size=3).map(
        lambda d: ("json", d)),
    st.integers(-(2**63), 2**63 - 1).map(lambda v: ("np", np.int64(v))),
    st.floats(allow_nan=False, width=32).map(lambda v: ("np", np.float32(v))),
    st.booleans().map(lambda v: ("np", np.bool_(v))),
    st.lists(st.integers(-100, 100), max_size=6).map(
        lambda v: ("np", np.array(v, dtype=np.int64))),
    st.lists(st.floats(allow_nan=False, width=32), max_size=6).map(
        lambda v: ("np", np.array(v, dtype=np.float32))),
)
_value = st.recursive(_leaf, lambda inner: st.lists(inner, max_size=3).map(
    lambda xs: ("tuple", xs)), max_leaves=8)


def _make(desc, pkg):
    if isinstance(desc, tuple) and len(desc) == 2 and isinstance(desc[0], str):
        kind, v = desc
        if kind == "ptr":
            return (TV if pkg == "torch" else JV).Pointer(v)
        if kind == "json":
            return (TJson if pkg == "torch" else JJson)(v)
        if kind == "np":
            return v
        if kind == "tuple":
            return tuple(_make(x, pkg) for x in v)
    return desc


@settings(max_examples=200, deadline=None)
@given(st.lists(_value, min_size=1, max_size=4))
def test_hash_values_and_ref_scalar_equal_jax(descs):
    t_vals = [_make(d, "torch") for d in descs]
    j_vals = [_make(d, "jax") for d in descs]
    assert TV.hash_values(*t_vals) == JV.hash_values(*j_vals)
    assert TV.ref_scalar(*t_vals).value == JV.ref_scalar(*j_vals).value
    inst_t, inst_j = t_vals[0], j_vals[0]
    assert (TV.ref_scalar_with_instance(*t_vals, instance=inst_t).value
            == JV.ref_scalar_with_instance(*j_vals, instance=inst_j).value)


@settings(max_examples=60, deadline=None)
@given(st.lists(_value, min_size=1, max_size=24))
def test_column_loop_and_python_path_equal_jax(descs):
    def col(pkg):
        c = np.empty(len(descs), dtype=object)
        c[:] = [_make(d, pkg) for d in descs]
        return c

    t, j = col("torch"), col("jax")
    want = JV.hash_value_column(j)
    np.testing.assert_array_equal(TV.hash_value_column(t), want)
    np.testing.assert_array_equal(TV.hash_value_column(t, native=False), want)
    np.testing.assert_array_equal(
        TV.keys_for_value_columns([t, t[::-1].copy()], len(t)),
        JV.keys_for_value_columns([j, j[::-1].copy()], len(j)))


def test_datetime_keys_equal_jax():
    import pandas as pd

    from pathway_tpu.internals import datetime_types as JDT
    from pathway_tpu_torch.internals import datetime_types as TDT

    naive = datetime.datetime(2024, 1, 2, 3, 4, 5, 6789)
    aware = naive.replace(tzinfo=datetime.timezone.utc)
    cases = [
        (naive, naive), (aware, aware),
        (pd.Timestamp("2020-02-29 12:00:00.123456789"),) * 2,
        (pd.Timedelta(seconds=3, nanoseconds=7),) * 2,
        (TDT.DateTimeNaive("2021-05-06 07:08:09"), JDT.DateTimeNaive("2021-05-06 07:08:09")),
        (TDT.DateTimeUtc("2021-05-06 07:08:09+00:00"),
         JDT.DateTimeUtc("2021-05-06 07:08:09+00:00")),
        (TDT.Duration(minutes=5), JDT.Duration(minutes=5)),
    ]
    for t, j in cases:
        assert TV.hash_values(t) == JV.hash_values(j), t
    # the pandas-free encoding of a plain datetime is pandas' own
    assert TV._datetime_ns(naive) == pd.Timestamp(naive).value
    assert TV._datetime_ns(aware) == pd.Timestamp(aware).value


@pytest.mark.parametrize("seed", range(3))
def test_xxh64_cpp_and_python_equal_xxhash(seed):
    rng = np.random.default_rng(seed)
    for n in list(range(0, 70)) + [int(x) for x in rng.integers(70, 5000, 20)]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        s = int(rng.integers(0, 2**63))
        want = xxhash.xxh64_intdigest(data)
        assert native.xxh64(data) == want
        assert xxh64_intdigest(data) == want
        assert native.xxh64(data, s) == xxh64_intdigest(data, s) == \
            xxhash.xxh64_intdigest(data, seed=s)
    data = os.urandom(257)
    assert xxh64_intdigest(data) == xxhash.xxh64_intdigest(data)


def test_engine_loops_build_from_the_ports_source():
    """The engine's C++ loops build from the port's own source, name only
    the loops the engine calls, and the Python key path imports no
    ``xxhash``."""
    import re

    text = native._ENGINE_SRC.read_text()
    table = text[text.index("static PyMethodDef methods[]"):]
    assert sorted(set(re.findall(r'\{"(\w+)", py_', table))) == [
        "batch_rows_split", "consolidate_pairs", "csv_cols", "hash_object_column",
        "join_apply_side", "join_ld_cross", "jsonl_rows", "rows_from_records",
        "set_pointer_type", "split_lines", "xxh64_digest"]
    path = native.build(native._ENGINE_SRC)
    assert path.parent == native.BUILD_DIR and path.name.startswith("_engine-")
    assert "xxhash" not in TV.__dict__


def test_from_rows_and_record_parsing_equal_jax():
    """The row transpose and the connectors' record extraction (record
    dicts and JSON lines) give JAX's rows."""
    import pathway_tpu as JPW
    import pathway_tpu_torch as TPW
    from pathway_tpu.engine.batch import Batch as JBatch
    from pathway_tpu.io import _utils as JU
    from pathway_tpu_torch.engine.batch import Batch as TBatch
    from pathway_tpu_torch.io import _utils as TU

    rows = [(i * 7919, (f"s{i}", i, None if i % 3 else 1.5), 1 - 2 * (i % 2))
            for i in range(20)]
    tb, jb = TBatch.from_rows(["a", "b", "c"], rows), JBatch.from_rows(["a", "b", "c"], rows)
    np.testing.assert_array_equal(tb.keys, jb.keys)
    np.testing.assert_array_equal(tb.diffs, jb.diffs)
    for c in "abc":
        assert tb.cols[c].tolist() == jb.cols[c].tolist()

    lines = [b'{"id": 1, "text": "a b", "w": 2.5}', b'{"id": 2, "text": "c"}',
             b"not json", b'{"id": "3", "text": "x\\ny", "w": 1}', b"[1, 2]",
             b'{"id": 4, "text": "d", "w": 7}']
    out = {}
    for name, pw, U in (("torch", TPW, TU), ("jax", JPW, JU)):
        class S(pw.Schema):
            id: int
            text: str
            w: float = pw.column_definition(default_value=0.0)

        cols = list(S.column_names())
        dtypes = {n: c.dtype for n, c in S.__columns__.items()}
        out[name] = (U.batch_parse_stream_records(lines, "json", S, cols, dtypes),
                     U.rows_from_bytes(b"\n".join(lines) + b"\n", "jsonlines", S))
    assert out["torch"] == out["jax"]
    assert out["torch"][0][2] is None and len(out["torch"][1]) == 4
