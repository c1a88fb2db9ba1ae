"""Shared connector plumbing: schema→row conversion, value parsing.

Reference parity: ``python/pathway/io/_utils.py`` + the parser layer of
``src/connectors/data_format.rs`` (DsvParser, JsonLinesParser,
IdentityParser). The record -> row extraction, the CSV parser and the line
splitter run in the port's C++ engine loops (``native/_engine.cpp``); a
failed build raises. ``native=False`` runs the Python parsers instead
(the tests' reference: the same values, slower).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Callable

from pathway_tpu_torch.engine.value import hash_values
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.json import Json

OnChangeCallback = Callable
OnFinishCallback = Callable


@dataclass
class CsvParserSettings:
    delimiter: str = ","
    quote: str = '"'
    escape: str | None = None
    enable_double_quote_escapes: bool = True
    enable_quoting: bool = True
    comment_character: str | None = None


_ABSENT = object()


def parse_record_fields(record: dict, cols: list[str],
                        dtypes: dict[str, Any], schema) -> dict:
    """Parse one record into column values with schema-default semantics
    shared by every schema-driven connector: an ABSENT field takes the
    column's default_value (when it has one); an explicit null stays None."""
    defaults = schema.default_values()
    out = {}
    for c in cols:
        raw = record.get(c, _ABSENT)
        if raw is _ABSENT and c in defaults:
            out[c] = defaults[c]
        else:
            out[c] = parse_value(None if raw is _ABSENT else raw, dtypes[c])
    return out


def parse_value(raw: Any, dtype: dt.DType):
    """Parse a raw (string or json) value into the dtype's representation."""
    if raw is None:
        return None
    target = dtype.strip_optional()
    try:
        if target is dt.INT:
            return int(raw)
        if target is dt.FLOAT:
            return float(raw)
        if target is dt.BOOL:
            if isinstance(raw, bool):
                return raw
            return str(raw).strip().lower() in ("1", "true", "yes", "on")
        if target is dt.STR:
            return str(raw)
        if target is dt.BYTES:
            if isinstance(raw, bytes):
                return raw
            return str(raw).encode("utf-8")
        if target is dt.JSON:
            if isinstance(raw, Json):
                return raw
            if isinstance(raw, str):
                return Json(json.loads(raw))
            return Json(raw)
        if target is dt.DATE_TIME_NAIVE or target is dt.DATE_TIME_UTC:
            import pandas as pd

            ts = pd.Timestamp(raw)
            from pathway_tpu_torch.internals.datetime_types import DateTimeNaive, DateTimeUtc

            return DateTimeUtc(ts) if ts.tzinfo is not None else DateTimeNaive(ts)
        if isinstance(target, (dt.List, dt.Tuple)):
            if isinstance(raw, str):
                raw = json.loads(raw)
            return tuple(raw)
        if isinstance(target, dt.Array):
            import numpy as np

            if isinstance(raw, str):
                raw = json.loads(raw)
            return np.asarray(raw)
    except (ValueError, TypeError, json.JSONDecodeError):
        from pathway_tpu_torch.engine.value import ERROR

        return ERROR
    return raw


def row_key(schema, values: dict, fallback) -> int:
    pk = schema.primary_key_columns()
    if pk:
        return hash_values(*[values[c] for c in pk])
    return hash_values(fallback)


def format_value_for_output(v) -> Any:
    import sys

    import numpy as np

    from pathway_tpu_torch.engine.value import ERROR, Pointer

    # pandas values exist only once pandas is loaded: never import it here
    pd = sys.modules.get("pandas")

    if v is ERROR:
        return "Error"
    if isinstance(v, Pointer):
        return repr(v)
    if isinstance(v, Json):
        return json.loads(str(v))
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, tuple):
        return [format_value_for_output(x) for x in v]
    if pd is not None and isinstance(v, pd.Timestamp):
        return v.isoformat()
    if pd is not None and isinstance(v, pd.Timedelta):
        return v.value
    return v


def parse_stream_record(value: bytes, fmt: str, schema, cols, dtypes):
    """One streamed record (kafka message / http line) -> values dict, or
    None for undecodable json. THE shared parse for stream connectors so
    raw/json semantics cannot drift between them: 'raw' keeps bytes
    untouched."""
    if fmt == "raw":
        return {"data": value}
    try:
        obj = json.loads(value)
    except json.JSONDecodeError:
        return None
    if not isinstance(obj, dict):
        # valid JSON but not a record (null / number / array): skipping is
        # the only safe option — crashing would kill the whole stream
        return None
    return parse_record_fields(obj, cols, dtypes, schema)


def _dtype_code(dtype: dt.DType) -> int:
    """Column dtype -> C++ fast-coercion code (0 = always take the Python
    parse_value path for non-null values)."""
    target = dtype.strip_optional()
    if target is dt.INT:
        return 1
    if target is dt.FLOAT:
        return 2
    if target is dt.BOOL:
        return 3
    if target is dt.STR:
        return 4
    if target is dt.BYTES:
        return 5
    if (
        target is dt.JSON
        or target is dt.DATE_TIME_NAIVE
        or target is dt.DATE_TIME_UTC
        or isinstance(target, (dt.List, dt.Tuple, dt.Array))
    ):
        return 0  # needs Json wrapping / datetime / container parsing
    return 6  # parse_value passes every other target through untouched


# joined batch parses separate items with a SENTINEL object, not a bare
# comma: two compensating malformations (a JSON fragment pair that merges
# plus a multi-object item that splits) can keep the element COUNT right
# while misassigning every row in between. With sentinels interleaved,
# any merge/split either breaks the 2n-1 count or displaces a sentinel
# off its odd index — both detectable — so the fast path can never
# fabricate rows the per-item path would reject.
_JSON_SEP = b',{"__pw_sep__":0},'
_JSON_SEP_OBJ = {"__pw_sep__": 0}


def _joined_parse(items: list[bytes]):
    """Parse ``items`` as one sentinel-separated JSON array; the decoded
    objects in order, or None when the batch must re-parse per item."""
    try:
        decoded = json.loads(b"[" + _JSON_SEP.join(items) + b"]")
    except (json.JSONDecodeError, TypeError):
        return None
    if len(decoded) != 2 * len(items) - 1:
        return None
    if any(decoded[i] != _JSON_SEP_OBJ for i in range(1, len(decoded), 2)):
        return None
    return decoded[::2]


_JSONL_CHUNK = 20_000


def _parse_json_line_chunks(lines):
    """Yield decoded objects for jsonlines content, chunked: one
    ``json.loads`` per chunk is ~3x per-line calls, and chunking bounds the
    transient join memory on multi-GB files. A chunk with any invalid line
    — or any line that is not ONE standalone JSON document (caught by the
    sentinel check in ``_joined_parse``) — falls back per-line with bad
    lines skipped, so results never depend on chunk boundaries."""
    for start in range(0, len(lines), _JSONL_CHUNK):
        chunk = lines[start : start + _JSONL_CHUNK]
        objs = _joined_parse(chunk)
        if objs is None:
            objs = []
            for line in chunk:
                try:
                    objs.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
        yield from objs


def fast_rows_eligible(fmt: str) -> bool:
    """Whether ``rows_from_bytes`` parses ``fmt`` (JSON lines)."""
    return fmt in ("json", "jsonlines")


def _fast_parse_plan(schema):
    """Loop-invariant parse inputs shared by the row and columnar fast
    paths: (cols, dtypes, codes, defaults)."""
    cols = [c for c in schema.column_names() if c != "_metadata"]
    dtypes = {n: c.dtype for n, c in schema.__columns__.items()}
    codes = [_dtype_code(dtypes[c]) for c in cols]
    defaults = {
        c: v for c, v in schema.default_values().items() if c in cols
    }
    return cols, dtypes, codes, defaults


def _repair_fallback(fallback, cols, dtypes, schema, write_row):
    """Shared fallback repair: re-parse each (row index, line bytes) entry
    in Python and hand ``write_row(i, values)`` the coerced values; returns
    the indices to DROP (undecodable / non-record lines). One home for the
    repair semantics of both the row and columnar paths."""
    drop = []
    for i, line in fallback:
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            drop.append(i)
            continue
        if not isinstance(obj, dict):
            drop.append(i)
            continue
        write_row(i, parse_record_fields(obj, cols, dtypes, schema))
    return drop


def rows_from_bytes(data: bytes, fmt: str, schema):
    """Batch parse: raw jsonlines bytes -> list of row TUPLES in schema
    column order (the reference parses records entirely in Rust,
    ``src/connectors/data_format.rs:500,1439``; this is the C++ analog).
    One pass over the bytes in C++; records needing slow coercions are
    re-parsed per record in Python, so results are identical either way;
    non-record JSON lines (scalars/arrays, multi-object lines) are skipped
    like undecodable ones."""
    from pathway_tpu_torch import native

    if fmt not in ("json", "jsonlines"):
        raise ValueError(f"rows_from_bytes parses JSON lines, not {fmt!r}")
    cols, dtypes, codes, defaults = _fast_parse_plan(schema)
    rows, fallback = native.jsonl_rows(data, cols, codes, defaults)

    def write_row(i, values):
        rows[i] = tuple(values[c] for c in cols)

    drop = _repair_fallback(fallback, cols, dtypes, schema, write_row)
    for i in reversed(drop):
        del rows[i]
    return rows


def stream_parse_plan(schema, cols, dtypes):
    """Precompute the loop-invariant pieces of
    ``batch_parse_stream_records`` (dtype codes + defaults) once per
    connector instead of per poll."""
    return (
        [_dtype_code(dtypes[c]) for c in cols],
        {c: v for c, v in schema.default_values().items() if c in cols},
    )


def batch_parse_stream_records(values: list[bytes], fmt: str, schema,
                               cols, dtypes,
                               plan=None) -> list[tuple | None]:
    """Batch analog of ``parse_stream_record`` for a drained queue poll:
    one sentinel-guarded ``json.loads`` + the C++ row extractor over the
    whole batch instead of a Python dict/coercion pass per message. Entry
    i is the row tuple for ``values[i]`` or None (undecodable /
    non-record), exactly matching the per-message function. Pass ``plan``
    from :func:`stream_parse_plan` to hoist the schema-derived constants
    out of a polling loop."""
    from pathway_tpu_torch import native

    if fmt == "raw":
        return [(v,) for v in values]
    objs = _joined_parse(values)
    if objs is None:
        objs = [None] * len(values)
        for i, v in enumerate(values):
            try:
                objs[i] = json.loads(v)
            except (json.JSONDecodeError, TypeError):
                objs[i] = None
    codes, defaults = plan if plan is not None else stream_parse_plan(
        schema, cols, dtypes
    )
    rows, fallback = native.rows_from_records(objs, cols, codes, defaults)
    for i in fallback:
        obj = objs[i]
        if isinstance(obj, dict):
            vals = parse_record_fields(obj, cols, dtypes, schema)
            rows[i] = tuple(vals[c] for c in cols)
        else:
            rows[i] = None
    return rows


def _csv_settings_simple(settings: "CsvParserSettings | None") -> bool:
    """Whether the C++ CSV state machine covers these settings (1-byte
    delimiter/quote, RFC4180 double-quote escapes, no comment chars)."""
    s = settings or CsvParserSettings()
    return (
        len(s.delimiter) == 1
        and ord(s.delimiter) < 128
        and len(s.quote) == 1
        and ord(s.quote) < 128
        and s.escape is None
        and s.enable_double_quote_escapes
        and s.enable_quoting
        and s.comment_character is None
    )


def fast_cols_eligible(fmt: str, csv_settings=None) -> bool:
    """Whether :func:`cols_from_bytes` parses ``fmt`` with these settings."""
    if fmt in ("json", "jsonlines"):
        return True
    if fmt in ("csv", "dsv"):
        return _csv_settings_simple(csv_settings)
    return False


def cols_from_bytes(data: bytes, fmt: str, schema, csv_settings=None,
                    native: bool = True):
    """Columnar twin of :func:`rows_from_bytes`: raw jsonlines OR csv
    bytes -> ``(column_lists, n_rows)`` with one Python list per schema
    column — no row tuples are ever materialized (the C++ parsers emit
    straight into column lists), so bulk readers skip the transpose
    entirely. Fallback records are repaired per record exactly like the
    row paths. ``native=False`` parses through
    :func:`iter_records_from_bytes` in Python (the same columns)."""
    if not fast_cols_eligible(fmt, csv_settings):
        raise ValueError(f"cols_from_bytes has no columnar parse for {fmt!r} "
                         f"with {csv_settings!r}")
    if not native:
        cols = [c for c in schema.column_names() if c != "_metadata"]
        recs = list(iter_records_from_bytes(data, fmt, schema, csv_settings, native=False))
        return [[r[c] for r in recs] for c in cols], len(recs)
    if fmt in ("csv", "dsv"):
        return _csv_cols_from_bytes(data, schema, csv_settings)
    from pathway_tpu_torch import native as native_mod

    cols, dtypes, codes, defaults = _fast_parse_plan(schema)
    col_lists, n, fallback = native_mod.jsonl_rows(data, cols, codes, defaults, 1)
    col_lists = list(col_lists)

    def write_row(i, values):
        for j, c in enumerate(cols):
            col_lists[j][i] = values[c]

    drop = _repair_fallback(fallback, cols, dtypes, schema, write_row)
    for i in reversed(drop):
        for col in col_lists:
            del col[i]
        n -= 1
    return col_lists, n


def _csv_cols_from_bytes(data: bytes, schema, csv_settings):
    """C++ CSV parse; fallback records (exotic coercions) re-parse through
    the REAL csv module against the header the C++ parser saw, so results
    match the DictReader path exactly."""
    import csv as csv_mod
    import io as io_mod

    from pathway_tpu_torch import native as native_mod

    settings = csv_settings or CsvParserSettings()
    cols, dtypes, codes, defaults = _fast_parse_plan(schema)
    header, col_lists, n, fallback = native_mod.csv_cols(
        data, settings.delimiter, settings.quote, cols, codes, defaults)
    col_lists = list(col_lists)
    drop: list[int] = []
    for i, rec_bytes in fallback:
        text = rec_bytes.decode("utf-8", errors="replace")
        parsed = list(csv_mod.reader(
            io_mod.StringIO(text), delimiter=settings.delimiter,
            quotechar=settings.quote,
        ))
        if not parsed:
            drop.append(i)
            continue
        fields = list(parsed[0])
        if len(fields) < len(header):  # DictReader restval: None
            fields += [None] * (len(header) - len(fields))
        record = dict(zip(header, fields))
        values = parse_record_fields(record, cols, dtypes, schema)
        for j, c in enumerate(cols):
            col_lists[j][i] = values[c]
    for i in reversed(drop):
        for col in col_lists:
            del col[i]
        n -= 1
    return col_lists, n


def _iter_lines(data: bytes, native: bool = True):
    """'\\n'-separated lines, mirroring text-file iteration (the final
    newline does not produce an empty trailing line; '\\r' is preserved).
    The C++ splitter cuts the bytes; ``native=False`` splits the decoded
    text in Python (the same lines: no UTF-8 sequence holds a newline
    byte)."""
    if native:
        from pathway_tpu_torch import native as native_mod

        return [data[int(a):int(b)].decode("utf-8", errors="replace")
                for a, b in native_mod.split_lines(data)]
    lines = data.decode("utf-8", errors="replace").split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    return lines


def iter_records_from_bytes(data: bytes, fmt: str, schema,
                            csv_settings: "CsvParserSettings | None" = None,
                            native: bool = True):
    """Yield per-record value dicts from raw file bytes — the ONE parser
    half of the reference's scanner x tokenizer split
    (``src/connectors/posix_like.rs``), so the formats cannot drift apart.
    The per-record path of the file reader (metadata, primary keys, CSV
    settings the C++ parser does not cover): CSV through
    ``csv.DictReader``, JSON lines through ``json``; plaintext lines come
    from the C++ splitter (``native=False``: from Python's)."""
    import csv as csv_mod
    import io as io_mod

    cols = [c for c in schema.column_names() if c != "_metadata"]
    dtypes = {n: c.dtype for n, c in schema.__columns__.items()}
    if fmt in ("csv", "dsv"):
        settings = csv_settings or CsvParserSettings()
        text = data.decode("utf-8", errors="replace")
        reader = csv_mod.DictReader(
            io_mod.StringIO(text), delimiter=settings.delimiter,
            quotechar=settings.quote,
        )
        for record in reader:
            yield parse_record_fields(record, cols, dtypes, schema)
    elif fmt in ("json", "jsonlines"):
        lines = [ln for ln in data.split(b"\n") if ln.strip()]
        for obj in _parse_json_line_chunks(lines):
            # valid JSON but not a record (null / number / array):
            # skip — same containment as parse_stream_record; one bad
            # line must not kill the connector
            if isinstance(obj, dict):
                yield parse_record_fields(obj, cols, dtypes, schema)
    elif fmt == "plaintext":
        for line in _iter_lines(data, native):
            yield {"data": line}
    elif fmt == "plaintext_by_file":
        yield {"data": data.decode("utf-8", errors="replace")}
    elif fmt == "binary":
        yield {"data": data}
    else:
        raise ValueError(f"unknown format {fmt!r}")
