"""The file connectors of the port (``pw.io.fs`` / ``csv`` / ``jsonlines``
/ ``plaintext``, ``io/_utils.py``'s CSV and lines half, the C++ ``csv_cols``
and ``split_lines`` of ``native/_engine.cpp``) held against the JAX
package: the cases of ``tests/test_io.py`` (:19, :35, :51, :67, :166,
:263) and ``tests/test_io_formats.py`` (:27-:154, :239, :288, :304, :319)
read the same files through both packages, and the row ids must be equal
bit for bit, the rows equal and the update streams equal in order (commit
times by rank: they are wall-clock times). The C++ parsers are held
against the Python parsers (``native=False``) and JAX's on the same bytes.
Every wait in a streaming case is bounded."""

import csv as csv_mod
import io as io_mod
import json
import threading
import time

import numpy as np
import pytest

from pathway_tpu.io import _utils as JU
from pathway_tpu_torch import native
from pathway_tpu_torch.io import _utils as TU
from tests.torch_engine import PACKAGES, PW, canon, final_state, j_run, t_run

WAIT = 20.0  # a bound on each wait of a streaming case


def _wn(pw):
    class WN(pw.Schema):
        word: str
        n: int

    return WN


def _word(pw):
    class WordSchema(pw.Schema):
        word: str

    return WordSchema


def _both(build):
    """{row id: row} and columns of ``build(pw)``'s final table, equal for
    both packages."""
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        out[pkg] = final_state(pkg, build(pw))
    assert out["torch"] == out["jax"]
    return out["torch"]


def _rows(state):
    rows, cols = state
    return sorted(rows.values()), cols


def _write(path, content):
    with open(path, "wb" if isinstance(content, bytes) else "w") as f:
        f.write(content)


# ------------------------------------------------------------ tests/test_io.py
def test_jsonlines_static_roundtrip(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    _write(src / "a.jsonl", "".join(json.dumps({"word": "w" + str(i % 2), "n": i}) + "\n"
                                    for i in range(4)))
    outs = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        t = pw.io.jsonlines.read(str(src), schema=_wn(pw), mode="static")
        counts = t.groupby(t.word).reduce(t.word, s=pw.reducers.sum(t.n))
        out = tmp_path / f"out-{pkg}.jsonl"
        pw.io.jsonlines.write(counts, str(out))
        pw.run()
        outs[pkg] = [{k: v for k, v in json.loads(line).items() if k != "time"}
                     for line in open(out)]
    assert outs["torch"] == outs["jax"]
    assert {r["word"]: r["s"] for r in outs["torch"] if r["diff"] == 1} == {"w0": 2, "w1": 4}


def test_csv_static(tmp_path):
    p = tmp_path / "data.csv"
    p.write_text("word,n\nfoo,1\nbar,2\n")
    rows, cols = _rows(_both(lambda pw: pw.io.csv.read(str(p), schema=_wn(pw), mode="static")))
    assert cols == ["word", "n"] and rows == [("bar", 2), ("foo", 1)]


def test_plaintext(tmp_path):
    p = tmp_path / "f.txt"
    p.write_text("hello\nworld\n")
    rows, _ = _rows(_both(lambda pw: pw.io.plaintext.read(str(p), mode="static")))
    assert rows == [("hello",), ("world",)]


def _stream(pkg, src, schema_of, feed, read=None, timeout=WAIT):
    """The update stream of a streaming read of ``src`` while ``feed(seen)``
    changes its files: ``(row id, row, time rank, is_addition)`` in order."""
    pw = PW[pkg]
    pw.clear_graph()
    read = read or (lambda pw: pw.io.jsonlines.read(
        str(src), schema=schema_of(pw), mode="streaming", refresh_interval=0.05))
    t = read(pw)
    seen = []
    lock = threading.Lock()

    def on_change(key, row, time, is_addition):
        with lock:
            seen.append((key.value, tuple(canon(v) for v in row.values()), time,
                         is_addition))

    pw.io.subscribe(t, on_change=on_change)
    conns = list(pw.G.connectors)

    def wait_for(n):
        deadline = time.time() + timeout
        while time.time() < deadline:
            with lock:
                if len(seen) >= n:
                    return
            time.sleep(0.02)

    def body():
        try:
            feed(wait_for)
        finally:
            for c in conns:
                c._stop.set()
                c.close()

    th = threading.Thread(target=body, daemon=True)
    th.start()
    pw.run()
    th.join(timeout)
    assert not th.is_alive(), "the feeder did not finish"
    ranks = {tm: i for i, tm in enumerate(sorted({e[2] for e in seen}))}
    return [(k, r, ranks[tm], add) for k, r, tm, add in seen]


def test_fs_streaming_picks_up_new_files(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    streams = {}
    for pkg in PACKAGES:
        (src / "b.jsonl").unlink(missing_ok=True)
        (src / "a.jsonl").write_text(json.dumps({"word": "x", "n": 1}) + "\n")

        def feed(wait_for):
            wait_for(1)
            (src / "b.jsonl").write_text(json.dumps({"word": "y", "n": 2}) + "\n")
            wait_for(2)

        streams[pkg] = _stream(pkg, src, _wn, feed)
    assert streams["torch"] == streams["jax"]
    assert [(e[1], e[2], e[3]) for e in streams["torch"]] == [
        (("x", 1), 0, True), (("y", 2), 1, True)]


def test_csv_write(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.jsonl").write_text('{"word": "cat", "n": 1}\n{"word": "dog", "n": 2}\n')
    outs = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        t = pw.io.jsonlines.read(str(src), schema=_wn(pw), mode="static")
        out = tmp_path / f"out-{pkg}.csv"
        pw.io.csv.write(t, str(out))
        pw.run()
        outs[pkg] = [r[:-2] + r[-1:] for r in csv_mod.reader(open(out))]  # without time
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] == ["word", "n", "diff"]
    assert sorted(outs["torch"][1:]) == [["cat", "1", "1"], ["dog", "2", "1"]]


def test_fs_list_primary_key_hashes_match_scalar(tmp_path):
    (tmp_path / "a.jsonl").write_text(
        json.dumps({"coord": [1, 2], "v": 1}) + "\n" + json.dumps({"coord": [3, 4], "v": 2})
        + "\n")

    def build(pw):
        class S(pw.Schema):
            coord: list = pw.column_definition(primary_key=True)
            v: int

        return pw.io.jsonlines.read(str(tmp_path), schema=S, mode="static")

    rows, _ = _both(build)
    from pathway_tpu_torch.engine.value import hash_values

    assert sorted(rows) == sorted([hash_values([1, 2]), hash_values([3, 4])])


# ---------------------------------------------------- tests/test_io_formats.py
def _static(tmp_path, fname, content, **kw):
    _write(tmp_path / fname, content)

    def build(pw):
        extra = dict(kw)
        schema = extra.pop("schema", None)
        if schema is not None:
            extra["schema"] = schema(pw)
        csv_settings = extra.pop("csv_settings", None)
        if csv_settings is not None:
            extra["csv_settings"] = pw.io.CsvParserSettings(**csv_settings)
        return pw.io.fs.read(str(tmp_path), mode="static", **extra)

    return _both(build)


def test_csv_custom_delimiter(tmp_path):
    rows, cols = _rows(_static(tmp_path, "a.csv", "word;n\ncat;1\n", format="csv",
                               schema=_wn, csv_settings={"delimiter": ";"}))
    assert rows == [("cat", 1)]


def test_csv_quoted_fields_with_delimiter_inside(tmp_path):
    rows, _ = _rows(_static(tmp_path, "a.csv", 'word,n\n"a,b",2\n', format="csv", schema=_wn))
    assert rows == [("a,b", 2)]


def test_csv_missing_column_uses_default(tmp_path):
    def schema(pw):
        class S(pw.Schema):
            word: str
            n: int = pw.column_definition(default_value=7)

        return S

    rows, _ = _rows(_static(tmp_path, "a.csv", "word\ncat\n", format="csv", schema=schema))
    assert rows == [("cat", 7)]


def test_jsonlines_skips_bad_lines(tmp_path):
    rows, _ = _rows(_static(tmp_path, "a.jsonl",
                            '{"word": "ok"}\nnot json at all\n{"word": "also"}\n',
                            format="json", schema=_word))
    assert rows == [("also",), ("ok",)]


def test_jsonlines_type_coercion_from_strings(tmp_path):
    rows, _ = _rows(_static(tmp_path, "a.jsonl", '{"word": "x", "n": "42"}\n',
                            format="json", schema=_wn))
    assert rows == [("x", 42)]


def test_plaintext_one_row_per_line(tmp_path):
    rows, _ = _rows(_static(tmp_path, "a.txt", "alpha\nbeta\n", format="plaintext"))
    assert rows == [("alpha",), ("beta",)]


def test_plaintext_by_file_one_row_per_file(tmp_path):
    rows, _ = _rows(_static(tmp_path, "a.txt", "alpha\nbeta\n", format="plaintext_by_file"))
    assert rows == [("alpha\nbeta\n",)]


def test_binary_reads_bytes(tmp_path):
    rows, _ = _rows(_static(tmp_path, "a.bin", b"\x00\x01\x02", format="binary"))
    assert rows == [(b"\x00\x01\x02",)]


@pytest.mark.parametrize("fmt", ["json", "binary", "plaintext", "csv"])
def test_with_metadata_attaches_path(tmp_path, fmt):
    content = {"json": '{"word": "x"}\n', "binary": b"x", "plaintext": "x\n",
               "csv": "word\nx\n"}[fmt]
    _write(tmp_path / "a.dat", content)
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        kw = {"schema": _word(pw)} if fmt in ("json", "csv") else {}
        t = pw.io.fs.read(str(tmp_path), format=fmt, mode="static", with_metadata=True, **kw)
        cap = (t_run if pkg == "torch" else j_run).capture_table(t)
        mi = list(cap.column_names).index("_metadata")
        out[pkg] = {}
        for key, row in cap.state.rows.items():
            # seen_at is the reader's clock: the one field that may differ
            meta = {k: v for k, v in row[mi].value.items() if k != "seen_at"}
            out[pkg][int(key)] = (tuple(canon(v) for v in row[:mi] + row[mi + 1:]), meta)
    assert out["torch"] == out["jax"]
    (_, meta), = out["torch"].values()
    assert meta["path"].endswith("a.dat") and meta["size"] > 0


def test_primary_key_upsert_across_files(tmp_path):
    (tmp_path / "a.jsonl").write_text('{"k": "x", "v": 1}\n')
    (tmp_path / "b.jsonl").write_text('{"k": "x", "v": 2}\n')

    def build(pw):
        class S(pw.Schema):
            k: str = pw.column_definition(primary_key=True)
            v: int

        return pw.io.jsonlines.read(str(tmp_path), schema=S, mode="static")

    rows, _ = _rows(_both(build))
    assert rows == [("x", 2)]


def test_write_jsonlines_includes_time_and_diff(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.jsonl").write_text('{"word": "cat"}\n')
    recs = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        t = pw.io.jsonlines.read(str(src), schema=_word(pw), mode="static")
        out = tmp_path / f"out-{pkg}.jsonl"
        pw.io.jsonlines.write(t, str(out))
        pw.run()
        recs[pkg] = json.loads(out.read_text().splitlines()[0])
    assert recs["torch"].keys() == recs["jax"].keys() == {"word", "time", "diff"}
    assert recs["torch"]["word"] == "cat" and recs["torch"]["diff"] == 1


def test_subscribe_sees_additions_in_diff_order():
    events = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        t = pw.debug.table_from_markdown(
            """
            v | __time__ | __diff__
            1 | 2        | 1
            1 | 4        | -1
            2 | 4        | 1
            """
        )
        events[pkg] = []
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition, e=events[pkg]:
                        e.append((key.value, row["v"], time, is_addition)))
        pw.run()
    assert events["torch"] == events["jax"]
    ev = [(v, add) for _k, v, _t, add in events["torch"]]
    assert ev.index((1, True)) < ev.index((1, False)) and (2, True) in ev


def test_csv_read_streaming_picks_up_appended_file(tmp_path):
    streams = {}
    for pkg in PACKAGES:
        (tmp_path / "b.csv").unlink(missing_ok=True)
        (tmp_path / "a.csv").write_text("word,n\ncat,1\n")

        def feed(wait_for):
            wait_for(1)
            (tmp_path / "b.csv").write_text("word,n\ndog,2\n")
            wait_for(2)

        streams[pkg] = _stream(pkg, tmp_path, _wn, feed, read=lambda pw: pw.io.csv.read(
            str(tmp_path), schema=_wn(pw), mode="streaming", refresh_interval=0.05))
    assert streams["torch"] == streams["jax"]
    assert [e[1] for e in streams["torch"]] == [("cat", 1), ("dog", 2)]


def test_fs_empty_dir_yields_empty_table(tmp_path):
    rows, _ = _both(lambda pw: pw.io.jsonlines.read(str(tmp_path), schema=_word(pw),
                                                    mode="static"))
    assert rows == {}


def test_csv_stray_quote_mid_field_is_literal(tmp_path):
    rows, _ = _rows(_static(tmp_path, "a.csv", 'word,n\n5" disk,1\n"a"b"c,2\nplain,3\n',
                            format="csv", schema=_wn))
    assert rows == [('5" disk', 1), ('ab"c', 2), ("plain", 3)]


def test_csv_bool_quoted_with_newline_whitespace(tmp_path):
    def schema(pw):
        class B(pw.Schema):
            f: bool

        return B

    rows, _ = _rows(_static(tmp_path, "b.csv", 'f\n"true\n"\n" YES\t"\n"no\r"\n',
                            format="csv", schema=schema))
    assert rows == [(False,), (True,), (True,)]


# ------------------------------------------------- the C++ parsers vs Python
CSV_CASES = {
    "plain": b"word,n,x\ncat,1,0.5\ndog,-2,1e3\n",
    "quoted_delim_newline": b'word,n,x\n"a,b",2,1\n"line\nbreak",3,2\n',
    "doubled_quotes": b'word,n,x\n"say ""hi""",1,1\n"""",2,2\n',
    "stray_quotes": b'word,n,x\n5" disk,1,1\n"a"b"c,2,2\nx"",3,3\n',
    "crlf_and_blank_lines": b"word,n,x\r\ncat,1,1\r\n\r\n\ndog,2,2\r\n",
    "short_and_long_rows": b"word,n,x\ncat\ndog,2,2,extra,more\n,,\n",
    "int_float_forms": b"word,n,x\na,+7,-0.25\nb,007,.5\nc,1_000,inf\nd, 3,1e400\n",
    "bool_and_default": b"word,x\nt,1\n",
    "non_ascii": "word,n,x\nżółw,1,1\nnaïve,2,2\n".encode(),
    "no_final_newline": b"word,n,x\ncat,1,1",
    "header_only": b"word,n,x\n",
    "empty": b"",
    "quote_at_eof": b'word,n,x\n"open,1,1\n',
    "delimiter_only_rows": b"word,n,x\n,,\n,1,\n",
}


def _csv_schema(pw):
    class C(pw.Schema):
        word: str
        n: int
        x: float
        flag: bool = pw.column_definition(default_value=True)

    return C


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_csv_cols_equal_the_python_parser(case):
    """``csv_cols`` (through ``cols_from_bytes``) gives the columns of
    Python's ``csv.DictReader`` path and of JAX's native parser."""
    import pathway_tpu as JPW
    import pathway_tpu_torch as TPW

    data = CSV_CASES[case]
    got = TU.cols_from_bytes(data, "csv", _csv_schema(TPW))
    ref = TU.cols_from_bytes(data, "csv", _csv_schema(TPW), native=False)
    jax = JU.cols_from_bytes(data, "csv", _csv_schema(JPW))
    canon_cols = lambda cl: ([[canon(v) for v in col] for col in cl[0]], cl[1])  # noqa: E731
    assert canon_cols(got) == canon_cols(ref) == canon_cols(jax)


def test_csv_cols_random_written_files_equal_the_python_parser():
    """Seeded files written by ``csv.writer`` with fields full of
    delimiters, quotes and newlines parse alike in C++ and Python."""
    import pathway_tpu_torch as TPW

    rng = np.random.default_rng(0)
    alphabet = list('ab ,"\n\r;') + ["é", "1", "-"]
    for trial in range(40):
        buf = io_mod.StringIO()
        w = csv_mod.writer(buf, lineterminator="\r\n" if trial % 2 else "\n")
        w.writerow(["word", "n", "x"])
        for _ in range(int(rng.integers(0, 12))):
            word = "".join(rng.choice(alphabet, int(rng.integers(0, 8))))
            w.writerow([word, int(rng.integers(-50, 50)), float(rng.normal())])
        data = buf.getvalue().encode()
        got = TU.cols_from_bytes(data, "csv", _csv_schema(TPW))
        ref = TU.cols_from_bytes(data, "csv", _csv_schema(TPW), native=False)
        assert got == ref, data


LINE_CASES = [b"", b"a", b"a\n", b"a\nb", b"a\n\nb\n\n", b"\n", b"x\r\ny\r\n",
              "żółw\nnaïve\n".encode(), b"\xff\xfe\nok\n", b"a\x00b\nc"]


@pytest.mark.parametrize("data", LINE_CASES, ids=range(len(LINE_CASES)))
def test_split_lines_equal_the_python_splitter(data):
    from pathway_tpu import native as jnative

    offs = native.split_lines(data)
    assert offs.dtype == np.uint64 and offs.shape[1] == 2
    np.testing.assert_array_equal(offs, jnative.split_lines_native(data))
    assert TU._iter_lines(data) == TU._iter_lines(data, native=False) == JU._iter_lines(data)


def test_native_parsers_raise_on_a_failed_build(tmp_path, monkeypatch):
    """No fallback to the Python parsers: a compiler that is missing makes
    the reader's parse raise."""
    import pathway_tpu_torch as TPW

    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        TU.cols_from_bytes(b"word,n,x\na,1,1\n", "csv", _csv_schema(TPW))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        TU._iter_lines(b"a\nb\n")


# ---------------------------------------------- what the port does its own way
def test_persistent_id_raises(tmp_path):
    """``persistent_id=`` raised until persistence came to the port; now
    it names the reader's snapshot log (``tests/test_torch_persistence.py``
    resumes from it)."""
    import pathway_tpu_torch as TPW

    TPW.clear_graph()
    TPW.io.csv.read(str(tmp_path), schema=_wn(TPW), persistent_id="p")
    TPW.io.plaintext.read(str(tmp_path), persistent_id="q")
    sources = TPW.persistence.get_persistent_sources()
    assert sorted(sources) == ["p", "q"]
    assert [c.persistent_id for c in TPW.G.connectors] == ["p", "q"]
    TPW.clear_graph()
    assert TPW.persistence.get_persistent_sources() == {}


@pytest.mark.parametrize("fmt", ["csv", "json"])
def test_fs_streaming_retracts_deleted_and_changed_files(tmp_path, fmt):
    """A streaming read retracts the rows of a file that goes away, and a
    file that changes retracts its old rows before its new ones arrive
    (JAX's reader keeps both; the reference's scanner retracts)."""
    ext, body = {"csv": ("csv", lambda w: "word,n\n" + "".join(f"{x},{n}\n" for x, n in w)),
                 "json": ("jsonl", lambda w: "".join(json.dumps({"word": x, "n": n}) + "\n"
                                                    for x, n in w))}[fmt]
    (tmp_path / f"a.{ext}").write_text(body([("a", 1), ("aa", 2)]))
    (tmp_path / f"b.{ext}").write_text(body([("b", 3)]))

    def feed(wait_for):
        wait_for(3)
        (tmp_path / f"a.{ext}").unlink()
        wait_for(5)
        time.sleep(0.05)  # a later mtime than the first read's
        (tmp_path / f"b.{ext}").write_text(body([("b", 4), ("bb", 5)]))
        wait_for(8)

    stream = _stream("torch", tmp_path, _wn, feed, read=lambda pw: pw.io.fs.read(
        str(tmp_path), format=fmt, schema=_wn(pw), mode="streaming", refresh_interval=0.05))
    ev = [(r, t, add) for _k, r, t, add in stream]
    assert sorted(ev[:3]) == [(("a", 1), 0, True), (("aa", 2), 0, True), (("b", 3), 0, True)]
    assert sorted(ev[3:5]) == [(("a", 1), 1, False), (("aa", 2), 1, False)]
    assert sorted(ev[5:]) == [(("b", 3), 2, False), (("b", 4), 2, True), (("bb", 5), 2, True)]
    keys = {r: k for k, r, _t, add in stream if add}
    # a row id is (file, line): b's first line keeps its id across the change
    assert keys[("b", 3)] == keys[("b", 4)] and len(set(keys.values())) == 4


def test_fs_streaming_upsert_retracts_a_deleted_files_keys(tmp_path):
    (tmp_path / "a.jsonl").write_text('{"k": "x", "v": 1}\n{"k": "y", "v": 2}\n')
    (tmp_path / "b.jsonl").write_text('{"k": "y", "v": 3}\n')

    def schema(pw):
        class S(pw.Schema):
            k: str = pw.column_definition(primary_key=True)
            v: int

        return S

    def feed(wait_for):
        wait_for(2)  # x from a; y as b last set it (a's y consolidated away)
        (tmp_path / "a.jsonl").unlink()
        wait_for(3)

    stream = _stream("torch", tmp_path, schema, feed)
    ev = [(r, t, add) for _k, r, t, add in stream]
    # x leaves with a.jsonl; y's row came from b.jsonl last and stays
    assert sorted(ev[:2]) == [(("x", 1), 0, True), (("y", 3), 0, True)]
    assert ev[2:] == [(("x", 1), 1, False)]
