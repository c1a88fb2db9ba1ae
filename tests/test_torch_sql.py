"""``pw.sql`` and ``pw.load_yaml`` in the port against JAX's.

Each of JAX's ``tests/test_sql_matrix.py`` cases (SELECT / WHERE / GROUP BY
/ HAVING / JOIN / CTE / set operations / expressions) runs the same query
over the same tables through both packages: the captured tables must be
equal, row ids included, and equal to JAX's expected rows. The
``load_yaml`` cases (``!pw...`` tags, ``$ref`` reuse, ``$ENV``
interpolation, an unknown tag) run both loaders on the same document."""

import pytest

import pathway_tpu as JPW
import pathway_tpu_torch as TPW
from tests.torch_engine import PACKAGES, PW, final_state


@pytest.fixture(autouse=True)
def _clear_graphs():
    JPW.clear_graph()
    TPW.clear_graph()
    yield
    JPW.clear_graph()
    TPW.clear_graph()


STAFF = """
    name  | dept | salary
    alice | eng  | 100
    bob   | eng  | 80
    carol | ops  | 90
    """
HEADS = """
    dept | head
    eng  | dana
    ops  | evan
    """
A = """
    v
    1
    2
    """
B = """
    v
    2
    3
    """
C = """
    v
    1
    """

# (id, query, tables, JAX's expected sorted rows, JAX's expected columns)
CASES = [
    ("select_columns", "SELECT name, salary FROM t", {"t": STAFF},
     [("alice", 100), ("bob", 80), ("carol", 90)], ["name", "salary"]),
    ("select_star", "SELECT * FROM t", {"t": STAFF},
     [("alice", "eng", 100), ("bob", "eng", 80), ("carol", "ops", 90)], None),
    ("where_comparison", "SELECT name FROM t WHERE salary > 85", {"t": STAFF},
     [("alice",), ("carol",)], None),
    ("where_and_or", "SELECT name FROM t WHERE dept = 'eng' AND salary >= 100 "
     "OR dept = 'ops'", {"t": STAFF}, [("alice",), ("carol",)], None),
    ("computed_column_with_alias", "SELECT name, salary * 2 AS double_pay FROM t",
     {"t": STAFF}, [("alice", 200), ("bob", 160), ("carol", 180)], ["name", "double_pay"]),
    ("group_by_aggregates", "SELECT dept, SUM(salary) AS total, COUNT(*) AS n "
     "FROM t GROUP BY dept", {"t": STAFF}, [("eng", 180, 2), ("ops", 90, 1)], None),
    ("group_by_having", "SELECT dept, SUM(salary) AS total FROM t GROUP BY dept "
     "HAVING SUM(salary) > 100", {"t": STAFF}, [("eng", 180)], None),
    ("global_aggregate", "SELECT MAX(salary) AS m FROM t", {"t": STAFF}, [(100,)], None),
    ("join_two_tables", "SELECT t.name, h.head FROM t JOIN h ON t.dept = h.dept",
     {"t": STAFF, "h": HEADS}, [("alice", "dana"), ("bob", "dana"), ("carol", "evan")],
     None),
    ("union_all", "SELECT v FROM a UNION ALL SELECT v FROM b", {"a": A, "b": B},
     [(1,), (2,), (2,), (3,)], None),
    ("union", "SELECT v FROM a UNION SELECT v FROM b", {"a": A, "b": B},
     [(1,), (2,), (3,)], None),
    ("intersect", "SELECT v FROM a INTERSECT SELECT v FROM b", {"a": A, "b": B},
     [(2,)], None),
    ("except", "SELECT v FROM a EXCEPT SELECT v FROM b", {"a": A, "b": B}, [(1,)], None),
    ("with_cte", "WITH rich AS (SELECT * FROM t WHERE salary >= 90) SELECT name FROM rich",
     {"t": STAFF}, [("alice",), ("carol",)], None),
    ("nested_cte_chain", "WITH a AS (SELECT * FROM t WHERE dept = 'eng'), "
     "b AS (SELECT * FROM a WHERE salary > 85) SELECT name FROM b", {"t": STAFF},
     [("alice",)], None),
    ("case_insensitive_keywords", "select name from t where salary = 80", {"t": STAFF},
     [("bob",)], None),
    ("arithmetic_in_where", "SELECT name FROM t WHERE salary - 10 = 70", {"t": STAFF},
     [("bob",)], None),
    ("not_equal_operators", "SELECT name FROM t WHERE dept <> 'eng'", {"t": STAFF},
     [("carol",)], None),
    ("intersect_binds_tighter_than_except",
     "SELECT v FROM a EXCEPT SELECT v FROM b INTERSECT SELECT v FROM c",
     {"a": A, "b": B, "c": C}, [(1,), (2,)], None),
    ("left_join_and_alias", "SELECT t.name AS who, h.head FROM t LEFT JOIN h "
     "ON t.dept = h.dept WHERE salary < 95", {"t": STAFF, "h": HEADS},
     [("bob", "dana"), ("carol", "evan")], ["who", "head"]),
    ("not_and_parentheses", "SELECT name, (salary + 10) / 2 AS half FROM t "
     "WHERE NOT dept = 'ops'", {"t": STAFF}, [("alice", 55.0), ("bob", 45.0)], None),
]


def _run(pkg, query, tables):
    pw = PW[pkg]
    pw.clear_graph()
    named = {n: pw.debug.table_from_markdown(md) for n, md in tables.items()}
    return final_state(pkg, pw.sql(query, **named))


@pytest.mark.parametrize("query,tables,want,cols", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_sql_equals_jax(query, tables, want, cols):
    jrows, jcols = _run("jax", query, tables)
    trows, tcols = _run("torch", query, tables)
    assert tcols == jcols and trows == jrows
    if cols is not None:
        assert tcols == cols
    order = ["name", "dept", "salary"] if query == "SELECT * FROM t" else tcols
    got = sorted(tuple(dict(zip(tcols, r))[c] for c in order) for r in trows.values())
    assert got == sorted(want)


@pytest.mark.parametrize("query", ["SELECT v FROM a ORDER BY v", "SELECT v FROM a LIMIT 1",
                                   "SELECT v FROM a WHERE v IN (1, 2)",
                                   "SELECT v FROM a; DROP", "SELECT v FROM a WHERE v = @x"])
def test_unsupported_clause_raises(query):
    for pkg in PACKAGES:
        pw = PW[pkg]
        with pytest.raises(NotImplementedError):
            pw.sql(query, a=pw.debug.table_from_markdown(A))


def test_unknown_table_and_column_raise():
    for pkg in PACKAGES:
        pw = PW[pkg]
        t = pw.debug.table_from_markdown(STAFF)
        with pytest.raises(ValueError, match="unknown table"):
            pw.sql("SELECT name FROM nope", t=t)
        h = pw.debug.table_from_markdown(HEADS)
        with pytest.raises(ValueError, match="unknown column"):
            pw.sql("SELECT name FROM t JOIN h ON zzz = h.dept", t=t, h=h)
        with pytest.raises(KeyError, match="zzz"):
            pw.sql("SELECT name FROM t JOIN h ON t.zzz = h.dept", t=t, h=h)
        with pytest.raises(NotImplementedError, match="HAVING requires GROUP BY"):
            pw.sql("SELECT name FROM t HAVING salary > 1", t=t)


# ------------------------------------------------------------------ #
# load_yaml


def _splitter_cls(pkg):
    if pkg == "jax":
        from pathway_tpu.xpacks.llm.splitters import TokenCountSplitter
    else:
        from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter
    return TokenCountSplitter


def test_yaml_loader_instantiates_tags():
    yml = """
splitter: !pw.xpacks.llm.splitters.TokenCountSplitter
  min_tokens: 2
  max_tokens: 4
limit: 7
"""
    for pkg in PACKAGES:
        out = PW[pkg].load_yaml(yml)
        assert isinstance(out["splitter"], _splitter_cls(pkg))
        assert (out["splitter"].min_tokens, out["splitter"].max_tokens) == (2, 4)
        assert out["limit"] == 7
    jout, tout = JPW.load_yaml(yml), TPW.load_yaml(yml)
    assert vars(tout["splitter"]).keys() == vars(jout["splitter"]).keys()


def test_yaml_loader_references():
    yml = """
shared: !pw.xpacks.llm.splitters.TokenCountSplitter {}
user: $shared
nested:
  - $shared
  - plain
"""
    for pkg in PACKAGES:
        out = PW[pkg].load_yaml(yml)
        assert out["user"] is out["shared"] and out["nested"][0] is out["shared"]
        assert out["nested"][1] == "plain"


def test_yaml_loader_env_interpolation(monkeypatch):
    """``$NAME`` / ``${NAME}`` in a tagged object's arguments reads the
    variable the YAML names (a user's value); an unset one stays as
    written. Outside arguments the text is kept, as in JAX."""
    monkeypatch.setenv("PW_TEST_MAX_TOKENS", "9")
    monkeypatch.delenv("PW_TEST_UNSET", raising=False)
    yml = """
splitter: !pw.xpacks.llm.splitters.TokenCountSplitter
  min_tokens: 2
  max_tokens: ${PW_TEST_MAX_TOKENS}
  encoding_name: $PW_TEST_UNSET
top: $PW_TEST_MAX_TOKENS
"""
    got = {}
    for pkg in PACKAGES:
        out = PW[pkg].load_yaml(yml)
        got[pkg] = (out["splitter"].max_tokens, out["splitter"].encoding_name, out["top"])
    assert got["torch"] == got["jax"] == ("9", "$PW_TEST_UNSET", "$PW_TEST_MAX_TOKENS")


def test_yaml_loader_unknown_tag_raises():
    yml = "x: !pw.xpacks.llm.splitters.NoSuchSplitter {}\n"
    for pkg in PACKAGES:
        with pytest.raises(AttributeError, match="NoSuchSplitter"):
            PW[pkg].load_yaml(yml)
    yml = "x: !no_such_module_anywhere.Thing {}\n"
    for pkg in PACKAGES:
        with pytest.raises(ModuleNotFoundError):
            PW[pkg].load_yaml(yml)


def test_yaml_loader_plain_documents_and_streams(tmp_path):
    path = tmp_path / "app.yaml"
    path.write_text("- 1\n- two\n- {a: 3}\n")
    for pkg in PACKAGES:
        with open(path) as f:
            assert PW[pkg].load_yaml(f) == [1, "two", {"a": 3}]
        assert PW[pkg].load_yaml("7") == 7


def test_asynchronous_shim_forwards_to_udfs():
    for pkg, udfs in (("jax", JPW.udfs), ("torch", TPW.udfs)):
        with pytest.warns(DeprecationWarning, match="deprecated"):
            got = PW[pkg].asynchronous.async_executor
        assert got is udfs.async_executor
