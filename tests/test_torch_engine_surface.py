"""What the port's ``pw`` surface still lacks is checked, not only written
down: the public ``Table`` methods and the ``pw.*``, ``pw.io.*`` and
``pw.indexing.*`` names of the JAX package, less the port's, must equal
the names listed in ROADMAP.md's A13 remaining items (the block between
the ``port-surface`` markers). Porting a name without taking it off the
list, or dropping one without listing it, fails here."""

import re
from pathlib import Path

import pathway_tpu as J
import pathway_tpu_torch as T

ROADMAP = Path(__file__).resolve().parent.parent / "ROADMAP.md"

# `from __future__ import annotations` leaves this feature object in the
# JAX package's namespace; it is not part of the API
_NOT_API = {"annotations"}


_MISSING = """
import json, sys
import pathway_tpu as J, pathway_tpu_torch as T

def public(obj):
    return {n for n in dir(obj) if not n.startswith("_")} - set(sys.argv[1:])

out = {f"Table.{n}" for n in public(J.Table) - public(T.Table)}
out |= public(J) - public(T)
out |= {f"io.{n}" for n in public(J.io) - public(T.io)}
out |= {f"indexing.{n}" for n in public(J.indexing) - public(T.indexing)}
print(json.dumps(sorted(out)))
"""


def _public(obj) -> set[str]:
    return {n for n in dir(obj) if not n.startswith("_")} - _NOT_API


def _missing() -> set[str]:
    """Measured in a fresh interpreter: a package's namespace also holds
    every submodule some earlier import loaded, so in a test process it
    depends on which tests ran before."""
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _MISSING, *_NOT_API], cwd=ROADMAP.parent,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def _listed() -> dict[str, list[str]]:
    """{item title: the backticked names after its ``Names:``}, in the
    block's order."""
    text = ROADMAP.read_text()
    block = text[text.index("<!-- port-surface begin -->"):
                 text.index("<!-- port-surface end -->")]
    items = {}
    for item in re.split(r"\n(?=\s*\d+\. \*\*)", block)[1:]:
        title = re.match(r"\s*\d+\. \*\*(.+?)\*\*", item).group(1)
        _, _, names = item.partition("Names:")
        items[title] = re.findall(r"`([A-Za-z_][\w.]*)`", names)
    return items


def test_missing_names_equal_the_roadmap_list():
    listed = _listed()
    flat = [n for names in listed.values() for n in names]
    assert len(flat) == len(set(flat)), "a name is listed twice"
    missing = _missing()
    assert set(flat) - missing == set(), "listed, but the port has it"
    assert missing - set(flat) == set(), "missing, but not listed"


def test_roadmap_items_come_in_the_port_order():
    """Joins first, then the temporal operators, sort, iterate, the
    gradual broadcast and the file connectors, then several processes,
    then the rest of the device seams; persistence before the rest of
    ``io/`` and ``stdlib/``."""
    order = list(_listed())
    assert order[:6] == ["joins", "temporal and windows", "sort", "iterate",
                         "gradual broadcast and the file connectors",
                         "several processes"]
    assert order[6] == "the rest of the device seams"
    assert order[8:10] == ["persistence", "the rest of `io/` and `stdlib/`"]


def test_the_port_has_what_the_slice_carries():
    for name in ("select", "with_columns", "filter", "concat", "concat_reindex",
                 "update_rows", "update_cells", "ix", "ix_ref", "flatten", "groupby",
                 "reduce", "deduplicate", "with_id", "with_id_from", "difference",
                 "intersect", "restrict", "promise_universe_is_subset_of",
                 "asof_join", "asof_now_join", "interval_join", "window_join",
                 "windowby", "diff", "interpolate", "sort"):
        assert name in _public(T.Table), name
    for name in ("run", "run_all", "udf", "UDF", "udfs", "Schema", "Table", "this",
                 "reducers", "apply", "apply_with_type", "apply_async", "G",
                 "clear_graph", "EngineConfig", "io", "debug", "indexing",
                 "DateTimeNaive", "DateTimeUtc", "Duration", "AsofJoinResult",
                 "IntervalJoinResult", "WindowJoinResult", "temporal", "ordered",
                 "statistical", "iterate", "iterate_universe", "graphs",
                 "persistence", "PersistenceMode"):
        assert name in _public(T), name
    for name in ("SortedIndex", "build_sorted_index", "retrieve_prev_next_values",
                 "sort_from_index", "sorting"):
        assert name in _public(T.indexing), name
    assert "_gradual_broadcast" in dir(T.Table)
