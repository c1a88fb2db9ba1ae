"""Shared helpers for the dataflow-engine parity tests between
``pathway_tpu`` (JAX, the reference) and ``pathway_tpu_torch`` (the port):
one program built against either package's ``pw`` namespace, run with a
given set of engine switches, read back as a final table (row ids and
values) or as its subscribe update stream.

The JAX engine reads its switches from ``PATHWAY_*`` environment flags
(set through ``monkeypatch``); the port takes them as one
``EngineConfig``. ``FLAG_ENV`` maps the one onto the other."""

import numpy as np

import pathway_tpu as JPW
import pathway_tpu_torch as TPW
from pathway_tpu.internals import run as j_run
from pathway_tpu_torch.internals import config as t_config
from pathway_tpu_torch.internals import run as t_run

PACKAGES = ("jax", "torch")
PW = {"jax": JPW, "torch": TPW}

FLAG_ENV = {
    "fusion": "PATHWAY_FUSION",
    "threads": "PATHWAY_THREADS",
    "columnar_subscribe": "PATHWAY_TPU_COLUMNAR_SUBSCRIBE",
    "drain_coalesce": "PATHWAY_TPU_DRAIN_COALESCE",
    "epoch_closeout": "PATHWAY_TPU_EPOCH_CLOSEOUT",
}


def _env_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    return str(v)


def engine_flags(pkg: str, monkeypatch, **flags):
    """The port's ``EngineConfig`` for ``flags``; for JAX, the same flags
    set in the environment (and ``None`` returned)."""
    if pkg == "torch":
        return t_config.EngineConfig(**flags)
    for name, value in flags.items():
        monkeypatch.setenv(FLAG_ENV[name], _env_value(value))
    return None


def canon(v):
    """A comparable, hashable form of a cell (numpy arrays by value)."""
    if isinstance(v, np.ndarray):
        return ("nd", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, (tuple, list)):
        return tuple(canon(x) for x in v)
    if isinstance(v, (JPW.Pointer, TPW.Pointer)):
        return ("ptr", v.value)
    return repr(v) if v is not None and not isinstance(
        v, (bool, int, float, str, bytes)) else v


def final_state(pkg: str, table, config=None):
    """{row id: canonical row} and the column names of ``table``'s final
    state after one run."""
    if pkg == "torch":
        cap = t_run.capture_table(table, config=config)
    else:
        cap = j_run.capture_table(table)
    rows = {int(k): tuple(canon(v) for v in row) for k, row in cap.state.rows.items()}
    return rows, list(cap.column_names)


def update_stream(pkg: str, table, config=None):
    """Every subscribe callback of one run, in order:
    ``(row id, canonical row, time, is_addition)``."""
    pw = PW[pkg]
    events = []

    def on_change(key, row, time, is_addition):
        events.append((key.value, tuple(canon(v) for v in row.values()), time,
                       is_addition))

    pw.io.subscribe(table, on_change=on_change)
    if pkg == "torch":
        pw.run(config=config)
    else:
        pw.run()
    return events


def last_run_stats(pkg: str):
    return (t_run if pkg == "torch" else j_run).LAST_RUN_STATS
