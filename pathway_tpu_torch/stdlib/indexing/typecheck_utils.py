"""Column type validation helpers (reference
``stdlib/indexing/typecheck_utils.py``)."""

from __future__ import annotations


def check_column_reference_type(column, expected, name: str = "column") -> None:
    """Validate a ColumnReference's dtype against ``expected`` (a DType or
    tuple of DTypes); ANY always passes."""
    from pathway_tpu_torch.internals import dtype as dt
    from pathway_tpu_torch.internals.type_interpreter import infer_dtype

    try:
        actual = infer_dtype(column, getattr(column, "table", None))
    except Exception:  # noqa: BLE001
        return
    if actual == dt.ANY:
        return
    allowed = expected if isinstance(expected, tuple) else (expected,)
    if actual not in allowed and actual.strip_optional() not in allowed:
        raise TypeError(
            f"{name} has dtype {actual!r}; expected one of {allowed!r}"
        )
