"""TableSlice — a manipulable collection of column references
(reference ``internals/table_slice.py:16``; created by ``Table.slice``).

Iterating yields ``ColumnReference``s, so the idiomatic uses compose with
``select``/``with_columns`` directly::

    t.select(*t.slice.without("age"))
    t.select(*t.slice.with_prefix("p_"))
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, Mapping

from pathway_tpu_torch.internals.expression import ColumnReference


class TableSlice:
    def __init__(self, mapping: "dict[str, ColumnReference]", table):
        self._mapping = dict(mapping)
        self._table = table

    def __iter__(self) -> Iterator[ColumnReference]:
        return iter(self._mapping.values())

    def __len__(self) -> int:
        return len(self._mapping)

    def __repr__(self) -> str:
        return f"TableSlice({list(self._mapping)})"

    def keys(self) -> list[str]:
        return list(self._mapping)

    def _name_of(self, arg: "str | ColumnReference") -> str:
        if isinstance(arg, ColumnReference):
            if arg._table is not self._table:
                raise ValueError(
                    "TableSlice method arguments should refer to table of this "
                    "TableSlice"
                )
            return arg._name
        return arg

    def __getitem__(self, args):
        if isinstance(args, (list, tuple)):
            names = [self._name_of(a) for a in args]
            return TableSlice(
                {n: self._mapping[n] for n in names}, self._table
            )
        return self._mapping[self._name_of(args)]

    def __getattr__(self, name: str) -> ColumnReference:
        from pathway_tpu_torch.internals.table import Table

        mapping = object.__getattribute__(self, "_mapping")
        if name in mapping:
            # discourage method-name columns like the reference does
            # (table_slice.py:67) — note that names colliding with
            # TableSlice's OWN methods (keys/without/rename/...) never
            # reach __getattr__ and must use [] access
            if hasattr(Table, name) and name != "id":
                raise ValueError(
                    f"{name!r} is a method name. It is discouraged to use "
                    f"it as a column name. If you really want to use it, "
                    f"use [{name!r}]."
                )
            return mapping[name]
        raise AttributeError(f"TableSlice has no column {name!r}")

    def without(self, *cols: "str | ColumnReference") -> "TableSlice":
        drop = {self._name_of(c) for c in cols}
        for name in drop:
            if name not in self._mapping:
                raise KeyError(f"column {name!r} not in slice")
        return TableSlice(
            {n: r for n, r in self._mapping.items() if n not in drop},
            self._table,
        )

    def rename(
        self, rename_dict: "Mapping[str | ColumnReference, str | ColumnReference]"
    ) -> "TableSlice":
        renames = {
            self._name_of(k): self._name_of(v) for k, v in rename_dict.items()
        }
        mapping = dict(self._mapping)
        for old in renames:
            if old not in mapping:
                raise KeyError(f"column {old!r} not in slice")
            mapping.pop(old)
        for old, new in renames.items():
            # stricter than the reference (which overwrites silently): a
            # target colliding with a kept column or another rename target
            # would silently DROP a column from the slice
            if new in mapping:
                raise ValueError(
                    f"rename target {new!r} collides with an existing "
                    f"column in the slice"
                )
            mapping[new] = self._mapping[old]  # renamed keys move to the end
        return TableSlice(mapping, self._table)

    def with_prefix(self, prefix: str) -> "TableSlice":
        return TableSlice(
            {prefix + n: r for n, r in self._mapping.items()}, self._table
        )

    def with_suffix(self, suffix: str) -> "TableSlice":
        return TableSlice(
            {n + suffix: r for n, r in self._mapping.items()}, self._table
        )

    @property
    def slice(self) -> "TableSlice":
        return self
