"""``pw.this`` / ``pw.left`` / ``pw.right`` placeholder tables.

Parity with reference ``internals/thisclass.py``: metaclass-backed sentinels
whose attribute access yields :class:`ColumnReference` objects bound to the
placeholder; table operations substitute the real table at call time
(see :mod:`pathway_tpu_torch.internals.desugaring`).
"""

from __future__ import annotations

from pathway_tpu_torch.internals.expression import ColumnReference


class ThisMetaclass(type):
    def __getattr__(cls, name: str) -> ColumnReference:
        if name.startswith("__"):
            raise AttributeError(name)
        return ColumnReference(cls, name)

    def __getitem__(cls, name) -> ColumnReference:
        if isinstance(name, ColumnReference):
            name = name.name
        return ColumnReference(cls, name)

    def __iter__(cls):
        # star-expansion marker: ``t.select(*pw.this)``
        yield _StarMarker(cls, ())

    def without(cls, *columns):
        names = tuple(c.name if isinstance(c, ColumnReference) else c for c in columns)
        return _WithoutHelper(cls, names)

    @property
    def id(cls) -> ColumnReference:
        return ColumnReference(cls, "id")

    def ix(cls, expression, *, optional: bool = False, context=None):
        from pathway_tpu_torch.internals.expression import IxExpression

        return _ThisIxHelper(cls, expression, optional)

    def ix_ref(cls, *args, optional: bool = False, instance=None):
        from pathway_tpu_torch.internals.expression import PointerExpression

        return _ThisIxHelper(
            cls, PointerExpression(cls, *args, optional=optional, instance=instance), optional
        )


class _StarMarker:
    """Expands to all columns of the substituted table."""

    def __init__(self, placeholder, excluded: tuple):
        self.placeholder = placeholder
        self.excluded = excluded


class _WithoutHelper:
    def __init__(self, placeholder, excluded: tuple):
        self.placeholder = placeholder
        self.excluded = excluded

    def __iter__(self):
        yield _StarMarker(self.placeholder, self.excluded)

    def without(self, *columns):
        names = tuple(c.name if isinstance(c, ColumnReference) else c for c in columns)
        return _WithoutHelper(self.placeholder, self.excluded + names)


class _ThisIxHelper:
    def __init__(self, placeholder, key_expr, optional: bool):
        self.placeholder = placeholder
        self.key_expr = key_expr
        self.optional = optional

    def __getattr__(self, name: str):
        from pathway_tpu_torch.internals.expression import IxExpression

        if name.startswith("__"):
            raise AttributeError(name)
        return IxExpression(self.placeholder, self.key_expr, name, self.optional)

    def __getitem__(self, name):
        from pathway_tpu_torch.internals.expression import IxExpression

        if isinstance(name, ColumnReference):
            name = name.name
        return IxExpression(self.placeholder, self.key_expr, name, self.optional)


class this(metaclass=ThisMetaclass):
    """The table a method is called on."""


class left(metaclass=ThisMetaclass):
    """The left table of a join."""


class right(metaclass=ThisMetaclass):
    """The right table of a join."""


PLACEHOLDERS = (this, left, right)
