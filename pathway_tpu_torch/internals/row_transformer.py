"""``@pw.transformer`` — class-based row transformers (counterpart of
``pathway_tpu/internals/row_transformer.py``).

Reference surface: ``python/pathway/internals/row_transformer.py`` (decorator,
``ClassArg``, ``input_attribute``/``input_method``/``attribute``/
``output_attribute``/``method``) executed by the engine's Computer machinery
(``src/engine/graph.rs:277-378`` complex columns). Re-designed for this
engine: a stateful host operator keeps the input tables materialised and
evaluates attribute functions lazily with memoisation, so rows can reference
*other rows'* computed attributes through pointers
(``self.transformer.table[ptr].attr``) — including recursively.

The dense/numeric path stays out of here on purpose: row transformers are the
framework's escape hatch for irregular, pointer-chasing logic; columnar work
belongs in expressions and UDFs, whose device work runs on the card.
"""

from __future__ import annotations

import functools
from typing import Any

from pathway_tpu_torch.engine.value import ERROR, Pointer, ref_scalar


# --------------------------------------------------------------------------- #
# attribute descriptors


class AbstractAttribute:
    is_input = False
    is_method = False
    is_output = False

    def __init__(self, **params):
        self.params = params
        self.name = params.get("name")
        self.dtype = params.get("dtype", Any)

    def __set_name__(self, owner, name):
        if self.name is None:
            self.name = name

    @property
    def output_name(self) -> str:
        return self.params.get("output_name", self.name)


class InputAttribute(AbstractAttribute):
    is_input = True


class InputMethod(AbstractAttribute):
    is_input = True
    is_method = True


class ComputedAttribute(AbstractAttribute):
    def __init__(self, func, **params):
        super().__init__(**params)
        self.func = func
        self.__doc__ = getattr(func, "__doc__", None)
        if "dtype" not in params:
            import inspect

            ann = inspect.signature(func).return_annotation
            if ann is not inspect.Signature.empty:
                self.dtype = ann


class Attribute(ComputedAttribute):
    """Computed, memoised, NOT included in the output table."""


class OutputAttribute(ComputedAttribute):
    is_output = True


class Method(ComputedAttribute):
    is_output = True
    is_method = True


def input_attribute(type: Any = Any):  # noqa: A002 - reference signature
    return InputAttribute(dtype=type)


def input_method(type: Any = Any):  # noqa: A002
    return InputMethod(dtype=type)


def attribute(func=None, **params):
    if func is None:
        return lambda f: Attribute(f, **params)
    return Attribute(func, **params)


def output_attribute(func=None, **params):
    if func is None:
        return lambda f: OutputAttribute(f, **params)
    return OutputAttribute(func, **params)


def method(func=None, **params):
    if func is None:
        return lambda f: Method(f, **params)
    return Method(func, **params)


# --------------------------------------------------------------------------- #
# ClassArg


class ClassArgMeta(type):
    _attributes: dict[str, AbstractAttribute]

    def __call__(cls, ref: "RowContext", ptr):  # type: ignore[override]
        # ``self.some_table(ptr)`` inside a compute fn: re-point the context
        return ref._evaluator.context(cls._arg_name, ptr)


class ClassArg(metaclass=ClassArgMeta):
    """Base class for a transformer's inner table classes."""

    _attributes: dict[str, AbstractAttribute] = {}
    _arg_name: str = ""

    def __init_subclass__(cls, input: Any = Any, output: Any = Any, **kw):
        super().__init_subclass__(**kw)
        attrs: dict[str, AbstractAttribute] = {}
        for name in dir(cls):
            a = getattr(cls, name, None)
            if isinstance(a, AbstractAttribute):
                attrs[a.name or name] = a
        cls._attributes = attrs
        cls._input_schema = input


# --------------------------------------------------------------------------- #
# runtime contexts


class RowContext:
    """``self`` inside attribute functions: one row of one class-arg table."""

    __slots__ = ("_evaluator", "_arg_name", "_key")

    def __init__(self, evaluator, arg_name: str, key: int):
        self._evaluator = evaluator
        self._arg_name = arg_name
        self._key = key

    @property
    def id(self) -> Pointer:
        return Pointer(self._key)

    @property
    def transformer(self) -> "TransformerContext":
        return TransformerContext(self._evaluator)

    def pointer_from(self, *args, optional: bool = False) -> Pointer:
        return ref_scalar(*args)

    def __getattr__(self, name: str):
        ev = object.__getattribute__(self, "_evaluator")
        arg_name = object.__getattribute__(self, "_arg_name")
        spec = ev.spec.class_args[arg_name]
        if name in spec._attributes:
            return ev.value(arg_name, object.__getattribute__(self, "_key"),
                            name)
        # plain class-level helpers / constants
        return getattr(spec, name)


class TableContext:
    __slots__ = ("_evaluator", "_arg_name")

    def __init__(self, evaluator, arg_name: str):
        self._evaluator = evaluator
        self._arg_name = arg_name

    def __getitem__(self, ptr) -> RowContext:
        return self._evaluator.context(self._arg_name, ptr)


class TransformerContext:
    __slots__ = ("_evaluator",)

    def __init__(self, evaluator):
        self._evaluator = evaluator

    def __getattr__(self, table_name: str) -> TableContext:
        return TableContext(object.__getattribute__(self, "_evaluator"),
                            table_name)


class BoundMethod:
    """A method column value: stable under delta-diffing (identity is the
    (table, attribute, row) triple, not the closure object)."""

    __slots__ = ("_evaluator_factory", "_arg_name", "_attr_name", "_key")

    def __init__(self, evaluator_factory, arg_name, attr_name, key):
        self._evaluator_factory = evaluator_factory
        self._arg_name = arg_name
        self._attr_name = attr_name
        self._key = key

    def __call__(self, *args):
        ev = self._evaluator_factory()
        return ev.call_method(self._arg_name, self._key, self._attr_name, args)

    def _ident(self):
        return (self._arg_name, self._attr_name, self._key)

    def __eq__(self, other):
        return isinstance(other, BoundMethod) and self._ident() == other._ident()

    def __hash__(self):
        return hash(self._ident())


class _Evaluator:
    """Lazy, memoised attribute evaluation over materialised input states."""

    def __init__(self, spec: "TransformerSpec", states: dict[str, Any],
                 input_positions: dict[str, dict[str, int]],
                 evaluator_factory):
        self.spec = spec
        self.states = states  # arg_name -> TableState
        self.input_positions = input_positions
        self.memo: dict[tuple, Any] = {}
        self.in_progress: set[tuple] = set()
        self.evaluator_factory = evaluator_factory

    def context(self, arg_name: str, key) -> RowContext:
        if isinstance(key, Pointer):
            key = key.value
        return RowContext(self, arg_name, int(key))

    def value(self, arg_name: str, key, attr_name: str):
        if isinstance(key, Pointer):
            key = key.value
        key = int(key)
        spec = self.spec.class_args[arg_name]
        attr = spec._attributes[attr_name]
        if attr.is_input:
            state = self.states[arg_name]
            row = state.get(key)
            if row is None:
                raise KeyError(
                    f"row {key} not present in transformer table {arg_name!r}"
                )
            return row[self.input_positions[arg_name][attr_name]]
        if attr.is_method:
            return BoundMethod(self.evaluator_factory, arg_name, attr_name, key)
        tag = (arg_name, key, attr_name)
        if tag in self.memo:
            return self.memo[tag]
        if tag in self.in_progress:
            raise RecursionError(
                f"cyclic attribute dependency at {arg_name}.{attr_name}"
            )
        self.in_progress.add(tag)
        try:
            val = attr.func(self.context(arg_name, key))
        finally:
            self.in_progress.discard(tag)
        self.memo[tag] = val
        return val

    def call_method(self, arg_name, key, attr_name, args):
        spec = self.spec.class_args[arg_name]
        attr = spec._attributes[attr_name]
        return attr.func(self.context(arg_name, key), *args)


# --------------------------------------------------------------------------- #
# transformer spec + decorator


class TransformerSpec:
    def __init__(self, name: str, class_args: dict[str, type[ClassArg]]):
        self.name = name
        self.class_args = class_args
        for arg_name, arg in class_args.items():
            arg._arg_name = arg_name


class TransformerResult:
    def __init__(self, tables: dict[str, Any]):
        self._tables = tables

    def __getattr__(self, name: str):
        try:
            return self._tables[name]
        except KeyError:
            raise AttributeError(name)


class RowTransformer:
    """The object `@pw.transformer` produces; calling it wires the operator."""

    def __init__(self, spec: TransformerSpec):
        self._spec = spec
        functools.update_wrapper(self, None, updated=())

    def __call__(self, **tables):
        from pathway_tpu_torch.engine.operators.row_transformer import (
            RowTransformerNode,
        )
        from pathway_tpu_torch.internals import schema as schema_mod
        from pathway_tpu_torch.internals.table import Table

        spec = self._spec
        missing = set(spec.class_args) - set(tables)
        if missing:
            raise TypeError(f"transformer {spec.name} missing tables {missing}")
        unexpected = set(tables) - set(spec.class_args)
        if unexpected:
            raise TypeError(
                f"transformer {spec.name} got unexpected tables {unexpected}"
            )

        # where each input attribute lives in its table's row tuple — held
        # per wiring (a transformer can be applied to differently-laid-out
        # tables; the spec object is shared between applications)
        input_positions: dict[str, dict[str, int]] = {}
        for arg_name, table in tables.items():
            cols = table.column_names()
            positions = {}
            for attr_name, attr in spec.class_args[arg_name]._attributes.items():
                if attr.is_input:
                    if attr_name not in cols:
                        raise ValueError(
                            f"table for {arg_name!r} lacks input attribute "
                            f"column {attr_name!r}"
                        )
                    positions[attr_name] = cols.index(attr_name)
            input_positions[arg_name] = positions

        arg_names = list(spec.class_args)
        input_nodes = [tables[n]._node for n in arg_names]
        graph = input_nodes[0].graph

        out_tables: dict[str, Table] = {}
        for arg_name, arg in spec.class_args.items():
            out_attrs = {
                a.output_name: a
                for a in arg._attributes.values()
                if a.is_output
            }
            if not out_attrs:
                continue
            node = RowTransformerNode(
                graph, input_nodes, spec, arg_names, arg_name,
                [(n, a.name) for n, a in out_attrs.items()],
                input_positions,
                name=f"transformer:{spec.name}.{arg_name}",
            )
            out_schema = schema_mod.schema_from_types(
                **{n: a.dtype for n, a in out_attrs.items()}
            )
            out_tables[arg_name] = Table(
                node, out_schema, universe=tables[arg_name]._universe
            )
        return TransformerResult(out_tables)


def transformer(cls) -> RowTransformer:
    """Decorator: turn a class with ``ClassArg`` inner classes into a
    row transformer (reference ``@pw.transformer``)."""
    class_args = {
        name: arg
        for name, arg in vars(cls).items()
        if isinstance(arg, type) and issubclass(arg, ClassArg)
    }
    if not class_args:
        raise TypeError(
            f"@pw.transformer class {cls.__name__} has no ClassArg tables"
        )
    spec = TransformerSpec(cls.__name__, class_args)
    return RowTransformer(spec)
