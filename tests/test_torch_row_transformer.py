"""``@pw.transformer`` row transformers in the port against JAX's.

JAX's ``tests/test_row_transformer.py`` cases (a per-row output
attribute, a row reading another row's computed attribute through a
pointer, recursion, two class-arg tables with a private attribute, a
dangling pointer) run the same program through both packages: the
captured tables must be equal, row ids included, and equal to JAX's
expected values. A streaming case holds the update stream too."""

import pytest

import pathway_tpu as JPW
import pathway_tpu_torch as TPW
from tests.torch_engine import PACKAGES, PW, final_state, update_stream


@pytest.fixture(autouse=True)
def _clear_graphs():
    JPW.clear_graph()
    TPW.clear_graph()
    yield
    JPW.clear_graph()
    TPW.clear_graph()


def _both(program):
    out = {}
    for pkg in PACKAGES:
        PW[pkg].clear_graph()
        out[pkg] = final_state(pkg, program(PW[pkg]))
    assert out["torch"] == out["jax"]
    return out["torch"]


def _col(state, name):
    rows, cols = state
    return [r[cols.index(name)] for r in rows.values()]


def test_simple_output_attribute():
    def program(pw):
        @pw.transformer
        class add_one:
            class table(pw.ClassArg):
                a = pw.input_attribute()

                @pw.output_attribute
                def result(self) -> int:
                    return self.a + 1

        t = pw.debug.table_from_markdown("""
            a
            1
            5
            """)
        return add_one(table=t).table

    assert sorted(_col(_both(program), "result")) == [2, 6]


def test_cross_row_pointer_access():
    def program(pw):
        @pw.transformer
        class chained:
            class table(pw.ClassArg):
                val = pw.input_attribute()
                next_id = pw.input_attribute()

                @pw.output_attribute
                def doubled(self) -> int:
                    return self.val * 2

                @pw.output_attribute
                def next_doubled(self) -> int:
                    if self.next_id is None:
                        return -1
                    return self.transformer.table[self.next_id].doubled

        t = pw.debug.table_from_markdown("""
            name | val
            x    | 10
            y    | 20
            """).with_id_from(pw.this.name)
        t = t.select(pw.this.val,
                     next_id=pw.if_else(pw.this.val == 10, t.pointer_from("y"), None))
        return chained(table=t).table

    state = _both(program)
    assert dict(zip(_col(state, "doubled"), _col(state, "next_doubled"))) == {20: 40, 40: -1}


def test_recursive_fibonacci():
    def program(pw):
        @pw.transformer
        class fib:
            class series(pw.ClassArg):
                n = pw.input_attribute()

                @pw.output_attribute
                def result(self) -> int:
                    if self.n <= 1:
                        return self.n
                    return (self.transformer.series[self.pointer_from(self.n - 1)].result
                            + self.transformer.series[self.pointer_from(self.n - 2)].result)

        t = pw.debug.table_from_markdown("""
            n
            0
            1
            2
            3
            4
            5
            6
            """).with_id_from(pw.this.n)
        return fib(series=t).series

    assert sorted(_col(_both(program), "result")) == [0, 1, 1, 2, 3, 5, 8]


def _join_like(pw):
    @pw.transformer
    class join_like:
        class prices(pw.ClassArg):
            price = pw.input_attribute()

            @pw.attribute
            def with_vat(self) -> float:
                return self.price * 1.23

            @pw.output_attribute
            def gross(self) -> float:
                return self.with_vat

        class orders(pw.ClassArg):
            product_id = pw.input_attribute()
            qty = pw.input_attribute()

            @pw.output_attribute
            def total(self) -> float:
                return self.qty * self.transformer.prices[self.product_id].gross

    prices = pw.debug.table_from_markdown("""
        name | price
        pen  | 100
        ink  | 10
        """).with_id_from(pw.this.name).select(pw.this.price)
    raw = pw.debug.table_from_markdown("""
        product | qty
        pen     | 2
        ink     | 5
        """)
    orders = raw.select(product_id=raw.pointer_from(pw.this.product), qty=pw.this.qty)
    return join_like(prices=prices, orders=orders)


def test_two_tables_and_private_attribute():
    orders = _both(lambda pw: _join_like(pw).orders)
    assert sorted(round(v, 2) for v in _col(orders, "total")) == [61.5, 246.0]
    prices = _both(lambda pw: _join_like(pw).prices)
    assert prices[1] == ["gross"]  # with_vat is not exported


def test_missing_pointer_gives_error_value():
    from pathway_tpu.internals.errors import EngineError as JEngineError
    from pathway_tpu_torch.internals.errors import EngineError as TEngineError

    for pkg, err in (("jax", JEngineError), ("torch", TEngineError)):
        pw = PW[pkg]
        pw.clear_graph()

        @pw.transformer
        class deref:
            class table(pw.ClassArg):
                target = pw.input_attribute()

                @pw.output_attribute
                def val(self) -> int:
                    return self.transformer.table[self.target].target

        raw = pw.debug.table_from_markdown("""
            x
            1
            """)
        t = raw.select(target=raw.pointer_from("nonexistent"))
        with pytest.raises(err, match="error value"):
            final_state(pkg, deref(table=t).table)


def test_methods_and_transformer_errors():
    """An output ``method`` column holds a callable bound to its row (equal
    under diffing by identity), and wiring mistakes raise as JAX's."""
    def program(pw):
        @pw.transformer
        class calc:
            class table(pw.ClassArg):
                a = pw.input_attribute()

                @pw.method
                def add(self, x) -> int:
                    return self.a + x

                @pw.output_attribute
                def seven(self) -> int:
                    return self.add(7)

        t = pw.debug.table_from_markdown("""
            a
            1
            2
            """)
        return calc(table=t).table

    for pkg in PACKAGES:
        PW[pkg].clear_graph()
        rows, cols = final_state(pkg, program(PW[pkg]))
        assert cols == ["add", "seven"] and sorted(r[1] for r in rows.values()) == [8, 9]
    for pkg in PACKAGES:
        pw = PW[pkg]
        with pytest.raises(TypeError, match="no ClassArg"):
            pw.transformer(type("empty", (), {}))

        @pw.transformer
        class one:
            class table(pw.ClassArg):
                a = pw.input_attribute()

                @pw.output_attribute
                def b(self) -> int:
                    return self.a

        t = pw.debug.table_from_markdown("""
            z
            1
            """)
        with pytest.raises(TypeError, match="missing tables"):
            one()
        with pytest.raises(ValueError, match="lacks input attribute"):
            one(table=t)


def test_streaming_updates_equal_jax():
    """Rows arriving over several commits, one retracted: the transformer's
    update stream (keys, values, times, additions) equals JAX's."""
    def program(pw):
        @pw.transformer
        class ranked:
            class table(pw.ClassArg):
                v = pw.input_attribute()

                @pw.output_attribute
                def twice(self) -> int:
                    return 2 * self.v

        t = pw.debug.table_from_markdown("""
            v | __time__ | __diff__
            1 | 2        | 1
            2 | 2        | 1
            3 | 4        | 1
            2 | 6        | -1
            """)
        return ranked(table=t).table

    got = {}
    for pkg in PACKAGES:
        PW[pkg].clear_graph()
        got[pkg] = update_stream(pkg, program(PW[pkg]))
    assert got["torch"] == got["jax"]
    assert sorted(e[1][0] for e in got["torch"] if e[3]) == [2, 4, 6]
