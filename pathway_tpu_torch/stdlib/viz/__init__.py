"""pathway_tpu_torch.stdlib.viz — notebook display & live plotting
(counterpart of ``pathway_tpu/stdlib/viz/``).

Importing this module attaches ``show``/``plot``/``_repr_mimebundle_`` to
``Table`` (the reference wires these the same way so `t.show()` / `t.plot()`
work without an explicit viz import, stdlib/viz/table_viz.py:20).
"""

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.viz.plotting import plot
from pathway_tpu_torch.stdlib.viz.table_viz import show, _repr_mimebundle_

Table.show = show
Table.plot = plot
Table._repr_mimebundle_ = _repr_mimebundle_

__all__ = ["plot", "show"]
