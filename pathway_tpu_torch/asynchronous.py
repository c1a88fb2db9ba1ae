"""DEPRECATED — content moved to ``pathway_tpu_torch.udfs`` (counterpart of
``pathway_tpu/asynchronous.py``).

Reference parity: ``python/pathway/asynchronous.py`` (deprecated alias
module forwarding to ``pathway.internals.udfs``). Kept so code written
against the old import path keeps working with a warning.
"""

from warnings import warn

from pathway_tpu_torch.internals import udfs


def __getattr__(name):
    warn(
        "pathway_tpu_torch.asynchronous is deprecated; use pathway_tpu_torch.udfs.",
        DeprecationWarning,
        stacklevel=2,
    )
    return getattr(udfs, name)
