"""ML helper utilities (counterpart of ``pathway_tpu/stdlib/ml/utils.py``,
reference ``stdlib/ml/utils.py``)."""

from __future__ import annotations

from pathway_tpu_torch.internals import reducers


def classifier_accuracy(predicted_labels, exact_labels):
    """Tally predicted-vs-exact label matches: returns a table grouped by
    the boolean ``match`` with counts (reference ``ml/utils.py:13``)."""
    predicted_labels.promise_universe_is_subset_of(exact_labels)
    comparative = predicted_labels.select(
        predicted_label=predicted_labels.predicted_label,
        label=exact_labels.restrict(predicted_labels).label,
    )
    comparative = comparative + comparative.select(
        match=comparative.label == comparative.predicted_label
    )
    accuracy = comparative.groupby(comparative.match).reduce(
        cnt=reducers.count(),
        value=comparative.match,
    )
    return accuracy
