"""RAG answer-quality evaluation harness (counterpart of
``pathway_tpu/xpacks/llm/rag_eval.py``).

Reference parity: ``integration_tests/rag_evals`` — ``run_eval_experiment``
(experiment.py:23-102, accuracy = mean per-question similarity) and the CI
gate ``eval_accuracy >= MIN_ACCURACY`` with ``MIN_ACCURACY = 0.6``
(test_eval.py:133,153). The reference scores answers with a RAGAS-style
LLM judge against a labeled CSV dataset served over its REST app; this
harness is its zero-network equivalent: the labeled QA set is synthesized
(the same samples as the JAX package's for the same ``n`` and ``seed``),
answers come from the port's own stack (retrieval and the decoder on the
card), and scoring is normalized exact/contains accuracy — deterministic
and runnable in CI without any external service.

The synthesized task is retrieval-grounded by construction: every question
names an entity whose answer code exists ONLY in that entity's document,
so a correct answer requires the indexer to return the right document AND
the generator to ground its answer in the retrieved context. Retrieval
misses or hallucinated codes both score 0.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

__all__ = [
    "RagSample",
    "generate_qa_dataset",
    "docs_table",
    "queries_table",
    "normalize_answer",
    "score_answer",
    "run_rag_eval",
]


@dataclass(frozen=True)
class RagSample:
    """One labeled QA example: the document holding the fact, its metadata
    path, the question, and the expected answer."""

    doc: str
    path: str
    question: str
    answer: str


_LETTERS = "abcdefghijklmnopqrstuvwxyz"
_DIGITS = "0123456789"


def generate_qa_dataset(n: int, seed: int = 0) -> list[RagSample]:
    """Synthesize ``n`` single-fact documents with unique entity names and
    unique numeric answer codes (the reference ships a hand-labeled CSV,
    ``integration_tests/rag_evals/dataset``; a synthesized set keeps the
    gate hermetic). Names are letters-only and codes digits-only so an
    answer can never accidentally appear in another document's text or in
    any path string."""
    import numpy as np

    rng = np.random.default_rng(seed)
    names: set[str] = set()
    codes: set[str] = set()
    samples: list[RagSample] = []
    while len(samples) < n:
        name = "".join(rng.choice(list(_LETTERS), 5))
        code = "".join(rng.choice(list(_DIGITS), 4))
        if name in names or code in codes:
            continue
        names.add(name)
        codes.add(code)
        samples.append(
            RagSample(
                doc=f"access code for {name} is {code}",
                path=f"/{name}.txt",
                question=f"what is the access code for {name}",
                answer=code,
            )
        )
    return samples


def docs_table(samples: list[RagSample]):
    """DocumentStore-shaped table (``data`` + ``_metadata``) for the set."""
    import pandas as pd

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.json import Json

    return pw.debug.table_from_pandas(
        pd.DataFrame(
            {
                "data": [s.doc for s in samples],
                "_metadata": [
                    Json({"path": s.path, "modified_at": i})
                    for i, s in enumerate(samples)
                ],
            }
        )
    )


def queries_table(samples: list[RagSample]):
    """pw_ai-shaped query table for ``BaseRAGQuestionAnswerer.answer_query``."""
    import pandas as pd

    import pathway_tpu_torch as pw

    n = len(samples)
    return pw.debug.table_from_pandas(
        pd.DataFrame(
            {
                "prompt": [s.question for s in samples],
                "filters": [None] * n,
                "model": [None] * n,
                "return_context_docs": [False] * n,
            }
        )
    )


def normalize_answer(text: str) -> str:
    """Lowercase, collapse whitespace, strip punctuation at the edges —
    the usual exact-match normalization for extractive QA scoring."""
    text = re.sub(r"\s+", " ", str(text)).strip().lower()
    return text.strip(".,;:!?\"'")


def score_answer(response: str, expected: str) -> tuple[bool, bool]:
    """(exact, contains) after normalization. ``contains`` is the headline
    metric: generated answers legitimately carry surrounding words."""
    got = normalize_answer(response)
    want = normalize_answer(expected)
    return got == want, want in got


def run_rag_eval(qa, samples: list[RagSample]) -> dict:
    """Run every sample's question through ``qa.answer_query`` (the full
    pipeline: retrieve -> prompt-assemble -> generate) and score.

    Returns ``{"accuracy_exact", "accuracy_contains", "n", "results"}``
    where ``results`` is per-sample ``(question, response, expected,
    contains)``. The reference's experiment writes the same per-question
    table plus the mean to MLflow (experiment.py:96-102)."""
    from pathway_tpu_torch.internals.json import unwrap_json
    from pathway_tpu_torch.internals.run import capture_table

    queries = queries_table(samples)
    by_question = {s.question: s for s in samples}
    q_cap = capture_table(queries)
    res = qa.answer_query(queries)
    cap = capture_table(res)
    q_cols = {c: i for i, c in enumerate(q_cap.column_names)}
    cols = {c: i for i, c in enumerate(cap.column_names)}
    q_rows = dict(q_cap.state.rows)
    results = []
    n_exact = n_contains = 0
    for key, row in dict(cap.state.rows).items():
        q_row = q_rows.get(key)
        question = q_row[q_cols["prompt"]] if q_row is not None else None
        sample = by_question.get(question)
        if sample is None:
            continue
        result = unwrap_json(row[cols["result"]])
        response = (
            result.get("response") if isinstance(result, dict) else result
        )
        exact, contains = score_answer(str(response), sample.answer)
        n_exact += exact
        n_contains += contains
        results.append((question, str(response), sample.answer, contains))
    n = len(results)
    return {
        "accuracy_exact": n_exact / n if n else 0.0,
        "accuracy_contains": n_contains / n if n else 0.0,
        "n": n,
        "results": results,
    }
