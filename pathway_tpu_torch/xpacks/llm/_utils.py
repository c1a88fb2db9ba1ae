"""Shared helpers for the LLM xpack (reference ``xpacks/llm/_utils.py``)."""

from __future__ import annotations

import logging
from typing import Any, TypedDict

from pathway_tpu_torch.internals.json import Json

logger = logging.getLogger(__name__)


class Doc(TypedDict, total=False):
    """A retrieved document chunk: ``text`` plus arbitrary metadata."""

    text: str
    metadata: dict
    dist: float


def _coerce_sync(fun):
    """Run an async callable synchronously if needed."""
    import asyncio
    import inspect

    if inspect.iscoroutinefunction(fun):
        def wrapper(*args, **kwargs):
            return asyncio.run(fun(*args, **kwargs))

        return wrapper
    return fun


def unwrap_udf(udf_or_callable):
    """Return the raw callable behind a UDF (or the callable itself)."""
    wrapped = getattr(udf_or_callable, "__wrapped__", None)
    if wrapped is not None and not isinstance(wrapped, type):
        return wrapped
    return udf_or_callable


def _unwrap_json(value: Any) -> Any:
    if isinstance(value, Json):
        return value.value
    return value


def _to_dict(doc: Any) -> dict:
    doc = _unwrap_json(doc)
    if isinstance(doc, dict):
        return {k: _unwrap_json(v) for k, v in doc.items()}
    return {"text": str(doc)}


def combine_metadata(docs: list[Any]) -> list[dict]:
    return [_to_dict(d) for d in docs]


def post_json(url: str, payload: dict, headers: dict | None = None,
              timeout: float | None = None):
    """POST JSON, return decoded JSON response — the one HTTP helper shared
    by VectorStoreClient and RAGClient."""
    import json
    import urllib.request

    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:  # noqa: S310
        return json.loads(resp.read().decode())


def get_func_arg_names(func):
    """Positional/keyword parameter names of ``func`` (reference
    ``xpacks/llm/_utils.py:74``); *args/**kwargs placeholders excluded."""
    import inspect

    kinds = (
        inspect.Parameter.POSITIONAL_ONLY,
        inspect.Parameter.POSITIONAL_OR_KEYWORD,
        inspect.Parameter.KEYWORD_ONLY,
    )
    return [
        p.name
        for p in inspect.signature(func).parameters.values()
        if p.kind in kinds
    ]
