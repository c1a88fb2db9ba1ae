"""Document parser UDFs (reference ``xpacks/llm/parsers.py:53-928``).

Each parser maps raw ``bytes`` to ``list[(text, metadata)]``. ``ParseUtf8``
is dependency-free; the rich-format parsers (unstructured / pypdf /
openparse) follow the reference's class surface and raise ``ImportError``
when their package is missing. The vision parsers (``ImageParser``,
``SlideParser``, ``parse_images`` and the default vision LLM) are not
ported yet (ROADMAP A13).
"""

from __future__ import annotations

import logging
from typing import Callable

import pathway_tpu_torch as pw

logger = logging.getLogger(__name__)


class ParseUtf8(pw.UDF):
    """Decode UTF-8 text (reference ``ParseUtf8``, parsers.py:53)."""

    def __wrapped__(self, contents: bytes, **kwargs) -> list[tuple[str, dict]]:
        if isinstance(contents, str):
            return [(contents, {})]
        return [(contents.decode("utf-8", errors="replace"), {})]


# the reference renamed ParseUtf8 -> Utf8Parser in newer versions; keep both
Utf8Parser = ParseUtf8


class ParseUnstructured(pw.UDF):
    """Parse any document via the ``unstructured`` library (reference
    ``ParseUnstructured``, parsers.py:79-233). Modes: single / elements /
    paged."""

    def __init__(self, mode: str = "single", post_processors: list[Callable] | None = None, **unstructured_kwargs):
        super().__init__()
        if mode not in ("single", "elements", "paged"):
            raise ValueError(f"mode must be single, elements or paged, got {mode}")
        try:
            import unstructured.partition.auto  # noqa: F401
        except ImportError as exc:  # pragma: no cover - gated dependency
            raise ImportError(
                "ParseUnstructured requires the `unstructured` package"
            ) from exc
        self.mode = mode
        self.post_processors = post_processors or []
        self.unstructured_kwargs = unstructured_kwargs

    def __wrapped__(self, contents: bytes, **kwargs) -> list[tuple[str, dict]]:
        import io

        from unstructured.partition.auto import partition

        elements = partition(file=io.BytesIO(contents), **{**self.unstructured_kwargs, **kwargs})
        for el in elements:
            for post in self.post_processors:
                el.apply(post)
        if self.mode == "elements":
            out = []
            for el in elements:
                meta = el.metadata.to_dict() if getattr(el, "metadata", None) else {}
                meta["category"] = getattr(el, "category", None)
                out.append((str(el), meta))
            return out
        if self.mode == "paged":
            pages: dict[int, list[str]] = {}
            for el in elements:
                page = getattr(getattr(el, "metadata", None), "page_number", 1) or 1
                pages.setdefault(page, []).append(str(el))
            return [
                ("\n\n".join(texts), {"page_number": page})
                for page, texts in sorted(pages.items())
            ]
        return [("\n\n".join(str(el) for el in elements), {})]


UnstructuredParser = ParseUnstructured


class PypdfParser(pw.UDF):
    """PDF text extraction via pypdf (reference ``PypdfParser``,
    parsers.py:746-830)."""

    def __init__(self, apply_text_cleanup: bool = True, cache_strategy=None):
        super().__init__(cache_strategy=cache_strategy)
        try:
            import pypdf  # noqa: F401
        except ImportError as exc:  # pragma: no cover - gated dependency
            raise ImportError("PypdfParser requires the `pypdf` package") from exc
        self.apply_text_cleanup = apply_text_cleanup

    def __wrapped__(self, contents: bytes, **kwargs) -> list[tuple[str, dict]]:
        import io

        import pypdf

        reader = pypdf.PdfReader(io.BytesIO(contents))
        out = []
        for i, page in enumerate(reader.pages):
            text = page.extract_text() or ""
            if self.apply_text_cleanup:
                text = " ".join(text.split())
            out.append((text, {"page_number": i + 1}))
        return out


class OpenParse(pw.UDF):
    """Layout-aware PDF parsing incl. tables (reference ``OpenParse``,
    parsers.py:235-394). Gated on ``openparse``."""

    def __init__(self, table_args: dict | None = None, cache_strategy=None, **kwargs):
        super().__init__(cache_strategy=cache_strategy)
        try:
            import openparse  # noqa: F401
        except ImportError as exc:  # pragma: no cover - gated dependency
            raise ImportError("OpenParse requires the `openparse` package") from exc
        self.table_args = table_args

    def __wrapped__(self, contents: bytes, **kwargs) -> list[tuple[str, dict]]:
        import io

        import openparse

        parser = openparse.DocumentParser(table_args=self.table_args)
        doc = parser.parse(io.BytesIO(contents))
        return [(node.text, {"node_type": str(type(node).__name__)}) for node in doc.nodes]
