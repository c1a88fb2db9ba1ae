"""Document parser UDFs (reference ``xpacks/llm/parsers.py:53-928``).

Each parser maps raw ``bytes`` to ``list[(text, metadata)]``. ``ParseUtf8``
is dependency-free; the rich-format parsers (unstructured / pypdf /
openparse) follow the reference's class surface and raise ``ImportError``
when their package is missing. The vision parsers (``ImageParser``,
``SlideParser`` and ``parse_images``) describe images through a chat with
vision support, as JAX's do; ``SlideParser``'s default chat,
``DEFAULT_VISION_LLM``, is an ``OpenAIChat`` with a ``DiskCache``, built
at its first use, never at import.
"""

from __future__ import annotations

import logging
from typing import Any, Callable

import pathway_tpu_torch as pw

logger = logging.getLogger(__name__)


def _default_vision_llm():
    """Lazy ``DEFAULT_VISION_LLM`` (reference ``parsers.py:45``): an
    OpenAIChat on the default vision model with disk cache + backoff; built
    on first use so importing parsers never constructs network clients."""
    from pathway_tpu_torch.internals import udfs
    from pathway_tpu_torch.xpacks.llm import llms
    from pathway_tpu_torch.xpacks.llm.constants import DEFAULT_VISION_MODEL

    return llms.OpenAIChat(
        model=DEFAULT_VISION_MODEL,
        cache_strategy=udfs.DiskCache(),
        retry_strategy=udfs.ExponentialBackoffRetryStrategy(max_retries=4),
        verbose=True,
    )


class _LazyVisionLLM:
    _inner = None

    def _resolve(self):
        if type(self)._inner is None:
            type(self)._inner = _default_vision_llm()
        return type(self)._inner

    def __call__(self, *args, **kwargs):
        return self._resolve()(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._resolve(), name)


DEFAULT_VISION_LLM = _LazyVisionLLM()


async def parse_images(images, llm, parse_prompt: str, *, run_mode: str = "parallel",
                       parse_details: bool = False, detail_parse_schema=None,
                       parse_image_details_fn=None,
                       max_image_size: int = 15 * 1024 * 1024,
                       downsize_horizontal_width: int = 1920):
    """Describe a list of PIL images with a vision LLM (reference
    ``parsers.py:parse_images``): downscale oversized images, base64-encode,
    and fan the prompts out (``run_mode``: "parallel" | "sequential")."""
    import asyncio

    from pathway_tpu_torch.xpacks.llm._parser_utils import (
        img_to_b64,
        maybe_downscale,
        parse,
        parse_image_details,
    )

    if run_mode not in ("parallel", "sequential"):
        raise ValueError(
            f"run_mode must be 'parallel' or 'sequential', got {run_mode!r}"
        )
    b64_images = [
        img_to_b64(maybe_downscale(img, max_image_size, downsize_horizontal_width))
        for img in images
    ]
    if run_mode == "sequential":
        parsed = [await parse(b64, llm, parse_prompt) for b64 in b64_images]
    else:
        parsed = list(
            await asyncio.gather(*(parse(b64, llm, parse_prompt) for b64 in b64_images))
        )
    details: list = []
    if parse_details:
        if detail_parse_schema is None:
            raise ValueError(
                "parse_details=True requires detail_parse_schema"
            )
        detail_fn = parse_image_details_fn or parse_image_details
        if run_mode == "sequential":
            details = [
                await detail_fn(b64, detail_parse_schema) for b64 in b64_images
            ]
        else:
            details = list(
                await asyncio.gather(
                    *(detail_fn(b64, detail_parse_schema) for b64 in b64_images)
                )
            )
    return parsed, details


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


class ImageParser(pw.UDF):
    """Describe images with a vision LLM (reference ``ImageParser``,
    parsers.py:396-567). Requires a chat with vision support."""

    def __init__(self, llm: Any, parse_prompt: str = "Describe the image contents.", **kwargs):
        super().__init__()
        self.llm = llm
        self.parse_prompt = parse_prompt

    def __wrapped__(self, contents: bytes, **kwargs) -> list[tuple[str, dict]]:
        import base64

        from pathway_tpu_torch.xpacks.llm._utils import _coerce_sync

        b64 = base64.b64encode(contents).decode()
        messages = [
            {
                "role": "user",
                "content": [
                    {"type": "text", "text": self.parse_prompt},
                    {
                        "type": "image_url",
                        "image_url": {"url": f"data:image/jpeg;base64,{b64}"},
                    },
                ],
            }
        ]
        response = _coerce_sync(self.llm.__wrapped__)(messages)
        return [(str(response), {})]


class SlideParser(pw.UDF):
    """Parse slide decks page-by-page with a vision LLM (reference
    ``SlideParser``, parsers.py:569-744): render each deck page to an
    image, describe every page with the vision LLM (``parse_images``, the
    same fan-out ImageParser uses), and return one ``(text, metadata)``
    chunk per slide with page numbering.

    Page rendering uses ``pdf2image`` (gated import); ``page_renderer``
    injects any ``bytes -> list[PIL.Image]`` callable instead — offline
    deployments and tests render through it without poppler installed.
    """

    def __init__(self, llm: Any = None,
                 parse_prompt: str = "Describe this slide.",
                 run_mode: str = "parallel",
                 include_page_screenshot: bool = False,
                 intermediate_image_format: str = "jpg",
                 max_image_size: int = 15 * 1024 * 1024,
                 downsize_horizontal_width: int = 1920,
                 cache_strategy=None,
                 page_renderer: Any = None, **kwargs):
        super().__init__(cache_strategy=cache_strategy)
        self.llm = llm if llm is not None else DEFAULT_VISION_LLM
        self.parse_prompt = parse_prompt
        self.run_mode = run_mode
        self.include_page_screenshot = include_page_screenshot
        self.intermediate_image_format = intermediate_image_format
        self.max_image_size = max_image_size
        self.downsize_horizontal_width = downsize_horizontal_width
        self.page_renderer = page_renderer

    def _render_pages(self, contents: bytes):
        if self.page_renderer is not None:
            return self.page_renderer(contents)
        try:
            from pdf2image import convert_from_bytes  # type: ignore
        except ImportError as exc:  # pragma: no cover - gated dependency
            raise ImportError(
                "SlideParser page rendering requires `pdf2image` (plus "
                "poppler); pass page_renderer=... to supply images another "
                "way, or use PypdfParser for text-only decks"
            ) from exc
        return convert_from_bytes(
            contents, fmt=self.intermediate_image_format
        )

    def __wrapped__(self, contents: bytes, **kwargs) -> list[tuple[str, dict]]:
        import asyncio

        from pathway_tpu_torch.internals.udfs import coerce_async
        from pathway_tpu_torch.xpacks.llm._parser_utils import img_to_b64

        pages = self._render_pages(contents)
        if not pages:
            return []
        llm_fn = (
            self.llm.__wrapped__ if isinstance(self.llm, pw.UDF) else self.llm
        )
        llm_async = coerce_async(llm_fn)

        # a plain function to carry the model: the async __wrapped__ of a
        # chat UDF (OpenAIChat) is a bound method, which takes no attribute
        # (JAX sets it on the method and fails there)
        async def fn(*args, **kw):
            return await llm_async(*args, **kw)

        # carry the llm's configured model through to parse() (which reads
        # it via getattr and passes it as a call kwarg that would otherwise
        # override the user's choice with the default vision model)
        model = getattr(self.llm, "model", None) or (
            self.llm.kwargs.get("model")
            if hasattr(self.llm, "kwargs")
            else None
        )
        if model is not None:
            fn.model = model
        parsed, _ = asyncio.run(
            parse_images(
                pages,
                fn,
                self.parse_prompt,
                run_mode=self.run_mode,
                max_image_size=self.max_image_size,
                downsize_horizontal_width=self.downsize_horizontal_width,
            )
        )
        out = []
        n = len(pages)
        for i, text in enumerate(parsed):
            meta: dict = {"page_number": i + 1, "page_count": n}
            if self.include_page_screenshot:
                meta["page_screenshot"] = img_to_b64(pages[i])
            out.append((str(text), meta))
        return out
