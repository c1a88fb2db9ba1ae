"""Image parsing helpers for vision-LLM document pipelines (reference
``xpacks/llm/_parser_utils.py``)."""

from __future__ import annotations

import base64
import io
import logging

from pathway_tpu_torch.xpacks.llm.constants import DEFAULT_VISION_MODEL

logger = logging.getLogger(__name__)


def img_to_b64(img) -> str:
    """PNG-encode a PIL image to a base64 string (reference ``:18``)."""
    buffer = io.BytesIO()
    img.save(buffer, format="PNG")
    return base64.b64encode(buffer.getbuffer()).decode("utf-8")


def maybe_downscale(img, max_image_size: int, downsize_horizontal_width: int):
    """Downscale an image keeping aspect ratio if its raw RGB size exceeds
    ``max_image_size`` bytes (reference ``:25``)."""
    img_size = img.size[0] * img.size[1] * 3
    if img_size > max_image_size:
        logger.info(
            "Image size %.1fMB exceeds the limit; resizing.",
            img_size / (1024 * 1024),
        )
        ratio = img.size[1] / img.size[0]
        img = img.resize(
            (downsize_horizontal_width, int(downsize_horizontal_width * ratio))
        )
    return img


async def parse(b_64_img, llm, prompt: str, model: str | None = None, **kwargs) -> str:
    """Describe a base64 image with a vision LLM (reference ``:49``);
    falls back to the LLM's default model, then ``DEFAULT_VISION_MODEL``."""
    if model is None:
        model = getattr(llm, "model", None) or DEFAULT_VISION_MODEL
    content = [
        {"type": "text", "text": prompt},
        {
            "type": "image_url",
            "image_url": {"url": f"data:image/png;base64,{b_64_img}"},
        },
    ]
    messages = [{"role": "user", "content": content}]
    fn = getattr(llm, "__wrapped__", llm)
    import inspect

    response = fn(messages, model=model, **kwargs)
    if inspect.isawaitable(response):
        response = await response
    return response


async def parse_image_details(b_64_img, parse_schema, model: str = DEFAULT_VISION_MODEL,
                              openai_client_args: dict | None = None, **kwargs):
    """Parse a structured schema from an image via an OpenAI-compatible
    vision endpoint (reference ``:96``); needs network + the `instructor`
    package, both absent here — gated accordingly."""
    from pathway_tpu_torch.optional_import import optional_imports

    with optional_imports("xpack-llm"):
        import instructor  # noqa: F401
        import openai  # noqa: F401
    raise NotImplementedError("structured image parsing requires network access")
