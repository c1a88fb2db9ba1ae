"""Shared LLM-xpack constants (reference ``xpacks/llm/constants.py``)."""

DEFAULT_VISION_MODEL = "gpt-4o"
