"""YAML app loader (counterpart of ``pathway_tpu/internals/yaml_loader.py``;
reference ``internals/yaml_loader.py``).

``$``-tagged YAML object instantiation for declarative RAG templates:
``!pw.xpacks.llm.llms.OpenAIChat`` style constructors (``pw`` is this
package), ``$ref`` reuse and environment variable interpolation. ``yaml``
is imported when a document is loaded, not with the package.
"""

from __future__ import annotations

import importlib
import re
from typing import IO, Any

from pathway_tpu_torch.internals.config import env_interpolate

_ENV_RE = re.compile(r"\$\{?([A-Za-z_][A-Za-z_0-9]*)\}?")


def _resolve_entry(value: Any, registry: dict[str, Any]) -> Any:
    if isinstance(value, dict):
        if len(value) == 1:
            (key, payload), = value.items()
            if isinstance(key, str) and key.startswith("!"):
                return _instantiate(key[1:], payload or {}, registry)
        return {k: _resolve_entry(v, registry) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve_entry(v, registry) for v in value]
    if isinstance(value, str):
        if value.startswith("$") and value[1:] in registry:
            return registry[value[1:]]
        m = _ENV_RE.fullmatch(value)
        if m:
            # the variable the YAML names: a user's value, not a setting
            # of the library
            env_val = env_interpolate(m.group(1))
            if env_val is not None:
                return env_val
    return value


def _instantiate(path: str, payload: Any, registry: dict[str, Any]) -> Any:
    module_path, _, attr = path.rpartition(".")
    if module_path.startswith("pw."):
        module_path = "pathway_tpu_torch" + module_path[2:]
    elif module_path == "pw":
        module_path = "pathway_tpu_torch"
    obj = importlib.import_module(module_path)
    target = getattr(obj, attr)
    if isinstance(payload, dict):
        kwargs = {k: _resolve_entry(v, registry) for k, v in payload.items()}
        return target(**kwargs)
    if payload is None or payload == {}:
        return target()
    args = _resolve_entry(payload, registry)
    if isinstance(args, list):
        return target(*args)
    return target(args)


class _TagObject:
    def __init__(self, tag: str, payload: Any):
        self.tag = tag
        self.payload = payload


_LOADER = None


def _loader():
    """``yaml.SafeLoader`` with every ``!tag`` kept as a ``_TagObject``,
    built at the first load."""
    global _LOADER
    if _LOADER is None:
        import yaml

        class PathwayYamlLoader(yaml.SafeLoader):
            pass

        def _unknown_tag(loader, tag_suffix, node):
            if isinstance(node, yaml.MappingNode):
                payload = loader.construct_mapping(node, deep=True)
            elif isinstance(node, yaml.SequenceNode):
                payload = loader.construct_sequence(node, deep=True)
            else:
                payload = loader.construct_scalar(node)
            return _TagObject(tag_suffix, payload)

        PathwayYamlLoader.add_multi_constructor("!", _unknown_tag)
        _LOADER = PathwayYamlLoader
    return _LOADER


def _materialize(value: Any, registry: dict[str, Any]) -> Any:
    if isinstance(value, _TagObject):
        payload = _materialize(value.payload, registry)
        return _instantiate(value.tag, payload, registry)
    if isinstance(value, dict):
        return {k: _materialize(v, registry) for k, v in value.items()}
    if isinstance(value, list):
        return [_materialize(v, registry) for v in value]
    if isinstance(value, str):
        if value.startswith("$") and value[1:] in registry:
            return registry[value[1:]]
    return value


def load_yaml(stream: str | IO) -> Any:
    """Load a Pathway YAML app/config with ``!pw...`` object instantiation."""
    import yaml

    raw = yaml.load(stream, Loader=_loader())  # noqa: S506
    registry: dict[str, Any] = {}
    if isinstance(raw, dict):
        out: dict[str, Any] = {}
        for k, v in raw.items():
            resolved = _materialize(v, registry)
            registry[k] = resolved
            out[k] = resolved
        return out
    return _materialize(raw, registry)
