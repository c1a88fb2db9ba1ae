"""HF checkpoint loaders (copy of the HF half of
``pathway_tpu/models/checkpoint.py``).

A LOCAL HuggingFace checkpoint directory (``config.json`` and
``model.safetensors`` or ``pytorch_model.bin``) becomes the JAX package's
parameter layout as numpy arrays: BERT-family encoders with the per-layer
Q/K/V fused into one ``(hidden, 3 * hidden)`` operand and the layers
stacked on a leading axis, the cross-encoder's classifier head, and GPT-2
decoders. ``params.from_jax_params`` turns that layout into the port's
tensors, so one carrier of weights serves both sources. ``safetensors`` is
read with numpy alone; ``.bin`` files go through ``torch.load``. Neither
``transformers`` nor ``safetensors`` is needed.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from pathway_tpu_torch.models.decoder import DecoderConfig
from pathway_tpu_torch.models.transformer import TransformerConfig

_ST_DTYPES: dict[str, Any] = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


def _bf16_to_f32(raw: bytes, shape: tuple[int, ...]) -> np.ndarray:
    """bfloat16 is f32 with the low 16 mantissa bits dropped; widen by
    left-shifting into the high half of a u32."""
    u16 = np.frombuffer(raw, dtype=np.uint16)
    u32 = u16.astype(np.uint32) << 16
    return u32.view(np.float32).reshape(shape)


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """Pure-numpy safetensors reader (format: u64 header length, JSON header
    with per-tensor dtype/shape/data_offsets, then one flat byte buffer)."""
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(header_len))
        buf = f.read()
    out: dict[str, np.ndarray] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        raw = buf[start:end]
        shape = tuple(meta["shape"])
        dt = meta["dtype"]
        if dt == "BF16":
            out[name] = _bf16_to_f32(raw, shape)
        else:
            np_dt = _ST_DTYPES.get(dt)
            if np_dt is None:
                raise ValueError(f"unsupported safetensors dtype {dt!r} for {name!r}")
            out[name] = np.frombuffer(raw, dtype=np_dt).reshape(shape)
    return out


_WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")


def has_checkpoint_weights(path: str) -> bool:
    """True when ``path`` is a directory holding loadable model weights —
    the single source of truth for 'does this dir have a checkpoint', shared
    with the xpack loaders so detection can't drift from what
    ``load_hf_state_dict`` actually accepts."""
    return os.path.isdir(path) and any(
        os.path.exists(os.path.join(path, f)) for f in _WEIGHT_FILES
    )


def load_hf_state_dict(path: str) -> dict[str, np.ndarray]:
    """Load a checkpoint directory's (or file's) weights as numpy arrays.

    Resolution order matches HF: ``model.safetensors`` then
    ``pytorch_model.bin`` (through ``torch.load(weights_only=True)``). A
    direct file path of either kind also works.
    """
    if os.path.isdir(path):
        for candidate in _WEIGHT_FILES:
            fp = os.path.join(path, candidate)
            if os.path.exists(fp):
                path = fp
                break
        else:
            raise FileNotFoundError(
                f"no model.safetensors or pytorch_model.bin under {path!r}"
            )
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in sd.items()}


def config_from_hf(path_or_cfg: str | dict) -> TransformerConfig:
    """Build a TransformerConfig from an HF ``config.json`` (path to the
    checkpoint dir, the json file, or an already-parsed dict)."""
    cfg = path_or_cfg
    if isinstance(cfg, str):
        if os.path.isdir(cfg):
            cfg = os.path.join(cfg, "config.json")
        with open(cfg) as f:
            cfg = json.load(f)
    act = cfg.get("hidden_act", "gelu")
    if act != "gelu":
        # the forward hardcodes exact-erf gelu (what BERT/MiniLM train with);
        # loading a relu/gelu_new checkpoint would silently produce wrong
        # outputs
        raise ValueError(
            f"unsupported hidden_act {act!r}: only 'gelu' checkpoints load"
        )
    model_type = cfg.get("model_type", "bert")
    if model_type not in ("bert", None):
        # e.g. roberta uses offset position ids (padding_idx+1) that this
        # converter does not apply
        raise ValueError(f"unsupported model_type {model_type!r}: BERT-family only")
    return TransformerConfig(
        vocab_size=cfg["vocab_size"],
        hidden=cfg["hidden_size"],
        layers=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"],
        intermediate=cfg["intermediate_size"],
        max_position=cfg.get("max_position_embeddings", 512),
        type_vocab=cfg.get("type_vocab_size", 2),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
    )


_PREFIXES = ("bert.", "auto_model.", "0.auto_model.", "model.")


def _strip_prefix(state: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Normalize away wrapper prefixes (BertModel inside
    BertForSequenceClassification, sentence-transformers module nesting)."""
    out = dict(state)
    for prefix in _PREFIXES:
        if any(k.startswith(prefix + "embeddings.") for k in out):
            out = {
                (k[len(prefix):] if k.startswith(prefix) else k): v
                for k, v in out.items()
            }
    return out


def params_from_hf_bert(
    state: dict[str, np.ndarray], cfg: TransformerConfig
) -> dict:
    """Re-lay an HF BERT state dict into the stacked fused-QKV layout.

    torch Linear stores ``W`` with ``y = x @ W.T`` — every dense weight is
    transposed here so the forward's ``x @ w`` layout holds.
    """
    state = _strip_prefix(state)
    pd = np.float32

    def get(name: str) -> np.ndarray:
        if name not in state:
            raise KeyError(
                f"checkpoint is missing {name!r}; not a BERT-family encoder? "
                f"(has {sorted(state)[:5]}...)"
            )
        return np.asarray(state[name], dtype=pd)

    emb = {
        "word": get("embeddings.word_embeddings.weight"),
        "position": get("embeddings.position_embeddings.weight"),
        "type": get("embeddings.token_type_embeddings.weight"),
        "ln_scale": get("embeddings.LayerNorm.weight"),
        "ln_bias": get("embeddings.LayerNorm.bias"),
    }
    if emb["word"].shape != (cfg.vocab_size, cfg.hidden):
        raise ValueError(
            f"vocab/hidden mismatch: checkpoint {emb['word'].shape} vs config "
            f"({cfg.vocab_size}, {cfg.hidden})"
        )

    stacked: dict[str, list[np.ndarray]] = {
        k: []
        for k in (
            "qkv_w", "qkv_b", "attn_out_w", "attn_out_b", "ln1_scale",
            "ln1_bias", "mlp_in_w", "mlp_in_b", "mlp_out_w", "mlp_out_b",
            "ln2_scale", "ln2_bias",
        )
    }
    for i in range(cfg.layers):
        p = f"encoder.layer.{i}."
        q_w = get(p + "attention.self.query.weight")
        k_w = get(p + "attention.self.key.weight")
        v_w = get(p + "attention.self.value.weight")
        stacked["qkv_w"].append(
            np.concatenate([q_w.T, k_w.T, v_w.T], axis=1)  # (h, 3h)
        )
        stacked["qkv_b"].append(
            np.concatenate(
                [
                    get(p + "attention.self.query.bias"),
                    get(p + "attention.self.key.bias"),
                    get(p + "attention.self.value.bias"),
                ]
            )
        )
        stacked["attn_out_w"].append(get(p + "attention.output.dense.weight").T)
        stacked["attn_out_b"].append(get(p + "attention.output.dense.bias"))
        stacked["ln1_scale"].append(get(p + "attention.output.LayerNorm.weight"))
        stacked["ln1_bias"].append(get(p + "attention.output.LayerNorm.bias"))
        stacked["mlp_in_w"].append(get(p + "intermediate.dense.weight").T)
        stacked["mlp_in_b"].append(get(p + "intermediate.dense.bias"))
        stacked["mlp_out_w"].append(get(p + "output.dense.weight").T)
        stacked["mlp_out_b"].append(get(p + "output.dense.bias"))
        stacked["ln2_scale"].append(get(p + "output.LayerNorm.weight"))
        stacked["ln2_bias"].append(get(p + "output.LayerNorm.bias"))

    layers = {k: np.stack(v) for k, v in stacked.items()}

    if "pooler.dense.weight" in state:
        pooler = {
            "w": get("pooler.dense.weight").T,
            "b": get("pooler.dense.bias"),
        }
    else:
        # sentence-transformers exports often drop the unused pooler; an
        # identity stand-in keeps the layout (mean pooling never reads it)
        pooler = {
            "w": np.eye(cfg.hidden, dtype=pd),
            "b": np.zeros((cfg.hidden,), dtype=pd),
        }

    return {"embeddings": emb, "layers": layers, "pooler": pooler}


def classifier_head_from_hf(state: dict[str, np.ndarray]) -> dict:
    """Sequence-classification head (cross-encoder score): HF
    ``classifier.{weight,bias}`` with weight (num_labels, hidden)."""
    for wk, bk in (
        ("classifier.weight", "classifier.bias"),
        ("classifier.dense.weight", "classifier.dense.bias"),
    ):
        if wk in state:
            return {
                "w": np.asarray(state[wk], np.float32).T,
                "b": np.asarray(state[bk], np.float32),
            }
    raise KeyError("checkpoint has no classifier head (classifier.weight)")


def load_encoder_checkpoint(
    path: str, cfg: TransformerConfig | None = None
) -> tuple[dict, TransformerConfig, dict | None]:
    """One-call loader: (numpy params, config, classifier head or None)."""
    if cfg is None:
        cfg = config_from_hf(path)
    raw = load_hf_state_dict(path)
    params = params_from_hf_bert(raw, cfg)
    head = None
    try:
        head = classifier_head_from_hf(_strip_prefix(raw))
    except KeyError:
        pass
    return params, cfg, head


# ---------------------------------------------------------------- decoder


def decoder_config_from_hf(path_or_cfg: "str | dict") -> DecoderConfig:
    """GPT-2 family ``config.json`` → DecoderConfig."""
    if isinstance(path_or_cfg, str):
        with open(os.path.join(path_or_cfg, "config.json")) as f:
            c = json.load(f)
    else:
        c = dict(path_or_cfg)
    return DecoderConfig(
        vocab_size=c.get("vocab_size", 50257),
        hidden=c.get("n_embd", 768),
        layers=c.get("n_layer", 12),
        heads=c.get("n_head", 12),
        intermediate=c.get("n_inner") or 4 * c.get("n_embd", 768),
        max_position=c.get("n_positions", 1024),
        layer_norm_eps=c.get("layer_norm_epsilon", 1e-5),
    )


def params_from_hf_gpt2(state: dict[str, np.ndarray], cfg) -> dict:
    """Re-lay an HF GPT-2 state dict into the stacked decoder layout
    (``models/decoder.py``).

    GPT-2's dense layers are ``Conv1D`` modules storing ``W`` as (in, out)
    with ``y = x @ W`` — the decoder's layout already — so unlike the BERT
    converter no transposes are needed. ``lm_head.weight`` is tied to
    ``wte`` and carries no separate tensor."""
    state = {
        (k[len("transformer."):] if k.startswith("transformer.") else k): v
        for k, v in state.items()
    }
    pd = np.float32

    def get(name: str) -> np.ndarray:
        if name not in state:
            raise KeyError(
                f"checkpoint is missing {name!r}; not a GPT-2-family decoder?"
                f" (has {sorted(state)[:5]}...)"
            )
        return np.asarray(state[name], dtype=pd)

    wte = get("wte.weight")
    if wte.shape != (cfg.vocab_size, cfg.hidden):
        raise ValueError(
            f"vocab/hidden mismatch: checkpoint {wte.shape} vs config "
            f"({cfg.vocab_size}, {cfg.hidden})"
        )
    stacked: dict[str, list[np.ndarray]] = {
        k: []
        for k in (
            "ln1_scale", "ln1_bias", "qkv_w", "qkv_b", "attn_out_w",
            "attn_out_b", "ln2_scale", "ln2_bias", "mlp_in_w", "mlp_in_b",
            "mlp_out_w", "mlp_out_b",
        )
    }
    for i in range(cfg.layers):
        p = f"h.{i}."
        stacked["ln1_scale"].append(get(p + "ln_1.weight"))
        stacked["ln1_bias"].append(get(p + "ln_1.bias"))
        stacked["qkv_w"].append(get(p + "attn.c_attn.weight"))  # (h, 3h)
        stacked["qkv_b"].append(get(p + "attn.c_attn.bias"))
        stacked["attn_out_w"].append(get(p + "attn.c_proj.weight"))
        stacked["attn_out_b"].append(get(p + "attn.c_proj.bias"))
        stacked["ln2_scale"].append(get(p + "ln_2.weight"))
        stacked["ln2_bias"].append(get(p + "ln_2.bias"))
        stacked["mlp_in_w"].append(get(p + "mlp.c_fc.weight"))
        stacked["mlp_in_b"].append(get(p + "mlp.c_fc.bias"))
        stacked["mlp_out_w"].append(get(p + "mlp.c_proj.weight"))
        stacked["mlp_out_b"].append(get(p + "mlp.c_proj.bias"))
    return {
        "wte": wte,
        "wpe": get("wpe.weight"),
        "layers": {k: np.stack(v) for k, v in stacked.items()},
        "ln_f_scale": get("ln_f.weight"),
        "ln_f_bias": get("ln_f.bias"),
    }


def load_decoder_checkpoint(path: str, cfg=None) -> tuple[dict, DecoderConfig]:
    """One-call loader for a local GPT-2-family checkpoint directory."""
    if cfg is None:
        cfg = decoder_config_from_hf(path)
    return params_from_hf_gpt2(load_hf_state_dict(path), cfg), cfg


# ---- the native checkpoint format ------------------------------------------
#
# A directory of ``params.npz`` (every leaf fully gathered, keys "a/b"
# joined) and ``layout.json`` (the mesh's axes and lengths, each sharded
# leaf's spec axis names, and ``weight_quant`` for int8 artifacts): the
# files JAX's ``save_checkpoint`` writes, so a checkpoint crosses the two
# packages in both directions bit for bit. bf16 leaves are stored as JAX
# stores them, 2-byte void records holding the bit patterns.

_CKPT_ARRAYS = "params.npz"
_CKPT_LAYOUT = "layout.json"
_KEY_SEP = "/"
# flat keys whose presence marks a weight-quantized artifact (the decoder's
# and the encoder's int8 format markers)
_WQ_MARKER_KEYS = ("wte_scale", "embeddings/word_scale")


class QuantizedCheckpointError(RuntimeError):
    """A weight-quantized checkpoint loaded without ``weight_quant="int8"``:
    an unquantized forward cannot read its int8 payloads, and a silent
    dequant would give up the quality pin."""


def _flatten_tree(tree: dict, prefix: str = "") -> dict[str, Any]:
    flat: dict[str, Any] = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{_KEY_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten_tree(v, name))
        else:
            flat[name] = v
    return flat


def _unflatten_tree(flat: dict[str, Any]) -> dict:
    tree: dict = {}
    for name, v in flat.items():
        parts = name.split(_KEY_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _leaf_spec_names(leaf) -> list | None:
    """A sharded leaf's spec axis names as a JSON row, None when it has
    none (host, plain or fully replicated tensors)."""
    from pathway_tpu_torch.parallel.mesh import ShardedTensor

    if not isinstance(leaf, ShardedTensor) or leaf.spec is None:
        return None
    names = [list(p) if isinstance(p, tuple) else p for p in leaf.spec]
    return names if any(n is not None for n in names) else None


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2 or a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def save_checkpoint(path: str, params: dict, *, mesh=None) -> None:
    """Write ``params`` (a nested dict of tensors, sharded or not) as a
    checkpoint directory: gathered arrays in ``params.npz`` and
    ``layout.json`` with the mesh and each sharded leaf's spec names.
    Saving from a mesh gathers, so the bytes never depend on the topology."""
    from pathway_tpu_torch.engine.state import host_state_pytree

    os.makedirs(path, exist_ok=True)
    flat = _flatten_tree(params)
    arrays = {k: _to_numpy(v) for k, v in _flatten_tree(host_state_pytree(params)).items()}
    layout: dict[str, Any] = {
        "format": 1,
        "mesh": None,
        "specs": {k: names for k, v in flat.items()
                  if (names := _leaf_spec_names(v)) is not None},
    }
    if any(k in flat for k in _WQ_MARKER_KEYS):
        layout["weight_quant"] = "int8"
    if mesh is not None:
        layout["mesh"] = {"axes": [str(a) for a in mesh.axis_names],
                          "shape": [int(mesh.shape[a]) for a in mesh.axis_names]}
    with open(os.path.join(path, _CKPT_ARRAYS), "wb") as fh:
        np.savez(fh, **arrays)
    with open(os.path.join(path, _CKPT_LAYOUT), "w") as fh:
        json.dump(layout, fh, indent=1, sort_keys=True)


def checkpoint_layout(path: str) -> dict:
    """The saved layout (mesh axes and lengths, per-leaf spec names)."""
    with open(os.path.join(path, _CKPT_LAYOUT)) as fh:
        return json.load(fh)


def load_checkpoint(path: str, *, mesh=None, specs=None, weight_quant=None) -> dict:
    """A checkpoint back as a nested dict of tensors.

    ``mesh=None`` gives host (CPU) tensors. With a mesh each leaf is placed
    by ``specs`` (a nested spec dict, or ``{flat_key: spec}``) when it names
    the leaf, else by replaying the saved spec names on the target mesh: an
    axis the mesh lacks, or whose length does not divide the dim, drops to
    replicated. A quantized artifact raises
    :class:`QuantizedCheckpointError` unless ``weight_quant="int8"``."""
    from pathway_tpu_torch.models.transformer import parse_weight_quant
    from pathway_tpu_torch.parallel.mesh import P, place_pytree

    with np.load(os.path.join(path, _CKPT_ARRAYS)) as z:
        flat = {k: _from_numpy(z[k]) for k in z.files}
    layout = checkpoint_layout(path)
    if (layout.get("weight_quant") or any(k in flat for k in _WQ_MARKER_KEYS)) \
            and not parse_weight_quant(weight_quant):
        raise QuantizedCheckpointError(
            f"{path!r} holds int8-quantized weights (layout weight_quant="
            f"{layout.get('weight_quant')!r}) but weight_quant is off: refusing "
            "to load int8 payloads into an unquantized config. Pass "
            "weight_quant='int8', or save an unquantized checkpoint.")
    if mesh is None:
        return _unflatten_tree(flat)
    saved = layout.get("specs", {})
    if specs is not None and any(isinstance(v, dict) for v in specs.values()):
        specs = _flatten_tree(specs)

    def keep(axes, dim: int):
        kept = tuple(a for a in axes if a in mesh.shape)
        size = 1
        for a in kept:
            size *= mesh.shape[a]
        return kept if kept and dim % size == 0 else None

    def spec_for(key: str, shape):
        if specs is not None and key in specs:
            return specs[key]
        parts = []
        for i, n in enumerate((saved.get(key) or [])[:len(shape)]):
            kept = keep(n if isinstance(n, list) else ([n] if n else []), int(shape[i]))
            parts.append(kept if kept and len(kept) > 1 else (kept[0] if kept else None))
        return P(*parts)

    placed = place_pytree(flat, mesh, {k: spec_for(k, v.shape) for k, v in flat.items()})
    return _unflatten_tree(placed)
