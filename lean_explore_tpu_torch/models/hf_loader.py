"""Load HF safetensors checkpoints into the port's Qwen3 parameter dict.

The reader needs no ``safetensors`` package: a file is an 8-byte
little-endian header length, a JSON header mapping each tensor name to its
dtype, shape and byte range, then the raw bytes. Linear weights are
transposed from HF's [out, in] to [in, out] and stacked over layers, the
layout of the JAX package (lean_explore_tpu/models/hf_loader.py).
"""

import json
import logging
import struct
from pathlib import Path

import numpy as np
import torch

from lean_explore_tpu_torch.models.qwen3 import Qwen3Config
from lean_explore_tpu_torch.util.platform import resolve_device

logger = logging.getLogger(__name__)

_DTYPES = {
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


def read_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """Every tensor of one .safetensors file as a host numpy array (bf16
    widened to float32, exactly)."""
    raw = Path(path).read_bytes()
    (header_len,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8 : 8 + header_len])
    base = 8 + header_len
    tensors = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        buf = raw[base + begin : base + end]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
            array = bits.view(np.float32)
        else:
            dtype = np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<")
            array = np.frombuffer(buf, dtype=dtype)
        tensors[name] = array.reshape(shape)
    return tensors


def _open_checkpoint(model_dir: Path) -> dict[str, np.ndarray]:
    index_path = model_dir / "model.safetensors.index.json"
    if index_path.exists():
        weight_map = json.loads(index_path.read_text())["weight_map"]
        files = sorted(set(weight_map.values()))
    elif (model_dir / "model.safetensors").exists():
        files = ["model.safetensors"]
    else:
        files = sorted(p.name for p in model_dir.glob("*.safetensors"))
        if not files:
            raise FileNotFoundError(
                f"No safetensors checkpoint found under {model_dir}"
            )
    tensors: dict[str, np.ndarray] = {}
    for fname in files:
        tensors.update(read_safetensors(model_dir / fname))
    return tensors


def _maybe_strip_prefix(tensors: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Sentence-transformers checkpoints may lack the 'model.' root."""
    if any(k.startswith("model.") for k in tensors):
        return tensors
    return {
        f"model.{k}" if not k.startswith("lm_head") else k: v
        for k, v in tensors.items()
    }


def _to_torch(array, dtype, device) -> torch.Tensor:
    host = np.array(array, dtype=np.float32, order="C", copy=True)
    return torch.from_numpy(host).to(device=device, dtype=dtype)


def load_params(
    model_dir: str | Path,
    *,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device | None = None,
) -> tuple[dict, Qwen3Config]:
    """Load (params, config) from an HF model directory onto ``device``
    (CUDA unless the caller passes ``device="cpu"``)."""
    device = resolve_device(device)
    model_dir = Path(model_dir)
    config = Qwen3Config.from_dir(model_dir)
    raw = _maybe_strip_prefix(_open_checkpoint(model_dir))
    logger.info("Loaded %d tensors from %s", len(raw), model_dir)

    def take(name: str) -> np.ndarray:
        if name not in raw:
            raise KeyError(
                f"Tensor {name!r} missing from checkpoint {model_dir} "
                f"(have {len(raw)} tensors)"
            )
        return raw[name]

    def stack(pattern: str, transpose: bool) -> torch.Tensor:
        mats = [take(pattern.format(i=i)) for i in range(config.num_hidden_layers)]
        return _to_torch(
            np.stack([m.T if transpose else m for m in mats]), dtype, device
        )

    prefix = "model.layers.{i}."
    params = {
        "embed": _to_torch(take("model.embed_tokens.weight"), dtype, device),
        "layers": {
            "input_norm": stack(prefix + "input_layernorm.weight", False),
            "q_proj": stack(prefix + "self_attn.q_proj.weight", True),
            "k_proj": stack(prefix + "self_attn.k_proj.weight", True),
            "v_proj": stack(prefix + "self_attn.v_proj.weight", True),
            "o_proj": stack(prefix + "self_attn.o_proj.weight", True),
            "q_norm": stack(prefix + "self_attn.q_norm.weight", False),
            "k_norm": stack(prefix + "self_attn.k_norm.weight", False),
            "post_norm": stack(prefix + "post_attention_layernorm.weight", False),
            "gate_proj": stack(prefix + "mlp.gate_proj.weight", True),
            "up_proj": stack(prefix + "mlp.up_proj.weight", True),
            "down_proj": stack(prefix + "mlp.down_proj.weight", True),
        },
        "final_norm": _to_torch(take("model.norm.weight"), dtype, device),
        "lm_head": None,
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = _to_torch(take("lm_head.weight").T, dtype, device)
    return params, config


def params_from_jax(
    params: dict,
    *,
    dtype: torch.dtype | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Carry a JAX-package params tree, given as nested dicts of numpy
    arrays, across to the port: the layouts are the same, so this is a
    conversion of each leaf. ``dtype=None`` keeps float32 leaves float32 and
    turns other float leaves (e.g. bf16) into bf16. Leaves go to
    ``device``, CUDA unless the caller passes ``device="cpu"``."""
    device = resolve_device(device)

    def leaf(x):
        if x is None:
            return None
        array = np.asarray(x)
        target = dtype
        if target is None:
            target = torch.float32 if array.dtype == np.float32 else torch.bfloat16
        return _to_torch(array, target, device)

    return {
        "embed": leaf(params["embed"]),
        "layers": {name: leaf(w) for name, w in params["layers"].items()},
        "final_norm": leaf(params["final_norm"]),
        "lm_head": leaf(params.get("lm_head")),
    }
