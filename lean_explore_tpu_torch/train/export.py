"""Export trained params as an HF-format checkpoint directory, the
counterpart of lean_explore_tpu/train/export.py.

The inverse of ``models.hf_loader.load_params``: the layer stacks are
unstacked, linear weights transposed back to HF's [out, in], and the
result written as ``model.safetensors`` + ``config.json`` that the clients
(and any HF consumer) load. The card's machine has no ``safetensors``
package, so ``write_safetensors`` writes the format itself, byte for byte
as ``safetensors.numpy.save_file`` does for float32 tensors.
"""

import json
import logging
import shutil
import struct
from pathlib import Path

import numpy as np
import torch

from lean_explore_tpu_torch.models.qwen3 import Qwen3Config

logger = logging.getLogger(__name__)

_TOKENIZER_FILES = (
    "tokenizer.json",
    "tokenizer_config.json",
    "special_tokens_map.json",
    "vocab.json",
    "merges.txt",
)

_HF_LAYER_NAMES = {
    "input_norm": "input_layernorm.weight",
    "q_proj": "self_attn.q_proj.weight",
    "k_proj": "self_attn.k_proj.weight",
    "v_proj": "self_attn.v_proj.weight",
    "o_proj": "self_attn.o_proj.weight",
    "q_norm": "self_attn.q_norm.weight",
    "k_norm": "self_attn.k_norm.weight",
    "post_norm": "post_attention_layernorm.weight",
    "gate_proj": "mlp.gate_proj.weight",
    "up_proj": "mlp.up_proj.weight",
    "down_proj": "mlp.down_proj.weight",
}
_TRANSPOSED = {"q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"}


def config_to_hf(config: Qwen3Config) -> dict:
    """HF config.json dict for a Qwen3Config (``Qwen3Config.from_hf``'s
    inverse), with the JAX package's keys in its order."""
    return {
        "architectures": ["Qwen3ForCausalLM"],
        "model_type": "qwen3",
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "num_key_value_heads": config.num_key_value_heads,
        "head_dim": config.head_dim,
        "intermediate_size": config.intermediate_size,
        "rms_norm_eps": config.rms_norm_eps,
        "rope_theta": config.rope_theta,
        "tie_word_embeddings": config.tie_word_embeddings,
    }


def write_safetensors(tensors: dict[str, np.ndarray], path: str | Path) -> None:
    """Write float32 tensors as one .safetensors file: an 8-byte
    little-endian header length, a compact JSON header of each tensor's
    dtype, shape and byte range, padded with spaces to a multiple of 8, then
    the little-endian data, tensors in name order (the order safetensors
    gives tensors of one dtype)."""
    header, chunks, offset = {}, [], 0
    for name in sorted(tensors):
        array = tensors[name]
        if array.dtype != np.float32:
            raise TypeError(f"write_safetensors writes float32 only, got {name}: {array.dtype}")
        data = np.ascontiguousarray(array, dtype="<f4").tobytes()
        header[name] = {
            "dtype": "F32",
            "shape": list(array.shape),
            "data_offsets": [offset, offset + len(data)],
        }
        chunks.append(data)
        offset += len(data)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for data in chunks:
            f.write(data)


def export_hf_checkpoint(
    params: dict,
    config: Qwen3Config,
    out_dir: str | Path,
    *,
    tokenizer_dir: str | Path | None = None,
    query_prompt: str | None = None,
) -> Path:
    """Write params (float32) as an HF checkpoint the clients can load.

    Args:
        params: The trunk's parameter dict (on any device).
        config: Matching model config.
        out_dir: Output directory (created; existing tensors overwritten).
        tokenizer_dir: If given, tokenizer files are copied from here.
        query_prompt: If given, written to config_sentence_transformers.json
            as the ``query`` prompt the embedding client prefers.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    # A leftover sharded-checkpoint index would make the loader prefer the
    # old shards over the fresh model.safetensors.
    index = out_dir / "model.safetensors.index.json"
    if index.exists():
        index.unlink()
        for shard in out_dir.glob("model-*-of-*.safetensors"):
            shard.unlink()

    def host(x) -> np.ndarray:
        return x.detach().to(device="cpu", dtype=torch.float32).numpy()

    tensors: dict[str, np.ndarray] = {
        "model.embed_tokens.weight": host(params["embed"]),
        "model.norm.weight": host(params["final_norm"]),
    }
    for key, hf_name in _HF_LAYER_NAMES.items():
        stacked = host(params["layers"][key])
        for i in range(config.num_hidden_layers):
            mat = stacked[i].T if key in _TRANSPOSED else stacked[i]
            tensors[f"model.layers.{i}.{hf_name}"] = np.ascontiguousarray(mat)
    if not config.tie_word_embeddings:
        tensors["lm_head.weight"] = np.ascontiguousarray(host(params["lm_head"]).T)

    write_safetensors(tensors, out_dir / "model.safetensors")
    (out_dir / "config.json").write_text(json.dumps(config_to_hf(config), indent=2))
    if tokenizer_dir is not None:
        for name in _TOKENIZER_FILES:
            src = Path(tokenizer_dir) / name
            if src.exists():
                shutil.copy(src, out_dir / name)
    if query_prompt is not None:
        (out_dir / "config_sentence_transformers.json").write_text(
            json.dumps({"prompts": {"query": query_prompt}})
        )
    logger.info("exported HF checkpoint: %s (%d tensors)", out_dir, len(tensors))
    return out_dir
