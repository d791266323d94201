"""Embedding client: batched Qwen3 forward passes in PyTorch
(lean_explore_tpu/util/embedding_client.py).

Same surface as the JAX client: ``embed(texts, is_query)`` returning an
EmbeddingResponse, the asymmetric query prompt, the env-overridable batch
size, and ``embed_device`` whose result stays on the device for the dense
stage.
"""

import asyncio
import json
import logging
import os
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from lean_explore_tpu_torch.models import qwen3 as qwen3_mod
from lean_explore_tpu_torch.models.hf_loader import load_params
from lean_explore_tpu_torch.models.tokenizer import encode_batch, load_tokenizer
from lean_explore_tpu_torch.util.platform import resolve_device

logger = logging.getLogger(__name__)

DEFAULT_BATCH_SIZE = 64

# Qwen3-Embedding's published asymmetric query prompt.
DEFAULT_QUERY_PROMPT = (
    "Instruct: Given a web search query, retrieve relevant passages that "
    "answer the query\nQuery: "
)


@dataclass
class EmbeddingResponse:
    """Response from embedding generation (same fields as the JAX client's)."""

    texts: list[str]
    embeddings: list[list[float]]
    model: str


def _read_query_prompt(model_dir: Path) -> str:
    """Prefer the checkpoint's own sentence-transformers prompt config."""
    cfg = model_dir / "config_sentence_transformers.json"
    if cfg.exists():
        try:
            prompts = json.loads(cfg.read_text()).get("prompts", {})
            if isinstance(prompts, dict) and isinstance(prompts.get("query"), str):
                return prompts["query"]
        except (json.JSONDecodeError, OSError, AttributeError):
            logger.warning("Unreadable %s; using default query prompt", cfg)
    return DEFAULT_QUERY_PROMPT


def resolve_model_dir(model_name: str) -> Path:
    """A model id as a local directory (no downloads)."""
    direct = Path(model_name)
    if direct.exists():
        return direct
    root = os.getenv("LEAN_EXPLORE_MODELS_DIR")
    if root:
        for candidate in (
            Path(root) / model_name.replace("/", "--"),
            Path(root) / model_name.split("/")[-1],
        ):
            if candidate.exists():
                return candidate
    raise FileNotFoundError(
        f"Model {model_name!r} not found locally. Set LEAN_EXPLORE_MODELS_DIR "
        "to a directory containing the checkpoint, or pass model_dir."
    )


class EmbeddingClient:
    """Client for generating text embeddings on one device."""

    def __init__(
        self,
        model_name: str,
        *,
        model_dir: str | Path | None = None,
        max_length: int | None = 512,
        batch_size: int | None = None,
        dtype: torch.dtype = torch.bfloat16,
        query_prompt: str | None = None,
        append_eos: bool = True,
        device: str | torch.device | None = None,
    ):
        """Load tokenizer + params onto ``device`` (default CUDA).

        Args:
            model_name: HF id (reporting) or a local directory path.
            model_dir: Local checkpoint directory; defaults to model_name when
                that is an existing path, else $LEAN_EXPLORE_MODELS_DIR/<name>.
            max_length: Token truncation length.
            batch_size: Device batch; falls back to
                LEAN_EXPLORE_EMBEDDING_BATCH_SIZE, then 64.
            dtype: Parameter dtype (bf16 serving, f32 parity).
            query_prompt: Override the asymmetric query prefix.
            append_eos: Append EOS before pooling (Qwen3 embedding models).
            device: Where the params live; CUDA unless the CPU is asked for.

        LEAN_EXPLORE_FUSED_QKV=1 serves the fused projection layout
        (``qwen3.fuse_params_for_serving``).
        """
        resolved = Path(model_dir) if model_dir else resolve_model_dir(model_name)
        if batch_size is not None and batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        env_batch = os.getenv("LEAN_EXPLORE_EMBEDDING_BATCH_SIZE")
        logger.info("Loading embedding model %s from %s", model_name, resolved)
        params, config = load_params(
            resolved, dtype=dtype, device=resolve_device(device)
        )
        if os.getenv("LEAN_EXPLORE_FUSED_QKV") == "1":
            # Column-exact fusion of q/k/v and gate/up, as the JAX client.
            params = qwen3_mod.fuse_params_for_serving(params)
        self._init(
            params,
            config,
            load_tokenizer(resolved),
            model_name=model_name,
            model_dir=resolved,
            max_length=max_length if max_length is not None else 512,
            batch_size=(
                batch_size
                if batch_size is not None
                else (int(env_batch) if env_batch else DEFAULT_BATCH_SIZE)
            ),
            append_eos=append_eos,
            query_prompt=(
                query_prompt
                if query_prompt is not None
                else _read_query_prompt(resolved)
            ),
        )

    @classmethod
    def from_components(
        cls,
        params,
        config,
        tokenizer,
        *,
        model_name: str = "in-memory",
        model_dir=None,
        max_length: int = 512,
        batch_size: int = 64,
        append_eos: bool = True,
        query_prompt: str = "",
    ) -> "EmbeddingClient":
        """A client around already-loaded params (on their device), config
        and tokenizer: random-weight benchmarks and tests."""
        self = object.__new__(cls)
        self._init(
            params, config, tokenizer, model_name=model_name,
            model_dir=model_dir, max_length=max_length, batch_size=batch_size,
            append_eos=append_eos, query_prompt=query_prompt,
        )
        return self

    def _init(
        self, params, config, tokenizer, *, model_name, model_dir, max_length,
        batch_size, append_eos, query_prompt,
    ) -> None:
        """Every attribute the scoring paths touch, in one place."""
        self.model_name = model_name
        self.model_dir = model_dir
        self.max_length = max_length
        self.batch_size = batch_size
        self.append_eos = append_eos
        self.tokenizer = tokenizer
        self._tokenizer_lock = threading.Lock()
        self.params, self.config = params, config
        self.device = params["embed"].device
        self.query_prompt = query_prompt

    @property
    def dim(self) -> int:
        return self.config.hidden_size

    @torch.no_grad()
    def embed_device(self, texts: list[str], is_query: bool = False) -> torch.Tensor:
        """Embed texts -> L2-normalized f32 tensor [len(texts), H] on the
        client's device (no autograd graph, whatever the params)."""
        if not texts:
            return torch.zeros(
                (0, self.config.hidden_size), dtype=torch.float32, device=self.device
            )
        prompted = [self.query_prompt + t for t in texts] if is_query else list(texts)
        out = []
        for start in range(0, len(prompted), self.batch_size):
            chunk = prompted[start : start + self.batch_size]
            with self._tokenizer_lock:
                batch = encode_batch(
                    self.tokenizer,
                    chunk,
                    max_length=self.max_length,
                    append_eos=self.append_eos,
                )
            ids = torch.from_numpy(batch.input_ids).to(self.device)
            lengths = torch.from_numpy(
                batch.attention_mask.sum(axis=1).astype(np.int32)
            ).to(self.device)
            emb = qwen3_mod.embed_pool_from_ids(self.params, self.config, ids, lengths)
            out.append(emb[: batch.n_valid])
        return out[0] if len(out) == 1 else torch.cat(out, dim=0)

    def embed_sync(self, texts: list[str], is_query: bool = False) -> np.ndarray:
        """Embed texts -> float32 [len(texts), H], L2-normalized."""
        return self.embed_device(texts, is_query).cpu().numpy()

    async def embed(self, texts: list[str], is_query: bool = False) -> EmbeddingResponse:
        embeddings = await asyncio.to_thread(self.embed_sync, texts, is_query)
        return EmbeddingResponse(
            texts=list(texts),
            embeddings=[row.tolist() for row in embeddings],
            model=self.model_name,
        )
