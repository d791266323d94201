"""Stages the end-to-end training scripts share
(scripts/train_torch_embedder_e2e.py, scripts/train_torch_reranker_e2e.py,
the port's counterparts of scripts/train_*_e2e.py): the synthetic task's
store, the model and learning-rate schedule they train, the step loop with
its log and timings, and a float32 index of a store embedded by a trained
or random checkpoint.

Timings (``train_steps``, ``loader_share``) are host clock seconds with
the device synchronized at their ends; they describe the run, and no
result depends on them.
"""

import os
import shutil
import sys
import time
from pathlib import Path

import torch

from lean_explore_tpu_torch.index.artifacts import build_index_artifacts, load_index_artifacts
from lean_explore_tpu_torch.models.qwen3 import Qwen3Config
from lean_explore_tpu_torch.models.store import DeclarationStore
from lean_explore_tpu_torch.search.engine import SearchEngine
from lean_explore_tpu_torch.train.contrastive import warmup_cosine_decay_schedule

QUERY_PROMPT = "query : "
# Steps before the timed rate: the first ones carry allocator and
# kernel-cache warm-up.
WARM_STEPS = 100


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fresh_dir(path: Path) -> Path:
    """``path`` as a new empty directory (an old one is removed)."""
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    return path


def make_store(corpus, data_dir: Path) -> DeclarationStore:
    """A new store of the corpus's declarations in ``data_dir``."""
    store = DeclarationStore(fresh_dir(data_dir) / "declarations.db", create=True)
    store.insert_many(corpus.declarations)
    return store


def padded_vocab(tokenizer) -> int:
    """The tokenizer's vocabulary size rounded up to a multiple of 8."""
    return (len(tokenizer.vocab) + 7) // 8 * 8


def model_config(vocab_size: int, hidden_size: int, num_layers: int) -> Qwen3Config:
    """The scripts' Qwen3 shape: 4 heads, 2 KV heads, head_dim hidden/4,
    MLP width 2 hidden."""
    return Qwen3Config(
        vocab_size=vocab_size,
        hidden_size=hidden_size,
        num_hidden_layers=num_layers,
        num_attention_heads=4,
        num_key_value_heads=2,
        head_dim=hidden_size // 4,
        intermediate_size=hidden_size * 2,
    )


def train_mesh(device: torch.device):
    """The JAX scripts' (n, 1) training mesh when torchrun started n > 1
    ranks (``parallel.mesh.init_distributed``: each rank on its card, or
    on the CPU when ``device`` is), else None: one rank trains alone."""
    ranks = int(os.environ.get("WORLD_SIZE", "1"))
    if ranks == 1:
        return None
    from lean_explore_tpu_torch.parallel.mesh import init_distributed

    return init_distributed((ranks, 1), device=device)


def rank_out(out: Path, mesh) -> Path:
    """Where a rank writes: ``out`` for rank 0 (and one rank alone), a
    ``rank<r>`` directory under it for the others, which train beside rank
    0 and stop after training."""
    if mesh is None or mesh.coords["data"] == 0:
        return out
    return out / f"rank{mesh.coords['data']}"


def lr_schedule(learning_rate: float, steps: int):
    """Warmup over min(200, steps // 10 + 1) steps from 0 to
    ``learning_rate``, then a cosine to 5% of it at ``steps``."""
    return warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=learning_rate,
        warmup_steps=min(200, steps // 10 + 1),
        decay_steps=steps,
        end_value=learning_rate * 0.05,
    )


def train_steps(
    step_fn, params, opt_state, batches, *, steps: int, batch_size: int,
    device: torch.device, log_every: int,
) -> tuple[list[dict], dict]:
    """``steps`` updates on batches drawn from ``batches`` (moved to
    ``device``); logs and records loss and accuracy every ``log_every``
    steps and at the last. Returns the history and the timings: wall
    seconds, pairs/s and ms a step over the steps after WARM_STEPS (over
    all of them in a shorter run), and the device's peak memory."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    history = []
    start = last = time.perf_counter()
    warm_at, last_step = None, 0
    for step in range(1, steps + 1):
        params, opt_state, metrics = step_fn(params, opt_state, next(batches).to(device))
        if step == WARM_STEPS and steps > WARM_STEPS:
            synchronize(device)
            warm_at = time.perf_counter()
        if step % log_every == 0 or step == steps:
            loss = float(metrics["loss"])
            accuracy = float(metrics["accuracy"])
            history.append({"step": step, "loss": round(loss, 4), "accuracy": round(accuracy, 4)})
            now = time.perf_counter()
            rate = batch_size * (step - last_step) / (now - last)
            last, last_step = now, step
            log(f"step {step}/{steps} loss {loss:.4f} acc {accuracy:.3f} ({rate:.0f} pairs/s)")
    synchronize(device)
    end = time.perf_counter()
    timed_from, timed_steps = (warm_at, steps - WARM_STEPS) if warm_at else (start, steps)
    step_s = (end - timed_from) / timed_steps
    timing = {
        "steps": steps,
        "seconds": end - start,
        "timed_steps": timed_steps,
        "pairs_per_s": batch_size / step_s,
        "step_ms": step_s * 1e3,
        "peak_memory_gib": (
            torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
        ),
    }
    return history, timing


def loader_share(timing: dict, loader, n: int = WARM_STEPS) -> None:
    """Adds to ``timing`` the loader's ms a batch, over ``n`` batches drawn
    from ``loader`` alone (the host's tokenizing and padding, no device
    work), and its share of a timed step."""
    batches = iter(loader)
    start = time.perf_counter()
    for _ in range(n):
        next(batches)
    timing["loader_ms"] = (time.perf_counter() - start) / n * 1e3
    timing["loader_share"] = timing["loader_ms"] / timing["step_ms"]
    log(
        f"training: {timing['pairs_per_s']:.1f} pairs/s over {timing['timed_steps']} "
        f"steps ({timing['step_ms']:.2f} ms a step), loader alone {timing['loader_ms']:.2f} "
        f"ms a batch ({timing['loader_share']:.1%} of a step), peak memory "
        f"{timing['peak_memory_gib']} GiB"
    )


def embed_store(store, client) -> float:
    """Embeds every declaration's informalization with ``client`` and
    writes the vectors to the store; returns the embedding's docs/s (the
    store's reads and writes left out)."""
    ids, texts = [], []
    for decl in store.iter_all(with_embeddings=False):
        ids.append(decl.id)
        texts.append(decl.informalization)
    start = time.perf_counter()
    vecs = client.embed_sync(texts, is_query=False)
    docs_per_s = len(texts) / (time.perf_counter() - start)
    store.set_embeddings(list(zip(ids, (v.tolist() for v in vecs))))
    return docs_per_s


def build_artifacts(store, data_dir: Path, art_dir: Path) -> Path:
    """The store's index artifacts written to a fresh ``art_dir``, beside a
    copy of its database."""
    fresh_dir(art_dir)
    shutil.copy(data_dir / "declarations.db", art_dir / "declarations.db")
    build_index_artifacts(store, art_dir)
    return art_dir


def open_engine(art_dir: Path, store, embedder, reranker, device) -> SearchEngine:
    """A SearchEngine over the artifacts in ``art_dir``, the dense corpus
    in float32 on ``device``."""
    return SearchEngine(
        str(art_dir),
        store=store,
        artifacts=load_index_artifacts(art_dir, dense_dtype="float32", device=device),
        embedding_client=embedder,
        reranker_client=reranker,
        device=device,
    )
