"""Import hygiene of the port: its serving and training paths load no JAX
and none of the packages the card's machine lacks.

A fresh interpreter imports the port, runs CPU searches through
``Service.search_batch`` (tiny random weights, a WordLevel tokenizer, a
BM25 + dense artifact set built in memory; a float32 and then an int8
dense index), a windowed dense search and a trunk forward on flash
attention (``forward_hidden(flash=True)`` at T = 256, the kernel's plain
twin on the CPU), one InfoNCE train step of ``lean_explore_tpu_torch.train``
with the documents on flash attention (forward and backward twins) and an
HF export of the trained params, a top-k through the pipelined bin-max
entry (``ops.bin_topk_pipelined``, K1's plain twin on the CPU), the index
build (a synthetic corpus and its WordLevel tokenizer, ``DenseIndex.save``,
the extract CLI's ``--embed --index --use-latest`` on the exported
checkpoint, ``evaluate_engine``), a search under the rerank cascade, the
fused int8 reranker's ``rerank_sync`` and ``scripts/eval_torch_quality.py``
(its full and cascade arms) at a tiny size, and then reports which of the
forbidden modules are in ``sys.modules``.
"""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = (
    "jax", "optax", "orbax", "lean_explore_tpu", "transformers", "tokenizers",
    "pydantic", "safetensors", "click",
)

SCRIPT = r"""
import asyncio, json, sys, tempfile
import numpy as np
import torch

from lean_explore_tpu_torch import Service, SearchEngine
from lean_explore_tpu_torch.index.artifacts import IndexArtifacts, build_bm25_name_indices
from lean_explore_tpu_torch.index.dense import DenseIndex
from lean_explore_tpu_torch.models import qwen3
from lean_explore_tpu_torch.models.store import Declaration, DeclarationStore
from lean_explore_tpu_torch.models.tokenizer import WordLevelTokenizer
from lean_explore_tpu_torch.util.embedding_client import EmbeddingClient
from lean_explore_tpu_torch.util.reranker_client import RerankerClient

words = ["nat", "add", "comm", "list", "map", "true", "false", ":", "<", ">"]
vocab = {"<pad>": 0, "<unk>": 1, "<eos>": 2}
for w in words:
    vocab.setdefault(w, len(vocab))
tokenizer = WordLevelTokenizer(
    {"model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"},
     "pre_tokenizer": {"type": "Whitespace"}},
    pad_token="<pad>", eos_token="<eos>", unk_token="<unk>",
)
config = qwen3.Qwen3Config(
    vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=8,
    intermediate_size=64,
)
gen = torch.Generator().manual_seed(0)
embedder = EmbeddingClient.from_components(
    qwen3.init_params(config, gen, device="cpu"), config, tokenizer, batch_size=8
)
reranker = RerankerClient.from_components(
    qwen3.init_params(config, gen, device="cpu"), config, tokenizer, max_length=64
)
names = [f"Nat.{a}_{b}{i}" for i, (a, b) in enumerate(
    [(x, y) for x in words[:5] for y in words[:5]])]
tmp = tempfile.mkdtemp()
store = DeclarationStore(f"{tmp}/declarations.db", create=True)
store.insert_many([
    Declaration(id=i + 1, name=n, module="M", source_text=n, source_link="l",
                informalization=f"nat add {n}")
    for i, n in enumerate(names)
])
spaced, raw = build_bm25_name_indices(names)
ids = np.arange(1, len(names) + 1)
dense = DenseIndex.build(
    np.random.default_rng(0).standard_normal((len(names), 32)), ids, device="cpu"
)
engine = SearchEngine(
    tmp, store=store,
    artifacts=IndexArtifacts(dense, spaced, raw, ids, {}),
    embedding_client=embedder, reranker_client=reranker,
    preload_metadata=True, device="cpu",
)
out = asyncio.run(Service(engine).search_batch(["nat add", "list map comm"]))
assert all(r.count > 0 for r in out), [r.count for r in out]
emb = np.random.default_rng(1).standard_normal((len(names), 32))
int8 = DenseIndex.build(emb, ids, dtype="int8", device="cpu")
engine._artifacts = IndexArtifacts(int8, spaced, raw, ids, {})
out = asyncio.run(Service(engine).search_batch(["nat add", "list map comm"]))
assert all(r.count > 0 for r in out), [r.count for r in out]
rows = np.random.default_rng(2).standard_normal((300, 32))
windowed = DenseIndex.build(rows, np.arange(300), device="cpu")
_, got = windowed.search(rows[:3], 4, method="windowed")
assert got[:, 0].tolist() == [0, 1, 2], got
flash_ids = torch.randint(3, len(vocab), (2, 256), generator=gen)
flash_mask = torch.ones(2, 256, dtype=torch.int32)
flash_mask[0, 100:] = 0
hidden = qwen3.forward_hidden(embedder.params, config, flash_ids, flash_mask, flash=True)
assert hidden.shape == (2, 256, 32) and bool(torch.isfinite(hidden).all())
from lean_explore_tpu_torch import train
from lean_explore_tpu_torch.train.export import export_hf_checkpoint
optimizer = train.make_optimizer()
params, opt_state = train.init_train_state(config, optimizer, seed=0, device="cpu")
qwen3._use_flash = lambda seq_len, device: seq_len >= 256
batch = train.ContrastiveBatch(
    flash_ids[:, :32], torch.ones(2, 32, dtype=torch.int32), flash_ids, flash_mask,
    torch.zeros(2, 2, dtype=torch.bool),
)
params, opt_state, metrics = train.make_train_step(config)(params, opt_state, batch)
assert np.isfinite(float(metrics["loss"]))
export_hf_checkpoint(params, config, f"{tmp}/export")
from lean_explore_tpu_torch.ops.bin_topk_pipelined import bin_topk_pipelined
k4_scores, k4_rows = bin_topk_pipelined(
    torch.from_numpy(rows[:2]).float(), torch.from_numpy(rows[:256]).float(), 256,
    k=4, bins=256, tile_rows=256,
)
assert k4_rows[:, 0].tolist() == [0, 1], k4_rows

import importlib.util, os
from pathlib import Path
from lean_explore_tpu_torch.config import Config, is_complete_index
from lean_explore_tpu_torch.evaluation import evaluate_engine, guard_store_vocab
from lean_explore_tpu_torch.extract import __main__ as extract_cli
from lean_explore_tpu_torch.train import synthetic
windowed.save(f"{tmp}/saved")
tok_spec = {"model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"},
            "pre_tokenizer": {"type": "Whitespace"}}
Path(f"{tmp}/export/tokenizer.json").write_text(json.dumps(tok_spec))
Path(f"{tmp}/export/tokenizer_config.json").write_text(json.dumps(
    {"pad_token": "<pad>", "eos_token": "<eos>", "unk_token": "<unk>"}))
extraction = Path(f"{tmp}/data/20260101_000000")
extraction.mkdir(parents=True)
with DeclarationStore(extraction / "declarations.db", create=True) as s:
    s.insert_many([
        Declaration(id=i + 1, name=n, module="M", source_text=n, source_link="l",
                    informalization=f"nat add {words[i % 5]} {words[i // 5]}")
        for i, n in enumerate(names)
    ])
Config.DATA_DIRECTORY, Config.CACHE_DIRECTORY = Path(f"{tmp}/data"), Path(f"{tmp}/cache")
Config.EMBEDDING_MODEL_NAME, Config.EMBEDDING_MAX_LENGTH = f"{tmp}/export", 32
os.environ["JAX_PLATFORMS"] = "cpu"
assert extract_cli.main(["--embed", "--index", "--use-latest"]) == 0
assert is_complete_index(extraction)
built = SearchEngine(extraction, embedding_client=embedder, reranker_client=reranker,
                     dense_dtype="float32", device="cpu")
guard_store_vocab(built.store, tokenizer)
metrics = evaluate_engine(built, [("nat add", names[0])], rerank_top=5)
assert metrics["n_queries"] == 1, metrics
os.environ["LEAN_EXPLORE_RERANK_CASCADE"] = "4,2"
out = asyncio.run(Service(built).search_batch(["nat add", "list map comm"], rerank_top=5))
assert all(r.count > 0 for r in out), [r.count for r in out]
del os.environ["LEAN_EXPLORE_RERANK_CASCADE"]
int8_reranker = RerankerClient.from_components(
    qwen3.quantize_params_int8(qwen3.fuse_params_for_serving(reranker.params)),
    config, tokenizer, max_length=64, int8=True,
)
assert len(int8_reranker.rerank_sync("nat add", names[:5]).scores) == 5

corpus = synthetic.make_corpus(n_decls=40, n_concepts=20, n_eval=4)
model_dir = Path(f"{tmp}/synthetic_model")
synthetic.build_wordlevel_tokenizer(corpus.texts(), model_dir)
syn_vocab = json.loads((model_dir / "tokenizer.json").read_text())["model"]["vocab"]
syn_config = qwen3.Qwen3Config(
    vocab_size=len(syn_vocab), hidden_size=32, num_hidden_layers=1,
    num_attention_heads=4, num_key_value_heads=2, head_dim=8, intermediate_size=64,
)
export_hf_checkpoint(qwen3.init_params(syn_config, gen, device="cpu"), syn_config, model_dir)
spec = importlib.util.spec_from_file_location("eval_torch_quality", "scripts/eval_torch_quality.py")
script = importlib.util.module_from_spec(spec)
spec.loader.exec_module(script)
report = script.main([
    "--embedder", str(model_dir), "--reranker", str(model_dir), "--n-decls", "40",
    "--n-concepts", "20", "--n-eval", "4", "--emb-max-length", "32",
    "--rr-max-length", "64", "--rerank-top", "5", "--device", "cpu",
])
assert report["results"]["full_pipeline"]["n_queries"] == 4, report
assert len(report["results"]) == 7, report["results"].keys()
print(json.dumps(sorted(m for m in FORBIDDEN if m in sys.modules)))
"""


def test_serving_path_imports_no_forbidden_module():
    code = f"FORBIDDEN = {FORBIDDEN!r}\n" + SCRIPT
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert loaded == [], f"the port's serving or training path imported {loaded}"
