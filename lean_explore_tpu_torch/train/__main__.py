"""Training CLI: ``python -m lean_explore_tpu_torch.train``.

Contrastive fine-tuning of the embedder on (query, informalization) pairs
from a declaration store, on one device, with the JAX CLI's flags
(lean_explore_tpu/train/__main__.py):

    python -m lean_explore_tpu_torch.train \
        --model-dir /models/Qwen3-Embedding-0.6B \
        --data-dir  ~/.lean_explore_tpu/cache/<version> \
        --steps 1000 --checkpoint-dir /ckpts/run1

It runs on the current CUDA device unless the environment asks for the CPU
(``JAX_PLATFORMS`` naming cpu, or ``XLA_FLAGS`` with
xla_force_host_platform_device_count: ``util.platform.requested_device``).
Params load in float32, as the JAX CLI trains. ``--mesh`` other than one
device raises: multi-GPU training is not ported. Without ``--model-dir`` it
trains the tiny config from a seed and reads the tokenizer from the data
directory. With LEAN_EXPLORE_FLASH_ATTENTION=1 the documents' forward and
backward at T >= 256 run the flash-attention kernels.
"""

import argparse
import logging
import time
from pathlib import Path

logger = logging.getLogger(__name__)


def parse_mesh(spec: str | None) -> None:
    """Accept a one-device mesh ("1", "1,1") or none; raise otherwise."""
    if spec is None:
        return
    shape = tuple(int(x) for x in spec.split(","))
    n = 1
    for size in shape:
        n *= size
    if n != 1:
        raise NotImplementedError(
            f"--mesh {spec}: the port trains on one device; the data/model mesh "
            "is not ported (ROADMAP A7)"
        )


def main(argv=None) -> list[dict]:
    """Run the CLI; returns one record per step run: step, loss, accuracy
    and seconds (host clock around the step, which ends by reading the
    loss)."""
    parser = argparse.ArgumentParser(description="Contrastive embedder training.")
    parser.add_argument(
        "--model-dir", default=None,
        help="HF checkpoint to fine-tune; omit for random init (smoke runs).",
    )
    parser.add_argument(
        "--data-dir", required=True, help="Directory containing declarations.db."
    )
    parser.add_argument("--mesh", default=None, help="one device only (e.g. 1,1).")
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--learning-rate", type=float, default=1e-5)
    parser.add_argument("--query-max-length", type=int, default=64)
    parser.add_argument("--doc-max-length", type=int, default=256)
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--checkpoint-every", type=int, default=200)
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)
    parse_mesh(args.mesh)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )

    import torch

    from lean_explore_tpu_torch.models.qwen3 import Qwen3Config
    from lean_explore_tpu_torch.models.store import DeclarationStore
    from lean_explore_tpu_torch.models.tokenizer import load_tokenizer
    from lean_explore_tpu_torch.train import (
        ContrastiveDataLoader,
        init_train_state,
        latest_checkpoint,
        make_optimizer,
        make_train_step,
        pairs_from_store,
        restore_checkpoint,
        save_checkpoint,
    )
    from lean_explore_tpu_torch.train.contrastive import trainable
    from lean_explore_tpu_torch.util.platform import requested_device

    device = requested_device()
    logger.info("training on %s", device)
    store = DeclarationStore(Path(args.data_dir) / "declarations.db")
    pairs = pairs_from_store(store)
    if len(pairs) < args.batch_size:
        raise SystemExit(
            f"only {len(pairs)} training pairs; need >= batch size {args.batch_size}"
        )

    optimizer = make_optimizer(learning_rate=args.learning_rate)
    if args.model_dir:
        from lean_explore_tpu_torch.models.hf_loader import load_params

        params, config = load_params(args.model_dir, dtype=torch.float32, device=device)
        params = trainable(params)
        opt_state = optimizer(params)
        tokenizer = load_tokenizer(args.model_dir)
    else:
        logger.warning("no --model-dir: random-init tiny config (smoke mode)")
        config = Qwen3Config.tiny()
        params, opt_state = init_train_state(config, optimizer, seed=args.seed, device=device)
        tokenizer = load_tokenizer(args.data_dir)

    start_step = 0
    if args.checkpoint_dir:
        found = latest_checkpoint(args.checkpoint_dir)
        if found:
            start_step, path = found
            restore_checkpoint(path, {"params": params, "opt_state": opt_state})
            logger.info("resumed from step %d", start_step)

    step_fn = make_train_step(config)
    loader = ContrastiveDataLoader(
        tokenizer, pairs, batch_size=args.batch_size,
        query_max_length=args.query_max_length, doc_max_length=args.doc_max_length,
        seed=args.seed,
    )

    batches = iter(loader)
    records = []
    for step in range(start_step + 1, args.steps + 1):
        batch = next(batches).to(device)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        records.append({
            "step": step, "loss": loss, "accuracy": float(metrics["accuracy"]),
            "seconds": time.perf_counter() - t0,
        })
        if step % args.log_every == 0 or step == args.steps:
            recent = records[-args.log_every:]
            rate = args.batch_size * len(recent) / sum(r["seconds"] for r in recent)
            logger.info(
                "step %d/%d loss %.4f acc %.3f (%.1f pairs/s)",
                step, args.steps, loss, records[-1]["accuracy"], rate,
            )
        if args.checkpoint_dir and (step % args.checkpoint_every == 0 or step == args.steps):
            save_checkpoint(args.checkpoint_dir, step, params, opt_state)
    logger.info("training complete at step %d", args.steps)
    return records


if __name__ == "__main__":
    main()
