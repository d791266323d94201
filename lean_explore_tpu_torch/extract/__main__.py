"""Extraction pipeline CLI: ``python -m lean_explore_tpu_torch.extract``.

The JAX CLI's stages and flags (lean_explore_tpu/extract/__main__.py) in
argparse: schema -> doc-gen4 -> parse -> informalize -> embed -> index,
every stage unless stage flags pick some, each resumable. Output goes to a
new timestamped directory under the data root (LEAN_EXPLORE_DATA_DIR), or
the newest one with --use-latest.

doc-gen4 runs Lake in the package workspaces under --lean-root (a Lean
toolchain is needed); informalization calls OpenRouter (OPENROUTER_API_KEY).
The embed stage runs on CUDA unless the environment asks for the CPU
(util.platform.requested_device).
"""

import argparse
import asyncio
import logging
import sys
import time
from pathlib import Path

from lean_explore_tpu_torch.config import Config
from lean_explore_tpu_torch.extract.embeddings import DEFAULT_BATCH_SIZE
from lean_explore_tpu_torch.extract.informalize import DEFAULT_MODEL
from lean_explore_tpu_torch.models.store import DeclarationStore
from lean_explore_tpu_torch.util.platform import requested_device

logger = logging.getLogger(__name__)


async def run_pipeline(
    extraction_path: Path,
    *,
    run_docgen: bool,
    run_parse: bool,
    run_informalize: bool,
    run_embed: bool,
    run_index: bool,
    lean_root: Path,
    informalize_model: str,
    max_concurrent: int,
    embed_batch_size: int,
    limit: int | None,
    informalize_client=None,
    embed_client=None,
) -> dict[str, float]:
    """The stages on ``extraction_path/declarations.db``; returns the
    host-clock seconds of each stage run. The clients default to the
    OpenRouter client and the configured embedding model, as in the JAX
    pipeline; a caller may hand in its own."""
    store = DeclarationStore(extraction_path / "declarations.db", create=True)
    seconds: dict[str, float] = {}
    stage_start = time.perf_counter()

    def done(stage: str) -> None:
        nonlocal stage_start
        now = time.perf_counter()
        seconds[stage] = now - stage_start
        logger.info("stage %s: %.1f s", stage, seconds[stage])
        stage_start = now

    try:
        if run_docgen:
            from lean_explore_tpu_torch.extract.doc_gen4 import run_doc_gen4

            logger.info("=== stage: doc-gen4 ===")
            run_doc_gen4(lean_root)
            done("doc-gen4")

        if run_parse:
            from lean_explore_tpu_torch.extract.doc_parser import extract_declarations

            logger.info("=== stage: parse declarations ===")
            extract_declarations(store, lean_root)
            done("parse")

        if run_informalize:
            from lean_explore_tpu_torch.extract.informalize import informalize_declarations

            logger.info("=== stage: informalize ===")
            await informalize_declarations(
                store,
                client=informalize_client,
                model=informalize_model,
                max_concurrent=max_concurrent,
                limit=limit,
            )
            done("informalize")

        if run_embed:
            from lean_explore_tpu_torch.extract.embeddings import generate_embeddings

            logger.info("=== stage: embeddings ===")
            generate_embeddings(
                store,
                client=embed_client,
                batch_size=embed_batch_size,
                limit=limit,
                device=requested_device(),
            )
            done("embed")

        if run_index:
            from lean_explore_tpu_torch.extract.index import build_indices

            logger.info("=== stage: index artifacts ===")
            build_indices(store, extraction_path)
            done("index")
    finally:
        store.close()
    return seconds


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m lean_explore_tpu_torch.extract",
        description="Run the extraction pipeline (all stages unless specific "
        "flags given).",
    )
    flag = parser.add_argument
    flag("--run-doc-gen4", dest="run_docgen", action="store_true", help="Run only doc-gen4.")
    flag("--parse", dest="run_parse", action="store_true", help="Run only parsing.")
    flag("--informalize", dest="run_informalize", action="store_true",
         help="Run only informalization.")
    flag("--embed", dest="run_embed", action="store_true", help="Run only embedding.")
    flag("--index", dest="run_index", action="store_true", help="Run only index build.")
    flag("--use-latest", action="store_true",
         help="Reuse the most recent timestamped extraction directory.")
    flag("--lean-root", type=Path, default=None,
         help="Root of Lean package workspaces (default: configured PACKAGES_ROOT).")
    flag("--model", dest="informalize_model", default=DEFAULT_MODEL,
         help="LLM for informalization.")
    flag("--max-concurrent", type=int, default=100, help="Concurrent LLM requests.")
    flag("--batch-size", dest="embed_batch_size", type=int, default=DEFAULT_BATCH_SIZE,
         help="Corpus embedding batch size.")
    flag("--limit", type=int, default=None, help="Cap processed rows (smoke).")
    flag("--verbose", action="store_true")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s",
    )
    stages = ("run_docgen", "run_parse", "run_informalize", "run_embed", "run_index")
    if not any(getattr(args, s) for s in stages):
        for s in stages:
            setattr(args, s, True)

    if args.use_latest:
        extraction_path = Config.get_latest_extraction_path()
        if extraction_path is None:
            print("No existing extraction directory found.", file=sys.stderr)
            return 1
    else:
        extraction_path = Config.create_timestamped_extraction_path()
    print(f"Extraction directory: {extraction_path}")

    asyncio.run(
        run_pipeline(
            extraction_path,
            run_docgen=args.run_docgen,
            run_parse=args.run_parse,
            run_informalize=args.run_informalize,
            run_embed=args.run_embed,
            run_index=args.run_index,
            lean_root=args.lean_root or Config.PACKAGES_ROOT,
            informalize_model=args.informalize_model,
            max_concurrent=args.max_concurrent,
            embed_batch_size=args.embed_batch_size,
            limit=args.limit,
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
