"""Extraction pipeline CLI: ``python -m lean_explore_tpu_torch.extract``.

The JAX CLI's flags (lean_explore_tpu/extract/__main__.py) in argparse:
every stage runs unless stage flags pick some, each stage is resumable, and
output goes to a new timestamped directory under the data root
(LEAN_EXPLORE_DATA_DIR), or the newest one with --use-latest.

The port runs the device stages, ``--embed`` and ``--index``, on CUDA
unless the environment asks for the CPU (util.platform.requested_device).
``--run-doc-gen4``, ``--parse`` and ``--informalize`` need a Lean
toolchain or the network; each raises NotImplementedError before any stage
runs (ROADMAP A10), and so does a run without stage flags, which includes
them.
"""

import argparse
import logging
import sys
from pathlib import Path

from lean_explore_tpu_torch.config import Config
from lean_explore_tpu_torch.extract.embeddings import DEFAULT_BATCH_SIZE
from lean_explore_tpu_torch.models.store import DeclarationStore
from lean_explore_tpu_torch.util.platform import requested_device

logger = logging.getLogger(__name__)

UNPORTED_STAGES = {
    "run_docgen": "doc-gen4 needs a Lean toolchain",
    "run_parse": "parsing reads doc-gen4's output, which needs a Lean toolchain",
    "run_informalize": "informalization calls an LLM over the network",
}


def run_pipeline(
    extraction_path: Path,
    *,
    run_embed: bool,
    run_index: bool,
    embed_batch_size: int,
    limit: int | None,
) -> None:
    """The embed and index stages on ``extraction_path/declarations.db``."""
    store = DeclarationStore(extraction_path / "declarations.db", create=True)
    try:
        if run_embed:
            from lean_explore_tpu_torch.extract.embeddings import generate_embeddings

            logger.info("=== stage: embeddings ===")
            generate_embeddings(
                store,
                batch_size=embed_batch_size,
                limit=limit,
                device=requested_device(),
            )
        if run_index:
            from lean_explore_tpu_torch.extract.index import build_indices

            logger.info("=== stage: index artifacts ===")
            build_indices(store, extraction_path)
    finally:
        store.close()


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
         help="Root of Lean package workspaces (doc-gen4 and parse only).")
    flag("--model", dest="informalize_model", default="google/gemini-3-flash-preview",
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
    unported = [why for s, why in UNPORTED_STAGES.items() if getattr(args, s)]
    if unported:
        raise NotImplementedError(
            f"{'; '.join(unported)}: not ported (ROADMAP A10). Run only "
            "--embed and/or --index on a store that holds informalizations."
        )

    if args.use_latest:
        extraction_path = Config.get_latest_extraction_path()
        if extraction_path is None:
            print("No existing extraction directory found.", file=sys.stderr)
            return 1
    else:
        extraction_path = Config.create_timestamped_extraction_path()
    print(f"Extraction directory: {extraction_path}")

    run_pipeline(
        extraction_path,
        run_embed=args.run_embed,
        run_index=args.run_index,
        embed_batch_size=args.embed_batch_size,
        limit=args.limit,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
