"""LLM informalization of declarations, dependency-ordered with caching
(lean_explore_tpu/extract/informalize.py).

Behavioral parity with the reference stage (extract/informalize.py:75-658):

- Kahn's-algorithm dependency layering, so a declaration's prerequisites are
  informalized first and can be fed into its prompt; cycles are dumped into
  one final layer.
- Cross-database cache keyed (name, source_text): every declarations.db
  under the data/cache roots is scanned, so re-extractions only pay LLM cost
  for changed declarations.
- Prompt carries up to 20 dependency descriptions, each truncated to 256
  chars; temperature 0.3; asyncio.Semaphore bounds concurrent API calls;
  results are committed in batches so crashes lose at most one batch.
- Resume: only rows with NULL informalization are processed.

A copy of the JAX module ("the reference" is the upstream lean-explore
project), with the port's store, config and OpenRouter client (on
``urllib``, each request in a worker thread under the semaphore) and its
own copy of the prompt template.
"""

import asyncio
import logging
import sqlite3
from dataclasses import dataclass
from pathlib import Path

from lean_explore_tpu_torch.config import Config
from lean_explore_tpu_torch.models.store import Declaration, DeclarationStore

logger = logging.getLogger(__name__)

DEFAULT_MODEL = "google/gemini-3-flash-preview"
PROMPT_PATH = Path(__file__).parent / "prompt.txt"
MAX_DEPENDENCIES_IN_PROMPT = 20
DEPENDENCY_DESCRIPTION_CHARS = 256


@dataclass
class InformalizationResult:
    declaration_id: int
    declaration_name: str
    informalization: str | None


def build_dependency_layers(
    declarations: list[Declaration],
) -> list[list[Declaration]]:
    """Topological layers: layer i depends only on layers < i; cycles last."""
    by_name = {d.name: d for d in declarations}
    dependents: dict[str, list[str]] = {d.name: [] for d in declarations}
    in_degree: dict[str, int] = {d.name: 0 for d in declarations}

    for decl in declarations:
        for dep in decl.dependency_names():
            if dep in by_name:
                dependents[dep].append(decl.name)
                in_degree[decl.name] += 1

    layers: list[list[Declaration]] = []
    current = [by_name[n] for n, deg in in_degree.items() if deg == 0]
    while current:
        layers.append(current)
        upcoming: list[Declaration] = []
        for decl in current:
            for dependent in dependents[decl.name]:
                in_degree[dependent] -= 1
                if in_degree[dependent] == 0:
                    upcoming.append(by_name[dependent])
        current = upcoming

    cyclic = [by_name[n] for n, deg in in_degree.items() if deg > 0]
    if cyclic:
        logger.warning("%d declarations in dependency cycles", len(cyclic))
        layers.append(cyclic)
    return layers


def discover_database_files() -> list[Path]:
    """Every declarations.db under the data and cache roots."""
    found: list[Path] = []
    for root in (Config.DATA_DIRECTORY, Config.CACHE_DIRECTORY):
        if root.exists():
            found.extend(root.rglob("declarations.db"))
    logger.info("discovered %d databases for cache scan", len(found))
    return found


def load_informalization_cache(
    database_files: list[Path],
) -> dict[tuple[str, str], str]:
    """(name, source_text) -> informalization across prior extractions."""
    cache: dict[tuple[str, str], str] = {}
    for db_path in database_files:
        try:
            conn = sqlite3.connect(str(db_path))
            try:
                rows = conn.execute(
                    "SELECT name, source_text, informalization FROM declarations "
                    "WHERE informalization IS NOT NULL"
                ).fetchall()
            finally:
                conn.close()
        except sqlite3.DatabaseError as error:
            logger.warning("skipping cache db %s: %s", db_path, error)
            continue
        for name, source_text, informalization in rows:
            cache.setdefault((name, source_text), informalization)
    logger.info("informalization cache: %d entries", len(cache))
    return cache


def render_prompt(
    template: str,
    decl: Declaration,
    informalizations_by_name: dict[str, str],
) -> str:
    """Fill the prompt template, attaching up to 20 dependency summaries."""
    dep_lines = []
    for dep_name in decl.dependency_names()[:MAX_DEPENDENCIES_IN_PROMPT]:
        description = informalizations_by_name.get(dep_name)
        if not description:
            continue
        if len(description) > DEPENDENCY_DESCRIPTION_CHARS:
            description = description[: DEPENDENCY_DESCRIPTION_CHARS - 3] + "..."
        dep_lines.append(f"- {dep_name}: {description}")
    dependencies_text = (
        "Dependencies:\n" + "\n".join(dep_lines) if dep_lines else ""
    )
    return template.format(
        name=decl.name,
        source_text=decl.source_text,
        docstring=decl.docstring or "No docstring available",
        dependencies=dependencies_text,
    )


async def informalize_declarations(
    store: DeclarationStore,
    *,
    client=None,
    model: str = DEFAULT_MODEL,
    max_concurrent: int = 100,
    commit_batch_size: int = 50,
    limit: int | None = None,
    use_cache: bool = True,
    prompt_template: str | None = None,
) -> int:
    """Generate informalizations for rows that lack one.

    Args:
        store: Target declaration store.
        client: OpenRouter-compatible client with async
            ``generate(prompt, model, temperature) -> str``; constructed from
            the environment when None.
        model: LLM id.
        max_concurrent: Semaphore bound on in-flight API calls.
        commit_batch_size: Updates per store commit.
        limit: Optional cap on processed declarations.
        use_cache: Scan prior databases for reusable informalizations.
        prompt_template: Override the bundled template.

    Returns:
        Number of declarations informalized (including cache hits).
    """
    template = prompt_template or PROMPT_PATH.read_text()

    todo = list(store.iter_missing_informalization())
    if limit:
        todo = todo[:limit]
    if not todo:
        logger.info("nothing to informalize")
        return 0

    cache: dict[tuple[str, str], str] = {}
    if use_cache:
        cache = load_informalization_cache(discover_database_files())

    # Seed name->description map with everything already in this store.
    informalizations_by_name: dict[str, str] = {
        d.name: d.informalization
        for d in store.iter_all(with_embeddings=False)
        if d.informalization
    }

    if client is None:
        from lean_explore_tpu_torch.util.openrouter_client import OpenRouterClient

        client = OpenRouterClient()

    semaphore = asyncio.Semaphore(max_concurrent)
    processed = 0

    async def generate_one(decl: Declaration) -> InformalizationResult:
        hit = cache.get((decl.name, decl.source_text))
        if hit is not None:
            return InformalizationResult(decl.id, decl.name, hit)
        async with semaphore:
            prompt = render_prompt(template, decl, informalizations_by_name)
            try:
                text = await client.generate(prompt, model=model, temperature=0.3)
            except Exception as error:  # noqa: BLE001 — per-decl resilience
                logger.warning("informalization failed for %s: %s", decl.name, error)
                return InformalizationResult(decl.id, decl.name, None)
        text = (text or "").strip()
        if not text:
            logger.warning("empty response for %s", decl.name)
            return InformalizationResult(decl.id, decl.name, None)
        return InformalizationResult(decl.id, decl.name, text)

    layers = build_dependency_layers(todo)
    logger.info("%d declarations across %d dependency layers", len(todo), len(layers))

    for layer_idx, layer in enumerate(layers):
        pending: list[tuple[int, str]] = []
        tasks = [asyncio.create_task(generate_one(d)) for d in layer]
        for future in asyncio.as_completed(tasks):
            result = await future
            if result.informalization:
                pending.append((result.declaration_id, result.informalization))
                informalizations_by_name[result.declaration_name] = (
                    result.informalization
                )
                processed += 1
            if len(pending) >= commit_batch_size:
                store.set_informalizations(pending)
                pending.clear()
        if pending:
            store.set_informalizations(pending)
        logger.info("layer %d/%d done", layer_idx + 1, len(layers))

    logger.info("informalized %d declarations", processed)
    return processed
