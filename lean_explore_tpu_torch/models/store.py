"""sqlite3-backed document store for Lean declarations.

Replaces the reference's SQLAlchemy/aiosqlite ORM layer
(upstream lean-explore src/lean_explore/models/search_db.py:44-76) with a thin,
dependency-free store. Metadata hydration is host-side and off the device
critical path; the only thing the serving loop needs is fast batched
``id -> row`` lookup, so the store exposes batch getters and the engine
wraps calls in ``asyncio.to_thread``.

Embeddings are stored as little-endian float32 blobs, byte-compatible with
the reference's ``BinaryEmbedding`` column (search_db.py:24-35, which packs
via ``struct.pack(f"{n}f")``).

A copy of lean_explore_tpu/models/store.py: the port imports nothing of the
JAX package.
"""

import json
import sqlite3
import threading
from collections.abc import Iterable, Iterator, Sequence
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

_SCHEMA = """
CREATE TABLE IF NOT EXISTS declarations (
    id INTEGER PRIMARY KEY,
    name TEXT NOT NULL UNIQUE,
    module TEXT NOT NULL,
    docstring TEXT,
    source_text TEXT NOT NULL,
    source_link TEXT NOT NULL,
    dependencies TEXT,
    informalization TEXT,
    informalization_embedding BLOB
);
CREATE INDEX IF NOT EXISTS idx_declarations_module ON declarations (module);
"""

_COLUMNS = (
    "id",
    "name",
    "module",
    "docstring",
    "source_text",
    "source_link",
    "dependencies",
    "informalization",
    "informalization_embedding",
)


def pack_embedding(vector: Sequence[float] | np.ndarray | None) -> bytes | None:
    """Encode a vector as a little-endian float32 blob."""
    if vector is None:
        return None
    return np.asarray(vector, dtype="<f4").tobytes()


def unpack_embedding(blob: bytes | None) -> list[float] | None:
    """Decode a float32 blob back to a list of floats."""
    if blob is None:
        return None
    return np.frombuffer(blob, dtype="<f4").tolist()


@dataclass(slots=True)
class Declaration:
    """One Lean declaration row (schema parity: reference search_db.py:44-76)."""

    name: str
    module: str
    source_text: str
    source_link: str
    id: int | None = None
    docstring: str | None = None
    dependencies: str | None = None
    informalization: str | None = None
    informalization_embedding: list[float] | None = field(default=None, repr=False)

    def dependency_names(self) -> list[str]:
        """Parse the JSON dependencies column; malformed JSON yields []."""
        if not self.dependencies:
            return []
        try:
            parsed = json.loads(self.dependencies)
        except json.JSONDecodeError:
            return []
        return [d for d in parsed if isinstance(d, str)] if isinstance(parsed, list) else []


_METADATA_COLUMNS = (
    "id, name, module, docstring, source_text, source_link, dependencies, "
    "informalization"
)


def _row_to_declaration(row: sqlite3.Row) -> Declaration:
    keys = row.keys()
    return Declaration(
        id=row["id"],
        name=row["name"],
        module=row["module"],
        docstring=row["docstring"],
        source_text=row["source_text"],
        source_link=row["source_link"],
        dependencies=row["dependencies"],
        informalization=row["informalization"],
        informalization_embedding=(
            unpack_embedding(row["informalization_embedding"])
            if "informalization_embedding" in keys
            else None
        ),
    )


class DeclarationStore:
    """Thread-safe sqlite3 store with batched access patterns.

    One connection guarded by a lock: the serving path issues a handful of
    short read transactions per query batch, so contention is negligible and
    sqlite's own serialization does the rest.
    """

    def __init__(self, path: str | Path, create: bool = False):
        """Open (or create) a declaration database.

        Args:
            path: Database file path, or ":memory:".
            create: Create schema if missing. Serving opens read-only stores
                with create=False and fails fast on absent files.
        """
        self.path = str(path)
        if not create and self.path != ":memory:" and not Path(self.path).exists():
            raise FileNotFoundError(
                f"Declaration database not found at {self.path}. "
                "Run 'lean-explore data fetch' or the extraction pipeline first."
            )
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.Lock()
        if create:
            with self._lock, self._conn:
                self._conn.executescript(_SCHEMA)

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    def __enter__(self) -> "DeclarationStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # Writes (extraction pipeline)
    # ------------------------------------------------------------------

    def insert_many(
        self, declarations: Iterable[Declaration], ignore_conflicts: bool = True
    ) -> int:
        """Batch-insert declarations; on name conflicts, skip (idempotent resume,
        mirrors reference doc_parser.py:793-847 on_conflict_do_nothing)."""
        conflict = "OR IGNORE" if ignore_conflicts else ""
        sql = (
            f"INSERT {conflict} INTO declarations "
            "(id, name, module, docstring, source_text, source_link, "
            "dependencies, informalization, informalization_embedding) "
            "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)"
        )
        rows = [
            (
                # Preserve an explicitly set id (NULL autoassigns): a
                # dump-and-rebuild that silently renumbered rows would
                # desync every artifact keyed on the old ids (dense index,
                # BM25 maps) — silently wrong results, not an error.
                None if d.id is None else int(d.id),
                d.name,
                d.module,
                d.docstring,
                d.source_text,
                d.source_link,
                d.dependencies,
                d.informalization,
                pack_embedding(d.informalization_embedding),
            )
            for d in declarations
        ]
        with self._lock, self._conn:
            cursor = self._conn.executemany(sql, rows)
            return cursor.rowcount

    def set_informalization(self, decl_id: int, text: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE declarations SET informalization = ? WHERE id = ?",
                (text, decl_id),
            )

    def set_informalizations(self, items: Iterable[tuple[int, str]]) -> None:
        with self._lock, self._conn:
            self._conn.executemany(
                "UPDATE declarations SET informalization = ? WHERE id = ?",
                [(text, decl_id) for decl_id, text in items],
            )

    def set_embeddings(
        self, items: Iterable[tuple[int, Sequence[float] | np.ndarray]]
    ) -> None:
        with self._lock, self._conn:
            self._conn.executemany(
                "UPDATE declarations SET informalization_embedding = ? WHERE id = ?",
                [(pack_embedding(vec), decl_id) for decl_id, vec in items],
            )

    # ------------------------------------------------------------------
    # Reads
    # ------------------------------------------------------------------

    def count(self) -> int:
        with self._lock:
            (n,) = self._conn.execute("SELECT COUNT(*) FROM declarations").fetchone()
        return n

    def get_by_id(
        self, decl_id: int, *, with_embedding: bool = False
    ) -> Declaration | None:
        columns = "*" if with_embedding else _METADATA_COLUMNS
        with self._lock:
            row = self._conn.execute(
                # int(): numpy integer ids bind as BLOBs and silently match
                # zero rows — retrieval ids originate as numpy arrays.
                f"SELECT {columns} FROM declarations WHERE id = ?",
                (int(decl_id),),
            ).fetchone()
        return _row_to_declaration(row) if row else None

    def get_by_ids(
        self, ids: Sequence[int], *, with_embeddings: bool = False
    ) -> dict[int, Declaration]:
        """Batched hydration for the serving path (reference engine.py:320-323).

        Large id lists are chunked to stay under sqlite's bound-variable
        limit. Embedding blobs are skipped by default: the serving path only
        needs metadata, and decoding 4KB float blobs per row dominates
        hydration cost otherwise.
        """
        out: dict[int, Declaration] = {}
        # int(): numpy integer ids bind as BLOBs and silently match nothing.
        ids = [int(i) for i in ids]
        columns = "*" if with_embeddings else _METADATA_COLUMNS
        with self._lock:
            for start in range(0, len(ids), 512):
                chunk = ids[start : start + 512]
                placeholders = ",".join("?" * len(chunk))
                rows = self._conn.execute(
                    f"SELECT {columns} FROM declarations WHERE id IN "
                    f"({placeholders})",
                    chunk,
                ).fetchall()
                for row in rows:
                    out[row["id"]] = _row_to_declaration(row)
        return out

    def get_by_name(
        self, name: str, *, with_embedding: bool = False
    ) -> Declaration | None:
        columns = "*" if with_embedding else _METADATA_COLUMNS
        with self._lock:
            row = self._conn.execute(
                f"SELECT {columns} FROM declarations WHERE name = ?", (name,)
            ).fetchone()
        return _row_to_declaration(row) if row else None

    def iter_all(
        self, batch_size: int = 1024, *, with_embeddings: bool = True
    ) -> Iterator[Declaration]:
        """Stream every row in id order (index build).

        Pass with_embeddings=False when only metadata is needed — decoding
        the 4KB embedding blob per row dominates iteration cost otherwise.
        """
        columns = "*" if with_embeddings else _METADATA_COLUMNS
        last_id = -1
        while True:
            with self._lock:
                rows = self._conn.execute(
                    f"SELECT {columns} FROM declarations WHERE id > ? "
                    "ORDER BY id LIMIT ?",
                    (last_id, batch_size),
                ).fetchall()
            if not rows:
                return
            for row in rows:
                yield _row_to_declaration(row)
            last_id = rows[-1]["id"]

    def iter_missing_informalization(
        self, batch_size: int = 1024
    ) -> Iterator[Declaration]:
        """Rows still needing an informalization (stage-level resume,
        reference informalize.py:157)."""
        yield from self._iter_where("informalization IS NULL", batch_size)

    def iter_missing_embedding(self, batch_size: int = 1024) -> Iterator[Declaration]:
        """Rows with an informalization but no embedding (reference
        embeddings.py:205-212)."""
        yield from self._iter_where(
            "informalization IS NOT NULL AND informalization_embedding IS NULL",
            batch_size,
        )

    def iter_embedded(self, batch_size: int = 1024) -> Iterator[Declaration]:
        """Rows with embeddings (dense index build input)."""
        yield from self._iter_where(
            "informalization_embedding IS NOT NULL", batch_size
        )

    def _iter_where(self, where: str, batch_size: int) -> Iterator[Declaration]:
        last_id = -1
        while True:
            with self._lock:
                rows = self._conn.execute(
                    f"SELECT * FROM declarations WHERE id > ? AND {where} "
                    "ORDER BY id LIMIT ?",
                    (last_id, batch_size),
                ).fetchall()
            if not rows:
                return
            for row in rows:
                yield _row_to_declaration(row)
            last_id = rows[-1]["id"]
