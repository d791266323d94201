"""Parser for doc-gen4 output: declarations, dependencies, source text.

Behavioral parity with the reference parser (extract/doc_parser.py:1-1015):

- SQLite format (api-docs.db, doc-gen4 >= v4.29.0-rc2): joins name_info /
  declaration_ranges / docstrings / modules; dependency names are decoded
  from the ``name_info.type`` RenderedCode BLOB.
- BMP JSON fallback (older doc-gen4): declarations per module file,
  dependencies scraped from the header HTML hrefs.
- Source text is read from local package checkouts by parsing the GitHub
  link's ``#L{start}-L{end}`` fragment, extending attribute-only ranges.
- Auto-generated ``.mk`` constructors and ``to*`` projections that share
  source text with their parent are dropped.

The RenderedCode BLOB uses leansqlite's ToBinary layout:

    TaggedText: text(0) String | tag(1) Tag TaggedText | append(2) Array
    Tag: keyword(0)|string(1)|const(2) Name|sort*(3..6)|otherExpr(7)
    Name: anonymous(0) | str(1) Name String | num(2) Name Nat
    Nat: little-endian 7-bit varint (high bit = continue)
    String: Nat byte-length + UTF-8 bytes

Decoders here are iterative (counter/loop based) rather than recursive —
Mathlib type signatures can nest deeply.

A copy of lean_explore_tpu/extract/doc_parser.py ("the reference" is the upstream
lean-explore project): the port imports nothing of the JAX package.
"""

import json
import logging
import re
import sqlite3
from pathlib import Path

from lean_explore_tpu_torch.extract.packages import (
    PACKAGE_REGISTRY,
    get_extraction_order,
)
from lean_explore_tpu_torch.extract.types import ParsedDeclaration
from lean_explore_tpu_torch.models.store import Declaration, DeclarationStore

logger = logging.getLogger(__name__)


# ----------------------------------------------------------------------
# leansqlite ToBinary decoding
# ----------------------------------------------------------------------


class BlobCursor:
    """Sequential reader over a leansqlite ToBinary blob."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError("unexpected end of blob")
        value = self.data[self.pos]
        self.pos += 1
        return value

    def nat(self) -> int:
        result = 0
        shift = 0
        while True:
            b = self.byte()
            result |= (b & 0x7F) << shift
            if b < 0x80:
                return result
            shift += 7

    def string(self) -> str:
        length = self.nat()
        end = self.pos + length
        if end > len(self.data):
            raise ValueError("string runs past end of blob")
        raw = self.data[self.pos : end]
        self.pos = end
        return raw.decode("utf-8")

    def name(self) -> str:
        """Decode a Lean Name to dotted form.

        The wire format nests parents head-first (tag bytes outermost-first,
        payloads innermost-first), so collect the tag chain, then read
        payloads against the reversed chain.
        """
        tags: list[int] = []
        while True:
            tag = self.byte()
            if tag == 0:
                break
            if tag not in (1, 2):
                raise ValueError(f"invalid Name tag {tag}")
            tags.append(tag)
        parts: list[str] = []
        for tag in reversed(tags):
            parts.append(self.string() if tag == 1 else str(self.nat()))
        return ".".join(parts)


def extract_type_dependencies(blob: bytes) -> list[str]:
    """Collect const-referenced names from a RenderedCode BLOB, in order,
    de-duplicated. Malformed blobs yield [] (reference behavior)."""
    cursor = BlobCursor(blob)
    names: list[str] = []
    seen: set[str] = set()
    try:
        pending = 1  # TaggedText nodes remaining, decoded sequentially
        while pending:
            pending -= 1
            node = cursor.byte()
            if node == 0:  # text payload
                cursor.string()
            elif node == 1:  # tag: Tag then child TaggedText
                tag = cursor.byte()
                if tag == 2:  # const Name
                    name = cursor.name()
                    if name and name not in seen:
                        seen.add(name)
                        names.append(name)
                elif tag > 7:
                    raise ValueError(f"invalid Tag {tag}")
                pending += 1
            elif node == 2:  # append: Array of TaggedText
                pending += cursor.nat()
            else:
                raise ValueError(f"invalid TaggedText tag {node}")
    except (ValueError, IndexError):
        logger.debug("unparseable RenderedCode blob (%d bytes)", len(blob))
        return []
    return names


# ----------------------------------------------------------------------
# Lean source handling
# ----------------------------------------------------------------------

_BLOCK_OPEN = "/-"
_BLOCK_CLOSE = "-/"
_DECL_KEYWORDS = (
    "def",
    "theorem",
    "lemma",
    "instance",
    "class",
    "structure",
    "inductive",
    "abbrev",
)


def _contains_decl_keyword(text: str) -> bool:
    """True when the attribute-extended range has reached a declaration.

    The reference matches ' kw ' with a LEADING SPACE only
    (doc_parser.py:365-385), so a keyword at column 0 — the common layout
    for '@[ext]\\nstructure Foo where' — never matches and the range
    overshoots to the next ':=' anywhere in the file. Deliberate
    divergence: also match keywords at line starts.
    """
    if ":=" in text:
        return True
    return any(
        f" {kw} " in text
        or f"\n{kw} " in text
        or text.startswith(f"{kw} ")
        for kw in _DECL_KEYWORDS
    )


def strip_lean_comments(source_text: str) -> str:
    """Remove line/block/doc comments and collapse whitespace.

    Used only for source-equality comparison in the projection filter;
    handles nested block comments.
    """
    if _BLOCK_OPEN not in source_text and "--" not in source_text:
        # No comment to strip: the loop below would copy every character.
        return " ".join(source_text.split())
    out: list[str] = []
    i = 0
    n = len(source_text)
    while i < n:
        two = source_text[i : i + 2]
        if two == _BLOCK_OPEN:
            depth = 1
            i += 2
            while i < n and depth:
                two = source_text[i : i + 2]
                if two == _BLOCK_OPEN:
                    depth += 1
                    i += 2
                elif two == _BLOCK_CLOSE:
                    depth -= 1
                    i += 2
                else:
                    i += 1
            continue
        if two == "--":
            while i < n and source_text[i] != "\n":
                i += 1
            continue
        out.append(source_text[i])
        i += 1
    return " ".join("".join(out).split())


def filter_projections(
    declarations: list[ParsedDeclaration],
) -> tuple[list[ParsedDeclaration], int]:
    """Drop auto-generated ``to*`` projections sharing source with a parent.

    A structure `extends` clause generates projections (Scheme.
    toLocallyRingedSpace) whose source range equals the parent's; genuine
    `toFoo` definitions have unique source text and are kept.
    """
    by_source: dict[str, int] = {}
    stripped_cache: dict[int, str] = {}
    for idx, decl in enumerate(declarations):
        stripped = strip_lean_comments(decl.source_text)
        stripped_cache[idx] = stripped
        by_source[stripped] = by_source.get(stripped, 0) + 1

    kept: list[ParsedDeclaration] = []
    removed = 0
    for idx, decl in enumerate(declarations):
        short = decl.name.rsplit(".", 1)[-1]
        looks_generated = (
            len(short) > 2 and short.startswith("to") and short[2].isupper()
        )
        if looks_generated and by_source[stripped_cache[idx]] > 1:
            removed += 1
            continue
        kept.append(decl)
    return kept, removed


_SOURCE_LINK_RE = re.compile(
    r"github\.com/([^/]+)/([^/]+)/blob/[^/]+/(.+\.lean)#L(\d+)-L(\d+)"
)


def read_source_lines(
    file_path: Path,
    line_start: int,
    line_end: int,
    lines_cache: dict[Path, list[str]] | None = None,
) -> str:
    """Read a 1-indexed inclusive line range; attribute-only ranges are
    extended until a declaration keyword appears.

    ``lines_cache`` (the port's addition) keeps each file's lines for the
    rest of one parse, which reads every file once instead of once per
    declaration in it."""
    lines = None if lines_cache is None else lines_cache.get(file_path)
    if lines is None:
        with open(file_path, encoding="utf-8") as f:
            lines = f.readlines()
        if lines_cache is not None:
            lines_cache[file_path] = lines
    if line_start > len(lines) or line_end > len(lines):
        raise ValueError(
            f"line range {line_start}-{line_end} out of bounds for {file_path}"
        )
    text = "".join(lines[line_start - 1 : line_end])
    if not text.strip().startswith("@["):
        return text
    end = line_end
    while end < len(lines):
        end += 1
        extended = "".join(lines[line_start - 1 : end])
        if _contains_decl_keyword(extended):
            return extended.rstrip()
    return "".join(lines[line_start - 1 : end]).rstrip()


def build_package_cache(
    lean_root: Path, workspace_name: str | None = None
) -> dict[str, Path]:
    """Map lowercase package names -> checkout dirs for source resolution.

    Restricting to one workspace avoids cross-workspace version skew
    (reference doc_parser.py:280-330)."""
    cache: dict[str, Path] = {}
    workspaces = [workspace_name] if workspace_name else get_extraction_order()
    for ws in workspaces:
        packages_dir = lean_root / ws / ".lake" / "packages"
        if packages_dir.exists():
            for pkg_dir in packages_dir.iterdir():
                if pkg_dir.is_dir():
                    cache[pkg_dir.name.lower()] = pkg_dir
    for ws in workspaces:
        toolchain_file = lean_root / ws / "lean-toolchain"
        if toolchain_file.exists():
            version = toolchain_file.read_text().strip().split(":")[-1]
            toolchain_src = (
                Path.home()
                / ".elan"
                / "toolchains"
                / f"leanprover--lean4---{version}"
                / "src"
                / "lean"
            )
            if toolchain_src.exists():
                cache["lean4"] = toolchain_src
                break
    return cache


def extract_source_text(
    source_link: str,
    lean_root: Path,
    package_cache: dict[str, Path],
    lines_cache: dict[Path, list[str]] | None = None,
) -> str:
    """Resolve a GitHub #L range link against local checkouts and read it
    (through ``lines_cache``, as ``read_source_lines``)."""
    match = _SOURCE_LINK_RE.search(source_link)
    if not match:
        raise ValueError(f"could not parse source link: {source_link}")
    _, package_name, file_path, start_s, end_s = match.groups()
    line_start, line_end = int(start_s), int(end_s)

    candidates: list[Path] = []
    for variant in (
        package_name.lower(),
        package_name.rstrip("0123456789").lower(),
        package_name.replace("-", "").lower(),
    ):
        root = package_cache.get(variant)
        if root is None:
            continue
        if variant == "lean4" and file_path.startswith("src/lean/"):
            candidates.append(root / file_path[9:])
        elif variant == "lean4" and file_path.startswith("src/lake/"):
            candidates.append(root.parent / "lake" / file_path[9:])
        elif variant == "lean4" and file_path.startswith("src/"):
            candidates.append(root / file_path[4:])
        else:
            candidates.append(root / file_path)
    candidates.append(lean_root / file_path)
    candidates.extend(root / file_path for root in package_cache.values())

    for candidate in candidates:
        if candidate.exists():
            return read_source_lines(candidate, line_start, line_end, lines_cache)
    raise FileNotFoundError(f"could not find {file_path} for {package_name}")


def read_lean_toolchain_version(workspace_path: Path) -> str | None:
    toolchain = workspace_path / "lean-toolchain"
    if not toolchain.exists():
        return None
    match = re.search(r"v\d+\.\d+\.\d+(?:-rc\d+)?", toolchain.read_text())
    return match.group() if match else None


def construct_source_link(
    module_name: str,
    module_source_url: str | None,
    start_line: int,
    end_line: int,
    lean_version: str | None = None,
) -> str | None:
    """Attach the #L range; core modules without a URL fall back to the
    leanprover/lean4 repo at the toolchain ref."""
    if module_source_url:
        return f"{module_source_url}#L{start_line}-L{end_line}"
    ref = lean_version or "master"
    module_path = module_name.replace(".", "/")
    root = module_name.split(".", 1)[0]
    if root in {"Init", "Lean", "Std"}:
        return (
            f"https://github.com/leanprover/lean4/blob/{ref}/src/lean/"
            f"{module_path}.lean#L{start_line}-L{end_line}"
        )
    if root == "Lake":
        return (
            f"https://github.com/leanprover/lean4/blob/{ref}/src/lake/"
            f"{module_path}.lean#L{start_line}-L{end_line}"
        )
    return None


# ----------------------------------------------------------------------
# Format parsers
# ----------------------------------------------------------------------

def _docgen_sql(tables: set[str]) -> str:
    """Build the extraction query for the tables this api-docs.db carries.

    Doc-gen4 stores docstrings as markdown text OR Verso binary BLOBs, never
    both (reference doc_parser.py:541-562). Markdown is used; Verso-only
    rows are surfaced as docstring=None and counted so the log shows what
    was dropped.
    """
    select_verso = (
        "v.content AS verso_docstring"
        if "declaration_verso_docstrings" in tables
        else "NULL AS verso_docstring"
    )
    join_markdown = (
        """LEFT JOIN declaration_markdown_docstrings d
        ON n.module_name = d.module_name AND n.position = d.position"""
        if "declaration_markdown_docstrings" in tables
        else ""
    )
    select_markdown = (
        "d.text AS docstring"
        if "declaration_markdown_docstrings" in tables
        else "NULL AS docstring"
    )
    join_verso = (
        """LEFT JOIN declaration_verso_docstrings v
        ON n.module_name = v.module_name AND n.position = v.position"""
        if "declaration_verso_docstrings" in tables
        else ""
    )
    return f"""
    SELECT
        n.module_name, n.name, n.type,
        r.start_line, r.end_line,
        {select_markdown},
        {select_verso},
        m.source_url
    FROM name_info n
    JOIN declaration_ranges r
        ON n.module_name = r.module_name AND n.position = r.position
    {join_markdown}
    {join_verso}
    JOIN modules m ON n.module_name = m.name
    WHERE n.render = 1
    ORDER BY n.module_name, n.position
"""

REQUIRED_DOCGEN_TABLES = {"name_info", "declaration_ranges", "modules"}


def validate_docgen_sqlite(database_path: Path) -> bool:
    """Reject empty/corrupt/incompatible api-docs.db left by crashed builds."""
    if database_path.stat().st_size == 0:
        logger.warning("api-docs.db is empty: %s", database_path)
        return False
    try:
        conn = sqlite3.connect(str(database_path))
        try:
            tables = {
                row[0]
                for row in conn.execute(
                    "SELECT name FROM sqlite_master WHERE type='table'"
                )
            }
        finally:
            conn.close()
    except sqlite3.DatabaseError as error:
        logger.warning("api-docs.db unreadable: %s", error)
        return False
    missing = REQUIRED_DOCGEN_TABLES - tables
    if missing:
        logger.warning("api-docs.db missing tables %s", missing)
        return False
    return True


def detect_docgen_format(workspace_path: Path) -> str:
    """'sqlite' | 'bmp' | 'none' for a workspace's doc-gen4 output."""
    api_docs = workspace_path / ".lake" / "build" / "api-docs.db"
    if api_docs.exists() and validate_docgen_sqlite(api_docs):
        return "sqlite"
    doc_data = workspace_path / ".lake" / "build" / "doc-data"
    if doc_data.exists() and any(doc_data.glob("**/*.bmp")):
        return "bmp"
    return "none"


def _module_filter(prefixes: list[str]):
    """'.'-boundary prefix filter — ONE definition shared by the sqlite and
    BMP parsers and behavior-matched to PackageConfig.should_include_module
    (packages.py), so a matching-rule fix cannot silently diverge."""
    def allowed(module: str) -> bool:
        return any(
            module == p or module.startswith(p + ".") for p in prefixes
        )

    return allowed


def parse_sqlite_docs(
    database_path: Path,
    lean_root: Path,
    package_cache: dict[str, Path],
    allowed_module_prefixes: list[str],
    lean_version: str | None = None,
) -> list[ParsedDeclaration]:
    """Parse an api-docs.db into declarations."""

    allowed = _module_filter(allowed_module_prefixes)

    declarations: list[ParsedDeclaration] = []
    lines_cache: dict[Path, list[str]] = {}
    stats = {"prefix": 0, "mk": 0, "no_source": 0, "source_error": 0, "verso": 0}
    conn = sqlite3.connect(str(database_path))
    conn.row_factory = sqlite3.Row
    try:
        tables = {
            row[0]
            for row in conn.execute(
                "SELECT name FROM sqlite_master WHERE type='table'"
            )
        }
        for row in conn.execute(_docgen_sql(tables)):
            module = row["module_name"]
            name = row["name"]
            if not allowed(module):
                stats["prefix"] += 1
                continue
            if name.endswith(".mk"):
                stats["mk"] += 1
                continue
            link = construct_source_link(
                module,
                row["source_url"],
                row["start_line"],
                row["end_line"],
                lean_version=lean_version,
            )
            if not link:
                stats["no_source"] += 1
                continue
            try:
                source_text = extract_source_text(link, lean_root, package_cache, lines_cache)
            except (FileNotFoundError, ValueError) as error:
                stats["source_error"] += 1
                if stats["source_error"] <= 10:
                    logger.debug("no source for %s: %s", name, error)
                continue
            deps = None
            if row["type"]:
                names = extract_type_dependencies(bytes(row["type"]))
                names = [d for d in names if d != name]
                deps = names or None
            docstring = row["docstring"]
            if not docstring and row["verso_docstring"]:
                # Verso-only docstring: binary format, not yet decoded —
                # stored as None, counted below (reference doc_parser.py:652-683).
                stats["verso"] += 1
                docstring = None
            declarations.append(
                ParsedDeclaration(
                    name=name,
                    module=module,
                    docstring=docstring,
                    source_text=source_text,
                    source_link=link,
                    dependencies=deps,
                )
            )
    finally:
        conn.close()
    if stats["verso"]:
        logger.warning(
            "%d declarations have Verso-only docstrings (stored as None)",
            stats["verso"],
        )
    logger.info(
        "api-docs.db: %d parsed (skipped prefix=%d mk=%d no-src=%d err=%d)",
        len(declarations), stats["prefix"], stats["mk"],
        stats["no_source"], stats["source_error"],
    )
    return declarations


_HREF_ANCHOR_RE = re.compile(r'href="[^"]*#([^"]+)"')


def extract_html_dependencies(html: str) -> list[str]:
    """Dependency names from declaration-header anchor hrefs (BMP format)."""
    seen: set[str] = set()
    out: list[str] = []
    for anchor in _HREF_ANCHOR_RE.findall(html):
        if anchor not in seen:
            seen.add(anchor)
            out.append(anchor)
    return out


def parse_bmp_docs(
    bmp_files: list[Path],
    lean_root: Path,
    package_cache: dict[str, Path],
    allowed_module_prefixes: list[str],
) -> list[ParsedDeclaration]:
    """Parse legacy per-module BMP JSON files into declarations."""

    allowed = _module_filter(allowed_module_prefixes)

    declarations: list[ParsedDeclaration] = []
    lines_cache: dict[Path, list[str]] = {}
    source_errors = 0
    for path in bmp_files:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        module = data["name"]
        if not allowed(module):
            continue
        for entry in data.get("declarations", []):
            info = entry["info"]
            name = info["name"]
            if name.endswith(".mk"):
                continue
            try:
                source_text = extract_source_text(
                    info["sourceLink"], lean_root, package_cache, lines_cache
                )
            except (FileNotFoundError, ValueError):
                source_errors += 1
                continue
            deps = [
                d for d in extract_html_dependencies(entry.get("header", ""))
                if d != name
            ]
            declarations.append(
                ParsedDeclaration(
                    name=name,
                    module=module,
                    docstring=info.get("doc"),
                    source_text=source_text,
                    source_link=info["sourceLink"],
                    dependencies=deps or None,
                )
            )
    if source_errors:
        logger.warning("no source text for %d declarations", source_errors)
    return declarations


# ----------------------------------------------------------------------
# Top-level stage
# ----------------------------------------------------------------------


def extract_declarations(
    store: DeclarationStore,
    lean_root: str | Path = "lean",
) -> int:
    """Parse every workspace's doc-gen4 output and load the store.

    Idempotent: inserts use OR IGNORE on the name key, so reruns after a
    crash only add missing rows.

    Returns:
        Number of newly inserted declarations.
    """
    lean_root = Path(lean_root)
    parsed: list[ParsedDeclaration] = []

    for package_name in get_extraction_order():
        config = PACKAGE_REGISTRY[package_name]
        workspace = lean_root / package_name
        fmt = detect_docgen_format(workspace)
        if fmt == "none":
            logger.warning("no doc-gen4 output for %s", package_name)
            continue
        cache = build_package_cache(lean_root, package_name)
        if fmt == "sqlite":
            decls = parse_sqlite_docs(
                workspace / ".lake" / "build" / "api-docs.db",
                lean_root,
                cache,
                config.module_prefixes,
                lean_version=read_lean_toolchain_version(workspace),
            )
        else:
            bmp_files = sorted(
                (workspace / ".lake" / "build" / "doc-data").glob("**/*.bmp")
            )
            decls = parse_bmp_docs(bmp_files, lean_root, cache, config.module_prefixes)
        logger.info("%s: %d declarations", package_name, len(decls))
        parsed.extend(decls)

    if not parsed:
        raise FileNotFoundError("no declarations extracted from any workspace")

    parsed, removed = filter_projections(parsed)
    if removed:
        logger.info("filtered %d auto-generated to* projections", removed)

    inserted = store.insert_many(
        Declaration(
            name=d.name,
            module=d.module,
            docstring=d.docstring,
            source_text=d.source_text,
            source_link=d.source_link,
            dependencies=json.dumps(d.dependencies) if d.dependencies else None,
        )
        for d in parsed
    )
    logger.info(
        "inserted %d new declarations (%d duplicates skipped)",
        inserted,
        len(parsed) - inserted,
    )
    return inserted
