"""doc-gen4 build runner: runs Lake per package workspace.

Behavioral parity with the reference runner (extract/doc_gen4.py:27-314):
toolchain fetch + lakefile doc-gen4 pinning, ``lake update`` with retries,
mathlib binary cache fetch, and building ``:docInfo`` (SQLite doc-gen4,
Lean >= v4.29.0-rc2) or ``:docs`` (legacy BMP) per library.

Everything here shells out to the Lean toolchain, so it is only exercised in
environments with lake/elan installed; unit tests fake the subprocess layer.

A copy of lean_explore_tpu/extract/doc_gen4.py ("the reference" is the upstream
lean-explore project): the port imports nothing of the JAX package.
"""

import logging
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

from lean_explore_tpu_torch.extract.github import extract_lean_version
from lean_explore_tpu_torch.extract.packages import (
    PACKAGE_REGISTRY,
    PackageConfig,
    get_extraction_order,
    get_package_toolchain,
    update_lakefile_docgen_version,
)

logger = logging.getLogger(__name__)

_LIBRARY_NAMES: dict[str, list[str]] = {
    "mathlib": ["MathExtract"],
    "physlean": ["PhysExtract"],
    "flt": ["FLTExtract"],
    "formal-conjectures": ["FormalConjectures", "FormalConjecturesForMathlib"],
    "cslib": ["CslibExtract"],
}


def uses_sqlite_docgen(lean_toolchain: str) -> bool:
    """doc-gen4 writes api-docs.db from Lean v4.29.0-rc2 onward."""
    version = extract_lean_version(lean_toolchain)
    match = re.match(r"^v(\d+)\.(\d+)\.(\d+)(?:-rc(\d+))?$", version)
    if match is None:
        return False
    major, minor, patch, rc = match.groups()
    triple = (int(major), int(minor), int(patch))
    if triple != (4, 29, 0):
        return triple > (4, 29, 0)
    return rc is None or int(rc) >= 2


def library_names(package_name: str) -> list[str]:
    """Lake build targets (umbrella-import extract libraries) per package."""
    return _LIBRARY_NAMES.get(package_name, [f"{package_name.title()}Extract"])


def clear_workspace_cache(workspace_path: Path) -> None:
    """Remove .lake and lake-manifest.json for a from-scratch nightly build."""
    manifest = workspace_path / "lake-manifest.json"
    if manifest.exists():
        manifest.unlink()
    lake_dir = workspace_path / ".lake"
    if lake_dir.exists():
        logger.info("removing %s for clean rebuild", lake_dir)
        shutil.rmtree(lake_dir)


def run_lake_update(
    workspace_path: Path,
    package_name: str,
    env: dict[str, str],
    *,
    max_retries: int = 3,
    base_delay: float = 30.0,
) -> None:
    """``lake update`` with exponential-backoff retries (network flakiness)."""
    for attempt in range(1, max_retries + 2):
        logger.info("[%s] lake update (attempt %d)", package_name, attempt)
        result = subprocess.run(
            ["lake", "update"],
            cwd=workspace_path,
            env=env,
            capture_output=True,
            text=True,
        )
        if result.returncode == 0:
            return
        if attempt <= max_retries:
            delay = base_delay * (2 ** (attempt - 1))
            logger.warning(
                "[%s] lake update failed; retrying in %.0fs\n%s",
                package_name, delay, result.stderr[-2000:],
            )
            time.sleep(delay)
    raise RuntimeError(f"lake update failed for {package_name}")


def run_lake_build(
    workspace_path: Path,
    package_name: str,
    target: str,
    env: dict[str, str],
    *,
    allow_failure: bool = False,
) -> bool:
    """``lake build <target>``, streaming output to the logger."""
    logger.info("[%s] lake build %s", package_name, target)
    process = subprocess.Popen(
        ["lake", "build", target],
        cwd=workspace_path,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
        bufsize=1,
        env=env,
    )
    assert process.stdout is not None
    for line in process.stdout:
        logger.debug("[%s] %s", package_name, line.rstrip())
    process.wait()
    if process.returncode == 0:
        return True
    if allow_failure:
        logger.warning("[%s] lake build %s failed (continuing)", package_name, target)
        return False
    raise RuntimeError(f"lake build {target} failed for {package_name}")


def setup_workspace(config: PackageConfig, lean_root: Path) -> str:
    """Write the workspace's lean-toolchain and pin doc-gen4; returns the
    Lean version string."""
    toolchain, ref = get_package_toolchain(config)
    logger.info("[%s] toolchain %s (ref %s)", config.name, toolchain, ref)
    workspace = config.workspace_path(lean_root)
    (workspace / "lean-toolchain").write_text(toolchain + "\n")
    version = extract_lean_version(toolchain)
    lakefile = workspace / "lakefile.lean"
    if lakefile.exists():
        update_lakefile_docgen_version(lakefile, version)
    return toolchain


def run_package(
    package_name: str,
    lean_root: Path = Path("lean"),
    *,
    clear_cache: bool = False,
) -> None:
    """Full doc build for one package: setup, update, cache get, build docs."""
    config = PACKAGE_REGISTRY[package_name]
    workspace = config.workspace_path(lean_root)
    if not workspace.exists():
        raise FileNotFoundError(f"workspace missing: {workspace}")

    if clear_cache:
        clear_workspace_cache(workspace)

    toolchain = setup_workspace(config, lean_root)
    env = dict(os.environ)

    run_lake_update(workspace, package_name, env)

    if package_name == "mathlib" or "mathlib" in config.depends_on:
        result = subprocess.run(
            ["lake", "exe", "cache", "get"],
            cwd=workspace,
            env=env,
            capture_output=True,
            text=True,
        )
        if result.returncode != 0:
            logger.warning("[%s] mathlib cache get failed", package_name)

    # SQLite-format doc-gen4 only needs :docInfo (populates api-docs.db);
    # the :docs facet additionally renders HTML, which the pipeline never
    # reads. Legacy doc-gen4 has no :docInfo facet.
    target_suffix = "docInfo" if uses_sqlite_docgen(toolchain) else "docs"
    for lib in library_names(package_name):
        run_lake_build(
            workspace,
            package_name,
            f"{lib}:{target_suffix}",
            env,
            allow_failure=True,
        )


def run_doc_gen4(
    lean_root: str | Path = "lean",
    *,
    packages: list[str] | None = None,
    clear_cache: bool = False,
) -> None:
    """Run doc-gen4 over every (or the given) package workspace, dependency
    order first."""
    lean_root = Path(lean_root)
    order = packages or get_extraction_order()
    for package_name in order:
        run_package(package_name, lean_root, clear_cache=clear_cache)
