"""Package registry, configuration, and ordering for Lean extraction.

Consolidates the reference's package_config.py / package_registry.py /
package_utils.py trio: 5 package workspaces driven through Lake/doc-gen4,
ordered so dependencies extract first.

A copy of lean_explore_tpu/extract/packages.py ("the reference" is the upstream
lean-explore project): the port imports nothing of the JAX package.
"""

import logging
import re
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path

logger = logging.getLogger(__name__)


class VersionStrategy(Enum):
    """How to pick the git ref to extract."""

    LATEST = "latest"
    """HEAD of main/master (packages whose CI keeps main green)."""

    TAGGED = "tagged"
    """Most recent semver tag (safer for downstream packages)."""


@dataclass
class PackageConfig:
    """One Lean package workspace (reference package_config.py:24-59)."""

    name: str
    git_url: str
    module_prefixes: list[str]
    version_strategy: VersionStrategy = VersionStrategy.TAGGED
    lean_toolchain: str | None = None
    depends_on: list[str] = field(default_factory=list)
    extract_core: bool = False

    def workspace_path(self, base_path: Path) -> Path:
        return base_path / self.name

    def should_include_module(self, module_name: str) -> bool:
        """Exact prefix match with '.'-boundary so 'Lean' never matches
        'LeanSearchClient'."""
        return any(
            module_name == p or module_name.startswith(p + ".")
            for p in self.module_prefixes
        )


PACKAGE_REGISTRY: dict[str, PackageConfig] = {
    "mathlib": PackageConfig(
        name="mathlib",
        git_url="https://github.com/leanprover-community/mathlib4",
        module_prefixes=["Mathlib", "Batteries", "Init", "Lean", "Std"],
        version_strategy=VersionStrategy.LATEST,
        extract_core=True,
    ),
    "physlean": PackageConfig(
        name="physlean",
        git_url="https://github.com/HEPLean/PhysLean",
        # The reference registry pins "Physlib" (package_registry.py:20),
        # but the pinned PhysLean checkout's root module is "PhysLean"
        # (lean/physlean/PhysExtract.lean imports it) — with only the
        # reference's value, every PhysLean declaration fails the prefix
        # filter. Accept both so reference rows stay included AND the
        # package actually contributes declarations.
        module_prefixes=["PhysLean", "Physlib", "QuantumInfo"],
        version_strategy=VersionStrategy.TAGGED,
        depends_on=["mathlib"],
    ),
    "flt": PackageConfig(
        name="flt",
        git_url="https://github.com/ImperialCollegeLondon/FLT",
        module_prefixes=["FLT"],
        version_strategy=VersionStrategy.LATEST,
        depends_on=["mathlib"],
    ),
    "formal-conjectures": PackageConfig(
        name="formal-conjectures",
        git_url="https://github.com/google-deepmind/formal-conjectures",
        module_prefixes=["FormalConjectures", "FormalConjecturesForMathlib"],
        version_strategy=VersionStrategy.LATEST,
        depends_on=["mathlib"],
    ),
    "cslib": PackageConfig(
        name="cslib",
        git_url="https://github.com/leanprover/cslib",
        module_prefixes=["Cslib"],
        version_strategy=VersionStrategy.LATEST,
        depends_on=["mathlib"],
    ),
}


def get_package_for_module(module_name: str) -> str | None:
    """Which registered package owns a module name, if any."""
    for package_name, config in PACKAGE_REGISTRY.items():
        if config.should_include_module(module_name):
            return package_name
    return None


def get_extraction_order() -> list[str]:
    """Registry names ordered so dependencies come before dependents."""
    ordered: list[str] = []
    visited: set[str] = set()

    def visit(name: str) -> None:
        if name in visited:
            return
        visited.add(name)
        config = PACKAGE_REGISTRY.get(name)
        if config is None:
            return
        for dep in config.depends_on:
            visit(dep)
        ordered.append(name)

    for name in PACKAGE_REGISTRY:
        visit(name)
    return ordered


def get_package_toolchain(config: PackageConfig) -> tuple[str, str]:
    """(lean-toolchain contents, git ref) for a package per its strategy."""
    from lean_explore_tpu_torch.extract.github import (
        fetch_latest_tag,
        fetch_lean_toolchain,
    )

    if config.version_strategy == VersionStrategy.LATEST:
        for branch in ("main", "master"):
            try:
                return fetch_lean_toolchain(config.git_url, branch), branch
            except RuntimeError:
                continue
        raise RuntimeError(
            f"Could not fetch lean-toolchain from main or master for {config.name}"
        )
    tag = fetch_latest_tag(config.git_url)
    return fetch_lean_toolchain(config.git_url, tag), tag


_DOCGEN_REQUIRE_RE = re.compile(
    r"require «doc-gen4» from git\s+"
    r'"https://github\.com/leanprover/doc-gen4"(?:\s+@\s+"[^"]*")?'
)


def update_lakefile_docgen_version(lakefile_path: Path, lean_version: str) -> None:
    """Pin the doc-gen4 require in a lakefile to the Lean toolchain version.

    doc-gen4 releases track Lean toolchain tags; pinning keeps them
    compatible (reference package_utils.py:84-113)."""
    content = lakefile_path.read_text()
    replacement = (
        "require «doc-gen4» from git\n"
        f'  "https://github.com/leanprover/doc-gen4" @ "{lean_version}"'
    )
    updated = _DOCGEN_REQUIRE_RE.sub(replacement, content)
    if updated != content:
        lakefile_path.write_text(updated)
        logger.info("Pinned doc-gen4 to %s in %s", lean_version, lakefile_path)
