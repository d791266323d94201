"""GitHub metadata lookups for the extraction pipeline.

Resolves the pieces of remote state the offline pipeline needs before it can
build a package: which toolchain a Lean repository pins and which release
tag to build from (parity surface: reference extract/github.py:15-112).

Everything here sits at a network boundary. Failures are wrapped in
:class:`GitHubFetchError` so the package-resolution stage
(extract/packages.py) can decide between retrying, falling back to another
ref, or skipping the package.

A copy of lean_explore_tpu/extract/github.py ("the reference" is the upstream
lean-explore project): the port imports nothing of the JAX package.
"""

import json
import logging
import re
import urllib.request
from dataclasses import dataclass

logger = logging.getLogger(__name__)

_TIMEOUT_SECONDS = 30
_OWNER_REPO = re.compile(r"github\.com/([^/]+)/([^/]+?)(?:\.git)?$")
_TOOLCHAIN_VERSION = re.compile(r"v\d+\.\d+\.\d+(?:-rc\d+)?")
# Full match: a prefix match would rank 'v2.0.0-rc3' as a release and its
# trailing digit would beat the final 'v2.0.0' in numeric comparison.
_RELEASE_TAG = re.compile(r"^v?\d+\.\d+\.\d+$")


class GitHubFetchError(RuntimeError):
    """A GitHub request failed (network, HTTP status, or empty result)."""


@dataclass(frozen=True)
class RepoRef:
    """An owner/repo pair parsed out of a git URL."""

    owner: str
    repo: str

    @classmethod
    def parse(cls, git_url: str) -> "RepoRef":
        found = _OWNER_REPO.search(git_url)
        if not found:
            raise ValueError(
                f"{git_url!r} does not look like a github.com repository URL"
            )
        return cls(*found.groups())

    def raw_file_url(self, ref: str, path: str) -> str:
        return (
            "https://raw.githubusercontent.com/"
            f"{self.owner}/{self.repo}/{ref}/{path}"
        )

    def tags_url(self) -> str:
        return (
            f"https://api.github.com/repos/{self.owner}/{self.repo}"
            "/tags?per_page=100"
        )


def _get(url: str, *, accept: str | None = None) -> bytes:
    """One GET with the pipeline's timeout; wraps any failure."""
    headers = {"Accept": accept} if accept else {}
    request = urllib.request.Request(url, headers=headers)
    try:
        with urllib.request.urlopen(request, timeout=_TIMEOUT_SECONDS) as reply:
            return reply.read()
    except Exception as error:  # noqa: BLE001 — network boundary
        raise GitHubFetchError(f"GET {url} failed: {error}") from error


def github_url_to_raw(git_url: str, branch: str, file_path: str) -> str:
    """Repo URL + ref + path -> raw.githubusercontent.com URL."""
    return RepoRef.parse(git_url).raw_file_url(branch, file_path)


def fetch_lean_toolchain(git_url: str, ref: str = "main") -> str:
    """The repository's ``lean-toolchain`` pin at ``ref``, stripped."""
    url = RepoRef.parse(git_url).raw_file_url(ref, "lean-toolchain")
    logger.info("resolving toolchain pin: %s", url)
    return _get(url).decode("utf-8").strip()


def fetch_latest_tag(git_url: str) -> str:
    """The repository's highest release-style tag.

    Tags that parse as (v)MAJOR.MINOR.PATCH are compared numerically; when
    none do, the API's first (most recent) tag is used as-is.
    """
    repo = RepoRef.parse(git_url)
    names: list[str] = []
    # Paginate: GitHub's /tags ordering is not semver, so with >100 tags
    # the newest release can fall outside the first page (cap at 10 pages
    # — 1000 tags — as a runaway guard).
    for page in range(1, 11):
        url = f"{repo.tags_url()}&page={page}"
        logger.info("listing tags: %s", url)
        tags = json.loads(_get(url, accept="application/vnd.github.v3+json"))
        names.extend(t["name"] for t in tags)
        if len(tags) < 100:
            break
    if not names:
        raise GitHubFetchError(f"{repo.owner}/{repo.repo} has no tags")
    releases = [n for n in names if _RELEASE_TAG.match(n)]
    if not releases:
        return names[0]

    def numeric(tag: str) -> list[int]:
        return [int(part) for part in re.findall(r"\d+", tag)]

    return max(releases, key=numeric)


def extract_lean_version(toolchain: str) -> str:
    """'leanprover/lean4:v4.27.0' -> 'v4.27.0' (rc suffixes preserved)."""
    found = _TOOLCHAIN_VERSION.search(toolchain)
    if not found:
        raise ValueError(f"no Lean version inside toolchain pin {toolchain!r}")
    return found.group()
