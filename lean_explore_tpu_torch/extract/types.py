"""Transfer types for the extraction pipeline
(lean_explore_tpu/extract/types.py): ``ParsedDeclaration`` as a dataclass,
since the port does not use pydantic."""

from dataclasses import dataclass


@dataclass
class ParsedDeclaration:
    """A declaration parsed from doc-gen4 output, pre-database."""

    name: str
    module: str
    source_text: str
    source_link: str
    docstring: str | None = None
    dependencies: list[str] | None = None
