"""Shared plumbing for the port's contract checker
(``python -m repro_torch.check``).

A checker is a function ``(CheckContext) -> List[Violation]``; the
registry in ``repro_torch.check.__init__`` runs them all. Source files are
parsed once into ``SourceFile`` records (path + text + AST + waivers) and
shared across the AST lints. The checked tree is ``src/repro_torch``.

Waivers: a violation that is *intentional* (a documented contract
exception) is silenced by a ``# repro: allow(rule-name)`` comment on the
offending line or the line directly above it, the same syntax as the JAX
package's checker. Every waiver names the one rule it silences — there is
no blanket opt-out — so exceptions stay greppable and reviewable.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Set

PACKAGE = "repro_torch"
SRC_PREFIX = f"src/{PACKAGE}/"


@dataclasses.dataclass(frozen=True)
class Violation:
    """One contract violation: ``rule`` is the checker's kebab-case id,
    ``path`` is repo-relative, ``line`` is 1-indexed."""
    rule: str
    path: str
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


_WAIVER_RE = re.compile(r"#\s*repro:\s*allow\(([a-z0-9_-]+)\)")


def parse_waivers(text: str) -> Dict[int, Set[str]]:
    """line (1-indexed) -> set of rule names waived ON that line.

    A waiver comment covers its own line and the line below it, so both
    trailing comments and comment-above style work::

        n2 = (d.to(torch.float64) ** 2).sum(1)   # repro: allow(dtype-f64)

        # repro: allow(dtype-f64)
        n2 = (d.to(torch.float64) ** 2).sum(1)
    """
    waivers: Dict[int, Set[str]] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        for m in _WAIVER_RE.finditer(line):
            waivers.setdefault(i, set()).add(m.group(1))
            waivers.setdefault(i + 1, set()).add(m.group(1))
    return waivers


@dataclasses.dataclass
class SourceFile:
    """One parsed python source file under the checked tree."""
    path: Path               # absolute
    rel: str                 # repo-relative, posix separators
    text: str
    tree: ast.Module
    waivers: Dict[int, Set[str]]

    @classmethod
    def parse(cls, path: Path, root: Path) -> "SourceFile":
        text = path.read_text()
        return cls(path=path, rel=path.relative_to(root).as_posix(),
                   text=text, tree=ast.parse(text, filename=str(path)),
                   waivers=parse_waivers(text))

    @classmethod
    def from_text(cls, text: str, rel: str = "<snippet>") -> "SourceFile":
        """Parse an in-memory snippet (the self-tests inject violations
        into synthetic sources through this)."""
        return cls(path=Path(rel), rel=rel, text=text,
                   tree=ast.parse(text), waivers=parse_waivers(text))

    def waived(self, rule: str, line: int) -> bool:
        return rule in self.waivers.get(line, ())


@dataclasses.dataclass
class CheckContext:
    """Everything a checker may need: the repo root, the parsed source
    set, and the test tree for cross-referencing."""
    repo_root: Path
    sources: List[SourceFile]

    @property
    def tests_root(self) -> Path:
        return self.repo_root / "tests"


def load_sources(repo_root: Path,
                 subdir: str = f"src/{PACKAGE}") -> List[SourceFile]:
    """Parse every ``.py`` under ``repo_root/subdir`` (sorted, stable)."""
    base = repo_root / subdir
    return [SourceFile.parse(p, repo_root)
            for p in sorted(base.rglob("*.py"))]


def make_context(repo_root: Path) -> CheckContext:
    return CheckContext(repo_root=Path(repo_root),
                        sources=load_sources(Path(repo_root)))


def iter_functions(tree: ast.AST):
    """Yield every (async) function definition, including nested ones."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None
