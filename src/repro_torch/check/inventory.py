"""Dead-inheritance inventory of the port — a report, not a gate.

Build the ``repro_torch.*`` import graph, take every module imported
(transitively) from ``tests/``, ``examples/``, ``benchmarks/`` and
``chip_smoke.py`` as live, and report the rest with line counts. Dead
modules are NOT violations; the report exists so growth is a decision,
not an accident. ``tests/test_torch_check.py`` pins the planes the port
has brought up OFF this list, so none can silently lose its last caller.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Set

from repro_torch.check.common import PACKAGE, CheckContext

ROOT_DIRS = ("tests", "examples", "benchmarks")
ROOT_FILES = ("chip_smoke.py",)


def _module_name(rel: str) -> str:
    """'src/repro_torch/core/attacks.py' -> 'repro_torch.core.attacks'."""
    parts = Path(rel).with_suffix("").parts
    parts = parts[parts.index(PACKAGE):]
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _imports_of(tree: ast.Module, known: Set[str]) -> Set[str]:
    """repro_torch.* modules referenced by a module's import statements."""
    out: Set[str] = set()

    def add(name: str) -> None:
        if name in known:
            out.add(name)

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                add(a.name)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[0] == PACKAGE:
            add(node.module)
            for a in node.names:
                add(f"{node.module}.{a.name}")
    return out


def _root_files(repo_root: Path) -> List[Path]:
    files = [repo_root / f for f in ROOT_FILES if (repo_root / f).is_file()]
    for d in ROOT_DIRS:
        base = repo_root / d
        if base.is_dir():
            files += sorted(base.rglob("*.py"))
    return files


def build_inventory(ctx: CheckContext) -> Dict:
    modules: Dict[str, object] = {}      # module -> SourceFile
    for src in ctx.sources:
        modules[_module_name(src.rel)] = src
    known = set(modules)

    graph = {m: _imports_of(src.tree, known)
             for m, src in modules.items()}
    # a submodule implicitly keeps its package __init__ alive
    for m in list(graph):
        parts = m.split(".")
        for i in range(1, len(parts)):
            pkg = ".".join(parts[:i])
            if pkg in known:
                graph[m].add(pkg)

    roots: Set[str] = set()
    for p in _root_files(ctx.repo_root):
        try:
            tree = ast.parse(p.read_text())
        except SyntaxError:
            continue
        roots |= _imports_of(tree, known)

    live: Set[str] = set()
    frontier = list(roots)
    while frontier:
        m = frontier.pop()
        if m in live:
            continue
        live.add(m)
        frontier.extend(graph.get(m, ()))

    dead = sorted(known - live)
    records: List[Dict] = []
    for m in dead:
        src = modules[m]
        records.append({"module": m, "path": src.rel,
                        "loc": src.text.count("\n") + 1})
    total = sum(r["loc"] for r in records)
    by_pkg: Dict[str, int] = {}
    for r in records:
        pkg = r["module"].split(".")[1] if "." in r["module"] else "."
        by_pkg[pkg] = by_pkg.get(pkg, 0) + r["loc"]
    return {"n_modules": len(known), "n_live": len(live & known),
            "n_dead": len(dead), "dead_loc": total,
            "dead_by_package": dict(sorted(by_pkg.items())),
            "dead": records}
