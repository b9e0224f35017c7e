"""Registry–test cross-referencing of the port.

Every entry of a behaviour registry (attack ``SCENARIOS``, ``DEFENSES``,
``TASKS``, scheduler ``POLICY_IDS``) must be exercised by the port's
parity tests, and every kernel of ``kernels/build.py::KERNELS`` must ship
a ``<name>_ref`` plain version, an operator of torch's dispatcher with its
cost (``kernels/oplib.COSTS``) and a test. Coverage is established by
*test AST evidence*, not by running the tests:

- a ``pytest.mark.parametrize`` whose argvalues expression mentions the
  registry symbol itself (e.g. ``sorted(atk.SCENARIOS)``) covers every
  entry by construction — the matrix can never lag the registry;
- otherwise each entry name must appear as a string literal somewhere
  in the designated test module (or its extras).

The checkers import the live registries, so registering a new scenario /
defense / task / policy without test coverage fails at
``tests/test_torch_check.py``.
"""
from __future__ import annotations

import ast
import importlib
from typing import Iterable, List, Optional, Sequence

from repro_torch.check.common import (SRC_PREFIX, CheckContext, Violation,
                                      dotted_name)


def _string_literals(tree: ast.AST) -> set:
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def _parametrizes_over(tree: ast.AST, symbol: str) -> bool:
    """True if some ``parametrize(...)`` call's argument expression
    references ``symbol`` (as a bare name or attribute tail)."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and (dotted_name(node.func) or "").endswith("parametrize")):
            continue
        for arg in list(node.args) + [k.value for k in node.keywords]:
            for sub in ast.walk(arg):
                name = dotted_name(sub)
                if name and name.split(".")[-1] == symbol:
                    return True
    return False


def registry_coverage(entries: Iterable[str], symbol: str,
                      test_tree: ast.AST, test_rel: str,
                      extra_trees: Sequence[ast.AST] = ()
                      ) -> List[Violation]:
    """Violations for registry entries with no test evidence.

    ``entries`` — the live registry's keys; ``symbol`` — the registry's
    attribute name (``SCENARIOS``, ``DEFENSES``, ...); ``test_tree`` —
    the designated test module's AST; ``extra_trees`` — further modules
    whose string literals also count as evidence.
    """
    trees = [test_tree, *extra_trees]
    if any(_parametrizes_over(t, symbol) for t in trees):
        return []
    literals = set()
    for t in trees:
        literals |= _string_literals(t)
    return [Violation(
        rule="registry-coverage", path=test_rel, line=1,
        message=f"registry entry `{name}` of `{symbol}` has no "
                f"coverage in {test_rel} — parametrize the matrix over "
                f"the registry (e.g. `sorted({symbol})`) or reference "
                "the entry explicitly")
        for name in sorted(entries) if name not in literals]


def _names_in(tree: ast.AST) -> set:
    names = {n.split(".")[-1] for n in map(dotted_name, ast.walk(tree)) if n}
    return names | _string_literals(tree)


def kernel_ref_twins(kernels: Iterable[str], ref_module,
                     test_tree: Optional[ast.AST], test_rel: str
                     ) -> List[Violation]:
    """Every kernel wrapper needs a ``<name>_ref`` plain version in
    ``ref_module`` and a reference to BOTH names in the test module — the
    JAX package's form of the rule, one module for all twins (the port's
    own wiring, ``check_kernel_twins``, hands it each kernel's module)."""
    out: List[Violation] = []
    names_in_test = _names_in(test_tree) if test_tree is not None else set()
    for k in sorted(kernels):
        twin = f"{k}_ref"
        if not hasattr(ref_module, twin):
            out.append(Violation(
                rule="kernel-ref-twin",
                path=SRC_PREFIX + f"kernels/{k}.py", line=1,
                message=f"kernel `{k}` has no `{twin}` plain version in "
                        "its module — every kernel ships a plain PyTorch "
                        "twin"))
            continue
        if test_tree is not None and not (
                k in names_in_test and twin in names_in_test):
            missing = [n for n in (k, twin) if n not in names_in_test]
            out.append(Violation(
                rule="kernel-ref-twin", path=test_rel, line=1,
                message=f"kernel `{k}`: {', '.join(missing)} never "
                        f"referenced in {test_rel} — the kernel/ref "
                        "pair must be pinned by a parity test"))
    return out


# --------------------------------------------------------------------- #
# repo wiring
# --------------------------------------------------------------------- #
def _test_tree(ctx: CheckContext, name: str):
    path = ctx.tests_root / name
    if not path.exists():
        return None
    return ast.parse(path.read_text(), filename=str(path))


def check_registries(ctx: CheckContext) -> List[Violation]:
    from repro_torch.core import attacks as atk
    from repro_torch.core import defenses as dfs
    from repro_torch.core.scheduler import POLICY_IDS
    from repro_torch.federated.task import TASKS

    out: List[Violation] = []
    specs = [
        (atk.SCENARIOS, "SCENARIOS", "test_torch_attacks.py", ()),
        (dfs.DEFENSES, "DEFENSES", "test_torch_defenses.py", ()),
        (TASKS, "TASKS", "test_torch_lm_task.py", ()),
        # policies have no single matrix file; any sweep/simulation/control
        # test referencing the name (or a parametrize over POLICY_IDS)
        # counts
        (POLICY_IDS, "POLICY_IDS", "test_torch_control.py",
         ("test_torch_sweep.py", "test_torch_simulation.py",
          "test_torch_batched_control.py")),
    ]
    for entries, symbol, test_name, extra in specs:
        tree = _test_tree(ctx, test_name)
        if tree is None:
            out.append(Violation(
                rule="registry-coverage", path=f"tests/{test_name}",
                line=1,
                message=f"test module for `{symbol}` not found"))
            continue
        extra_trees = [t for t in (_test_tree(ctx, e) for e in extra)
                       if t is not None]
        out.extend(registry_coverage(entries, symbol, tree,
                                     f"tests/{test_name}", extra_trees))
    return out


def check_kernel_twins(ctx: CheckContext) -> List[Violation]:
    """Each kernel of ``build.KERNELS``: a ``<name>_ref`` in its own
    module, an operator in ``oplib.COSTS``, and a ``tests/test_torch_*.py``
    file that names both the kernel and its twin."""
    import torch

    from repro_torch.kernels import build, oplib

    trees = {p.name: ast.parse(p.read_text(), filename=str(p))
             for p in sorted(ctx.tests_root.glob("test_torch_*.py"))}
    names = {f: _names_in(t) for f, t in trees.items()}
    out: List[Violation] = []
    for k in build.KERNELS:
        mod = importlib.import_module(f"repro_torch.kernels.{k}")
        twin = f"{k}_ref"
        found = sorted(f for f, n in names.items() if {k, twin} <= n)
        out += kernel_ref_twins(
            [k], mod, trees[found[0]] if found else ast.parse(""),
            f"tests/{found[0]}" if found else "tests/test_torch_*.py")
        if getattr(torch.ops.repro_torch, k, None) not in oplib.COSTS:
            out.append(Violation(
                rule="kernel-ref-twin", path=SRC_PREFIX + f"kernels/{k}.py",
                line=1,
                message=f"kernel `{k}` is no operator of "
                        "`kernels/oplib.py` with a cost — define it "
                        "through `oplib.define`"))
    return out
