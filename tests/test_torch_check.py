"""The port's contract checker (``repro_torch.check``) against the JAX
package's (``repro.check``), and its own gates and self-tests.

Five parts:
- the same verdicts on the same inputs: ``parse_waivers`` on drawn text,
  ``registry_coverage`` and ``kernel_ref_twins`` on the reference's own
  self-test snippets, and the wall-clock, numpy-RNG and masked-mean lints
  on tests/test_check.py's snippets (``jnp`` rewritten to ``torch``) give
  equal ``(rule, line)`` lists;
- the registries and the trace: the port's four registries hold the
  reference's keys, the trace entries match the reference's one for one,
  and both checkers are clean on their own trees;
- per-checker self-tests: mutate a known-good snippet (a torch call in a
  host oracle, ``.item()`` on a launch path, a draw from torch's global
  generator, a float64 in models/, an unguarded masked mean, a dropped
  registry entry, a deleted ``_ref`` twin, a float64 promotion, a trace
  error, a float32 control output) and assert the checker catches exactly
  that — a checker that cannot detect its own target is silently useless;
- the gates: ``run_checks(device="cpu")`` is clean, ``run_checks()``
  without CUDA raises, and the CLI's report has the reference's schema;
- the dead-inheritance inventory keeps the planes the port brought up
  live.
"""
import ast
import json
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st
from torch_parity import reference

from repro_torch.check import CHECKERS, run_checks
from repro_torch.check.__main__ import main as check_main
from repro_torch.check.common import SourceFile, parse_waivers
from repro_torch.check.lints import (check_dtype, check_host_sync,
                                     check_nondeterminism,
                                     check_oracle_purity, lint_clock_imports,
                                     lint_dtype_f64, lint_host_sync,
                                     lint_masked_mean, lint_nondeterminism,
                                     lint_oracle_purity, lint_wall_clock)
from repro_torch.check.registry import (check_kernel_twins,
                                        check_registries, kernel_ref_twins,
                                        registry_coverage)
from repro_torch.check.trace import (assert_f64_outputs, assert_no_f64,
                                     check_static_args, check_traces,
                                     trace_entries, trace_report)

ROOT = Path(__file__).resolve().parents[1]

# the reference's trace entries -> the port's, in the reference's order
TRACE_NAMES = {
    "cohort.cohort_train": "cohort.cohort_train",
    "cohort.cohort_eval": "cohort.cohort_eval",
    "aggregation.fedavg_stacked": "aggregation.fedavg_stacked",
    "kernels.robust_aggregate_ref[trimmed_mean]":
        "kernels.robust_aggregate[trimmed_mean]",
    "kernels.robust_aggregate_ref[median]":
        "kernels.robust_aggregate[median]",
    "kernels.weighted_aggregate_ref": "kernels.weighted_aggregate",
    "attacks.ModelAttack.apply_stacked": "attacks.ModelAttack.apply_stacked",
    "control._finalize_kernel": "control.finalize_runs[device]",
    "control._schedule_kernel": "control._schedule_device",
}


@pytest.fixture(scope="module")
def ref():
    return types.SimpleNamespace(
        check=reference("check"), common=reference("check.common"),
        lints=reference("check.lints"), registry=reference("check.registry"),
        trace=reference("check.trace"), main=reference("check.__main__"),
        atk=reference("core.attacks"), dfs=reference("core.defenses"),
        sched=reference("core.scheduler"), task=reference("federated.task"))


def _src(text, rel="<snippet>"):
    return SourceFile.from_text(textwrap.dedent(text), rel=rel)


def _to_torch(text):
    """A reference snippet with its array library rewritten to torch."""
    return textwrap.dedent(text).replace(
        "import jax.numpy as jnp", "import torch").replace("jnp.", "torch.")


def _verdicts(vs):
    return [(v.rule, v.line) for v in vs]


# ---------------------------------------------------------------------- #
# 1. the same verdicts as repro.check on the same inputs
# ---------------------------------------------------------------------- #
_WAIVER_LINES = ["x = 1", "# repro: allow(dtype-f64)",
                 "y = f(x)  # repro: allow(nondeterminism)",
                 "#repro:allow(host-sync)", "# repro: allow(Bad Rule)",
                 "z = 2  # repro: allow(a) # repro: allow(b-c)", "",
                 "# repro allow(missing-colon)", "    # repro: allow(x_y)"]


@given(st.lists(st.sampled_from(_WAIVER_LINES), min_size=0, max_size=8),
       st.text(alphabet="abc-_() #:", min_size=0, max_size=12))
@settings(max_examples=25, deadline=None)
def test_parse_waivers_agrees_with_the_reference(ref, lines, tail):
    text = "\n".join(lines + [f"w = 0  # repro: allow({tail})", tail])
    assert parse_waivers(text) == ref.common.parse_waivers(text)


_CLOCK_SNIPPETS = [
    ("""
        import time

        def timed():
            return time.perf_counter()
    """, "launch/serve.py"),
    ("""
        from time import monotonic

        def timed():
            return monotonic()
    """, "launch/dryrun.py"),
    ("x = 1", "launch/serve.py"),
    ("""
        import time

        def timed():
            # repro: allow(nondeterminism)
            return time.time()
    """, "launch/serve.py"),
]

_RNG_SNIPPETS = [
    """
        import time
        import numpy as np

        def sample():
            t = time.time()
            u = np.random.normal(size=3)
            rng = np.random.default_rng()
            return t, u, rng
    """,
    """
        import numpy as np

        def sample(seed):
            rng = np.random.default_rng(seed)
            return rng.normal(size=3)
    """,
    """
        import heapq
        import time

        def run(heap):
            while heap:
                t_arr, e = heapq.heappop(heap)
                time.sleep(t_arr - time.time())
                yield e
    """,
    """
        import numpy as np

        def sample():
            # repro: allow(nondeterminism)
            return np.random.normal(size=3)
    """,
    """
        import numpy as np

        def sample():
            # repro: allow(dtype-f64)
            return np.random.normal(size=3)
    """,
]

_MASKED_MEAN_SNIPPETS = [
    """
        import jax.numpy as jnp

        def mean(x, m):
            return jnp.sum(x * m) / jnp.sum(m)
    """,
    """
        import jax.numpy as jnp

        def mean(x, m):
            return jnp.sum(x * m) / jnp.maximum(jnp.sum(m), 1.0)
    """,
]


@pytest.mark.parametrize("i", range(len(_CLOCK_SNIPPETS)))
def test_wall_clock_lint_agrees_with_the_reference(ref, i):
    text, sub = _CLOCK_SNIPPETS[i]
    mine = lint_wall_clock(_src(text, f"src/repro_torch/{sub}"))
    theirs = ref.lints.lint_wall_clock(
        ref.common.SourceFile.from_text(textwrap.dedent(text),
                                        rel=f"src/repro/{sub}"))
    assert _verdicts(mine) == _verdicts(theirs)
    assert all("repro_torch.obs.clock" in v.message for v in mine)


@pytest.mark.parametrize("i", range(len(_RNG_SNIPPETS)))
def test_numpy_rng_lint_agrees_with_the_reference(ref, i):
    text = _RNG_SNIPPETS[i]
    rel = "federated/async_engine.py"
    mine = lint_nondeterminism(_src(text, f"src/repro_torch/{rel}"))
    theirs = ref.lints.lint_nondeterminism(
        ref.common.SourceFile.from_text(textwrap.dedent(text),
                                        rel=f"src/repro/{rel}"))
    assert _verdicts(mine) == _verdicts(theirs)
    assert [v.message for v in mine] == [v.message for v in theirs]


@pytest.mark.parametrize("i", range(len(_MASKED_MEAN_SNIPPETS)))
def test_masked_mean_lint_agrees_with_the_reference(ref, i):
    text = _MASKED_MEAN_SNIPPETS[i]
    mine = lint_masked_mean(SourceFile.from_text(_to_torch(text)))
    theirs = ref.lints.lint_masked_mean(
        ref.common.SourceFile.from_text(textwrap.dedent(text)))
    assert _verdicts(mine) == _verdicts(theirs)


def _coverage_cases():
    para = ast.parse("import pytest\n"
                     "@pytest.mark.parametrize('name', sorted(REG))\n"
                     "def test_all(name):\n    pass\n")
    covered = ast.parse("def test_a():\n    run('alpha')\n"
                        "def test_b():\n    run('beta')\n")
    partial_ = ast.parse("def test_a():\n    run('alpha')\n")
    return [({"alpha", "beta"}, covered), ({"alpha", "beta"}, partial_),
            ({"a", "b", "zzz-new"}, para), ({"alpha"}, ast.parse("x = 1"))]


@pytest.mark.parametrize("i", range(4))
def test_registry_coverage_agrees_with_the_reference(ref, i):
    entries, tree = _coverage_cases()[i]
    mine = registry_coverage(entries, "REG", tree, "tests/t.py")
    theirs = ref.registry.registry_coverage(entries, "REG", tree,
                                            "tests/t.py")
    assert [v.message for v in mine] == [v.message for v in theirs]
    assert _verdicts(mine) == _verdicts(theirs)


@pytest.mark.parametrize("kernels,test_src", [
    (["foo"], "from k import foo, foo_ref\n"
              "def test_foo():\n    assert foo and foo_ref\n"),
    (["foo", "bar"], "from k import foo, foo_ref\n"
                     "def test_foo():\n    assert foo and foo_ref\n"),
    (["foo"], "x = 1"),
    (["foo"], None),
])
def test_kernel_ref_twins_agrees_with_the_reference(ref, kernels, test_src):
    ref_mod = types.SimpleNamespace(foo_ref=object())
    tree = None if test_src is None else ast.parse(test_src)
    mine = kernel_ref_twins(kernels, ref_mod, tree, "tests/t.py")
    theirs = ref.registry.kernel_ref_twins(kernels, ref_mod, tree,
                                           "tests/t.py")
    assert [v.rule for v in mine] == [v.rule for v in theirs]
    assert [v.line for v in mine] == [v.line for v in theirs]
    for a, b in zip(mine, theirs):
        for word in ("bar_ref", "never referenced"):
            assert (word in a.message) == (word in b.message)


@given(st.dictionaries(st.text(alphabet="abcdefgh_", min_size=1,
                               max_size=8),
                       st.booleans(), min_size=1, max_size=6))
@settings(max_examples=10, deadline=None)
def test_registry_coverage_property_agrees(ref, reg):
    """For any registry, full coverage and coverage missing its first
    entry give the reference's verdicts."""
    names = sorted(reg)
    for kept in (names, names[1:]):
        tree = ast.parse("\n".join(
            f"def test_{i}():\n    use({n!r})"
            for i, n in enumerate(kept)) or "x = 1")
        mine = registry_coverage(names, "REG", tree, "tests/t.py")
        theirs = ref.registry.registry_coverage(names, "REG", tree,
                                                "tests/t.py")
        assert [v.message for v in mine] == [v.message for v in theirs]


def test_checker_names_are_the_references(ref):
    theirs = ["host-sync" if n == "tracer-leak" else n
              for n in ref.check.CHECKERS]
    assert list(CHECKERS) == theirs == [
        "oracle-purity", "host-sync", "nondeterminism", "dtype",
        "registry-coverage", "kernel-ref-twin", "static-args", "trace"]


# ---------------------------------------------------------------------- #
# 2. registries and trace entries
# ---------------------------------------------------------------------- #
def test_the_registries_hold_the_references_keys(ref):
    from repro_torch.core import attacks as atk
    from repro_torch.core import defenses as dfs
    from repro_torch.core.scheduler import POLICY_IDS
    from repro_torch.federated.task import TASKS
    assert sorted(atk.SCENARIOS) == sorted(ref.atk.SCENARIOS)
    assert sorted(dfs.DEFENSES) == sorted(ref.dfs.DEFENSES)
    assert sorted(TASKS) == sorted(ref.task.TASKS)
    assert POLICY_IDS == ref.sched.POLICY_IDS


def test_trace_entries_match_the_references_one_for_one(ref, monkeypatch):
    """Run the reference's ``check_traces`` with its two assertions
    replaced by recorders: the port's entries are its entries, in its
    order, each of the same kind."""
    seen = []
    monkeypatch.setattr(ref.trace, "assert_no_f64",
                        lambda name, fn: seen.append((name, "f32")) or [])
    monkeypatch.setattr(ref.trace, "assert_f64_outputs",
                        lambda name, fn: seen.append((name, "f64")) or [])
    assert ref.trace.check_traces(None) == []
    mine = [(name, kind) for name, kind, _ in
            trace_entries(torch.device("cpu"))]
    assert [n for n, _ in seen] == list(TRACE_NAMES)
    assert mine == [(TRACE_NAMES[n], k) for n, k in seen]


def test_the_trace_goes_through_the_k1_and_k2_operators():
    """On the CPU the operators run their plain versions; the trace sees
    each as one operator, and the control entries run in float64."""
    report = {e["name"]: e for e in trace_report("cpu")}
    for name in ("aggregation.fedavg_stacked", "kernels.weighted_aggregate"):
        assert "repro_torch.weighted_aggregate" in report[name]["ops"]
    for mode in ("trimmed_mean", "median"):
        ops = report[f"kernels.robust_aggregate[{mode}]"]["ops"]
        assert "repro_torch.robust_aggregate" in ops
        assert "aten.sort" not in ops           # the plain version is inside
    for e in report.values():
        assert e["violations"] == [] and e["ops"] and e["outputs"], e
        want = "float32" if e["kind"] == "f32" else "float64"
        assert {dt.split(".")[-1] for dt in e["outputs"]} == {want}, e


def test_both_checkers_are_clean_on_their_own_trees(ref):
    theirs = ref.check.run_checks()
    assert [v.format() for v in theirs.violations] == []
    mine = run_checks(device="cpu")
    assert [v.format() for v in mine.violations] == []
    assert mine.ok and set(mine.per_checker) == set(CHECKERS)
    assert all(n == 0 for n in mine.per_checker.values())


# ---------------------------------------------------------------------- #
# 3. self-tests: each checker catches its own target
# ---------------------------------------------------------------------- #
def test_oracle_purity_catches_injected_torch():
    good = _src("""
        import numpy as np
        import torch

        def agg_host(x):
            return np.sum(x, axis=0)

        def agg_batched(x):
            return torch.sum(x, dim=0)     # not an oracle: torch is fine
    """)
    assert lint_oracle_purity(good) == []
    bad = _src("""
        import numpy as np
        import torch

        def agg_host(x):
            return torch.as_tensor(x).sum(0).numpy()
    """)
    vs = lint_oracle_purity(bad)
    assert _verdicts(vs) == [("oracle-purity", 6)]
    assert "agg_host" in vs[0].message
    oracle = _src("""
        import torch as T

        def eval_oracle(p):
            return T.zeros(3)
    """)
    assert _verdicts(lint_oracle_purity(oracle)) == [("oracle-purity", 5)]
    # through the checker: the host oracles of core/ are in scope
    ctx = types.SimpleNamespace(sources=[
        _src(bad.text, "src/repro_torch/core/defenses.py")])
    assert len(check_oracle_purity(ctx)) == 1


_KERNEL_MODULE = '''
import torch
from typing import Optional


def _kernel(x: torch.Tensor, n: int, flag: bool,
            w: Optional[int]) -> torch.Tensor:
    m = int(x.shape[1]) + int(x.numel()) + int(n) + int(flag)
    {inject}
    return x.new_empty(m)


class _Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return _kernel(x, 1, True, None)


def foo(x: torch.Tensor, n: int) -> torch.Tensor:
    return _Fn.apply(x, n)


def cost(x):
    return float(x.sum()), x.tolist()      # a host helper: not a launch path
'''


@pytest.mark.parametrize("inject,hits", [
    ("pass", []),
    ("m = m + x.sum().item()", [".item()"]),
    ("m = m + int(x.max())", ["`int()` on tensor argument `x`"]),
    ("torch.cuda.synchronize()", [".synchronize()"]),
    ("s = x.cpu().numpy()", [".numpy()", ".cpu()"]),
    ("m = bool(x[0])", ["`bool()` on tensor argument `x`"]),
    ("m = x.tolist()", [".tolist()"]),
])
def test_host_sync_catches_a_host_read_on_a_launch_path(inject, hits):
    text = _KERNEL_MODULE.format(inject=inject)
    src = SourceFile.from_text(text, rel="src/repro_torch/kernels/foo.py")
    vs = lint_host_sync(src)
    line = text.splitlines().index(f"    {inject}") + 1
    assert [v.line for v in vs] == [line] * len(hits)
    assert all(v.rule == "host-sync" and "_kernel" in v.message for v in vs)
    for want in hits:
        assert any(want in v.message for v in vs), (want, vs)
    # an autograd Function's forward is a launch path (ctx is no tensor)
    fwd = text.replace("ctx.n = n", "ctx.n = int(x)")
    extra = lint_host_sync(SourceFile.from_text(
        fwd, rel="src/repro_torch/kernels/foo.py"))[len(vs):]
    assert [(v.rule, "`forward`" in v.message) for v in extra] == [
        ("host-sync", True)]
    # the public wrapper, named after its module, is a launch path
    wrap = text.replace("return _Fn.apply(x, n)",
                        "return _Fn.apply(x, x.sum().item())")
    assert any("`foo`" in v.message for v in lint_host_sync(
        SourceFile.from_text(wrap, rel="src/repro_torch/kernels/foo.py")))
    # only kernels/ is in the checker's scope
    ctx = types.SimpleNamespace(sources=[
        SourceFile.from_text(text, rel="src/repro_torch/models/foo.py")])
    assert check_host_sync(ctx) == []


def test_host_sync_waiver_silences_one_line():
    text = _KERNEL_MODULE.format(
        inject="m = m + x.sum().item()  # repro: allow(host-sync)")
    assert lint_host_sync(SourceFile.from_text(
        text, rel="src/repro_torch/kernels/foo.py")) == []


@pytest.mark.parametrize("call,bad", [
    ("torch.randn(3)", True),
    ("torch.randn(3, generator=g)", False),
    ("torch.rand(2, 2)", True),
    ("torch.randint(0, 5, (3,))", True),
    ("torch.randperm(7, generator=g)", False),
    ("torch.normal(0.0, 1.0, (3,))", True),
    ("torch.bernoulli(p)", True),
    ("torch.multinomial(p, 2, generator=g)", False),
    ("torch.empty(3).uniform_(0, 1)", True),
    ("torch.empty(3).uniform_(0, 1, generator=g)", False),
    ("x.normal_()", True),
    ("x.exponential_(generator=g)", False),
    ("torch.manual_seed(0)", True),
    ("torch.seed()", True),
    ("torch.cuda.manual_seed(0)", True),
    ("torch.cuda.manual_seed_all(0)", True),
    ("torch.Generator().manual_seed(0)", False),
    ("g.manual_seed(0)", False),
])
def test_nondeterminism_catches_torchs_global_generator(call, bad):
    src = _src(f"""
        import torch

        def sample(g, p, x):
            return {call}
    """, "src/repro_torch/models/x.py")
    vs = lint_nondeterminism(src)
    assert _verdicts(vs) == ([("nondeterminism", 5)] if bad else [])


def test_check_nondeterminism_exempts_only_obs_clock():
    """Simulation dirs get the full lint, every other src/repro_torch file
    the wall-clock half and the clock-import rule, and obs/clock.py — the
    one sanctioned site — is exempt."""
    code = "import time\n\ndef t():\n    return time.monotonic()\n"

    def ctx(rel):
        return types.SimpleNamespace(
            sources=[SourceFile.from_text(code, rel=rel)])

    assert check_nondeterminism(ctx("src/repro_torch/obs/clock.py")) == []
    for rel in ("src/repro_torch/obs/trace.py",
                "src/repro_torch/launch/serve.py",
                "src/repro_torch/federated/server.py"):
        assert _verdicts(check_nondeterminism(ctx(rel))) == [
            ("nondeterminism", 4), ("nondeterminism", 1)], rel
    assert check_nondeterminism(ctx("tests/whatever.py")) == []
    imports = SourceFile.from_text(
        "import datetime\nfrom timeit import default_timer\nimport os\n",
        rel="src/repro_torch/launch/x.py")
    assert _verdicts(lint_clock_imports(imports)) == [
        ("nondeterminism", 1), ("nondeterminism", 2)]


@pytest.mark.parametrize("expr,bad", [
    ("x.to(torch.float64)", True),
    ("x.double()", True),
    ("torch.zeros(3, dtype=torch.double)", True),
    ("x.to(torch.float32)", False),
    ("np.float64(x)", False),
])
def test_dtype_f64_outside_the_control_plane(expr, bad):
    text = f"""
        import numpy as np
        import torch

        def promote(x):
            return {expr}
    """
    assert _verdicts(lint_dtype_f64(_src(text))) == (
        [("dtype-f64", 6)] if bad else [])

    def ctx(rel):
        return types.SimpleNamespace(sources=[_src(text, rel)])

    # models/ is data plane; the control plane's modules may hold float64
    assert len(check_dtype(ctx("src/repro_torch/models/mlp.py"))) == bad
    assert check_dtype(ctx("src/repro_torch/core/control.py")) == []
    assert check_dtype(ctx("src/repro_torch/core/reputation.py")) == []
    waived = text.replace(f"return {expr}",
                          f"return {expr}  # repro: allow(dtype-f64)")
    assert lint_dtype_f64(_src(waived)) == []


@pytest.mark.parametrize("expr,bad", [
    ("torch.sum(x * m) / torch.sum(m)", True),
    ("(x * m).sum() / m.sum()", True),
    ("(x * m).sum(-1) / m.sum(-1)", True),
    ("(x * m).sum(-1) / m.sum(-1).clamp_min(1.0)", False),
    ("torch.sum(x * m) / torch.maximum(torch.sum(m), one)", False),
    ("np.sum(x * m) / np.sum(m)", False),            # the host's
])
def test_masked_mean_pin(expr, bad):
    src = _src(f"""
        import numpy as np
        import torch

        def mean(x, m, one):
            return {expr}
    """)
    assert _verdicts(lint_masked_mean(src)) == (
        [("masked-mean-pin", 6)] if bad else [])


def test_registry_coverage_catches_a_dropped_entry(monkeypatch):
    """A policy no test names (the policy files cover POLICY_IDS by
    literal, not by a parametrize over the registry)."""
    from repro_torch.core import scheduler
    assert check_registries(types.SimpleNamespace(
        tests_root=ROOT / "tests")) == []
    monkeypatch.setitem(scheduler.POLICY_IDS, "dropped_policy", 99)
    vs = check_registries(types.SimpleNamespace(tests_root=ROOT / "tests"))
    assert [(v.rule, v.path) for v in vs] == [
        ("registry-coverage", "tests/test_torch_control.py")]
    assert "`dropped_policy` of `POLICY_IDS`" in vs[0].message


def test_kernel_twin_catches_a_deleted_ref(monkeypatch):
    from repro_torch.kernels import weighted_aggregate as k1
    ctx = types.SimpleNamespace(tests_root=ROOT / "tests")
    assert check_kernel_twins(ctx) == []
    monkeypatch.delattr(k1, "weighted_aggregate_ref")
    vs = check_kernel_twins(ctx)
    assert [(v.rule, v.path) for v in vs] == [
        ("kernel-ref-twin",
         "src/repro_torch/kernels/weighted_aggregate.py")]
    assert "weighted_aggregate_ref" in vs[0].message


def test_kernel_twin_needs_an_operator_and_a_test(monkeypatch, tmp_path):
    from repro_torch.kernels import moe_gemm, oplib  # noqa: F401
    ctx = types.SimpleNamespace(tests_root=ROOT / "tests")
    monkeypatch.delitem(oplib.COSTS, torch.ops.repro_torch.moe_gemm)
    vs = check_kernel_twins(ctx)
    assert [v.rule for v in vs] == ["kernel-ref-twin"]
    assert "moe_gemm" in vs[0].message and "oplib" in vs[0].message
    monkeypatch.undo()
    # no test file names the pair
    (tmp_path / "test_torch_x.py").write_text("x = 1\n")
    vs = check_kernel_twins(types.SimpleNamespace(tests_root=tmp_path))
    assert len(vs) == 6 and all("never referenced" in v.message
                                for v in vs)


def test_trace_checker_catches_f64_promotion():
    x32 = torch.ones(3)
    assert assert_no_f64("good", lambda: x32 * 2.0) == []
    vs = assert_no_f64("bad", lambda: x32.to(torch.float64) + 1.0)
    assert vs and all(v.rule == "trace-f64" for v in vs)
    assert "conversion to float64" in vs[0].message
    assert len(assert_no_f64("bad", lambda: x32.double())) == 1


def test_trace_checker_reports_trace_errors():
    def boom():
        raise ValueError("no inputs")
    vs = assert_no_f64("broken", boom)
    assert len(vs) == 1 and vs[0].rule == "trace-error"
    assert len(assert_f64_outputs("broken", boom)) == 1


def test_control_f64_pin():
    x64 = torch.zeros(3, dtype=torch.float64)
    assert assert_f64_outputs("good", lambda: (x64 + 1.0,
                                               np.zeros(2))) == []
    vs = assert_f64_outputs("bad", lambda: (x64 + 1.0).float())
    assert _verdicts(vs) == [("control-f64-pin", 0)]
    vs = assert_f64_outputs("bad", lambda: (x64, np.zeros(2, np.float32)))
    assert len(vs) == 1 and "float32" in vs[0].message


def test_check_traces_catches_a_promotion_in_an_entry(monkeypatch):
    """The negative control of the card's phase: one ``.double()`` in a
    data-plane function is reported, and a control entry returning
    float32 too."""
    from repro_torch.core import control as ctl
    from repro_torch.core.attacks import ModelAttack
    real = ModelAttack.apply_stacked
    monkeypatch.setattr(ModelAttack, "apply_stacked",
                        lambda self, s, g, mal: {
                            k: v.double() for k, v in
                            real(self, s, g, mal).items()})
    real_sched = ctl._schedule_device
    monkeypatch.setattr(ctl, "_schedule_device", lambda *a: tuple(
        o.astype(np.float32) if o.dtype == np.float64 else o
        for o in real_sched(*a)))
    vs = check_traces(None, "cpu")
    assert {(v.rule, v.path) for v in vs} == {
        ("trace-f64", "attacks.ModelAttack.apply_stacked"),
        ("control-f64-pin", "control._schedule_device")}


def test_static_args_catches_an_unhashable_task(monkeypatch):
    from repro_torch.federated import task as tk
    assert check_static_args(None) == []

    class Mutable:
        __hash__ = None

    monkeypatch.setitem(tk.TASKS, "mutable", Mutable())
    vs = check_static_args(None)
    assert [v.rule for v in vs] == ["static-args"]
    assert "unhashable" in vs[0].message


# ---------------------------------------------------------------------- #
# 4. the gates
# ---------------------------------------------------------------------- #
def test_run_checks_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_checks()
    assert run_checks(skip_trace=True).per_checker["trace"] == -1


def test_cli_strict_json_report_has_the_references_schema(ref, tmp_path):
    out, theirs = tmp_path / "mine.json", tmp_path / "theirs.json"
    assert check_main(["--strict", "--json", "--out", str(out),
                       "--no-trace"]) == 0
    assert ref.main.main(["--strict", "--json", "--out", str(theirs),
                          "--no-trace"]) == 0
    mine, ref_payload = (json.loads(p.read_text()) for p in (out, theirs))
    assert set(mine) == set(ref_payload)
    assert mine["check"] == "contracts" and mine["ok"]
    assert set(mine["meta"]) == {"commit", "python", "torch", "numpy",
                                 "timestamp"}
    assert set(ref_payload["meta"]) - {"jax"} == set(mine["meta"]) - {
        "torch"}
    assert mine["meta"]["torch"] == torch.__version__
    assert mine["violations"] == []
    assert mine["per_checker"]["trace"] == -1
    assert mine["per_checker"]["host-sync"] == 0
    assert set(mine["inventory"]) == set(ref_payload["inventory"])
    assert mine["inventory"]["n_modules"] > 0


def test_cli_runs_the_trace_on_the_cpu_when_asked(capsys):
    assert check_main(["--strict", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("contracts: clean")
    assert "trace=0" in out


def test_module_entry_point_without_cuda_fails():
    """``python -m repro_torch.check`` without ``--device`` runs its trace
    on the card; without one it fails, not silently on the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.check", "--strict"],
        capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert "contracts: clean" not in proc.stdout


# ---------------------------------------------------------------------- #
# 5. the dead-inheritance inventory
# ---------------------------------------------------------------------- #
def test_the_ported_planes_stay_live():
    inv = run_checks(skip_trace=True).inventory
    assert inv["n_modules"] == inv["n_live"] + inv["n_dead"]
    assert inv["n_modules"] > 80            # the import graph was walked
    assert inv["dead_loc"] == sum(m["loc"] for m in inv["dead"])
    dead = {m["module"] for m in inv["dead"]}
    for mod in ("repro_torch.check", "repro_torch.check.trace",
                "repro_torch.obs", "repro_torch.obs.trace",
                "repro_torch.obs.clock", "repro_torch.obs.metrics",
                "repro_torch.obs.report", "repro_torch.launch.dryrun",
                "repro_torch.launch.hillclimb", "repro_torch.launch.serve",
                "repro_torch.launch.roofline", "repro_torch.core.population",
                "repro_torch.federated.async_engine"):
        assert mod not in dead, f"{mod} regressed to dead inheritance"
