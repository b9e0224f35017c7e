"""The port stands alone: no module under src/repro_torch/ and not
chip_smoke.py imports jax or the JAX package, nor msgpack (absent on the
card's machine); importing the port's server pulls no jax into the
process; entry points run on the GPU unless the caller asks for the CPU,
and raise where CUDA is absent; only ``obs/clock.py`` reads the wall
clock (the port's own checker's lint, ``repro_torch.check.lints``), and
the training launcher takes its clock from there."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.check.common import SourceFile
from repro_torch.check.lints import lint_clock_imports, lint_wall_clock
from repro_torch.configs.base import FeelConfig
from repro_torch.data.partition import partition
from repro_torch.data.synthetic_mnist import generate
from repro_torch.device import resolve_device
from repro_torch.federated.server import FeelServer
from repro_torch.kernels import build

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES + EXAMPLES,
                         ids=[str(p.relative_to(ROOT))
                              for p in PORT_FILES + EXAMPLES])
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES + EXAMPLES,
                         ids=[str(p.relative_to(ROOT))
                              for p in PORT_FILES + EXAMPLES])
def test_no_msgpack_import(path):
    """The checkpoint codec is the port's own: msgpack is not installed
    where the port runs on the card."""
    assert not [m for m in _imported_modules(path)
                if m.split(".")[0] == "msgpack"], path


def test_the_training_launcher_takes_its_clock_from_obs_clock():
    mods = set(_imported_modules(ROOT / "src" / "repro_torch" / "launch"
                                 / "train.py"))
    assert "repro_torch.obs.clock" in mods
    assert not {m.split(".")[0] for m in mods} & CLOCK_MODULES
    tree = ast.parse((ROOT / "src" / "repro_torch" / "launch"
                      / "train.py").read_text())
    assert any(isinstance(n, ast.ImportFrom)
               and n.module == "repro_torch.obs.clock"
               and [a.name for a in n.names] == ["wall_clock"]
               for n in ast.walk(tree))


def test_importing_the_server_loads_no_jax():
    code = ("import sys, repro_torch.federated.simulation, chip_smoke; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]"


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_server_without_device_raises_when_cuda_is_absent(monkeypatch):
    _no_cuda(monkeypatch)
    cfg = FeelConfig(n_ues=4, n_malicious=0)
    train, test = generate(800, 100, seed=0)
    rng = np.random.default_rng(0)
    clients = partition(train, 4, rng)
    state = rng.bit_generator.state
    with pytest.raises(RuntimeError, match="CUDA"):
        FeelServer(cfg, clients, test, rng)
    assert rng.bit_generator.state == state      # no draw consumed
    FeelServer(cfg, clients, test, rng, device="cpu")


def test_kernel_build_goes_to_an_ignored_directory():
    """The kernels build into build/, which .gitignore lists, under a name
    keyed by the source hash; nothing is built at import."""
    assert build.KERNELS == ("weighted_aggregate", "robust_aggregate",
                             "flash_attention", "decode_attention",
                             "moe_gemm", "ssd_scan", "bi_gemm", "bi_reduce")
    for name in build.KERNELS:
        path = build.library_path(name)
        assert path.parent == ROOT / "build" / "repro_torch_kernels"
        assert (build.CSRC / f"{name}.cu").is_file()
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert build.load.cache_info().currsize == 0


def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
    """A kernel's library name hashes the headers its source may include,
    so an edit to csrc/*.cuh rebuilds every kernel; and each header a
    kernel includes is one of those."""
    for name in build.KERNELS:
        for line in (build.CSRC / f"{name}.cu").read_text().splitlines():
            if line.startswith('#include "'):
                assert (build.CSRC / line.split('"')[1]).is_file(), line
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path("k")
    assert build.library_path("k") == before
    (tmp_path / "h.cuh").write_text("// two\n")
    assert build.library_path("k") != before


@pytest.mark.parametrize("entry", ["population_mesh", "population_run",
                                   "async_run", "serve_cli"])
def test_population_and_async_entry_points_default_to_cuda(monkeypatch,
                                                           entry):
    """The population plane, the async engine's runs and the serve CLI
    build on the GPU unless the caller asks for the CPU, and raise where
    CUDA is absent, before any work."""
    from repro_torch.core import population
    from repro_torch.federated import simulation
    from repro_torch.launch import serve
    _no_cuda(monkeypatch)
    calls = {
        "population_mesh": lambda: population.population_mesh(),
        "population_run": lambda: simulation.run_experiment(
            cfg=FeelConfig(n_ues=4, n_malicious=0), population=12,
            n_train=600, n_test=100, rounds=1),
        "async_run": lambda: simulation.run_experiment(
            cfg=FeelConfig(n_ues=4, n_malicious=0, mode="async"),
            n_train=600, n_test=100, rounds=1),
        "serve_cli": lambda: serve.main(["--rounds", "1", "--ues", "4"])}
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


@pytest.mark.parametrize("helper", ["mlp_init", "normalize_weights"])
def test_helpers_default_to_the_card(monkeypatch, helper):
    """``models.mlp.mlp_init`` and ``aggregation.normalize_weights`` place
    their tensors on the GPU unless the caller asks for the CPU, and raise
    where CUDA is absent (``mlp_init`` before any draw)."""
    from repro_torch.federated.aggregation import normalize_weights
    from repro_torch.models.mlp import mlp_init
    from repro_torch.random import PRNGKey
    _no_cuda(monkeypatch)
    key = PRNGKey(0, "cpu")
    state = key.clone()
    call = {"mlp_init": lambda dev=None: mlp_init(key, device=dev),
            "normalize_weights": lambda dev=None: normalize_weights(
                [1.0, 3.0], dev)}[helper]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    assert torch.equal(key, state)
    out = call("cpu")
    for t in (out.values() if isinstance(out, dict) else [out]):
        assert t.device == torch.device("cpu")


@pytest.mark.parametrize("name", ["federated/async_engine.py",
                                  "launch/serve.py", "core/population.py"])
def test_the_simulated_clock_reads_no_wall_clock(name):
    """The async engine's clock is simulated: the engine, its CLI and the
    population plane import no clock module."""
    mods = set(_imported_modules(ROOT / "src" / "repro_torch" / name))
    assert not mods & {"time", "datetime", "timeit"}, mods


CLOCK_SITE = ROOT / "src" / "repro_torch" / "obs" / "clock.py"
CLOCK_MODULES = {"time", "datetime", "timeit"}


@pytest.mark.parametrize(
    "path", [p for p in PORT_FILES if "repro_torch" in p.parts],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_only_the_clock_module_reads_the_wall_clock(path):
    """The wall-clock half of the port's nondeterminism rule, run through
    the port's own checker (``repro_torch.check.lints``): every wall-clock
    read of the port goes through ``obs/clock.py``, so no other module
    under src/repro_torch/ calls a ``time`` clock (``lint_wall_clock``, the
    counterpart of ``repro.check.lints.lint_wall_clock``) or imports
    ``time``, ``datetime`` or ``timeit``, at any depth of the module
    (``lint_clock_imports``)."""
    src = SourceFile.parse(path, ROOT)
    if path == CLOCK_SITE:
        mods = {m.split(".")[0] for m in _imported_modules(path)}
        assert {"time", "datetime"} <= mods
    else:
        assert [v.format() for v in lint_wall_clock(src)
                + lint_clock_imports(src)] == []


# the reference's public names the port spells otherwise (None: not ported)
RENAMED = {"core": {"greedy_pack_jnp": "greedy_pack_rows", "normalize": None}}


def _reference_all(package):
    """``repro.<package>.__all__``, read from its source (not imported)."""
    tree = ast.parse((ROOT / "src" / "repro" / package / "__init__.py")
                     .read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "__all__":
            return [ast.literal_eval(e) for e in node.value.elts]
    raise AssertionError(f"repro.{package} has no __all__")


@pytest.mark.parametrize("package", ["core", "federated", "data", "configs"])
def test_packages_export_the_reference_public_names(package):
    """``repro_torch.<package>.__all__`` is the reference's, name for name
    and in its order, but for the documented renames (RENAMED, the
    ``repro_torch.core`` docstring); every name is bound."""
    import importlib
    mod = importlib.import_module(f"repro_torch.{package}")
    renamed = RENAMED.get(package, {})
    want = [renamed.get(n, n) for n in _reference_all(package)
            if renamed.get(n, n) is not None]
    assert mod.__all__ == want
    assert all(hasattr(mod, n) for n in mod.__all__)
    for old, new in renamed.items():
        if new is not None:
            assert old not in mod.__all__
            assert old in mod.__doc__ and new in mod.__doc__


def test_policies_name_the_ports_schedules():
    """``scheduler.POLICIES`` maps the reference's four packing policies
    (read from its source) to the port's schedule functions of the same
    names."""
    from repro_torch.core import scheduler
    tree = ast.parse((ROOT / "src" / "repro" / "core" / "scheduler.py")
                     .read_text())
    want = next({ast.literal_eval(k): v.id
                 for k, v in zip(n.value.keys, n.value.values)}
                for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "POLICIES")
    assert {k: f.__name__ for k, f in scheduler.POLICIES.items()} == want
    assert all(f is getattr(scheduler, f.__name__)
               for f in scheduler.POLICIES.values())


def test_importing_the_packages_builds_no_kernel():
    """``import repro_torch.core`` (and the other three packages, whose
    names pull in the server, the defenses and the kernels' wrappers)
    imports neither jax nor the JAX package, and builds or loads no
    kernel library."""
    code = ("import sys, repro_torch.core, repro_torch.federated, "
            "repro_torch.data, repro_torch.configs\n"
            "from repro_torch.kernels import build\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')), "
            "build.load.cache_info().currsize)")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[] 0"
