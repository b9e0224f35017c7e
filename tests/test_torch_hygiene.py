"""The port stands alone: no module under src/repro_torch/ and not
chip_smoke.py imports jax or the JAX package; importing the port's server
pulls no jax into the process; entry points run on the GPU unless the
caller asks for the CPU, and raise where CUDA is absent."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import FeelConfig
from repro_torch.data.partition import partition
from repro_torch.data.synthetic_mnist import generate
from repro_torch.device import resolve_device
from repro_torch.federated.server import FeelServer
from repro_torch.kernels import build

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


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
                             "moe_gemm", "ssd_scan")
    for name in build.KERNELS:
        path = build.library_path(name)
        assert path.parent == ROOT / "build" / "repro_torch_kernels"
        assert (build.CSRC / f"{name}.cu").is_file()
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert build.load.cache_info().currsize == 0
