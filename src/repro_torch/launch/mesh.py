"""Mesh builders, the hardware constants of the port's device, one NVIDIA
H100 SXM5 80GB, and the launcher's optimizer policy (``ADAFACTOR_ARCHS``).

``make_production_mesh`` and ``make_host_mesh`` give the JAX package's
meshes — one pod 16x16 ("data", "model"), two pods 2x16x16 ("pod",
"data", "model"), a host's ("data", "model") — as a
``torch.distributed`` ``DeviceMesh`` when the default process group exists
with that many ranks, else as the ``sharding.specs.MeshShape`` the
partition rules read. They never start a process group: the caller does
(``chip_smoke.py`` an NCCL group of one, the dry run's ``--cohort`` a
fake one, the tests gloo ranks).

Each constant is the H100 SXM5 80GB data-sheet figure (dense rates, no
sparsity, at the full 700 W power limit), not a measurement;
``launch/roofline.py`` and ``chip_smoke.py``'s kernel bounds read them
from here.
"""
from __future__ import annotations

from repro_torch.sharding.specs import MeshShape

# H100 SXM5 80GB spec value: bf16 on the tensor cores, dense (FLOP/s)
PEAK_FLOPS_BF16 = 989e12
# H100 SXM5 80GB spec value: float32 outside the tensor cores (FLOP/s)
PEAK_FLOPS_F32 = 67e12
# H100 SXM5 80GB spec value: HBM3 bandwidth (bytes/s)
HBM_BW = 3.35e12
# H100 SXM5 80GB spec value: NVLink 4, 900 GB/s both ways, so 450e9
# bytes/s a direction
ICI_BW = 450e9

# the reference's launcher policy: the 398B/671B configs train with a
# factored-moment optimizer (their AdamW moments would not fit)
ADAFACTOR_ARCHS = {"deepseek-v3-671b", "jamba-1.5-large-398b"}


def _world_size() -> int:
    """The default process group's size, or 0 where there is none."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 0


def _mesh(shape, axes, device_type: str):
    mesh = MeshShape(tuple(axes), tuple(shape))
    if _world_size() != mesh.size:
        return mesh
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, mesh.sizes,
                            mesh_dim_names=mesh.axis_names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_host_mesh(model_parallel: int = 1, device_type: str = "cuda"):
    """Small ("data", "model") mesh over the process group's ranks (1
    without a group). When ``model_parallel`` does not divide the rank
    count the remainder ranks are left out of the mesh (n // mp data
    slices), which then has fewer ranks than the group: its shape comes
    back as a ``MeshShape``."""
    n = _world_size() or 1
    mp = min(model_parallel, n)
    return _mesh((n // mp, mp), ("data", "model"), device_type)
