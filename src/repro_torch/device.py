"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device``. The default is the GPU, and
asking for the GPU where CUDA is absent raises: nothing falls back to the
CPU behind the caller's back. The CPU runs only when the caller passes
``device="cpu"``, as the tests do.
"""
from __future__ import annotations

import functools
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises when the resolved device is CUDA and no
    CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU")
        # Keep float32 matrix products and convolutions in full float32:
        # TF32 keeps ~3 decimal digits, far outside the tolerances that
        # hold the port against the float32 reference.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of CUDA ``device``, read once a device
    (a kernel wrapper sizes its grid by it on every call)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _sm_count(index)
