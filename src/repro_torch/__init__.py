"""PyTorch/CUDA port of the FEEL data-quality scheduling system.

The package mirrors the JAX package ``repro`` module for module (same file
names, same public functions) and is held against it by the parity tests
in ``tests/test_torch_*.py``. It imports neither ``jax`` nor ``repro``.

Entry points take an explicit ``device`` and default to the GPU
(``device.resolve_device``); the FedAvg aggregation runs through the
hand-written Hopper kernel in ``kernels/csrc/weighted_aggregate.cu``, the
defense plane's trimmed mean and median through
``kernels/csrc/robust_aggregate.cu``, every attention forward through
``kernels/csrc/flash_attention.cu``, every attention decode step of the
model zoo through ``kernels/csrc/decode_attention.cu`` and its Mamba2 SSD
scan through ``kernels/csrc/ssd_scan.cu``.
"""
