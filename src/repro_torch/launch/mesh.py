"""Hardware constants of the port's device, one NVIDIA H100 SXM5 80GB,
and the launcher's optimizer policy (``ADAFACTOR_ARCHS``).

Constants only: the mesh builders come with the sharded plane. Each value
is the H100 SXM5 80GB data-sheet figure (dense rates, no sparsity, at the
full 700 W power limit), not a measurement; ``launch/roofline.py`` and
``chip_smoke.py``'s kernel bounds read them from here.
"""
from __future__ import annotations

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
