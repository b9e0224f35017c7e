"""K2 ``robust_aggregate`` at the main path's shape: 44 real rows of a
48-row stack, M = 50,890 (the MLP's flattened update), in both modes — the
plain version against the Pallas kernel in interpret mode and the
reference's ref twin within atol = rtol = 1e-6. A file of its own because
the interpret-mode compile of the 48-row sorting network takes ~25 s a
mode."""
import pytest
from torch_parity import single_threaded  # noqa: F401
from test_torch_kernels import ref, robust_case  # noqa: F401

import numpy as np


@pytest.mark.parametrize("mode", ["trimmed_mean", "median"])
def test_robust_plain_matches_pallas_at_main_path_shape(ref, mode):
    got, pallas, oracle, real = robust_case(ref, 44, 48, 50_890, mode)
    assert got.shape == (50_890,)
    np.testing.assert_allclose(got, pallas, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got, oracle, atol=1e-6, rtol=1e-6)
    assert np.all(got <= real.max(0)) and np.all(got >= real.min(0))
