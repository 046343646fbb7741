"""Kernel tests that need the card: the ARIMA bank kernel against its plain
PyTorch version on CUDA tensors, and the port's device paths on CUDA.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor ``repro``: the machine with the card has
only the port's dependencies.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.arima import ARIMA
from repro_torch.core.kmeans import kmeans
from repro_torch.kernels import arima_bank as K

pytestmark = pytest.mark.cuda

# kernel vs plain on the same card: the kernel is built without FMA
# contraction and sums in the plain version's order, so the two should
# agree bit for bit; 1e-3 leaves room for a library function (powf) that
# rounds differently, amplified by the Adam trajectory
RTOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(seed, rows, n):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.normal(3600.0, 400.0, size=(rows, n)).astype(np.float32))


@pytest.mark.parametrize("order,n", [((2, 1, 1), 4), ((2, 1, 1), 16),
                                     ((2, 1, 1), 60), ((1, 2, 0), 32),
                                     ((4, 2, 4), 24)])
def test_kernel_matches_plain(cuda, order, n):
    y = _rows(n, 300, n).to(cuda)
    got = K.arima_bank(y, order, 200, 0.05)
    want = K.arima_fit_plain(y, order, 200, 0.05)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    torch.testing.assert_close(got[ok], want[ok], rtol=RTOL, atol=0.0)


def test_kernel_rows_independent_of_launch(cuda):
    y = _rows(1, 200, 16).to(cuda)
    full = K.arima_bank(y, (2, 1, 1), 200, 0.05)
    rev = K.arima_bank(y.flip(0).contiguous(), (2, 1, 1), 200, 0.05).flip(0)
    alone = torch.cat([K.arima_bank(y[i:i + 1].contiguous(), (2, 1, 1), 200,
                                    0.05) for i in range(0, 200, 23)])
    assert torch.equal(full.view(torch.int32), rev.view(torch.int32))
    assert torch.equal(full[::23].view(torch.int32), alone.view(torch.int32))


def test_kernel_counts_launches_and_rows(cuda):
    K.reset_counts()
    K.arima_bank(_rows(2, 70, 8).to(cuda), (2, 1, 1), 20, 0.05)
    K.arima_bank(_rows(3, 5, 8).to(cuda), (2, 1, 1), 20, 0.05)
    assert (K.LAUNCHES, K.ROWS) == (2, 75)


def test_online_equals_batched_on_cuda(cuda):
    rng = np.random.default_rng(4)
    series = [rng.normal(3600.0, 400.0, size=k).astype(np.float32)
              for k in (0, 2, 4, 9, 16, 16, 30, 60, 61, 5)] + \
        [rng.normal(3600.0, 400.0, size=16).astype(np.float32)
         for _ in range(40)]
    model = ARIMA(device=cuda)
    batched = model.batched_forecast(series)
    assert batched.tolist() == [model.forecast_next(s) for s in series]


def test_kmeans_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, 4, 3000), rng.integers(0, 6, 3000),
                  rng.integers(0, 6, 3000) * 5.0 / 6.0], axis=1)
    cg, ag, _ = kmeans(x, 4, device=cuda)
    cc, ac, _ = kmeans(x, 4, device="cpu")
    assert np.array_equal(ag, ac)
    np.testing.assert_allclose(cg, cc, rtol=1e-5, atol=1e-5)
