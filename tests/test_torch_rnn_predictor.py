"""The port's GRU predictor (``repro_torch.core.rnn_predictor``, K4's plain
version ``repro_torch.kernels.gru_fit``) against ``repro.core.rnn_predictor``
on the CPU.

``repro``'s initial weights (``_init_params`` of a JAX key) are injected
into the port with ``convert.gru_params_from_numpy``; inputs come from
seeded NumPy generators.  Tolerances, each stated where it is used:
forward and gradients 1e-5 (float32, other summation orders), 10 Adam
steps 1e-4, full 150-step forecasts on well-conditioned series 1e-3 (the
Adam trajectory amplifies ulps, as ARIMA's does, ``test_torch_arima.py``),
the predictor's shortcut, clip and fallback paths exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rnn_predictor as R
from repro_torch.convert import gru_params_from_numpy
from repro_torch.core import rnn_predictor as T
from repro_torch.kernels import gru_fit as G

KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def jax_params():
    return R._init_params(KEY)


@pytest.fixture(scope="module")
def flat(jax_params):
    tree = {k: np.asarray(v) for k, v in jax_params.items()}
    return gru_params_from_numpy(tree, device="cpu")


def _rows(flat, rows):
    return flat[None, :].expand(rows, G.N_PARAMS).contiguous()


def _jax_loss(params, y):
    preds, _ = R._predict_series(params, y)
    err = preds[:-1] - y[1:]
    return jnp.mean(err * err)


def _flatten_jax(tree) -> np.ndarray:
    return np.concatenate([np.asarray(tree[name], np.float32).reshape(-1)
                           for name, _ in G.LAYOUT])


def _periodic(rng, n):
    """``benchmarks/beyond_rnn_predictor.py``'s near-periodic regime."""
    return (3600 + rng.normal(0, 180, n)).astype(np.float32)


def test_params_cross_in_layout_order(jax_params, flat):
    assert flat.shape == (G.N_PARAMS,) and G.N_PARAMS == 517
    p = G.unpack(flat[None, :])
    for name, shape in G.LAYOUT:
        np.testing.assert_array_equal(p[name][0].numpy(),
                                      np.asarray(jax_params[name]))
    assert torch.equal(G.pack(p)[0], flat)


def test_init_params_draws_as_repro_does():
    """Seven normal draws x 0.3, zero biases: the same distribution as
    ``_init_params``, other numbers (``torch.Generator``, not
    ``jax.random``); a seed gives the same weights every time."""
    p = T.init_params(0)
    assert torch.equal(p, T.init_params(0))
    assert not torch.equal(p, T.init_params(1))
    parts = G.unpack(p[None, :])
    for name in ("bz", "br", "bc", "bo"):
        assert not parts[name].any()
    drawn = torch.cat([parts[n].reshape(-1) for n in
                       ("wz", "wr", "wc", "uz", "ur", "uc", "wo")])
    assert drawn.numel() == 480 and 0.25 < float(drawn.std()) < 0.35


def test_rowsum_adds_in_the_kernels_fixed_tree():
    """``_rowsum`` adds ``s_k = (p_k + p_{k+4}) + p_{k+8}``, then
    ``(s_0 + s_1) + (s_2 + s_3)``: the order ``csrc/gru_fit.cu``'s ``dot``
    adds in.  On these float32 values left to right rounds to 25 and the
    tree to 18, along any leading axes."""
    p = np.float32([1e8, 3, 5, 7, 1, -1e8, 1, 1, 1, 2, 2, 2])
    left_to_right = p[0]
    for x in p[1:]:
        left_to_right = np.float32(left_to_right + x)
    s = [np.float32(np.float32(p[k] + p[k + 4]) + p[k + 8]) for k in range(4)]
    tree = np.float32(np.float32(s[0] + s[1]) + np.float32(s[2] + s[3]))
    assert (left_to_right, tree) == (25.0, 18.0)
    got = G._rowsum(torch.from_numpy(np.tile(p, (2, 3, 1))))
    assert got.shape == (2, 3) and bool((got == 18.0).all())


@pytest.mark.parametrize("n", [4, 16, 60])
def test_forward_matches_predict_series(jax_params, flat, n):
    """Predictions and the last state at rtol 1e-5 (atol 1e-6)."""
    rng = np.random.default_rng(n)
    y = rng.normal(0.0, 1.0, (3, n)).astype(np.float32)
    preds, (H, _, _, _) = G.gru_forward(G.unpack(_rows(flat, 3)),
                                        torch.from_numpy(y))
    for i in range(3):
        jp, jh = R._predict_series(jax_params, jnp.asarray(y[i]))
        np.testing.assert_allclose(preds[i].numpy(), np.asarray(jp),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(H[i, -1].numpy(), np.asarray(jh),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [8, 60])
def test_loss_and_gradient_match_jax(jax_params, flat, n):
    """``gru_grad_manual`` against ``jax.value_and_grad`` of ``repro``'s
    loss: rtol 1e-5, atol 1e-6 of the gradient's largest element (elements
    near zero are sums that cancel)."""
    rng = np.random.default_rng(100 + n)
    y = rng.normal(0.0, 1.0, (2, n)).astype(np.float32)
    loss, grad = G.gru_grad_manual(_rows(flat, 2), torch.from_numpy(y))
    for i in range(2):
        jl, jg = jax.value_and_grad(_jax_loss)(jax_params, jnp.asarray(y[i]))
        jg = _flatten_jax(jg)
        np.testing.assert_allclose(float(loss[i]), float(jl), rtol=1e-5)
        np.testing.assert_allclose(grad[i].numpy(), jg, rtol=1e-5,
                                   atol=1e-6 * np.abs(jg).max())


@pytest.mark.parametrize("n", [4, 16, 60])
def test_manual_gradient_matches_autograd(flat, n):
    """The hand-derived reverse recursion against ``torch.autograd`` of
    :func:`gru_loss`: rtol 1e-5, atol 1e-6 of the largest element."""
    rng = np.random.default_rng(200 + n)
    y = torch.from_numpy(rng.normal(0.0, 1.0, (4, n)).astype(np.float32))
    params = _rows(flat, 4) + torch.from_numpy(
        rng.normal(0.0, 0.05, (4, G.N_PARAMS)).astype(np.float32))
    loss, grad = G.gru_grad_manual(params, y)
    w = params.clone().requires_grad_(True)
    auto_loss = G.gru_loss(w, y)
    (auto,) = torch.autograd.grad(auto_loss.sum(), w)
    torch.testing.assert_close(loss, auto_loss.detach(), rtol=1e-5, atol=0)
    torch.testing.assert_close(grad, auto, rtol=1e-5,
                               atol=1e-6 * float(auto.abs().max()))


def test_ten_adam_steps_match_repro(flat):
    """Ten Adam steps and the forecast at rtol 1e-4."""
    rng = np.random.default_rng(7)
    y = (600 + 8 * np.arange(16) + rng.normal(0, 40, 16)).astype(np.float32)
    want, _ = R._compiled_fit(16, 10, 0.03)(jnp.asarray(y), KEY)
    got = G.gru_fit_plain(torch.from_numpy(y[None, :]), flat, 10, 0.03)
    np.testing.assert_allclose(float(got[0]), float(want), rtol=1e-4)


@pytest.mark.parametrize("n", [16, 60])
def test_full_fit_matches_repro_on_periodic_series(flat, n):
    """The full 150-step fit and forecast on the near-periodic regime at
    rtol 1e-3 (well-conditioned: the trajectory does not amplify the
    frameworks' ulp differences past it)."""
    y = _periodic(np.random.default_rng(0), n)
    want, _ = R._compiled_fit(n, 150, 0.03)(jnp.asarray(y), KEY)
    got = T.GRUPredictor(n=60, device="cpu", params=flat).forecast_next(y)
    np.testing.assert_allclose(got, float(want), rtol=1e-3)


def test_wrapper_on_cpu_is_the_plain_version(flat):
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.normal(100.0, 10.0, (3, 8)).astype(np.float32))
    G.reset_counts()
    got = G.gru_fit(y, flat, 5, 0.03)
    assert torch.equal(got, G.gru_fit_plain(y, flat, 5, 0.03))
    assert G.LAUNCHES == 0


@pytest.mark.parametrize("bad", [
    dict(y=torch.zeros(2, 65)), dict(y=torch.zeros(2, 1)),
    dict(y=torch.zeros(2, 8, dtype=torch.float64)),
    dict(y=torch.zeros(8, 2).t()), dict(params0=torch.zeros(516)),
    dict(steps=-1)])
def test_wrapper_refuses_what_the_kernel_does_not_take(flat, bad):
    args = dict(y=torch.zeros(2, 8), params0=flat, steps=1, lr=0.03)
    args.update(bad)
    with pytest.raises((ValueError, TypeError)):
        G.gru_fit(**args)


class _Fixed:
    """A model whose forecast is given: drives the clip path alike in both
    packages."""

    def __init__(self, value):
        self.value = value

    def forecast_next(self, series):
        return self.value


@pytest.mark.parametrize("ts", [
    [], [5.0], np.arange(50) * 600.0, [0.0, 0.0, 0.0],
    np.cumsum(np.r_[0.0, np.full(30, 60.0)])])
def test_shortcuts_equal_repro_exactly(ts):
    model = T.GRUPredictor(device="cpu")
    assert T.predict_next_timestamp_rnn(np.asarray(ts), model) == \
        R.predict_next_timestamp_rnn(np.asarray(ts), R.GRUPredictor())


@pytest.mark.parametrize("value", [-50.0, 1e12, 123.25])
def test_clip_equals_repro_exactly(value):
    ts = np.cumsum(np.random.default_rng(4).exponential(100.0, 20))
    assert T.predict_next_timestamp_rnn(ts, _Fixed(value)) == \
        R.predict_next_timestamp_rnn(ts, _Fixed(value))


@pytest.mark.parametrize("series", [
    [1.0, 2.0, 3.0], [], [7.0],
    [1.0, 2.0, np.inf, 4.0, 5.0], [1.0, 2.0, 3.0, np.nan, 5.0]])
def test_forecast_fallbacks_equal_repro_exactly(flat, series):
    """Under 4 points: the last value; a non-finite fit: the median."""
    series = np.asarray(series, np.float32)
    got = T.GRUPredictor(device="cpu", params=flat).forecast_next(series)
    want = R.GRUPredictor().forecast_next(series)
    assert got == want or (np.isnan(got) and np.isnan(want))


# the four cases of tests/test_rnn_predictor.py, through the port


def test_constant_series_shortcut():
    ts = np.arange(50) * 600.0
    pred = T.predict_next_timestamp_rnn(ts, T.GRUPredictor(device="cpu"))
    assert pred == pytest.approx(ts[-1] + 600.0, rel=0.01)


def test_noisy_periodic():
    rng = np.random.default_rng(0)
    gaps = 3600.0 + rng.normal(0, 300.0, 64)
    ts = np.concatenate([[0.0], np.cumsum(gaps)])
    pred = T.predict_next_timestamp_rnn(ts, T.GRUPredictor(device="cpu"))
    assert pred - ts[-1] == pytest.approx(3600.0, rel=0.3)


def test_finite_on_irregular():
    rng = np.random.default_rng(1)
    ts = np.cumsum(rng.exponential(100.0, 40))
    pred = T.predict_next_timestamp_rnn(ts, T.GRUPredictor(device="cpu"))
    assert np.isfinite(pred) and pred >= ts[-1]


def test_forecast_bounded():
    g = T.GRUPredictor(device="cpu")
    out = g.forecast_next(np.array([10.0, 20.0, 15.0, 30.0, 25.0] * 8))
    assert np.isfinite(out)
