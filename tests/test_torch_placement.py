"""k-means and placement in the port against ``repro``: the k-means++ seeds
are NumPy's in both, and the Lloyd iterations must give the same
assignments (exact) and centers (within 1e-5: the per-cluster sums may be
added in another order)."""
import numpy as np
import pytest

from repro.core.kmeans import kmeans as j_kmeans
from repro.core import placement as JP
from repro.core import trace as J
from repro_torch.core.kmeans import kmeans as t_kmeans
from repro_torch.core import placement as TP
from repro_torch.core import trace as T


@pytest.mark.parametrize("seed,k,n", [(0, 4, 500), (1, 3, 64), (2, 4, 2000),
                                      (3, 2, 7)])
def test_kmeans_on_integer_features_matches_repro(seed, k, n):
    """Small-integer features (the regime of ``_request_features``): ties
    in the distance argmin are frequent."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, 4, n), rng.integers(0, 6, n),
                  rng.integers(0, 6, n) * 5.0 / 6.0], axis=1).astype(np.float32)
    cj, aj, ij = j_kmeans(x, k, seed=seed)
    ct, at, it = t_kmeans(x, k, seed=seed, device="cpu")
    assert np.array_equal(np.asarray(aj, np.int64), at.astype(np.int64))
    np.testing.assert_allclose(ct, cj, rtol=1e-5, atol=1e-5)
    assert it == pytest.approx(ij, rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("trace", ["ooi", "gage"])
def test_recluster_groups_match_repro(trace):
    grid_j = {"ooi": J.OOI_PROFILE, "gage": J.GAGE_PROFILE}[trace].grid
    grid_t = {"ooi": T.OOI_PROFILE, "gage": T.GAGE_PROFILE}[trace].grid
    recent_j = J.make_trace(trace, seed=1, scale=0.05)[-3000:]
    recent_t = T.make_trace(trace, seed=1, scale=0.05)[-3000:]
    assert np.array_equal(JP._request_features(recent_j, grid_j),
                          TP._request_features(recent_t, grid_t))
    user_dtn = {r.user_id: r.continent + 1 for r in recent_j}
    bw = np.arange(49, dtype=np.float64).reshape(7, 7) % 11
    util = {d: 0.1 * d for d in range(1, 7)}
    gj = JP.PlacementEngine(grid_j).recluster(recent_j, user_dtn, bw, util)
    gt = TP.PlacementEngine(grid_t, device="cpu").recluster(
        recent_t, user_dtn, bw, util)
    assert len(gj) > 1
    assert [(g.group_id, g.user_ids, g.hub_dtn, g.hot_objs) for g in gj] == \
        [(g.group_id, g.user_ids, g.hub_dtn, g.hot_objs) for g in gt]
