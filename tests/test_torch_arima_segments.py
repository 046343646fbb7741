"""The ARIMA bank's segmented launch and its two kernel paths, on the CPU.

``kernels.arima_bank.route`` picks the kernel path from (order, n) alone;
``segment_table`` lays one segment per history length back to back,
longest first, each on a warp boundary; ``ARIMA.batched_forecast`` packs a
whole batch into one buffer and makes ONE call.  On the CPU the call runs
the plain version per segment, so every forecast here is held bit for bit
against the plain version of its own bucket and against ``forecast_next``.
The JAX package has no segmented launch, so nothing here imports it; the
fit itself is held against ``repro`` in ``test_torch_arima.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import arima as T
from repro_torch.kernels import arima_bank as K


@pytest.mark.parametrize("n", [4, 8, 16, 32, 60])
def test_route_takes_the_register_path_for_the_bank_shapes(n):
    o = T.ARIMAOrder()                 # the order every caller uses
    assert K.route((o.p, o.d, o.q), n) == "register"


def test_register_n_is_the_buckets_and_the_default_history():
    # the lengths a default ARIMA launches at are exactly the register
    # path's, so no bank shape falls to the generic path
    model = T.ARIMA(device="cpu")
    assert sorted(K.REGISTER_N) == sorted({*T._BUCKETS, model.n})


@pytest.mark.parametrize("order,n", [((2, 1, 1), 5), ((2, 1, 1), 24),
                                     ((2, 1, 1), 59), ((2, 1, 1), 64),
                                     ((1, 2, 0), 32), ((4, 2, 4), 24),
                                     ((2, 1, 2), 60), ((2, 0, 1), 60),
                                     ((3, 1, 1), 16)])
def test_route_sends_every_other_shape_to_the_generic_path(order, n):
    assert K.route(order, n) == "generic"


def test_segment_table_covers_rows_once_on_warps_longest_first():
    # the last segment may end inside a warp: nothing follows it
    sizes = {4: 33, 60: 96, 16: 32, 32: 320, 8: 64}
    table = K.segment_table(sizes)
    assert [n for _, _, n in table] == [60, 32, 16, 8, 4]
    covered = []
    for row0, rows, n in table:
        assert row0 % K.WARP == 0 and rows == sizes[n]
        covered += range(row0, row0 + rows)
    assert covered == list(range(sum(sizes.values())))


@pytest.mark.parametrize("table", [
    [(0, 40, 60), (40, 32, 4)],          # a warp would hold n=60 and n=4
    [(0, 32, 60), (64, 32, 4)],          # a gap
    [(0, 64, 60), (32, 32, 4)],          # an overlap
    [(32, 32, 60)],                      # does not start at row 0
    [(0, 0, 60)],                        # empty
    [],
    [(32 * i, 32, 4) for i in range(K.MAX_SEGMENTS + 1)],
])
def test_check_segments_refuses_what_the_kernel_does_not_take(table):
    with pytest.raises(ValueError):
        K.check_segments(table)


def test_segment_table_refuses_a_warp_mixing_two_lengths():
    with pytest.raises(ValueError, match="warp"):
        K.segment_table({60: 40, 4: 32})


def _buckets(rng):
    return {n: [rng.normal(3600.0, 400.0, size=n).astype(np.float32)
                for _ in range(k)]
            for n, k in ((4, 5), (8, 33), (16, 1), (60, 40))}


def test_pack_bank_lays_rows_by_the_table_and_pads_with_group_heads():
    buckets = _buckets(np.random.default_rng(1))
    flat, table = T.pack_bank(buckets)
    assert [n for _, _, n in table] == [60, 16, 8, 4]
    elem = 0
    for row0, rows, n in table:
        block = flat[elem:elem + rows * n].reshape(rows, n)
        got = buckets[n]
        assert rows == -(-len(got) // T.BANK_WIDTH) * T.BANK_WIDTH
        assert np.array_equal(block[:len(got)], np.stack(got))
        for j in range(len(got), rows):
            assert np.array_equal(block[j], block[j - j % T.BANK_WIDTH])
        elem += rows * n
    assert elem == flat.size


def test_segments_on_cpu_equal_the_plain_version_per_segment():
    rng = np.random.default_rng(2)
    flat, table = T.pack_bank(_buckets(rng))
    got = K.arima_bank_segments(torch.from_numpy(flat), table, (2, 1, 1),
                                30, 0.05)
    elem = 0
    for row0, rows, n in table:
        y = torch.from_numpy(flat[elem:elem + rows * n].reshape(rows, n))
        want = K.arima_fit_plain(y, (2, 1, 1), 30, 0.05)
        assert torch.equal(got[row0:row0 + rows].view(torch.int32),
                           want.view(torch.int32))
        elem += rows * n


@pytest.mark.parametrize("bad", ["short", "long", "2d", "float64"])
def test_segments_wrapper_refuses_a_buffer_that_does_not_fit(bad):
    table = [(0, 32, 8), (32, 32, 4)]
    y = torch.zeros(32 * 8 + 32 * 4)
    if bad == "short":
        y = y[:-1]
    elif bad == "long":
        y = torch.zeros(y.numel() + 1)
    elif bad == "2d":
        y = y.view(32, -1)
    elif bad == "float64":
        y = y.double()
    with pytest.raises((TypeError, ValueError)):
        K.arima_bank_segments(y, table, (2, 1, 1), 5, 0.05)


@pytest.mark.parametrize("n_model", [60, 16])
def test_batched_forecast_is_one_call_equal_to_per_bucket_plain(
        monkeypatch, n_model):
    rng = np.random.default_rng(n_model)
    sizes = [0, 2, 3, 4, 6, 9, 15, 16, 20, 31, 33, 59, 60, 61, 90]
    series = [rng.normal(3600.0, 400.0, size=k).astype(np.float32)
              for k in sizes * 3]
    model = T.ARIMA(n=n_model, steps=40, device="cpu")
    calls = []
    inner = T.arima_bank_segments

    def counted(y, table, *args):
        calls.append(table)
        return inner(y, table, *args)

    monkeypatch.setattr(T, "arima_bank_segments", counted)
    batched = model.batched_forecast(series)
    assert len(calls) == 1
    assert [n for _, _, n in calls[0]] == sorted(
        {model._bucket(s.size) for s in series if s.size >= 4}, reverse=True)
    for i, s in enumerate(series):
        if s.size < 4:
            continue
        n = model._bucket(s.size)
        y = torch.from_numpy(s[-n:].copy())[None, :]
        want = float(K.arima_fit_plain(y, (2, 1, 1), 40, 0.05)[0])
        assert batched[i] == (want if np.isfinite(want)
                              else float(np.median(s[-n:])))
    monkeypatch.setattr(T, "arima_bank_segments", inner)
    assert batched.tolist() == [model.forecast_next(s) for s in series]


def test_generic_order_batches_through_the_same_call():
    rng = np.random.default_rng(7)
    series = [rng.normal(3600.0, 400.0, size=k).astype(np.float32)
              for k in (5, 9, 17, 24, 30)]
    model = T.ARIMA(order=T.ARIMAOrder(p=1, d=2, q=0), n=24, steps=30,
                    device="cpu")
    assert {K.route((1, 2, 0), model._bucket(s.size)) for s in series} == \
        {"generic"}
    assert model.batched_forecast(series).tolist() == \
        [model.forecast_next(s) for s in series]
