"""The port's cache states replay seeded random operation sequences to the
same state and statistics as ``repro``'s (exact integers, no tolerance)."""
import numpy as np
import pytest

from repro.core import cache as J
from repro_torch.core import cache as T

N_KEYS = 96
SIZE = 10


def _state(mod, policy, capacity):
    present = np.zeros(N_KEYS, np.bool_)
    return mod.make_int_cache_state(policy, capacity, N_KEYS, present)


def _snapshot(st):
    out = dict(present=st.present.tolist(), size=st.size.tolist(),
               used=st.used, n_live=st.n_live,
               stats=st.to_cache_stats().__dict__)
    for name in ("stamp", "freq"):
        if hasattr(st, name):
            out[name] = getattr(st, name).tolist()
    return out


def _drive(states, policy, rng, n_ops):
    """Apply one random op to every state in ``states`` (same arguments)."""
    ref = states[0]
    ops = ["touch", "insert", "upsert", "upsert_seq", "lookup"]
    if policy == "lru":
        ops += ["touch_one", "insert_one", "plan_apply"]
    for _ in range(n_ops):
        op = ops[rng.integers(len(ops))]
        present = np.nonzero(ref.present)[0]
        absent = np.nonzero(~ref.present)[0]
        m = int(rng.integers(1, 8))
        size = int(rng.choice([SIZE, SIZE, 2 * SIZE]))
        if op == "touch" and len(present):
            keys = rng.permutation(present)[:m]
            for s in states:
                s.touch_hits(keys.copy())
        elif op == "insert" and len(absent):
            keys = rng.permutation(absent)[:m]
            for s in states:
                s.insert_batch(keys.copy(), size)
        elif op == "upsert":
            keys = rng.permutation(N_KEYS)[:m].astype(np.int64)
            for s in states:
                s.upsert_batch(keys.copy(), size)
        elif op == "upsert_seq":
            keys = rng.permutation(N_KEYS)[:m].tolist()
            for s in states:
                s.upsert_seq(list(keys), size)
        elif op == "lookup":
            h, mi = int(rng.integers(0, 5)), int(rng.integers(0, 5))
            for s in states:
                s.record_lookup(h, mi, size)
        elif op == "touch_one" and len(present):
            k = int(rng.choice(present))
            for s in states:
                s.touch_one(k)
        elif op == "insert_one":
            k = int(rng.integers(N_KEYS))
            for s in states:
                s.insert_one(k, size)
        elif op == "plan_apply" and len(present):
            need = int(rng.integers(1, 6)) * SIZE
            blocked = np.zeros(N_KEYS, np.bool_)
            blocked[rng.permutation(N_KEYS)[:3]] = True
            plans = [s.plan_evictions(need, blocked.copy()) for s in states]
            for a, b in zip(plans[0], plans[1]):
                assert np.array_equal(a, b)
            n = int(rng.integers(0, len(plans[0][0]) + 1))
            for s, (vk, cf, ee) in zip(states, plans):
                s.apply_evictions(vk, cf, ee, n)
        assert _snapshot(states[0]) == _snapshot(states[1]), op


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", ["lru", "lfu"])
@pytest.mark.parametrize("capacity", [8 * SIZE, 40 * SIZE])
def test_int_state_random_sequences(policy, capacity, seed):
    rng = np.random.default_rng(1000 * seed + capacity)
    states = [_state(J, policy, capacity), _state(T, policy, capacity)]
    _drive(states, policy, rng, 300)
    assert states[1].to_cache_stats() == T.CacheStats(
        **states[0].to_cache_stats().__dict__)


@pytest.mark.parametrize("policy", ["lru", "lfu"])
def test_reference_caches_random_sequences(policy):
    rng = np.random.default_rng(7)
    a, b = J.make_cache(policy, 30 * SIZE), T.make_cache(policy, 30 * SIZE)
    for _ in range(600):
        key = (int(rng.integers(4)), int(rng.integers(40)))
        size = int(rng.choice([SIZE, 3 * SIZE]))
        if rng.random() < 0.5:
            assert a.lookup(key, size) == b.lookup(key, size)
        else:
            a.insert(key, size)
            b.insert(key, size)
        assert a.used == b.used and list(a.keys()) == list(b.keys())
    assert a.stats.__dict__ == b.stats.__dict__


def test_chunk_helpers_identical():
    rng = np.random.default_rng(3)
    s = rng.uniform(-5e4, 5e5, 200)
    e = s + rng.uniform(-100.0, 2e4, 200)
    for cs in (60.0, 900.0, 3600.0):
        fa, na = J.chunk_bounds_bulk(s, e, cs)
        fb, nb = T.chunk_bounds_bulk(s, e, cs)
        assert np.array_equal(fa, fb) and np.array_equal(na, nb)
        for x, y in zip(s[:20], e[:20]):
            assert J.chunks_for_range(3, x, y, cs) == \
                T.chunks_for_range(3, x, y, cs)
    assert J.chunk_bytes(8e3, 3600.0) == T.chunk_bytes(8e3, 3600.0)
