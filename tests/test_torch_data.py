"""The port's training input path against the JAX package's, on the CPU:
``test_substrate.py``'s four data cases run through both packages, and
seeded request streams through both staging caches and push servers.

Everything here is host NumPy and threads, so the comparisons are exact:
the same shards bit for bit, the same batches, stats, pushes and LRU
eviction order.
"""
import numpy as np
import pytest

from repro.data import pipeline as JP
from repro.data import staging as JS
from repro_torch.data import pipeline as TP
from repro_torch.data import staging as TS


def _run_loader(mod, **src):
    loader = mod.PrefetchingLoader(mod.SyntheticLM(**src["source"]),
                                   n_steps=src["n_steps"])
    batches = list(loader)
    loader.close()
    return batches, loader.stats


def test_loader_yields_all_steps():
    kw = {"source": dict(vocab=64, seq_len=16, batch=2, n_shards=8),
          "n_steps": 12}
    got, got_stats = _run_loader(TP, **kw)
    want, want_stats = _run_loader(JP, **kw)
    assert len(got) == len(want) == 12
    assert got[0]["tokens"].shape == (2, 16)
    assert (got[0]["labels"][:, :-1] == got[0]["tokens"][:, 1:]).all()
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    assert got_stats == want_stats


def test_push_server_learns_sequential_scan():
    kw = {"source": dict(vocab=64, seq_len=16, batch=2, n_shards=32),
          "n_steps": 24}
    _, stats = _run_loader(TP, **kw)
    _, want = _run_loader(JP, **kw)
    assert stats == want
    assert stats["pushes"] > 0
    assert stats["pushed_hits"] > stats["misses"]


@pytest.mark.parametrize("seed,shard,codebooks", [(3, 7, 1), (0, 0, 1),
                                                   (11, 1023, 1), (5, 2, 4)])
def test_deterministic_shards(seed, shard, codebooks):
    src = TP.SyntheticLM(vocab=64, seq_len=16, batch=2, codebooks=codebooks,
                         seed=seed)
    a = src.load_shard(shard)
    np.testing.assert_array_equal(a, src.load_shard(shard))
    want = JP.SyntheticLM(vocab=64, seq_len=16, batch=2, codebooks=codebooks,
                          seed=seed).load_shard(shard)
    assert a.dtype == want.dtype and a.shape == want.shape
    np.testing.assert_array_equal(a, want)


def test_staging_cache_eviction():
    def run(mod):
        fetches = []

        def fetch(s):
            fetches.append(s)
            return np.zeros(100, np.uint8)

        cache = mod.StagingCache(capacity_bytes=250, fetch_fn=fetch)
        for s in (0, 1, 2, 0):
            cache.get(s)
        return fetches, cache.stats, list(cache.cache.keys())

    got = run(TS)
    # capacity 250 holds 2 shards of 100: shard 0 evicted by 2
    assert got[0] == [0, 1, 2, 0]
    assert got == run(JS)


def _stream(mod, seed: int):
    """Three hosts, each mostly scanning its own shards in order with
    random jumps and re-reads; shards of random sizes."""
    rng = np.random.default_rng(seed)
    n_shards = 40
    sizes = rng.integers(50, 200, size=n_shards)

    def load(s):
        return np.zeros(int(sizes[s]), np.uint8)

    caches = {h: mod.StagingCache(600, load) for h in range(3)}
    server = mod.PushServer(caches, load, n_shards,
                            threshold=int(rng.integers(1, 4)),
                            lookahead=int(rng.integers(1, 4)))
    pos = {h: int(rng.integers(0, n_shards)) for h in caches}
    trail = []
    for t in range(300):
        h = int(rng.integers(0, 3))
        r = rng.random()
        if r < 0.75:
            pos[h] = (pos[h] + 1) % n_shards
        elif r < 0.9:
            pos[h] = int(rng.integers(0, n_shards))
        server.observe(mod.ShardRequest(float(t), h, pos[h]))
        caches[h].get(pos[h])
        trail.append(tuple(caches[h].cache.keys()))
    return ({h: (c.stats, list(c.cache.keys()), sorted(c.store))
             for h, c in caches.items()}, server.pushes, trail)


@pytest.mark.parametrize("seed", range(4))
def test_staging_and_push_server_match_repro(seed):
    got = _stream(TS, seed)
    assert got == _stream(JS, seed)
    assert got[1] > 0


def test_staging_cache_under_concurrent_gets_and_pushes():
    """Eight threads get and push shards at once, with a short switch
    interval: every get is counted exactly once, and the store holds
    exactly the LRU's keys within its byte budget."""
    import sys
    import threading

    def load(s):
        return np.zeros(10 + s % 7, np.uint8)

    cache = TS.StagingCache(120, load)
    n_threads, n_ops = 8, 400
    errors = []

    def work(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(n_ops):
                s = int(rng.integers(0, 24))
                if rng.random() < 0.3:
                    cache.push(s, load(s))
                else:
                    assert cache.get(s).nbytes == load(s).nbytes
        except Exception as e:            # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    stats = cache.stats
    assert sorted(cache.store) == sorted(cache.cache.keys())
    assert cache.cache.used <= 120
    assert cache.cache.used == sum(a.nbytes for a in cache.store.values())
    assert sum(stats.values()) == _gets(n_threads, n_ops)


def _gets(n_threads: int, n_ops: int) -> int:
    """How many of ``work``'s operations are gets: its draws replayed."""
    total = 0
    for seed in range(n_threads):
        rng = np.random.default_rng(seed)
        for _ in range(n_ops):
            rng.integers(0, 24)
            total += rng.random() >= 0.3
    return total
