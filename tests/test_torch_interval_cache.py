"""The port's interval cache layer against ``repro``'s.

``IntervalLRUState`` and ``FlatIntervalState`` of ``repro_torch`` must
reproduce the port's per-chunk ``LRUCache`` chunk for chunk on the named
edge cases, and must match ``repro``'s two states digest for digest
(counters, intervals, eviction plans) under the same seeded op sequences;
inside the port, flat and list agree.  ``repro``'s states run with their
event logs off: the port keeps none.  The peer-fetch range helpers are
held against ``repro``'s on seeded random inputs.  Everything is integer:
equality is exact.
"""
import random

import numpy as np
import pytest

import repro.core.delivery as JD
from repro.core.cache import IntervalLRUState as JList
from repro.core.interval_store import FlatIntervalState as JFlat
import repro_torch.core.delivery as TD
from repro_torch.core.cache import IntervalLRUState as TList
from repro_torch.core.cache import LRUCache
from repro_torch.core.interval_store import FlatIntervalState as TFlat

PORT_STATES = [TList, TFlat]


def ref_serve(cache: LRUCache, lo: int, hi: int, size: int) -> int:
    """The reference simulator's per-chunk cache interaction for one
    request in the static path: lookup every chunk, then insert every
    miss."""
    missing, nh = [], 0
    for k in range(lo, hi):
        if cache.lookup(k, size):
            nh += 1
        else:
            missing.append(k)
    for k in missing:
        cache.insert(k, size)
    return nh


def keys_of(state) -> list[int]:
    return [k for s, e in state.intervals() for k in range(s, e)]


def _runs(runs) -> list:
    """Key runs as tuples of Python ints (the flat state returns numpy
    scalars and arrays)."""
    return [tuple(map(int, r)) for r in runs]


def _digest(st) -> dict:
    return dict(hits=st.hits, misses=st.misses, hit_bytes=st.hit_bytes,
                miss_bytes=st.miss_bytes, evictions=st.evictions,
                inserted_bytes=st.inserted_bytes, used=st.used,
                n_live=st.n_live, iv=_runs(st.intervals()),
                obj_hi=dict(st.obj_hi))


# ---------------------------------------------------------------------------
# named edge cases, on both of the port's states
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls", PORT_STATES)
def test_zero_length_range_is_a_noop(cls):
    st = cls(100)
    assert st.serve(0, 0, 5, 5, 10) == 0
    assert st.lookup_touch(0, 7, 7, 10)[0] == 0
    st.check_invariants()
    assert st.intervals() == []
    assert (st.hits, st.misses, st.used) == (0, 0, 0)


@pytest.mark.parametrize("cls", PORT_STATES)
def test_adjacent_ranges_merge_on_insert(cls):
    st = cls(1000)
    st.serve(0, 0, 0, 3, 1)
    st.serve(1, 0, 3, 6, 1)
    st.check_invariants()
    assert st.intervals() == [(0, 6)]
    assert st.coverage_runs(0, 0, 10) == [(0, 6)]
    nh, miss = st.lookup_touch(0, 0, 6, 1)
    assert nh == 6 and not len(miss)


@pytest.mark.parametrize("cls", PORT_STATES)
def test_merge_on_insert_fills_interior_gap(cls):
    st = cls(1000)
    st.serve(0, 0, 0, 2, 1)
    st.serve(1, 0, 4, 6, 1)
    assert st.intervals() == [(0, 2), (4, 6)]
    st.serve(2, 0, 2, 4, 1)
    st.check_invariants()
    assert st.intervals() == [(0, 6)]


@pytest.mark.parametrize("cls", PORT_STATES)
def test_eviction_splits_an_interval(cls):
    ref, st = LRUCache(4), cls(4)
    assert ref_serve(ref, 0, 4, 1) == st.serve(0, 0, 0, 4, 1) == 0
    assert ref_serve(ref, 1, 3, 1) == st.serve(1, 0, 1, 3, 1) == 2
    assert ref_serve(ref, 10, 12, 1) == st.serve(2, 0, 10, 12, 1) == 0
    st.check_invariants()
    assert keys_of(st) == sorted(ref._od.keys()) == [1, 2, 10, 11]
    assert st.intervals() == [(1, 3), (10, 12)]
    assert st.evictions == ref.stats.evictions == 2


@pytest.mark.parametrize("cls", PORT_STATES)
def test_full_cache_boundary(cls):
    ref, st = LRUCache(6), cls(6)
    ref_serve(ref, 0, 3, 2)
    st.serve(0, 0, 0, 3, 2)
    assert st.used == st.capacity == 6
    ref_serve(ref, 5, 6, 2)
    st.serve(1, 0, 5, 6, 2)
    st.check_invariants()
    assert st.used == 6
    assert st.evictions == ref.stats.evictions == 1
    assert keys_of(st) == sorted(ref._od.keys()) == [1, 2, 5]


@pytest.mark.parametrize("cls", PORT_STATES)
def test_oversized_chunk_is_skipped_not_evicted(cls):
    ref, st = LRUCache(10), cls(10)
    ref_serve(ref, 0, 5, 2)
    st.serve(0, 0, 0, 5, 2)
    ref_serve(ref, 7, 8, 11)
    st.serve(1, 0, 7, 8, 11)
    st.check_invariants()
    assert st.evictions == ref.stats.evictions == 0
    assert keys_of(st) == sorted(ref._od.keys())
    assert (st.misses, st.miss_bytes) == (ref.stats.misses,
                                          ref.stats.miss_bytes)


@pytest.mark.parametrize("cls", PORT_STATES)
def test_eviction_inside_one_request_self_evicts_in_order(cls):
    ref, st = LRUCache(3), cls(3)
    ref_serve(ref, 0, 5, 1)
    st.serve(0, 0, 0, 5, 1)
    st.check_invariants()
    assert keys_of(st) == sorted(ref._od.keys()) == [2, 3, 4]
    assert st.evictions == ref.stats.evictions == 2


@pytest.mark.parametrize("cls", PORT_STATES)
@pytest.mark.parametrize("seed", range(6))
def test_matches_per_chunk_lru_randomized(cls, seed):
    rng = random.Random(seed)
    cap = rng.choice([23, 37, 50, 200, 1000])
    ref, st = LRUCache(cap), cls(cap)
    for step in range(120):
        obj = rng.randrange(2)
        lo = obj * 1000 + rng.randrange(0, 60)
        hi = lo + rng.randrange(0, 12)
        size = rng.choice([1, 2, 5, 13, 60])
        assert ref_serve(ref, lo, hi, size) == st.serve(step, obj, lo, hi,
                                                        size)
        assert keys_of(st) == sorted(ref._od.keys())
        s = ref.stats
        assert (s.hits, s.misses, s.hit_bytes, s.miss_bytes, s.evictions,
                s.inserted_bytes) == \
               (st.hits, st.misses, st.hit_bytes, st.miss_bytes,
                st.evictions, st.inserted_bytes)
    st.check_invariants()


# ---------------------------------------------------------------------------
# differential fuzz: the port's states against repro's, and flat vs list
# ---------------------------------------------------------------------------


def _absent_runs(held: set, obj: int, pos: int, rng, step: int, size: int):
    """Disjoint absent key runs for a fused-style commit."""
    recs_z, recs_r = [], []
    for _ in range(rng.randrange(1, 4)):
        w = rng.randrange(1, 20)
        run = sorted(k for k in range(pos, pos + w) if k not in held)
        pos += w + rng.randrange(0, 10)
        i = 0
        while i < len(run):
            j = i
            while j + 1 < len(run) and run[j + 1] == run[j] + 1:
                j += 1
            recs_z.append((obj, run[i], run[j] + 1, step, size))
            recs_r.append((obj, run[i], run[j] + 1, step))
            held.update(range(run[i], run[j] + 1))
            i = j + 1
    return recs_z, recs_r


def _runs_from(keys) -> list:
    out = []
    for k in sorted(keys):
        if out and out[-1][1] == k:
            out[-1] = (out[-1][0], k + 1)
        else:
            out.append((k, k + 1))
    return out


def _fuzz(states: list, seed: int, steps: int = 130) -> None:
    """Drive every state through one seeded op sequence: serves, lookups,
    peer/origin-partitioned inserts, coverage queries, fused block commits
    (with re-stamps of present runs), speculative eviction plans and forced
    evictions.  Every op's result and, at checkpoints, every digest must
    agree across ``states``."""
    span = 1 << 20
    rng = random.Random(repr((20261017, seed)))
    cap = rng.choice([150, 600, 1000])
    sts = [cls(cap, log_events=False) if cls in (JList, JFlat) else cls(cap)
           for cls in states]
    a = sts[0]
    sizes: dict = {}

    def same(fn):
        outs = [fn(s) for s in sts]
        for o in outs[1:]:
            assert o == outs[0]
        return outs[0]

    for step in range(steps):
        op = rng.random()
        obj = rng.randrange(3)
        size = sizes.setdefault(obj, rng.choice([1, 3, 7, 16]))
        lo = obj * span + rng.randrange(300)
        hi = lo + rng.randrange(1, 60)
        if op < 0.40:
            same(lambda s: s.serve(step, obj, lo, hi, size))
        elif op < 0.52:
            def lookup(s):
                nh, miss = s.lookup_touch(obj, lo, hi, size)
                return nh, _runs(miss)
            same(lookup)
        elif op < 0.62:
            # the sweep's partitioned flow: peer-fetched runs first
            nh, miss = a.lookup_touch(obj, lo, hi, size)
            for s in sts[1:]:
                assert s.lookup_touch(obj, lo, hi, size)[0] == nh
            keys = [k for x, y in miss for k in range(int(x), int(y))]
            peer = {k for k in keys if rng.random() < 0.4}
            for s in sts:
                s.insert_runs(obj, _runs_from(peer), size, step)
                s.insert_runs(obj, _runs_from(set(keys) - peer), size, step)
        elif op < 0.70:
            same(lambda s: _runs(s.coverage_runs(obj, lo, hi)))
            same(lambda s: [v.tolist() for v in s.coverage_arrays()])
        elif op < 0.84:
            held = set(keys_of(a))
            recs_z, recs_r = _absent_runs(held, obj,
                                          obj * span + rng.randrange(400),
                                          rng, step, size)
            tot = sum((e - s) * sz for _, s, e, _, sz in recs_z)
            if tot <= cap:
                if a.used + tot > cap:
                    for s in sts:            # the engine evicts ahead
                        s._evict_until(tot, step)
                iv = a.intervals()
                if iv and rng.random() < 0.5:
                    # re-stamp part of a present run (possibly a planned
                    # victim)
                    s0, e0 = iv[rng.randrange(len(iv))]
                    s2 = rng.randrange(s0, e0)
                    recs_r.append((s0 // span, s2,
                                   rng.randrange(s2 + 1, e0 + 1), step))
                if recs_r:
                    for s in sts:
                        s.commit_block(recs_z, recs_r)
        else:
            bl = sorted(rng.sample(range(obj * span, obj * span + 400), 4))
            need = rng.randrange(1, cap)
            same(lambda s: s.plan_evict_clean(need, [bl[0], bl[2]],
                                              [bl[1], bl[3]]))
        if step % 13 == 0:
            for s in sts:
                s.check_invariants()
            same(_digest)
    same(_digest)


@pytest.mark.parametrize("seed", range(16))
@pytest.mark.parametrize("pair", ["list", "flat"])
def test_port_state_matches_repro_digest_for_digest(pair, seed):
    states = {"list": [JList, TList], "flat": [JFlat, TFlat]}[pair]
    _fuzz(states, seed)


@pytest.mark.parametrize("seed", range(12))
def test_flat_matches_list_inside_the_port(seed):
    _fuzz([TList, TFlat], 100 + seed)


# ---------------------------------------------------------------------------
# peer-range helpers against repro's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_peer_range_helpers_match_repro(seed):
    rng = np.random.default_rng(seed)
    n = 200
    req = np.sort(rng.integers(0, 30, n)).astype(np.int64)
    keys = np.cumsum(rng.integers(0, 3, n)).astype(np.int64)
    src = rng.integers(1, 4, n).astype(np.int64)
    got = TD.coalesce_peer_fetches(req, keys, src, dtn=2)
    assert got == JD.coalesce_peer_fetches(req, keys, src, dtn=2)
    assert len(got) < n and all(isinstance(r, TD.PeerFetchRange)
                                for r in got)

    bw = rng.uniform(1.0, 30.0, (6, 50))
    holders = rng.random((6, 50)) < 0.4
    holders[0] = False
    got = TD.select_peer_sources_ranges(bw, holders)
    want = JD.select_peer_sources_ranges(bw, holders)
    for g, w in zip(got, want):
        assert g.tolist() == w.tolist()
    assert got[2].any() and not got[2].all()

    dtn = rng.integers(1, 4, n).astype(np.int64)
    hi = keys + rng.integers(1, 3, n)
    args = (req, dtn, src, keys, hi.astype(np.int64))
    assert TD.coalesce_peer_ranges(*args) == JD.coalesce_peer_ranges(*args)
