"""Flat array-backed interval LRU cache state.

:class:`FlatIntervalState` is a drop-in replacement for
:class:`repro_torch.core.cache.IntervalLRUState` — same API, same observable
behavior (hit/miss/eviction counters, coverage), verified by the
randomized differential fuzz in ``tests/test_torch_interval_cache.py`` and the
engine-level counter contract — with the Python-list run storage and deque
FIFO replaced by flat numpy column arrays so the fused block replay's
*already-batched* commit and eviction work lands as vectorized kernels
instead of per-run Python splices (profile: ``_splice_r``/``_splice_z``
plus the eviction walks were the fused path's floor).

Storage layout (all int64, amortized-doubling capacity, live prefix
``[0:n)``):

- **size map** ``(_zs, _ze, _zv)[:_zn]`` — globally sorted disjoint
  ``[start, end)`` key runs with per-chunk byte sizes.  Each data object
  owns a disjoint dense key span (``obj * span + chunk + off``), so one
  global sorted array replaces the list version's per-object buckets and
  every lookup is a single ``searchsorted``.  Adjacent equal-size runs are
  coalesced exactly like the list version's ``_splice_z``.  Never contains
  empty runs — :meth:`coverage_arrays` returns ``[: _zn]`` views of these
  columns directly, making the fused replay's block-start snapshot free
  (the list version converts per-object Python lists through a memo).
- **recency map** ``(_rs, _re, _rr)[:_rn]`` — same key runs fragmented per
  touch, carrying record ids (LRU order).  Evictions always consume a
  record's runs front-to-back, so they shrink runs in place (start moves
  right) or empty them; emptied runs become zero-length tombstones
  ``[x, x)`` (kept sorted: a tombstone never sits strictly inside a live
  run) and are dropped by the next batched rebuild or by
  :meth:`_r_compact` when they pile up.  This keeps the hot eviction path
  free of array splices entirely.
- **FIFO** ``(_fr, _flo, _fhi, _fsrc)[_fh:_ft]`` — the record queue as
  parallel arrays (record id, key range, inserting request or -1).
  ``_live[rid]`` (rid-indexed array) counts each record's live chunks, so
  stale records are skipped in O(1) and silently dropped when the queue
  compacts — observationally identical to the deque (stale pops have no
  side effects).

Mutation strategy is *adaptive*: every batched entry point first tries a
scalar plain-int walk when the batch is small (a handful of runs or FIFO
records — the common case, where Python-int arithmetic beats numpy kernel
dispatch) and falls back to the batched kernel for large or fragmented
batches; both consume state in the same order, so mixing them is exact.
Hot paths call ndarray *methods* (``arr.searchsorted`` etc.) rather than
``np.*`` module functions to skip a dispatch layer that profiles as real
time at this call density.

Batched kernels:

- :meth:`commit_block` / :meth:`commit_block_arrays` — one
  ``searchsorted`` + rebuild pass merges a whole block's size records and
  recency records into each map (the engine hands the columns over as the
  arrays it already computed, skipping the list-of-tuples round trip);
- :meth:`_evict_until` — scans the FIFO in array batches: per-record
  valid runs are gathered with two ``searchsorted`` calls, each run is
  priced via a cached byte-prefix over the size map, and the LRU cutoff
  is one ``cumsum``/``searchsorted``; only the final partially consumed
  run replays the reference's per-size-run ceil arithmetic scalarly;
- :meth:`plan_evict_clean` — the same batched scan as a pure dry run with
  a vectorized blocked-run stab, clamped at ``max_need`` (the fused block
  replay only compares the result against its byte shortfall — see the
  call-site contract in ``engine._fused_block_replay``).

Equivalence notes (the load-bearing arguments; each is exercised by the
differential fuzz):

- evictions never *split* a recency run: a record's runs all start at
  positions the eviction scan reaches front-to-back, so only in-place
  start shifts and tombstones are needed (a split would need an insert);
- pricing candidate runs against the size map *before* mutating is exact
  because all candidates are disjoint and present at call time;
- sequential ``_evict_until`` calls with nondecreasing cumulative ``size``
  arguments equal one call with the final value (chunk-granular LRU
  prefix consumption is monotone), which is why the engine may collapse a
  block's eviction loop into a single call.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.cache import CacheStats, EvictPlan

_I64 = np.int64
_EMPTY = np.empty(0, _I64)


def _replace_runs(os_: np.ndarray, oe: np.ndarray, ov: np.ndarray,
                  ns: np.ndarray, ne: np.ndarray,
                  nv: "np.ndarray | None"):
    """Rebuild a sorted-disjoint run map: remove the coverage under each
    new run (``ns/ne`` sorted, disjoint, non-empty), then insert the new
    runs themselves unless ``nv is None`` (pure subtraction).  Zero-length
    entries (tombstones) never survive.  Returns ``(s, e, v, removed)``
    where ``removed[i]`` is the coverage length taken from old entry
    ``i`` (for the caller's per-record live accounting)."""
    n = len(os_)
    if n == 0:
        if nv is None:
            return _EMPTY, _EMPTY, _EMPTY, _EMPTY
        return ns.copy(), ne.copy(), nv.copy(), _EMPTY
    a0 = ne.searchsorted(os_, side="right")       # first run ending past seg
    a1 = ns.searchsorted(oe, side="left")         # first run starting at/after
    hit = a1 > a0                                 # entries a new run touches
    # untouched entries survive whole; only the touched minority pays the
    # ragged piece machinery, then one positional merge re-interleaves
    ts, te, tv = os_[hit], oe[hit], ov[hit]
    removed = np.zeros(n, _I64)
    nt = len(ts)
    if nt:
        t0 = a0[hit]
        cnt = a1[hit] - t0 + 1                    # pieces per touched entry
        total = int(cnt.sum())
        cum = cnt.cumsum()
        seg_of = np.arange(nt).repeat(cnt)
        jj = np.arange(total) - (cum - cnt).repeat(cnt)
        left = t0[seg_of] + jj
        # piece j of a seg spans from the end of overlapping run j-1 (or
        # the seg start) to the start of overlapping run j (or the seg end)
        ps = np.where(jj == 0, ts[seg_of], ne[np.maximum(left - 1, 0)])
        is_last = jj == cnt[seg_of] - 1
        pe = np.where(is_last, te[seg_of], ns[np.minimum(left, len(ns) - 1)])
        np.maximum(ps, ts[seg_of], out=ps)
        np.minimum(pe, te[seg_of], out=pe)
        keep = pe > ps
        ks, ke, kseg = ps[keep], pe[keep], seg_of[keep]
        kv = tv[kseg]
        # chunk-count weights are small, so the float round trip is exact
        kept_len = np.bincount(kseg, weights=ke - ks,
                               minlength=nt).astype(_I64)
        removed[hit] = (te - ts) - kept_len
    else:
        ks = ke = kv = _EMPTY
    if nv is None:
        ins_s, ins_e, ins_v = ks, ke, kv
    else:
        # pieces and new runs are disjoint with distinct starts (an equal
        # start would imply a zero-length piece, already dropped): merge
        # the two small sorted sets positionally
        nn = len(ns)
        pos = ks.searchsorted(ns, side="right") + np.arange(nn)
        m = len(ks) + nn
        ins_s = np.empty(m, _I64)
        ins_e = np.empty(m, _I64)
        ins_v = np.empty(m, _I64)
        mask = np.ones(m, bool)
        mask[pos] = False
        ins_s[pos] = ns
        ins_e[pos] = ne
        ins_v[pos] = nv
        ins_s[mask] = ks
        ins_e[mask] = ke
        ins_v[mask] = kv
    # drop zero-length untouched entries (pre-existing tombstones) and
    # interleave the replacement set back among the survivors
    us, ue, uv = os_[~hit], oe[~hit], ov[~hit]
    lv = ue > us
    if not lv.all():
        us, ue, uv = us[lv], ue[lv], uv[lv]
    mi = len(ins_s)
    if not mi:
        return us, ue, uv, removed
    pos2 = us.searchsorted(ins_s, side="right") + np.arange(mi)
    m2 = len(us) + mi
    ms = np.empty(m2, _I64)
    me = np.empty(m2, _I64)
    mv = np.empty(m2, _I64)
    mask2 = np.ones(m2, bool)
    mask2[pos2] = False
    ms[pos2] = ins_s
    me[pos2] = ins_e
    mv[pos2] = ins_v
    ms[mask2] = us
    me[mask2] = ue
    mv[mask2] = uv
    return ms, me, mv, removed


class FlatIntervalState:
    """LRU cache state over dense int chunk keys in flat numpy arrays.
    Drop-in for :class:`repro_torch.core.cache.IntervalLRUState` (see the module
    docstring for layout and equivalence arguments)."""

    policy = "lru"
    #: engine dispatch marker: batched kernels accept array arguments
    flat = True

    def __init__(self, capacity_bytes: int):
        self.capacity = int(capacity_bytes)
        self.used = 0
        self.n_live = 0
        # recency map (may hold zero-length tombstones from evictions)
        self._rs = np.empty(64, _I64)
        self._re = np.empty(64, _I64)
        self._rr = np.empty(64, _I64)
        self._rn = 0
        self._rdead = 0
        # size map (never tombstoned; equal-size-adjacent runs coalesced)
        self._zs = np.empty(64, _I64)
        self._ze = np.empty(64, _I64)
        self._zv = np.empty(64, _I64)
        self._zn = 0
        self._zcum = _EMPTY          # byte prefix over the size map
        self._zcum_ok = True
        # FIFO of (rid, lo, hi, src) records, live slice [_fh:_ft)
        self._fr = np.empty(64, _I64)
        self._flo = np.empty(64, _I64)
        self._fhi = np.empty(64, _I64)
        self._fsrc = np.empty(64, _I64)
        self._fh = 0
        self._ft = 0
        # rid -> live chunk count (grown with _next_rid)
        self._live = np.zeros(64, _I64)
        self._next_rid = 1
        # speculative eviction plan (cache.EvictPlan); _fgen guards its
        # stored FIFO positions against queue compaction
        self._plan: "EvictPlan | None" = None
        self._fgen = 0
        self.obj_hi: dict[int, int] = {}
        # counters (CacheStats-compatible)
        self.hits = 0
        self.misses = 0
        self.hit_bytes = 0
        self.miss_bytes = 0
        self.evictions = 0
        self.inserted_bytes = 0

    # -- introspection -------------------------------------------------------

    def intervals(self) -> list[tuple[int, int]]:
        """Cached coverage as merged sorted disjoint ``[start, end)`` key
        runs (the size map carries exactly the present key set)."""
        out: list[tuple[int, int]] = []
        zn = self._zn
        for s, e in zip(self._zs[:zn].tolist(), self._ze[:zn].tolist()):
            if out and out[-1][1] == s:
                out[-1] = (out[-1][0], e)
            else:
                out.append((s, e))
        return out

    def __contains__(self, key: int) -> bool:
        zn = self._zn
        i = int(self._zs[:zn].searchsorted(key, side="right")) - 1
        return i >= 0 and key < self._ze[i]

    def to_cache_stats(self) -> CacheStats:
        return CacheStats(self.hits, self.misses, self.hit_bytes,
                          self.miss_bytes, self.evictions, self.inserted_bytes)

    def check_invariants(self) -> None:
        """Test hook: both maps sorted and disjoint, recency tombstones
        consistent, identical coverage, counters consistent."""
        rn, zn = self._rn, self._zn
        rs, re_, rr = self._rs[:rn], self._re[:rn], self._rr[:rn]
        zs, ze, zv = self._zs[:zn], self._ze[:zn], self._zv[:zn]
        assert (re_ >= rs).all()
        assert (rs[1:] >= rs[:-1]).all() and (re_[1:] >= re_[:-1]).all()
        liv = re_ > rs
        assert int((~liv).sum()) == self._rdead, (int((~liv).sum()),
                                                  self._rdead)
        lrs, lre = rs[liv], re_[liv]
        assert (lrs[1:] >= lre[:-1]).all()        # live runs disjoint
        assert (zs < ze).all()
        assert (zs[1:] >= ze[:-1]).all()
        # coalescing invariant (mirrors _splice_z)
        assert not ((zs[1:] == ze[:-1]) & (zv[1:] == zv[:-1])).any()
        live_chunks = int((lre - lrs).sum())
        z_chunks = int((ze - zs).sum())
        assert live_chunks == z_chunks == self.n_live, (
            live_chunks, z_chunks, self.n_live)
        assert int(((ze - zs) * zv).sum()) == self.used
        # identical coverage: merged run sets must match
        def merged(a, b):
            out = []
            for s, e in zip(a.tolist(), b.tolist()):
                if out and out[-1][1] == s:
                    out[-1][1] = e
                else:
                    out.append([s, e])
            return out
        assert merged(lrs, lre) == merged(zs, ze)
        by_rid = np.zeros(self._next_rid, _I64)
        np.add.at(by_rid, rr[liv], lre - lrs)
        assert (by_rid == self._live[:self._next_rid]).all()
        assert 0 <= self._fh <= self._ft <= len(self._fr)

    # -- plumbing ------------------------------------------------------------

    def _new_rid(self) -> int:
        rid = self._next_rid
        self._next_rid = rid + 1
        if rid >= len(self._live):
            nl = np.zeros(2 * len(self._live), _I64)
            nl[:len(self._live)] = self._live
            self._live = nl
        return rid

    def _live_reserve(self, n: int) -> None:
        if n > len(self._live):
            cap = len(self._live)
            while cap < n:
                cap *= 2
            nl = np.zeros(cap, _I64)
            nl[:len(self._live)] = self._live
            self._live = nl

    def _fifo_reserve(self, k: int) -> None:
        """Ensure room for ``k`` more records, compacting consumed and
        fully stale records away (a stale pop has no observable effect, so
        dropping stale records mid-queue is behavior-preserving)."""
        if self._ft + k <= len(self._fr):
            return
        h, t = self._fh, self._ft
        keep = self._live[self._fr[h:t]] > 0
        m = int(keep.sum())
        cap = 64
        while cap < 2 * (m + k):
            cap *= 2
        for name in ("_fr", "_flo", "_fhi", "_fsrc"):
            old = getattr(self, name)
            na = np.empty(cap, _I64)
            na[:m] = old[h:t][keep]
            setattr(self, name, na)
        self._fh = 0
        self._ft = m
        self._fgen += 1                  # stored FIFO positions renumbered

    def _fifo_push(self, rid: int, lo: int, hi: int, src: int) -> None:
        if self._ft == len(self._fr):
            self._fifo_reserve(1)
        t = self._ft
        self._fr[t] = rid
        self._flo[t] = lo
        self._fhi[t] = hi
        self._fsrc[t] = src
        self._ft = t + 1

    def _r_compact(self) -> None:
        rn = self._rn
        keep = self._re[:rn] > self._rs[:rn]
        m = int(keep.sum())
        self._rs[:m] = self._rs[:rn][keep]
        self._re[:m] = self._re[:rn][keep]
        self._rr[:m] = self._rr[:rn][keep]
        self._rn = m
        self._rdead = 0

    def _zcum_arr(self) -> np.ndarray:
        if not self._zcum_ok:
            zn = self._zn
            self._zcum = ((self._ze[:zn] - self._zs[:zn])
                          * self._zv[:zn]).cumsum()
            self._zcum_ok = True
        return self._zcum

    def _bytes_below(self, x: np.ndarray) -> np.ndarray:
        """Vectorized byte prefix F(x): total bytes of cached chunks with
        key < x (size and recency maps cover identical keys, so pricing a
        presence run is ``F(end) - F(start)``)."""
        zn = self._zn
        if zn == 0:
            return np.zeros(len(x), _I64)
        zc = self._zcum_arr()
        i = self._zs[:zn].searchsorted(x, side="right") - 1
        ic = np.maximum(i, 0)
        over = self._ze[ic] - x
        np.maximum(over, 0, out=over)
        over *= self._zv[ic]
        return np.where(i >= 0, zc[ic] - over, 0)

    def _bytes_below1(self, x: int) -> int:
        """Scalar F(x) for the plain-int scan prefixes."""
        zn = self._zn
        if zn == 0:
            return 0
        i = int(self._zs[:zn].searchsorted(x, side="right")) - 1
        if i < 0:
            return 0
        zc = self._zcum_arr()
        e = int(self._ze[i])
        if e > x:
            return int(zc[i]) - (e - x) * int(self._zv[i])
        return int(zc[i])

    def _gather_segs(self, lo_r: np.ndarray, hi_r: np.ndarray,
                     rid_r: np.ndarray):
        """Valid (still rid-carrying, non-empty) recency runs of a batch of
        FIFO records, in FIFO-then-key order — the eviction scan order.
        Returns ``(rec_of, seg_idx, starts, ends)``."""
        rn = self._rn
        i0 = self._re[:rn].searchsorted(lo_r, side="right")
        j0 = self._rs[:rn].searchsorted(hi_r, side="left")
        cnt = j0 - i0
        np.maximum(cnt, 0, out=cnt)
        total = int(cnt.sum())
        if total == 0:
            return _EMPTY, _EMPTY, _EMPTY, _EMPTY
        rec_of = np.arange(len(lo_r)).repeat(cnt)
        cum = cnt.cumsum()
        seg = np.arange(total) - (cum - cnt).repeat(cnt) + i0.repeat(cnt)
        ok = (self._rr[seg] == rid_r[rec_of]) \
            & (self._re[seg] > self._rs[seg])
        seg = seg[ok]
        rec_of = rec_of[ok]
        # a record's rid only ever covers keys inside its [lo, hi)
        s = np.maximum(self._rs[seg], lo_r[rec_of])
        e = np.minimum(self._re[seg], hi_r[rec_of])
        return rec_of, seg, s, e

    def _splice(self, zmode: bool, lo: int, hi: int, mid_s: list,
                mid_e: list, mid_v: list) -> None:
        """Scalar in-place splice: replace ``[lo, hi)`` with the given
        pieces, keeping boundary remainders — the flat equivalent of the
        list version's ``_splice_r``/``_splice_z`` (including its live
        bookkeeping and equal-size coalescing).  Tombstones inside the
        range are dropped for free."""
        if zmode:
            s, e, v, n = self._zs, self._ze, self._zv, self._zn
        else:
            s, e, v, n = self._rs, self._re, self._rr, self._rn
        i = int(e[:n].searchsorted(lo, side="right"))
        j = int(s[:n].searchsorted(hi, side="left"))
        if not zmode and j > i:
            # the overlap window is tiny (a few runs): plain-int loops beat
            # vectorized ufunc dispatch here
            live = self._live
            sw = s[i:j].tolist()
            ew = e[i:j].tolist()
            vw = v[i:j].tolist()
            dead = 0
            for k in range(j - i):
                a = sw[k]
                b = ew[k]
                if a == b:
                    dead += 1
                    continue
                if a < lo:
                    a = lo
                if b > hi:
                    b = hi
                live[vw[k]] += a - b
            self._rdead -= dead
        new_s = list(mid_s)
        new_e = list(mid_e)
        new_v = list(mid_v)
        if not zmode:
            for a2, b2, r2 in zip(new_s, new_e, new_v):
                self._live[r2] += b2 - a2
        if j > i and s[i] < lo:                        # left remainder
            new_s.insert(0, int(s[i]))
            new_e.insert(0, lo)
            new_v.insert(0, int(v[i]))
        if j > i and e[j - 1] > hi:                    # right remainder
            new_s.append(hi)
            new_e.append(int(e[j - 1]))
            new_v.append(int(v[j - 1]))
        if zmode:
            k = 1
            while k < len(new_s):
                if new_s[k] == new_e[k - 1] and new_v[k] == new_v[k - 1]:
                    new_e[k - 1] = new_e[k]
                    del new_s[k], new_e[k], new_v[k]
                else:
                    k += 1
            if new_s:
                if i > 0 and e[i - 1] == new_s[0] and v[i - 1] == new_v[0]:
                    new_s[0] = int(s[i - 1])
                    i -= 1
                if j < n and s[j] == new_e[-1] and v[j] == new_v[-1]:
                    new_e[-1] = int(e[j])
                    j += 1
        k = len(new_s)
        n2 = n + k - (j - i)
        if zmode:
            if n2 > len(s):
                s, e, v = self._z_grow(n2)
            self._zn = n2
            self._zcum_ok = False
        else:
            if n2 > len(s):
                s, e, v = self._r_grow(n2)
            self._rn = n2
        if k != j - i:
            # numpy slice assignment buffers overlapping moves
            s[i + k:n2] = s[j:n]
            e[i + k:n2] = e[j:n]
            v[i + k:n2] = v[j:n]
        if k:
            s[i:i + k] = new_s
            e[i:i + k] = new_e
            v[i:i + k] = new_v

    def _z_grow(self, n: int):
        cap = len(self._zs)
        while cap < n:
            cap *= 2
        for name in ("_zs", "_ze", "_zv"):
            na = np.empty(cap, _I64)
            na[:self._zn] = getattr(self, name)[:self._zn]
            setattr(self, name, na)
        return self._zs, self._ze, self._zv

    def _r_grow(self, n: int):
        cap = len(self._rs)
        while cap < n:
            cap *= 2
        for name in ("_rs", "_re", "_rr"):
            na = np.empty(cap, _I64)
            na[:self._rn] = getattr(self, name)[:self._rn]
            setattr(self, name, na)
        return self._rs, self._re, self._rr

    def _z_store(self, s: np.ndarray, e: np.ndarray, v: np.ndarray) -> None:
        # fresh arrays with slack; outstanding coverage_arrays() views keep
        # the old buffers as a frozen snapshot
        n = len(s)
        cap = 64
        while cap < 2 * n:
            cap *= 2
        zs = np.empty(cap, _I64)
        ze = np.empty(cap, _I64)
        zv = np.empty(cap, _I64)
        zs[:n] = s
        ze[:n] = e
        zv[:n] = v
        self._zs, self._ze, self._zv = zs, ze, zv
        self._zn = n
        self._zcum_ok = False

    def _z_replace(self, runs_s: np.ndarray, runs_e: np.ndarray,
                   runs_v: np.ndarray) -> None:
        """Batched size-map commit: one rebuild pass inserts all runs
        (sorted, disjoint, absent) and re-coalesces equal-size neighbors."""
        zn = self._zn
        zs, ze, zv = self._zs[:zn], self._ze[:zn], self._zv[:zn]
        i0 = ze.searchsorted(runs_s, side="right")
        j0 = zs.searchsorted(runs_e, side="left")
        if not (j0 > i0).any():
            # the committed runs are absent (always true for fused-replay
            # commits: size records are first-touch misses and only
            # evictions mutated the map since) — pure positional merge of
            # two sorted disjoint sets, no piece machinery
            nn = len(runs_s)
            pos = zs.searchsorted(runs_s, side="right") + np.arange(nn)
            s2 = np.empty(zn + nn, _I64)
            e2 = np.empty(zn + nn, _I64)
            v2 = np.empty(zn + nn, _I64)
            mask = np.ones(zn + nn, bool)
            mask[pos] = False
            s2[pos] = runs_s
            e2[pos] = runs_e
            v2[pos] = runs_v
            s2[mask] = zs
            e2[mask] = ze
            v2[mask] = zv
        else:
            s2, e2, v2, _ = _replace_runs(zs, ze, zv,
                                          runs_s, runs_e, runs_v)
        if len(s2) > 1:
            brk = np.empty(len(s2), bool)
            brk[0] = True
            brk[1:] = (s2[1:] != e2[:-1]) | (v2[1:] != v2[:-1])
            if not brk.all():
                heads = brk.nonzero()[0]
                tails = np.append(heads[1:], len(s2)) - 1
                s2, e2, v2 = s2[heads], e2[tails], v2[heads]
        self._z_store(s2, e2, v2)

    def _z_subtract(self, runs_s: np.ndarray, runs_e: np.ndarray) -> None:
        """Batched size-map eviction: remove the coverage under all runs
        (sorted, disjoint) in one rebuild pass.  Subtraction cannot create
        new equal-size adjacency, so no coalescing is needed.  Small
        batches take per-run in-place splices instead: each is one memmove
        at C speed, cheaper than an O(map) rebuild."""
        if len(runs_s) <= 8:
            for a, b in zip(runs_s.tolist(), runs_e.tolist()):
                self._splice(True, a, b, (), (), ())
            return
        zn = self._zn
        s2, e2, v2, _ = _replace_runs(
            self._zs[:zn], self._ze[:zn], self._zv[:zn],
            runs_s, runs_e, None)
        self._z_store(s2, e2, v2)

    def _r_replace(self, runs_s: np.ndarray, runs_e: np.ndarray,
                   rids: np.ndarray) -> None:
        """Batched recency-map commit: replace coverage under each run
        with its fresh record id, maintaining per-record live counts.
        When no committed run overlaps existing coverage (or a tombstone),
        a pure positional merge replaces the rebuild."""
        rn = self._rn
        os_, oe, ov = self._rs[:rn], self._re[:rn], self._rr[:rn]
        i0 = oe.searchsorted(runs_s, side="right")
        j0 = os_.searchsorted(runs_e, side="left")
        if not (j0 > i0).any():
            nn = len(runs_s)
            # side="right" keeps an equal-start tombstone [x, x) sorted
            # before the inserted live run [x, y) (end-sortedness)
            pos = os_.searchsorted(runs_s, side="right") + np.arange(nn)
            n = rn + nn
            cap = 64
            while cap < 2 * n:
                cap *= 2
            rs = np.empty(cap, _I64)
            re_ = np.empty(cap, _I64)
            rr = np.empty(cap, _I64)
            mask = np.ones(n, bool)
            mask[pos] = False
            rs[:n][pos] = runs_s
            re_[:n][pos] = runs_e
            rr[:n][pos] = rids
            rs[:n][mask] = os_
            re_[:n][mask] = oe
            rr[:n][mask] = ov
            self._rs, self._re, self._rr = rs, re_, rr
            self._rn = n
            # tombstones survive a merge; _rdead is unchanged
        else:
            s2, e2, v2, removed = _replace_runs(os_, oe, ov,
                                                runs_s, runs_e, rids)
            idx = removed.nonzero()[0]
            if len(idx):
                np.add.at(self._live, ov[idx], -removed[idx])
            n = len(s2)
            cap = 64
            while cap < 2 * n:
                cap *= 2
            rs = np.empty(cap, _I64)
            re_ = np.empty(cap, _I64)
            rr = np.empty(cap, _I64)
            rs[:n] = s2
            re_[:n] = e2
            rr[:n] = v2
            self._rs, self._re, self._rr = rs, re_, rr
            self._rn = n
            self._rdead = 0            # rebuilds drop all tombstones
        # rids are fresh (so their counts start at 0), but grouped commits
        # repeat a rid across runs — accumulate, don't assign
        np.add.at(self._live, rids, runs_e - runs_s)

    def _valid_segs(self, rid: int, obj: int, lo: int,
                    hi: int) -> list[tuple[int, int]]:
        """Sub-runs of ``[lo, hi)`` still carrying ``rid``, ascending
        (``obj`` is accepted for list-version API parity; the global key
        space needs no bucket)."""
        rn = self._rn
        i = int(self._re[:rn].searchsorted(lo, side="right"))
        j = int(self._rs[:rn].searchsorted(hi, side="left"))
        if i >= j:
            return []
        sw = self._rs[i:j]
        ew = self._re[i:j]
        m = (self._rr[i:j] == rid) & (ew > sw)
        s = np.maximum(sw[m], lo)
        e = np.minimum(ew[m], hi)
        return list(zip(s.tolist(), e.tolist()))

    # -- eviction ------------------------------------------------------------

    def _evict_range(self, s: int, stop: int, rid: int) -> None:
        """Remove the evicted prefix ``[s, stop)`` (of one recency run
        carrying ``rid``) from both maps.  The recency run shrinks in
        place; the size map takes a real splice (it may split)."""
        rn = self._rn
        i = int(self._re[:rn].searchsorted(s, side="right"))
        # [s, stop) is a prefix of the run at i (eviction consumes runs
        # front-to-back, so the run starts exactly at s)
        self._rs[i] = stop
        if stop == self._re[i]:
            self._rdead += 1
        self._live[rid] -= stop - s
        self._splice(True, s, stop, [], [], [])

    def _evict_until(self, size: int, t_now: int) -> None:
        """Evict chunks in exact LRU order until ``used + size`` fits —
        the reference's per-chunk loop arithmetically (per victim size
        run, ``ceil(shortfall / chunk_size)`` chunks).  Adaptive: the
        first few records are walked with plain-int scalars (the dominant
        case — a thrash-regime insert frees its need from the head record
        or two), then the batched array scan takes over.  Both consume the
        same LRU prefix, so mixing them is exact."""
        cap = self.capacity
        if self.used + size <= cap:
            return
        p = self._plan
        if p is not None:
            if p.fgen == self._fgen:
                self._evict_via_plan(p, size)
                return
            self._plan = None          # FIFO compacted: positions stale
        live = self._live
        fr = self._fr
        flo = self._flo
        fhi = self._fhi
        t = self._ft
        budget = 4
        while self.used + size > cap:
            if budget == 0:
                self._evict_batched(size)
                break
            budget -= 1
            p = self._fh
            while p < t and live[fr[p]] <= 0:
                p += 1
            self._fh = p
            if p >= t:
                # mirrors the reference's evict-from-empty popleft
                raise IndexError("pop from an empty deque")
            rid = int(fr[p])
            lo = int(flo[p])
            hi = int(fhi[p])
            rn = self._rn
            rs = self._rs
            re_ = self._re
            rr = self._rr
            i0 = int(re_[:rn].searchsorted(lo, side="right"))
            j0 = int(rs[:rn].searchsorted(hi, side="left"))
            if j0 - i0 > 24:
                # heavily fragmented record: per-seg scalar stabs lose to
                # the vectorized scan
                self._evict_batched(size)
                break
            requeued = False
            for k in range(i0, j0):
                if rr[k] != rid:
                    continue
                s = int(rs[k])
                e0 = int(re_[k])
                if e0 <= s:
                    continue
                e = e0 if e0 <= hi else hi
                if s < lo:
                    s = lo
                # per-size-run ceil walk (the reference's arithmetic)
                stop = s
                used = self.used
                ze = self._ze
                zv = self._zv
                zi = int(ze[:self._zn].searchsorted(s, side="right"))
                while stop < e:
                    need = used + size - cap
                    if need <= 0:
                        break
                    z = int(zv[zi])
                    pe = int(ze[zi])
                    if pe > e:
                        pe = e
                    take = -(-need // z)
                    if take > pe - stop:
                        take = pe - stop
                    used -= take * z
                    stop += take
                    if stop == pe:
                        zi += 1
                self.used = used
                if stop > s:
                    n_ev = stop - s
                    self.n_live -= n_ev
                    self.evictions += n_ev
                    live[rid] -= n_ev
                    rs[k] = stop           # in-place prefix shrink
                    if stop == e0:
                        self._rdead += 1
                    self._splice(True, s, stop, (), (), ())
                if stop < e:
                    # need met mid-run: re-queue the remainder at the head
                    flo[p] = stop
                    requeued = True
                    break
            if not requeued:
                self._fh = p + 1
        if self._rdead > 64 and self._rdead * 2 > self._rn:
            self._r_compact()

    def _evict_batched(self, size: int) -> None:
        """Batched FIFO array scan for long eviction tails (see
        :meth:`_evict_until`)."""
        need = self.used + size - self.capacity
        if need <= 0:
            return
        full_seg: list = []
        full_s: list = []
        full_e: list = []
        full_rid: list = []
        freed = 0
        p = self._fh
        t = self._ft
        K = 32
        while True:
            if p >= t:
                # mirrors the reference's evict-from-empty popleft
                raise IndexError("pop from an empty deque")
            q = min(t, p + K)
            K = min(1024, K * 2)
            alive = self._live[self._fr[p:q]] > 0
            rpos = alive.nonzero()[0] + p
            if not len(rpos):
                p = q
                continue
            rid_b = self._fr[rpos]
            rec_of, seg, s, e = self._gather_segs(
                self._flo[rpos], self._fhi[rpos], rid_b)
            by = self._bytes_below(e) - self._bytes_below(s)
            cumb = freed + by.cumsum()
            cut = int(cumb.searchsorted(need, side="left"))
            if cut >= len(by):
                full_seg.append(seg)
                full_s.append(s)
                full_e.append(e)
                full_rid.append(rid_b[rec_of])
                if len(by):
                    freed = int(cumb[-1])
                p = q
                continue
            full_seg.append(seg[:cut])
            full_s.append(s[:cut])
            full_e.append(e[:cut])
            full_rid.append(rid_b[rec_of[:cut]])
            seg_c = int(seg[cut])
            s_c = int(s[cut])
            e_c = int(e[cut])
            rid_c = int(rid_b[rec_of[cut]])
            rec_c = int(rpos[rec_of[cut]])
            cum_before = int(cumb[cut - 1]) if cut > 0 else freed
            break
        # final run: replay the reference's per-size-run ceil arithmetic
        rem = need - cum_before
        ze = self._ze
        zv = self._zv
        zi = int(ze[:self._zn].searchsorted(s_c, side="right"))
        stop = s_c
        part_bytes = 0
        while stop < e_c and rem > 0:
            z = int(zv[zi])
            pe = int(ze[zi])
            if pe > e_c:
                pe = e_c
            take = min(pe - stop, -(-rem // z))
            part_bytes += take * z
            rem -= take * z
            stop += take
            if stop == pe:
                zi += 1
        Fseg = np.concatenate(full_seg) if full_seg else _EMPTY
        Fs = np.concatenate(full_s) if full_s else _EMPTY
        Fe = np.concatenate(full_e) if full_e else _EMPTY
        Frid = np.concatenate(full_rid) if full_rid else _EMPTY
        n_full = int((Fe - Fs).sum())
        n_part = stop - s_c
        self.used -= cum_before + part_bytes
        self.n_live -= n_full + n_part
        self.evictions += n_full + n_part
        if len(Fseg):
            np.add.at(self._live, Frid, -(Fe - Fs))
            self._rs[Fseg] = self._re[Fseg]    # tombstone in place
            self._rdead += len(Fseg)
        self._live[rid_c] -= n_part
        self._rs[seg_c] = stop
        if stop == e_c:
            self._rdead += 1
        # the cut record keeps the queue head with its remainder (the list
        # version's appendleft re-queue); if fully consumed it goes stale
        # and the next scan skips it
        self._fh = rec_c
        self._flo[rec_c] = stop
        sub_s = np.append(Fs, s_c)
        sub_e = np.append(Fe, stop)
        order = sub_s.argsort()
        self._z_subtract(sub_s[order], sub_e[order])

    # -- speculative eviction planning (cache.EvictPlan) ---------------------

    def _plan_seg_bytes(self, obj: int, s: int, stop: int) -> int:
        """Bytes of the present run ``[s, stop)`` (``obj`` unused — the
        global size map prices any run)."""
        return self._bytes_below1(stop) - self._bytes_below1(s)

    def get_evict_plan(self, max_need: int) -> "EvictPlan":
        """The state's speculative eviction plan, guaranteed to cover
        ``>= max_need`` bytes or be exhausted.  A cached plan short of the
        bar is *extended* from its scan frontier when the FIFO generation
        still matches (the common case: block truncations re-query with
        shrinking needs, evictions consume the planned prefix in order);
        a compaction-stale plan is rebuilt from the queue head."""
        p = self._plan
        if p is not None:
            if p.total >= max_need:
                # deliberately no fgen check: plan_evict_clean consumes
                # only key runs + byte sums (vs/ve/cumb/segb against the
                # CURRENT size map), never the FIFO positions that a
                # compaction renumbers, and ``_evict_until`` re-validates
                # ``p.fgen`` itself before consuming the plan.  Phased
                # block replay makes this branch hot: phase commits can
                # compact the FIFO (fgen bump) between boundary plans.
                return p
            if p.fgen == self._fgen:
                if p.pos >= self._ft:
                    return p           # exhausted: covers every byte
                self._plan_extend(p, max_need)
                return p
        p = EvictPlan(self)
        p.pos = self._fh
        p.fgen = self._fgen
        self._plan = p
        self._plan_extend(p, max_need)
        return p

    def _plan_extend(self, p: "EvictPlan", max_need: int) -> None:
        """Scan the FIFO from the plan's frontier, appending victim runs
        until planned bytes reach ~2x ``max_need`` or the queue ends.
        Pure (no ``_fh`` advance — stale records are skipped, not
        dropped); mirrors ``_evict_batched``'s gather exactly."""
        t = self._ft
        target = 2 * max_need
        pos = p.pos
        vs_parts: list[np.ndarray] = []
        ve_parts: list[np.ndarray] = []
        by_parts: list[np.ndarray] = []
        rec_parts: list[np.ndarray] = []
        got = 0
        K = 32
        while pos < t and p.total + got < target:
            q = min(t, pos + K)
            K = min(1024, K * 2)
            alive = self._live[self._fr[pos:q]] > 0
            rpos = alive.nonzero()[0] + pos
            pos = q
            if not len(rpos):
                continue
            rec_of, seg, s, e = self._gather_segs(
                self._flo[rpos], self._fhi[rpos], self._fr[rpos])
            if not len(seg):
                continue
            by = self._bytes_below(e) - self._bytes_below(s)
            vs_parts.append(s)
            ve_parts.append(e)
            by_parts.append(by)
            rec_parts.append(rpos[rec_of])
            got += int(by.sum())
        p.pos = pos
        p.exhausted = pos >= t
        if vs_parts:
            p.vs = np.concatenate([p.vs] + vs_parts)
            p.ve = np.concatenate([p.ve] + ve_parts)
            p.segb = np.concatenate([p.segb] + by_parts)
            p.vrec = np.concatenate([p.vrec] + rec_parts)
            p.cumb = p.segb.cumsum()
            p.total += got
            p._index()

    def _evict_via_plan(self, p: "EvictPlan", size: int) -> None:
        """Consume the planned victim prefix to fit ``used + size`` —
        state mutations identical to :meth:`_evict_batched` (same cutoff
        search, same per-size-run ceil arithmetic on the cut run), but fed
        from the plan instead of a fresh FIFO scan.  Exact because the
        plan's runs are, under the validity guards, precisely what that
        scan would find, and the leftover plan suffix equals the next
        scan's result (consumption advances ``_fh``/``_flo`` in step)."""
        need = self.used + size - self.capacity
        if p.total < need:
            if p.pos < self._ft:
                self._plan_extend(p, need)
            if p.total < need and p.pos >= self._ft:
                # planning every freeable byte still falls short — the
                # reference's evict-from-empty popleft
                raise IndexError("pop from an empty deque")
        cumb = p.cumb
        cut = int(cumb.searchsorted(need, side="left"))
        base = int(cumb[cut - 1]) if cut > 0 else 0
        s_c = int(p.vs[cut])
        e_c = int(p.ve[cut])
        # cut run: the reference's per-size-run ceil arithmetic
        rem = need - base
        ze = self._ze
        zv = self._zv
        zi = int(ze[:self._zn].searchsorted(s_c, side="right"))
        stop = s_c
        part_bytes = 0
        while stop < e_c and rem > 0:
            z = int(zv[zi])
            pe = int(ze[zi])
            if pe > e_c:
                pe = e_c
            take = min(pe - stop, -(-rem // z))
            part_bytes += take * z
            rem -= take * z
            stop += take
            if stop == pe:
                zi += 1
        vs_f = p.vs[:cut]
        ve_f = p.ve[:cut]
        n_full = int((ve_f - vs_f).sum())
        n_part = stop - s_c
        self.used -= base + part_bytes
        self.n_live -= n_full + n_part
        self.evictions += n_full + n_part
        rn = self._rn
        re_live = self._re[:rn]
        if cut:
            # recover the recency-run index of each victim run: runs are
            # consumed front-to-back, so a live run starts exactly at the
            # victim start and is the first entry ending past it
            # (end-sortedness; same lookup as _evict_range)
            Fseg = re_live.searchsorted(vs_f, side="right")
            np.add.at(self._live, self._rr[Fseg], -(ve_f - vs_f))
            self._rs[Fseg] = self._re[Fseg]    # tombstone in place
            self._rdead += cut
        seg_c = int(re_live.searchsorted(s_c, side="right"))
        self._live[self._rr[seg_c]] -= n_part
        self._rs[seg_c] = stop
        if stop == e_c:
            self._rdead += 1
        # the cut record keeps the queue head with its remainder
        rec_c = int(p.vrec[cut])
        self._fh = rec_c
        self._flo[rec_c] = stop
        sub_s = np.append(vs_f, s_c)
        sub_e = np.append(ve_f, stop)
        order = sub_s.argsort()
        self._z_subtract(sub_s[order], sub_e[order])
        # advance the plan past the consumed prefix (ks/ke stay stale —
        # consumed runs can only cause a spurious, safe invalidation)
        if stop < e_c:
            vs2 = p.vs[cut:].copy()
            vs2[0] = stop
            sb2 = p.segb[cut:].copy()
            sb2[0] -= part_bytes
            p.vs = vs2
            p.ve = p.ve[cut:]
            p.vrec = p.vrec[cut:]
            p.segb = sb2
        else:
            p.vs = p.vs[cut + 1:]
            p.ve = p.ve[cut + 1:]
            p.vrec = p.vrec[cut + 1:]
            p.segb = p.segb[cut + 1:]
        p.cumb = p.segb.cumsum()
        p.total -= base + part_bytes
        if self._rdead > 64 and self._rdead * 2 > self._rn:
            self._r_compact()

    # -- bulk block APIs (fused block-over-intervals replay) -----------------

    def coverage_arrays(self, objs=None) -> tuple[np.ndarray, np.ndarray]:
        """Presence snapshot as flat globally sorted ``(starts, ends)``
        views of the size map — free (the list version converts per-object
        Python lists through a memo).  ``objs`` is accepted for API parity
        and ignored: the full map is a superset that stabs identically for
        any key inside the requested objects' disjoint spans.

        Snapshot contract: the views alias live storage, so they are valid
        until the next mutating call — exactly the fused replay's usage
        (one snapshot per block attempt, consumed before any commit or
        eviction; batched rebuilds allocate fresh arrays, leaving older
        snapshots frozen)."""
        zn = self._zn
        return self._zs[:zn], self._ze[:zn]

    def plan_evict_clean(self, max_need, blocked_starts,
                         blocked_ends) -> int:
        """Dry-run the eviction scan: bytes freeable in exact LRU order
        before the first victim chunk inside a *blocked* run, clamped at
        ``max_need`` (see the contract note at the call site in
        ``engine._fused_block_replay``).  Pure; accepts lists or arrays
        for the blocked runs.  Answered from the state's speculative
        :class:`~repro_torch.core.cache.EvictPlan`, which persists across block
        truncations, later blocks, and the evictions that consume it."""
        max_need = int(max_need)
        if max_need <= 0:
            return 0
        return self.get_evict_plan(max_need).clean_before(
            max_need, blocked_starts, blocked_ends)

    def commit_block(self, size_recs: list, recency_recs: list,
                     r_grp: "list | None" = None) -> None:
        """Bulk-commit one fused replay block (list-of-tuples API parity
        with the list version; see :meth:`commit_block_arrays`)."""
        za = np.asarray(size_recs, _I64).reshape(-1, 5)
        ra = np.asarray(recency_recs, _I64).reshape(-1, 4)
        self.commit_block_arrays(za[:, 0], za[:, 1], za[:, 2], za[:, 3],
                                 za[:, 4], ra[:, 0], ra[:, 1], ra[:, 2],
                                 ra[:, 3],
                                 None if r_grp is None
                                 else np.asarray(r_grp, _I64))

    def commit_block_arrays(self, z_obj, z_lo, z_hi, z_src, z_sz,
                            r_obj, r_lo, r_hi, r_src,
                            r_grp: "np.ndarray | None" = None) -> None:
        """Bulk-commit one fused replay block from the column arrays the
        engine already computed (same record semantics as the list
        version's ``commit_block``: size records carry presence/byte
        bookkeeping in trace order, recency records append FIFO records in
        final-stamp order).  Each map is merged in one batched rebuild.

        ``r_grp`` (optional): contiguous non-decreasing group ids
        parallel to the recency columns — one group's records (same
        DTN-object group, consecutive final stamps, ascending disjoint key
        runs) are fused under ONE rid and ONE FIFO record spanning
        first-lo..last-hi; see the exactness argument on the list
        version's ``commit_block``."""
        kz = len(z_lo)
        p = self._plan
        if p is not None and len(r_lo) and len(p.ks):
            # a recency record re-stamping a planned victim invalidates
            # the plan (size records insert absent keys — never victims)
            ii = p.ks.searchsorted(r_hi, side="left")
            if bool(((ii > 0) & (p.ke[np.maximum(ii - 1, 0)]
                                 > r_lo)).any()):
                self._plan = None
        if kz:
            nm = z_hi - z_lo
            tot_chunks = int(nm.sum())
            tot_bytes = int((nm * z_sz).sum())
            self.used += tot_bytes
            self.n_live += tot_chunks
            self.inserted_bytes += tot_bytes
            oh = self.obj_hi
            for o, b in zip(z_obj.tolist(), z_hi.tolist()):
                if b > oh.get(o, 0):
                    oh[o] = b
            zl = np.asarray(z_lo, _I64)
            zh = np.asarray(z_hi, _I64)
            zz = np.asarray(z_sz, _I64)
            if kz <= 8:
                # small commit: sequential scalar splices in trace order
                # (identical to the list version's per-record loop)
                for a, b, z in zip(zl.tolist(), zh.tolist(), zz.tolist()):
                    self._splice(True, a, b, (a,), (b,), (z,))
            else:
                if not (zl[1:] >= zl[:-1]).all():
                    o2 = zl.argsort(kind="stable")
                    zl = zl[o2]
                    zh = zh[o2]
                    zz = zz[o2]
                self._z_replace(zl, zh, zz)
        kr = len(r_lo)
        if kr:
            if r_grp is not None:
                gh_mask = np.empty(kr, bool)
                gh_mask[0] = True
                gh_mask[1:] = r_grp[1:] != r_grp[:-1]
                gh = gh_mask.nonzero()[0]          # group head run indices
                gt = np.append(gh[1:], kr) - 1     # group tail run indices
                G = len(gh)
            if kr <= 8:
                # small commit: push + splice one record at a time (splices
                # set live counts immediately, so no bulk reserve is needed)
                if r_grp is None:
                    self._fifo_reserve(kr)
                    for a, b, s_ in zip(r_lo.tolist(), r_hi.tolist(),
                                        r_src.tolist()):
                        rid = self._new_rid()
                        self._fifo_push(rid, a, b, s_)
                        self._splice(False, a, b, (a,), (b,), (rid,))
                    return
                self._fifo_reserve(G)
                lo_l = r_lo.tolist()
                hi_l = r_hi.tolist()
                src_l = r_src.tolist()
                for x in range(G):
                    h = int(gh[x])
                    t_ = int(gt[x])
                    rid = self._new_rid()
                    src_g = src_l[h] if h == t_ else -1
                    self._fifo_push(rid, lo_l[h], hi_l[t_], src_g)
                    for y in range(h, t_ + 1):
                        self._splice(False, lo_l[y], hi_l[y],
                                     (lo_l[y],), (hi_l[y],), (rid,))
                return
            if r_grp is None:
                rid0 = self._next_rid
                self._next_rid = rid0 + kr
                self._live_reserve(self._next_rid)
                rids_rec = np.arange(rid0, rid0 + kr, dtype=_I64)
                rids_run = rids_rec
                f_lo, f_hi, f_src = r_lo, r_hi, r_src
                G = kr
            else:
                rid0 = self._next_rid
                self._next_rid = rid0 + G
                self._live_reserve(self._next_rid)
                rids_rec = np.arange(rid0, rid0 + G, dtype=_I64)
                rids_run = rid0 + (np.cumsum(gh_mask) - 1)
                f_lo = r_lo[gh]
                f_hi = r_hi[gt]
                f_src = np.where(gh == gt, r_src[gh], -1)
            self._fifo_reserve(G)
            t = self._ft
            self._fr[t:t + G] = rids_rec
            self._flo[t:t + G] = f_lo
            self._fhi[t:t + G] = f_hi
            self._fsrc[t:t + G] = f_src
            self._ft = t + G
            rl = np.asarray(r_lo, _I64)
            rh = np.asarray(r_hi, _I64)
            if not (rl[1:] >= rl[:-1]).all():
                o3 = rl.argsort(kind="stable")
                rl = rl[o3]
                rh = rh[o3]
                rids_run = rids_run[o3]
            self._r_replace(rl, rh, rids_run)

    # -- serving -------------------------------------------------------------

    def lookup_touch(self, obj: int, lo: int, hi: int,
                     size: int) -> tuple[int, tuple]:
        """Hit/miss split plus LRU touch for chunk keys ``[lo, hi)`` —
        identical decision sequence to the list version (hits touched in
        ascending order, one coalesced record per maximal present run)."""
        if hi <= lo:
            return 0, ()
        p = self._plan
        if p is not None and hi > p.kmin and lo < p.kmax:
            i_ = int(p.ks.searchsorted(hi, side="left"))
            if i_ > 0 and int(p.ke[i_ - 1]) > lo:
                self._plan = None  # touch may re-stamp a planned victim
        rn = self._rn
        rs = self._rs
        re_ = self._re
        i = int(re_[:rn].searchsorted(lo, side="right"))
        if i < rn and rs[i] <= lo and re_[i] >= hi:
            # full hit inside one run (tombstones can never satisfy this:
            # start <= lo < end is impossible for a zero-length entry)
            nh = hi - lo
            self.hits += nh
            self.hit_bytes += nh * size
            live = self._live
            old = int(self._rr[i])
            if rs[i] == lo and re_[i] == hi:
                t = self._ft
                if t > self._fh and self._fr[t - 1] == old \
                        and live[old] == nh:
                    # newest record, fully live: re-touching is a no-op
                    return nh, ()
                rid = self._new_rid()
                self._fifo_push(rid, lo, hi, -1)
                self._live[old] -= nh
                self._live[rid] = nh
                self._rr[i] = rid
                return nh, ()
            rid = self._new_rid()
            self._fifo_push(rid, lo, hi, -1)
            self._splice(False, lo, hi, [lo], [hi], [rid])
            return nh, ()
        j = int(rs[:rn].searchsorted(hi, side="left"))
        hit_runs: list[tuple[int, int]] = []
        miss_runs: list[tuple[int, int]] = []
        pos = lo
        if j > i:
            sw = rs[i:j].tolist()
            ew = re_[i:j].tolist()
            for k in range(j - i):
                a = sw[k]
                b = ew[k]
                if b <= a:
                    continue               # tombstone
                if a < lo:
                    a = lo
                if b > hi:
                    b = hi
                if a > pos:
                    miss_runs.append((pos, a))
                if hit_runs and hit_runs[-1][1] == a:
                    hit_runs[-1] = (hit_runs[-1][0], b)
                else:
                    hit_runs.append((a, b))
                pos = b
        if pos < hi:
            miss_runs.append((pos, hi))
        nh = (hi - lo) - sum(b - a for a, b in miss_runs)
        nm = (hi - lo) - nh
        self.hits += nh
        self.misses += nm
        self.hit_bytes += nh * size
        self.miss_bytes += nm * size
        if hit_runs:
            # reserve up front: the records' live counts are only set by
            # the splice below, so a compaction triggered by a later push
            # in this loop would drop the earlier records as stale
            self._fifo_reserve(len(hit_runs))
            h_s: list = []
            h_e: list = []
            h_r: list = []
            for a, b in hit_runs:
                rid = self._new_rid()
                self._fifo_push(rid, a, b, -1)
                h_s.append(a)
                h_e.append(b)
                h_r.append(rid)
            self._splice(False, lo, hi, h_s, h_e, h_r)
        return nh, miss_runs

    def coverage_runs(self, obj: int, lo: int, hi: int) -> list:
        """Present sub-runs of ``[lo, hi)`` (merged, ascending) — the peer
        lookup primitive."""
        if lo >= self.obj_hi.get(obj, 0):
            return []
        rn = self._rn
        i = int(self._re[:rn].searchsorted(lo, side="right"))
        j = int(self._rs[:rn].searchsorted(hi, side="left"))
        if i >= j:
            return []
        sw = self._rs[i:j].tolist()
        ew = self._re[i:j].tolist()
        out: list[tuple[int, int]] = []
        for k in range(j - i):
            a = sw[k]
            b = ew[k]
            if b <= a:
                continue
            if a < lo:
                a = lo
            if b > hi:
                b = hi
            if out and out[-1][1] == a:
                out[-1] = (out[-1][0], b)
            else:
                out.append((a, b))
        return out

    def insert_runs(self, obj: int, runs: list, size: int,
                    req_pos: int) -> None:
        """Insert absent chunk runs (ascending) with reference ``insert``
        semantics (oversize skip, chunk-by-chunk evict-ahead)."""
        if not runs or size > self.capacity:
            return
        nm = sum(b - a for a, b in runs)
        oh = self.obj_hi
        if runs[-1][1] > oh.get(obj, 0):
            oh[obj] = runs[-1][1]
        if self.used + nm * size <= self.capacity:
            for a, b in runs:
                rid = self._new_rid()
                self._fifo_push(rid, a, b, req_pos)
                self._splice(False, a, b, [a], [b], [rid])
                self._splice(True, a, b, [a], [b], [size])
            self.used += nm * size
            self.n_live += nm
            self.inserted_bytes += nm * size
            return
        self._insert_with_evict(obj, runs, size, req_pos)

    def serve(self, req_pos: int, obj: int, lo: int, hi: int,
              size: int) -> int:
        """Serve one request with every miss inserted in ascending chunk
        order (all from one source).  Returns the hit count."""
        nh, miss_runs = self.lookup_touch(obj, lo, hi, size)
        if miss_runs:
            self.insert_runs(obj, miss_runs, size, req_pos)
        return nh

    def _insert_with_evict(self, obj: int, miss_runs: list, size: int,
                           req_pos: int) -> None:
        nm = sum(b - a for a, b in miss_runs)
        if nm * size <= self.capacity:
            # churn-tail fast path (the degenerate scalar serves): ONE
            # batched eviction for the whole insert volume, then one splice
            # pair per run — exact because LRU prefix consumption is
            # monotone (evicting for the per-chunk cumulative needs in
            # sequence lands on the same final prefix with the same final
            # split arithmetic), and no chunk of this insert can become
            # its own victim when the volume fits capacity.
            if self.used + nm * size > self.capacity:
                self._evict_until(nm * size, req_pos)
            for a, b in miss_runs:
                rid = self._new_rid()
                self._fifo_push(rid, a, b, req_pos)
                self._splice(False, a, b, [a], [b], [rid])
                self._splice(True, a, b, [a], [b], [size])
            self.used += nm * size
            self.n_live += nm
            self.inserted_bytes += nm * size
            return
        # oversize wrap: the run cannot fit at once, so later chunks evict
        # earlier chunks of the same insert (reference chunk-by-chunk
        # evict-ahead semantics)
        for a, b in miss_runs:
            j = a
            while j < b:
                if self.used + size > self.capacity:
                    self._evict_until(size, req_pos)
                cnt = min(b - j, (self.capacity - self.used) // size)
                rid = self._new_rid()
                self._splice(False, j, j + cnt, [j], [j + cnt], [rid])
                self._splice(True, j, j + cnt, [j], [j + cnt], [size])
                self._fifo_push(rid, j, j + cnt, req_pos)
                self.used += cnt * size
                self.n_live += cnt
                self.inserted_bytes += cnt * size
                j += cnt
