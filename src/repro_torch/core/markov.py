"""MD1 reference pre-fetching model — Li et al. (2012).

"A prefetching model based on access popularity for geospatial data in a
cluster-based caching system": connect the geospatial coordinates of accessed
objects into an *access path*; observe that tile accesses follow Zipf's law;
predict the next accesses with a first-order Markov chain **over locations**
(the access path) combined with global object **popularity** at the predicted
locations.

Unlike HPM, the model is applied uniformly to all requests (no human/program
distinction) and carries no per-user moving-window state — this is exactly
the weakness the paper's comparison exposes (§V-B1).
"""
from __future__ import annotations

import collections
from typing import Iterable

from repro_torch.core.trace import ObjectGrid, Request


class MarkovPredictor:
    """Location-path Markov chain + Zipf popularity (Li et al. 2012)."""

    def __init__(self, grid: ObjectGrid, smoothing: float = 0.1):
        self.grid = grid
        self.smoothing = smoothing
        # loc -> next-loc transition counts (the "access path")
        self.loc_transitions: dict[int, collections.Counter] = \
            collections.defaultdict(collections.Counter)
        # global object popularity (Zipf-distributed in their traces)
        self.popularity: collections.Counter = collections.Counter()
        # objects seen per location (for popularity-at-location ranking)
        self.loc_objs: dict[int, collections.Counter] = \
            collections.defaultdict(collections.Counter)
        self._last_loc: dict[int, int] = {}   # per-user last location

    def fit(self, requests: Iterable[Request]) -> "MarkovPredictor":
        by_user: dict[int, list[Request]] = collections.defaultdict(list)
        for r in requests:
            by_user[r.user_id].append(r)
        for reqs in by_user.values():
            reqs.sort(key=lambda r: r.ts)
            for a, b in zip(reqs, reqs[1:]):
                self.loc_transitions[self.grid.loc_of(a.obj)][
                    self.grid.loc_of(b.obj)] += 1
            for r in reqs:
                self._count(r)
        return self

    def _count(self, r: Request) -> None:
        self.popularity[r.obj] += 1
        self.loc_objs[self.grid.loc_of(r.obj)][r.obj] += 1

    def observe(self, r: Request) -> None:
        loc = self.grid.loc_of(r.obj)
        last = self._last_loc.get(r.user_id)
        if last is not None:
            self.loc_transitions[last][loc] += 1
        self._count(r)
        self._last_loc[r.user_id] = loc

    def predict_next_objs(self, r: Request, top_n: int = 3) -> list[int]:
        """Most popular objects at the Markov-predicted next locations."""
        loc = self.grid.loc_of(r.obj)
        trans = self.loc_transitions.get(loc)
        loc_scores: dict[int, float] = {}
        if trans:
            total = sum(trans.values())
            for nxt, c in trans.items():
                loc_scores[nxt] = (1 - self.smoothing) * c / total
        # popularity smoothing: stay in the same location
        loc_scores[loc] = loc_scores.get(loc, 0.0) + self.smoothing
        scored: dict[int, float] = {}
        for l, ls in sorted(loc_scores.items(), key=lambda kv: -kv[1])[:3]:
            pops = self.loc_objs.get(l)
            if not pops:
                continue
            total_pop = sum(pops.values())
            for obj, c in pops.most_common(top_n + 1):
                if obj == r.obj:
                    continue
                s = ls * c / total_pop
                scored[obj] = max(scored.get(obj, 0.0), s)
        ranked = sorted(scored.items(), key=lambda kv: (-kv[1], kv[0]))
        return [obj for obj, _ in ranked[:top_n]]

    def predict(self, r: Request, top_n: int = 3) -> list[tuple[int, float, float, float]]:
        """Prefetch plan [(obj, ts, tr_start, tr_end)] after request r."""
        objs = self.predict_next_objs(r, top_n)
        return [(obj, r.ts, r.tr_start, r.tr_end) for obj in objs]
