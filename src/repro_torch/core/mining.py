"""MD2 reference pre-fetching model — Xiong et al. (2016).

"Prefetching scheme for massive spatiotemporal data in a smart city": lay a
regional mesh over the object space, mine association rules between mesh
cells with FP-Growth (spatial correlation), and use ARIMA to predict access
times (temporal correlation).  The same strategy is applied to every request
— unlike HPM, which first classifies the request stream.
"""
from __future__ import annotations

import collections
from typing import Iterable

import numpy as np

from repro_torch.core.arima import ARIMA, predict_next_timestamp
from repro_torch.core.fpgrowth import RulePredictor
from repro_torch.core.trace import ObjectGrid, Request


class MeshRulePredictor:
    """MD2: regional-mesh association rules + ARIMA timing, for all users."""

    def __init__(
        self,
        grid: ObjectGrid,
        mesh_locs: int = 5,
        min_support: int = 10,
        min_confidence: float = 0.4,
        history: int = 60,
        device=None,
    ):
        self.grid = grid
        self.mesh_locs = mesh_locs          # locations per mesh cell
        self.min_support = min_support
        self.min_confidence = min_confidence
        self.history = history
        # md2 predicts online in BOTH engines (no batch planning): fit each
        # series as one kernel row instead of a padded bank group
        self.arima = ARIMA(n=history, bank=False, device=device)
        self._user_ts: dict[int, list[float]] = collections.defaultdict(list)
        self._user_recent_cells: dict[int, list[int]] = collections.defaultdict(list)
        self._cell_objs: dict[int, collections.Counter] = collections.defaultdict(
            collections.Counter
        )
        self.rule_predictor: RulePredictor | None = None

    def _cell(self, obj: int) -> int:
        return self.grid.loc_of(obj) // self.mesh_locs

    def fit(self, requests: Iterable[Request]) -> "MeshRulePredictor":
        sessions: dict[tuple[int, int], list[int]] = collections.defaultdict(list)
        for r in requests:
            # session = (user, hour bucket): cells co-accessed close in time
            sessions[(r.user_id, int(r.ts // 3600))].append(self._cell(r.obj))
            self._cell_objs[self._cell(r.obj)][r.obj] += 1
        txs = [list(dict.fromkeys(v)) for v in sessions.values() if len(v) >= 1]
        self.rule_predictor = RulePredictor(
            txs, self.min_support, self.min_confidence
        )
        return self

    def observe(self, r: Request) -> None:
        ts_list = self._user_ts[r.user_id]
        # keep *distinct* timestamps: multi-stream users issue several
        # requests at the same instant (one per stream)
        if not ts_list or r.ts > ts_list[-1]:
            ts_list.append(r.ts)
        if len(ts_list) > self.history + 1:
            del ts_list[0]
        cells = self._user_recent_cells[r.user_id]
        cells.append(self._cell(r.obj))
        if len(cells) > 8:
            del cells[0]
        self._cell_objs[self._cell(r.obj)][r.obj] += 1

    def predict(self, r: Request, top_n: int = 3) -> list[tuple[int, float, float, float]]:
        """Prefetch plan [(obj, prefetch_ts, tr_start, tr_end)]."""
        # temporal: ARIMA over this user's access timestamps
        ts_hist = np.array(self._user_ts.get(r.user_id, [r.ts]))
        next_ts = predict_next_timestamp(ts_hist, self.arima) if ts_hist.size >= 4 \
            else r.ts + (ts_hist[-1] - ts_hist[-2] if ts_hist.size >= 2 else 3600.0)
        # spatial: rule-predicted mesh cells -> most popular objects therein,
        # plus the triggering object's own cell (moving-window continuation).
        plan: list[tuple[int, float, float, float]] = []
        width = r.tr_end - r.tr_start
        cells: list[int] = []
        if self.rule_predictor is not None:
            cells = list(
                self.rule_predictor.predict(
                    self._user_recent_cells.get(r.user_id, [self._cell(r.obj)]),
                    top_n=top_n,
                )
            )
        candidate_objs: list[int] = [r.obj]
        for c in cells:
            pops = self._cell_objs.get(c)
            if pops:
                candidate_objs.extend(o for o, _ in pops.most_common(2))
        seen = set()
        for obj in candidate_objs:
            if obj in seen:
                continue
            seen.add(obj)
            # predicted range: window advanced to the predicted access time
            plan.append((obj, float(next_ts), float(next_ts - width), float(next_ts)))
            if len(plan) >= top_n:
                break
        return plan
