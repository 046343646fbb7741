"""What crosses from the JAX package into the port: plain data.

The delivery path has no trained parameters — ARIMA fits from zero on every
call, FP-Growth rules are mined from the training requests and k-means seeds
come from NumPy's generator — so what a comparison carries across is data:
traces and planned prefetch streams, as NumPy arrays or tuples.  This
module builds the port's objects from them; it never imports the JAX
package.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.delivery import PlannedPrediction
from repro_torch.core.hpm import PrefetchOp
from repro_torch.core.trace import Request, RequestList


def requests_from_arrays(ts, user_id, obj, tr_start, tr_end, nbytes,
                         continent) -> RequestList:
    """A :class:`RequestList` from the seven request columns."""
    cols = (np.asarray(ts, np.float64).tolist(),
            np.asarray(user_id, np.int64).tolist(),
            np.asarray(obj, np.int64).tolist(),
            np.asarray(tr_start, np.float64).tolist(),
            np.asarray(tr_end, np.float64).tolist(),
            np.asarray(nbytes, np.int64).tolist(),
            np.asarray(continent, np.int64).tolist())
    if len({len(c) for c in cols}) != 1:
        raise ValueError("request columns differ in length")
    return RequestList(map(Request, *cols))


def prefetch_plan_from_tuples(ops: Iterable[Sequence[tuple]],
                              subscriptions: Iterable[Sequence[tuple]]
                              ) -> PlannedPrediction:
    """A whole-trace :class:`PlannedPrediction` (what an adapter's ``plan``
    returns) from per-request lists of ``(issue_ts, user_id, obj, tr_start,
    tr_end, reason)`` op tuples and per-request lists of
    ``StreamingEngine.subscribe`` argument tuples."""
    empty: tuple = ()
    plan_ops = [[PrefetchOp(float(a), int(u), int(o), float(s), float(e),
                            str(reason)) for a, u, o, s, e, reason in r]
                or empty for r in ops]
    subs = [[tuple(s) for s in r] or empty for r in subscriptions]
    return PlannedPrediction(ops=plan_ops, subscriptions=subs)
