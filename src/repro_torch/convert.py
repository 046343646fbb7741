"""What crosses from the JAX package into the port: plain data.

The delivery path has no trained parameters — ARIMA fits from zero on every
call, FP-Growth rules are mined from the training requests and k-means seeds
come from NumPy's generator — so what a comparison carries across is data:
traces and planned prefetch streams, as NumPy arrays or tuples.  The LM
substrate's and the GRU predictor's random initialisations cannot be
reproduced in torch, so their parameters cross as NumPy arrays too.  This module builds the port's
objects from them; it never imports the JAX package.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.delivery import PlannedPrediction
from repro_torch.core.hpm import PrefetchOp
from repro_torch.core.trace import Request, RequestList
from repro_torch.device import resolve_device
from repro_torch.kernels.gru_fit import LAYOUT
from repro_torch.models.transformer import ModelConfig


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


# parameters the JAX package keeps in float32 whatever the model's dtype
_FLOAT32_LEAVES = frozenset({"norm1", "norm2", "final_norm", "norm",
                             "A_log", "dt_bias", "D", "norm_scale",
                             "router"})


def params_from_numpy(tree, cfg: ModelConfig, device=None):
    """The port's parameters from ``repro``'s ``init_params`` tree given as
    nested dicts and lists of NumPy arrays.

    ``repro`` stacks the unit parameters on a leading axis (one entry per
    pattern layer, each of shape ``[n_units, ...]``); the port keeps a list
    of units; the MTP subtree (``mtp``) is not stacked.  Float arrays become
    ``cfg.dtype`` (float32 for norm scales, the MoE router and the SSM's
    ``A_log``/``dt_bias``/``D``, as ``repro`` keeps them).
    JAX's bfloat16 arrays do not cross as NumPy, so pass float32 arrays:
    casting those to bfloat16 is exact for bfloat16 values."""
    device = resolve_device(device)

    def leaf(name, a):
        dtype = torch.float32 if name in _FLOAT32_LEAVES else cfg.dtype
        return torch.from_numpy(np.array(a, np.float32)).to(device, dtype)

    def convert(node, name=None):
        if isinstance(node, dict):
            return {k: convert(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v, name) for v in node]
        return leaf(name, node)

    def unit(node, u):
        if isinstance(node, dict):
            return {k: unit(v, u) for k, v in node.items()}
        return np.asarray(node)[u]

    params = {k: convert(v, k) for k, v in tree.items()
              if k not in ("prelude", "units")}
    params["prelude"] = convert(list(tree.get("prelude", [])))
    params["units"] = [convert([unit(layer, u) for layer in tree["units"]])
                       for u in range(cfg.n_units)]
    return params


def gru_params_from_numpy(tree, device=None) -> torch.Tensor:
    """The GRU predictor's flat float32 parameters (``[N_PARAMS]`` in the
    order of :data:`repro_torch.kernels.gru_fit.LAYOUT`) from ``repro``'s
    ``core/rnn_predictor.py::_init_params`` dict given as NumPy arrays."""
    device = resolve_device(device)
    flat = np.concatenate([np.asarray(tree[name], np.float32).reshape(-1)
                           for name, _ in LAYOUT])
    return torch.from_numpy(flat).to(device)
