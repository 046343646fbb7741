"""Data placement: virtual groups and local data hubs (paper §IV-C2).

- Cluster past requests with K-Means (PyTorch) on (object-space, location)
  features → *virtual groups* of users with common data interests.
- Split each group geographically; for each sub-group pick the DTN that
  maximizes Eq. (2):  ``V_dh = max(θ_p·Σ_j P_ij + θ_u·U_i + θ_f·F_i)`` with
  θ_p=0.6, θ_u=0.2, θ_f=0.2 — network throughput to peers, device resource
  availability, and member request frequency.
- Hot data for the group is replicated to its hub.  Re-clustering happens
  periodically; a demoted hub keeps its already-cached data (paper: minimize
  reconfiguration cost).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.kmeans import kmeans
from repro_torch.core.trace import ObjectGrid, Request
from repro_torch.device import resolve_device

THETA_P = 0.6
THETA_U = 0.2
THETA_F = 0.2


@dataclasses.dataclass
class VirtualGroup:
    group_id: int
    user_ids: list[int]
    hub_dtn: int                       # chosen local data hub
    hot_objs: list[int]                # objects to replicate at the hub


def _request_features(reqs: Sequence[Request], grid: ObjectGrid) -> np.ndarray:
    """Feature vector per request: (instrument type, location, continent)."""
    f = np.zeros((len(reqs), 3), dtype=np.float32)
    for i, r in enumerate(reqs):
        f[i, 0] = grid.type_of(r.obj)
        f[i, 1] = grid.loc_of(r.obj)
        f[i, 2] = r.continent * grid.n_locs / 6.0   # keep scales comparable
    return f


def select_hub(
    candidate_dtns: Sequence[int],
    peer_throughput: np.ndarray,        # [n_dtn, n_dtn] Gbps
    utilization: Mapping[int, float],   # 0..1 free-resource score per DTN
    request_freq: Mapping[int, float],  # per-DTN member request rate
) -> int:
    """Eq. (2): argmax over candidate DTNs of the weighted score."""
    best, best_score = candidate_dtns[0], -np.inf
    # normalize terms across candidates so the weights are meaningful
    p_sums = {i: float(np.sum(peer_throughput[i]) - peer_throughput[i, i])
              for i in candidate_dtns}
    p_max = max(p_sums.values()) or 1.0
    f_max = max((request_freq.get(i, 0.0) for i in candidate_dtns), default=1.0) or 1.0
    for i in candidate_dtns:
        score = (
            THETA_P * p_sums[i] / p_max
            + THETA_U * utilization.get(i, 0.0)
            + THETA_F * request_freq.get(i, 0.0) / f_max
        )
        if score > best_score:
            best, best_score = i, score
    return best


class PlacementEngine:
    """Periodic virtual-group clustering + hub selection + hot-data listing."""

    def __init__(
        self,
        grid: ObjectGrid,
        n_groups: int = 4,
        hot_objs_per_group: int = 8,
        seed: int = 0,
        device=None,
    ):
        self.grid = grid
        self.device = resolve_device(device)
        self.n_groups = n_groups
        self.hot_objs_per_group = hot_objs_per_group
        self.seed = seed
        self.groups: list[VirtualGroup] = []

    def recluster(
        self,
        recent_requests: Sequence[Request],
        user_dtn: Mapping[int, int],            # user -> its access DTN
        peer_throughput: np.ndarray,            # [n_dtn, n_dtn]
        utilization: Mapping[int, float],
    ) -> list[VirtualGroup]:
        if not recent_requests:
            self.groups = []
            return self.groups
        feats = _request_features(recent_requests, self.grid)
        k = min(self.n_groups, max(1, len({r.user_id for r in recent_requests})))
        _, assign, _ = kmeans(feats, k, seed=self.seed, device=self.device)
        groups: list[VirtualGroup] = []
        for g in range(k):
            reqs_g = [r for r, a in zip(recent_requests, assign) if a == g]
            if not reqs_g:
                continue
            users = sorted({r.user_id for r in reqs_g})
            # geographic split: one sub-group per DTN present in the group;
            # hub selected among those DTNs by Eq. (2).
            dtns = sorted({user_dtn.get(u, 0) for u in users})
            freq = collections.Counter(user_dtn.get(r.user_id, 0) for r in reqs_g)
            hub = select_hub(dtns, peer_throughput, utilization,
                             {d: float(c) for d, c in freq.items()})
            obj_pop = collections.Counter(r.obj for r in reqs_g)
            hot = [o for o, _ in obj_pop.most_common(self.hot_objs_per_group)]
            groups.append(VirtualGroup(g, users, hub, hot))
        self.groups = groups
        return groups

    def hub_for_user(self, user_id: int) -> int | None:
        for g in self.groups:
            if user_id in g.user_ids:
                return g.hub_dtn
        return None
