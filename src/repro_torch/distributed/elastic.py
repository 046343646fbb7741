"""Elastic scaling and straggler mitigation.

**Elastic restart**: on a node's loss the job restarts on the surviving
ranks; ``remesh`` rebuilds the largest valid (data, model) mesh for the
new world size and the checkpoint restores into the new placements
(``CheckpointManager.restore`` distributes each full array by the
template's placements).  The global batch is kept by raising per-replica
microbatching.

**Straggler mitigation** (host-side; documented policy + hooks):

- the data pipeline is push-based (HPM prefetch), so a slow data host never
  blocks the step — batches for step N+1 are resident before step N ends;
- ``StragglerMonitor`` tracks per-step wall times; a host whose step time
  exceeds ``threshold × median`` for ``patience`` consecutive steps is
  reported for eviction (the orchestrator then restarts elastically without
  it — the same path as a failure);
- collective timeouts: launchers set ``TORCH_NCCL_ASYNC_ERROR_HANDLING=1``
  and give ``init_process_group`` a ``timeout``, so a hung peer aborts the
  communicator and becomes a clean restart instead of a deadlock.  This is
  a policy for the launcher, not a knob of this module.
"""
from __future__ import annotations

import dataclasses
import statistics

import torch.distributed as dist


def largest_mesh_shape(n_devices: int, model_parallel: int = 16,
                       want_pods: bool = False):
    """Largest (pod, data, model) shape for the available device count.

    Keeps TP fixed (model weights layouts unchanged), shrinks DP — the
    elastic policy that avoids resharding attention heads on restart.
    """
    tp = model_parallel
    while tp > 1 and n_devices % tp != 0:
        tp //= 2
    rest = n_devices // tp
    if want_pods and rest % 2 == 0 and rest >= 4:
        return (2, rest // 2, tp), ("pod", "data", "model")
    return (rest, tp), ("data", "model")


def remesh(n_devices: int | None = None, model_parallel: int = 16,
           device_type: str | None = None):
    """Build the best mesh for the CURRENT world size (elastic restart)."""
    from repro_torch.launch.mesh import make_mesh
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    shape, axes = largest_mesh_shape(n, model_parallel)
    return make_mesh(shape, axes, device_type)


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 1.5       # × median step time
    patience: int = 5
    window: int = 50

    def __post_init__(self):
        self._times: dict[int, list[float]] = {}

    def record(self, host: int, step_time: float) -> None:
        ts = self._times.setdefault(host, [])
        ts.append(step_time)
        if len(ts) > self.window:
            del ts[0]

    def stragglers(self) -> list[int]:
        """Hosts exceeding threshold×median for `patience` recent steps."""
        if not self._times:
            return []
        medians = {h: statistics.median(ts) for h, ts in self._times.items()
                   if ts}
        global_median = statistics.median(medians.values())
        out = []
        for h, ts in self._times.items():
            recent = ts[-self.patience:]
            if len(recent) >= self.patience and all(
                    t > self.threshold * global_median for t in recent):
                out.append(h)
        return sorted(out)
