"""Data streaming mechanism for real-time requests (paper §IV-B).

Real-time consumers poll the observatory at high frequency (e.g. 1/min) for
tiny increments.  The streaming engine converts this pull storm into push:

- the first real-time request for a stream registers a *subscription* at the
  server-side DTN;
- the server polls/receives the source **once** per publication interval and
  pushes every new chunk to all subscribed client DTNs (identical concurrent
  requests are combined; redundant requests filtered);
- subsequent user polls are served from the local DTN cache.

The engine therefore reduces origin request traffic for S subscribers from
S·f to f requests/s per stream.
"""
from __future__ import annotations

import collections
import dataclasses

from repro_torch.core.trace import Request


@dataclasses.dataclass(frozen=True)
class StreamPush:
    """A push of new data for a stream to a set of client DTNs."""

    ts: float
    obj: int
    tr_start: float
    tr_end: float
    dtns: tuple[int, ...]


@dataclasses.dataclass
class _Subscription:
    obj: int
    period: float
    subscribers: dict[int, set[int]] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(set)
    )  # dtn -> user ids
    last_push_end: float = 0.0


class StreamingEngine:
    """Server-side subscription registry + push scheduler."""

    def __init__(self):
        self.subs: dict[int, _Subscription] = {}     # obj -> subscription
        self.pushes_emitted = 0
        self.requests_absorbed = 0
        # earliest time any stream could be due; lets the per-request poll in
        # the simulators return without scanning every subscription
        self._next_due = float("inf")

    def subscribe(self, user_id: int, dtn: int, obj: int, period: float,
                  now: float) -> None:
        sub = self.subs.get(obj)
        if sub is None:
            sub = _Subscription(obj=obj, period=period, last_push_end=now)
            self.subs[obj] = sub
        else:
            sub.period = min(sub.period, period)   # fastest subscriber wins
        sub.subscribers[dtn].add(user_id)
        self._next_due = min(self._next_due, sub.last_push_end + sub.period)

    def unsubscribe(self, user_id: int, obj: int) -> None:
        sub = self.subs.get(obj)
        if not sub:
            return
        for users in sub.subscribers.values():
            users.discard(user_id)

    def is_subscribed(self, user_id: int, obj: int) -> bool:
        sub = self.subs.get(obj)
        return bool(sub) and any(user_id in u for u in sub.subscribers.values())

    def absorb(self, r: Request) -> bool:
        """True if this request is satisfied by an active subscription (the
        origin never sees it)."""
        if self.is_subscribed(r.user_id, r.obj):
            self.requests_absorbed += 1
            return True
        return False

    def pushes_until(self, now: float) -> list[StreamPush]:
        """Emit pushes for every stream whose publication interval elapsed.
        One push serves *all* subscribed DTNs (request combining)."""
        if now < self._next_due:
            # nothing can be due yet — the common case for every request
            # event between publication intervals
            return []
        out: list[StreamPush] = []
        nxt = float("inf")
        for sub in self.subs.values():
            dtns = tuple(sorted(d for d, u in sub.subscribers.items() if u))
            if not dtns:
                continue
            while sub.last_push_end + sub.period <= now:
                start = sub.last_push_end
                end = start + sub.period
                out.append(StreamPush(end, sub.obj, start, end, dtns))
                sub.last_push_end = end
                self.pushes_emitted += 1
            nxt = min(nxt, sub.last_push_end + sub.period)
        self._next_due = nxt
        return out
