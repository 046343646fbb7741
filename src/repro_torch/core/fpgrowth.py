"""FP-Growth frequent-pattern mining and association rules (paper §IV-A3).

Classic Han et al. (2000) algorithm: build a compact FP-tree from the
transaction database, then recursively mine conditional pattern bases.
Association rules ``antecedent -> consequent`` are derived from the frequent
itemsets and filtered by confidence.

Used by the HPM's association-rule predictor for human/unclassified requests
(support=30, confidence=0.5 in the paper; both configurable here) and by the
MD2 baseline.  This is host-side control-plane logic (pure Python) — it runs
beside the data path, like the DTN prediction engine in the paper.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Hashable, Iterable, Sequence

Item = Hashable
Transaction = Sequence[Item]


class _Node:
    __slots__ = ("item", "count", "parent", "children", "link")

    def __init__(self, item: Item | None, parent: "_Node | None"):
        self.item = item
        self.count = 0
        self.parent = parent
        self.children: dict[Item, _Node] = {}
        self.link: _Node | None = None


@dataclasses.dataclass(frozen=True)
class Rule:
    antecedent: frozenset
    consequent: frozenset
    support: int
    confidence: float


class FPTree:
    def __init__(self, transactions: Iterable[Transaction], min_support: int):
        self.min_support = min_support
        counts = collections.Counter()
        txs = []
        for t in transactions:
            t = list(dict.fromkeys(t))  # dedupe, keep order
            txs.append(t)
            counts.update(t)
        self.item_counts = {i: c for i, c in counts.items() if c >= min_support}
        # global frequency order (ties broken by repr for determinism)
        self.order = {
            i: r
            for r, (i, _) in enumerate(
                sorted(self.item_counts.items(), key=lambda kv: (-kv[1], repr(kv[0])))
            )
        }
        self.root = _Node(None, None)
        self.headers: dict[Item, _Node] = {}
        for t in txs:
            ft = sorted(
                (i for i in t if i in self.item_counts), key=self.order.__getitem__
            )
            self._insert(ft, 1)

    def _insert(self, items: Sequence[Item], count: int) -> None:
        node = self.root
        for item in items:
            child = node.children.get(item)
            if child is None:
                child = _Node(item, node)
                node.children[item] = child
                # header link
                if item in self.headers:
                    last = self.headers[item]
                    while last.link is not None:
                        last = last.link
                    last.link = child
                else:
                    self.headers[item] = child
            child.count += count
            node = child

    def _prefix_paths(self, item: Item) -> list[tuple[list[Item], int]]:
        paths = []
        node = self.headers.get(item)
        while node is not None:
            path = []
            p = node.parent
            while p is not None and p.item is not None:
                path.append(p.item)
                p = p.parent
            if path:
                paths.append((list(reversed(path)), node.count))
            node = node.link
        return paths


def _mine(tree: FPTree, suffix: frozenset, out: dict[frozenset, int]) -> None:
    # items in increasing frequency order (bottom-up)
    for item in sorted(tree.item_counts, key=tree.order.__getitem__, reverse=True):
        support = tree.item_counts[item]
        itemset = suffix | {item}
        out[frozenset(itemset)] = support
        paths = tree._prefix_paths(item)
        if not paths:
            continue
        # conditional transaction DB
        cond_txs: list[list[Item]] = []
        for path, count in paths:
            cond_txs.extend([path] * count)
        cond_tree = FPTree(cond_txs, tree.min_support)
        if cond_tree.item_counts:
            _mine(cond_tree, frozenset(itemset), out)


def frequent_itemsets(
    transactions: Iterable[Transaction], min_support: int
) -> dict[frozenset, int]:
    """All itemsets with support >= min_support, {itemset: support}."""
    tree = FPTree(transactions, min_support)
    out: dict[frozenset, int] = {}
    _mine(tree, frozenset(), out)
    return out


def association_rules(
    itemsets: dict[frozenset, int], min_confidence: float
) -> list[Rule]:
    """Rules A -> B (A, B disjoint, A ∪ B frequent) with
    conf = support(A∪B)/support(A) >= min_confidence."""
    rules: list[Rule] = []
    for itemset, sup in itemsets.items():
        if len(itemset) < 2:
            continue
        items = sorted(itemset, key=repr)
        for r in range(1, len(items)):
            for ante in itertools.combinations(items, r):
                a = frozenset(ante)
                sup_a = itemsets.get(a)
                if not sup_a:
                    continue
                conf = sup / sup_a
                if conf >= min_confidence:
                    rules.append(Rule(a, frozenset(itemset - a), sup, conf))
    rules.sort(key=lambda r: (-r.confidence, -r.support, repr(r.antecedent)))
    return rules


class RulePredictor:
    """Predict likely next items given recently seen items, using mined rules.

    The paper pre-fetches the top-n (n=3) predicted objects ranked by rule
    confidence.
    """

    def __init__(
        self,
        transactions: Iterable[Transaction],
        min_support: int = 30,
        min_confidence: float = 0.5,
    ):
        self.itemsets = frequent_itemsets(transactions, min_support)
        self.rules = association_rules(self.itemsets, min_confidence)
        # index rules by antecedent for lookup
        self._by_ante: dict[frozenset, list[Rule]] = collections.defaultdict(list)
        for r in self.rules:
            self._by_ante[r.antecedent].append(r)
        # items that appear in ANY antecedent: candidate combinations outside
        # this universe cannot match a rule, so predict() skips them
        self._ante_items = {i for a in self._by_ante for i in a}

    def predict(self, recent: Iterable[Item], top_n: int = 3) -> list[Item]:
        recent_set = frozenset(recent)
        cand = sorted(recent_set & self._ante_items, key=repr)
        scored: dict[Item, float] = {}
        for sz in range(min(3, len(cand)), 0, -1):
            for ante in itertools.combinations(cand, sz):
                for rule in self._by_ante.get(frozenset(ante), ()):
                    for item in rule.consequent:
                        if item in recent_set:
                            continue
                        scored[item] = max(scored.get(item, 0.0), rule.confidence)
        ranked = sorted(scored.items(), key=lambda kv: (-kv[1], repr(kv[0])))
        return [i for i, _ in ranked[:top_n]]
