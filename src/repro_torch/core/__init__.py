"""Core: the paper's push-based data delivery framework, ported to PyTorch.

Public API re-exports (the same names as ``repro.core``).
"""
from repro_torch.core.arima import ARIMA, ARIMAOrder, predict_next_timestamp
from repro_torch.core.cache import (IntervalLRUState, IntLFUState,
                                    IntLRUState, LFUCache, LRUCache,
                                    chunk_bounds_bulk, chunks_for_range,
                                    make_cache, make_int_cache_state)
from repro_torch.core.engine import IntervalVDCSimulator, VectorVDCSimulator
from repro_torch.core.interval_store import FlatIntervalState
from repro_torch.core.classify import (classify_request_type, classify_users,
                                       fresh_duplicate_bytes, summarize_trace)
from repro_torch.core.delivery import (HPMAdapter, MD1Adapter, MD2Adapter,
                                       NoPrefetch, PeerFetchRange,
                                       coalesce_peer_fetches, make_prefetcher,
                                       select_peer_sources)
from repro_torch.core.fpgrowth import (RulePredictor, association_rules,
                                       frequent_itemsets)
from repro_torch.core.hpm import (BatchedHPMPlanner, HybridPrefetcher,
                                  PrefetchOp, build_rule_transactions)
from repro_torch.core.kmeans import kmeans
from repro_torch.core.markov import MarkovPredictor
from repro_torch.core.mining import MeshRulePredictor
from repro_torch.core.placement import PlacementEngine, select_hub
from repro_torch.core.simulator import (OutcomeAggregate, SimConfig,
                                        SimResult, VDCSimulator, run_strategy)
from repro_torch.core.streaming import StreamingEngine
from repro_torch.core.trace import (GAGE_PROFILE, OOI_PROFILE, ObjectGrid,
                                    Request, RequestArrays, RequestList,
                                    StreamingRequestSource,
                                    StreamingTraceSynthesizer, TraceGenerator,
                                    make_trace, requests_to_arrays)

__all__ = [n for n in dir() if not n.startswith("_")]
