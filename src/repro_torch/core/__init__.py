# The paper's primary contribution: expected-latency-aware KV cache
# management (AsymCache) — frequency function, O(log n) evictor,
# cost model, block manager, online lifespan adaptation.
from repro_torch.core.block_manager import (
    Block,
    BlockManager,
    MatchResult,
    chain_hash,
    hash_seed,
)
from repro_torch.core.cost_model import (
    H20,
    TPU_V5E,
    CostModel,
    Hardware,
    analytic_cost_model,
    fit,
    mixed_window_cost_model,
)
from repro_torch.core.evictor import (
    POLICIES,
    AsymCacheEvictor,
    AsymCacheLinearEvictor,
    EvictableMeta,
    EvictionPolicy,
    LRUEvictor,
    MaxScoreEvictor,
    PensieveEvictor,
    make_policy,
)
from repro_torch.core.faults import FAULT_SITES, FaultPlan, InjectedFault
from repro_torch.core.freq import EwmaCounter, FreqParams
from repro_torch.core.lifespan import LifespanTracker, ResumePredictor
from repro_torch.core.offload import (
    HostEntry,
    HostHalf,
    OffloadConfig,
    dequantize_half,
    half_checksum,
    quantize_half,
    snap_to_grid_np,
    verify_half,
)
from repro_torch.core.prefix_store import (
    BatchReport,
    PrefixStore,
    PrefixStoreConfig,
    content_key,
    content_key_chain,
    model_fingerprint,
)
from repro_torch.core.prefix_trie import PrefixMatch, PrefixTrie
from repro_torch.core.treap import Treap

__all__ = [
    "Block", "BlockManager", "MatchResult", "chain_hash", "hash_seed",
    "PrefixMatch", "PrefixTrie",
    "CostModel", "Hardware", "H20", "TPU_V5E", "analytic_cost_model",
    "fit", "mixed_window_cost_model",
    "POLICIES", "AsymCacheEvictor", "AsymCacheLinearEvictor",
    "EvictableMeta", "EvictionPolicy", "LRUEvictor", "MaxScoreEvictor",
    "PensieveEvictor", "make_policy",
    "EwmaCounter", "FreqParams", "LifespanTracker", "ResumePredictor",
    "Treap",
    "HostEntry", "HostHalf", "OffloadConfig",
    "dequantize_half", "half_checksum", "quantize_half",
    "snap_to_grid_np", "verify_half",
    "FAULT_SITES", "FaultPlan", "InjectedFault",
    "BatchReport", "PrefixStore", "PrefixStoreConfig",
    "content_key", "content_key_chain", "model_fingerprint",
]
