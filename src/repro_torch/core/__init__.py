# Copied from src/repro/core/__init__.py (numpy-only): only module paths are renamed repro -> repro_torch.
"""RelayGR core: lifecycle caching under late-binding placement.

The paper's contribution as a composable library: sequence-aware trigger
(admission, Eqs. 1-3), affinity-aware router (placement, invariant I1),
memory-aware expander (DRAM reuse tier), HBM sliding-window cache
(invariant I2) — all orchestrated by the single event-driven
``RelayRuntime`` (repro_torch.core.runtime), which live serving
(``RelayGRService``) and the cluster simulator drive through pluggable
clocks, executors and policies.
"""
from repro_torch.serving.batching import (BatchAggregator, BatchingConfig,
                                    PendingRank, bucket_of)

from .cache import (CacheEntry, HBMCacheStore, PagedHBMStore, kv_nbytes,
                    make_hbm_store)
from .paging import DevicePagePool, PageLayout, PagePool, PagedPsi
from .clock import Clock, VirtualClock, WallClock
from .coldstore import ColdStore, ColdStoreConfig
from .costmodel import GRCostModel, HardwareModel
from .engine import InstanceConfig, RankingInstance
from .executors import (EXECUTORS, BatchedLiveExecutor, Executor,
                        LiveExecutor, SimExecutor, executor_names,
                        get_executor, register_executor)
from .expander import DRAMExpander, ExpanderConfig, SingleFlight
from .policies import (make_expander, make_router, make_trigger,
                       policy_names, register_expander, register_router,
                       register_trigger)
from .router import AffinityRouter, ConsistentHashRing
from .topology import (ClusterTopology, Host, OwnerMap, make_prefill_hosts,
                       stripe_hosts)
from .runtime import (ClusterConfig, InstanceRuntime, PipelineConfig, Record,
                      RelayConfig, RelayRuntime, as_relay_config,
                      relay_config)
from .service import RelayGRService, ServiceConfig
from .trigger import SequenceAwareTrigger, TriggerConfig
from .types import (HASH_KEY, CacheState, HitKind, RankResult, Request,
                    Stage, UserMeta)
