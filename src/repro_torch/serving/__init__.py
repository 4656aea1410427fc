"""Multi-tenant QR-LoRA serving of the port: the hierarchical λ-store, paged KV block
allocator and prefix cache, continuous-batching scheduler, the engine, and
engine replicas behind the adapter-locality router."""
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import (
    MultiTenantEngine,
    TokenEvent,
    base_lambda,
    merge_tenant_params,
    reference_decode,
)
from repro_torch.serving.lam_store import (
    BASE_TENANT,
    COLD_SLOT,
    LamStore,
    MmapColdTier,
    extract_lambda,
    lam_digest,
    random_lambda,
)
from repro_torch.serving.paging import BlockAllocator, PoolExhausted, PrefixCache
from repro_torch.serving.replica import (
    EngineReplica,
    LocalTransport,
    Transport,
    build_replicas,
    payload_nbytes,
)
from repro_torch.serving.router import RoutedRequest, Router
from repro_torch.serving.scheduler import ContinuousBatchScheduler, Request
