"""Multi-tenant QR-LoRA serving of the port: λ-store, paged KV block
allocator and prefix cache, continuous-batching scheduler and the engine."""
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import (
    MultiTenantEngine,
    base_lambda,
    merge_tenant_params,
    reference_decode,
)
from repro_torch.serving.lam_store import (
    BASE_TENANT,
    LamStore,
    extract_lambda,
    lam_digest,
    random_lambda,
)
from repro_torch.serving.paging import BlockAllocator, PoolExhausted, PrefixCache
from repro_torch.serving.scheduler import ContinuousBatchScheduler, Request
