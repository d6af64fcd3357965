"""The two-level store of the port: a copy of the JAX package's ``repro.core``
store closure, so the port imports nothing of the JAX package.

The modules are copied as they are, with only ``repro.core`` read as
``repro_torch.core`` (a test holds each copy to its original), so both
packages write the same bytes: stripes, blocks, manifests and CRCs.  None of
them imports ``torch``; the store is host I/O on bytes and numpy.

* :mod:`repro_torch.core.cluster`  — hardware calibrations (paper Table 2).
* :mod:`repro_torch.core.iomodel`  — the analytic throughput models (Eqs. 1-7).
* :mod:`repro_torch.core.layout`   — block <-> stripe layout mapping (Fig. 3).
* :mod:`repro_torch.core.tiers`    — MemoryTier (Tachyon) / PFSTier (OrangeFS).
* :mod:`repro_torch.core.store`    — TwoLevelStore with the 3+3 I/O modes (Fig. 4).
* :mod:`repro_torch.core.arbiter`  — the elastic memory arbiter.
* :mod:`repro_torch.core.dstore`   — DistributedStore: per-host shards, leases, peers
  (its retries and circuit breakers in :mod:`repro_torch.core.resilience`).
* :mod:`repro_torch.core.simulator` — storage mountain + TeraSort phase models.
"""

from repro_torch.core.cluster import ClusterSpec, paper_average_cluster, palmetto_cluster, tpu_v5e_pod
from repro_torch.core.dstore import (
    DistributedStore,
    DStoreStats,
    GossipBoard,
    HostRegistry,
    LeaseLost,
    LeaseTable,
    NotOwner,
    PeerUnreachable,
)
from repro_torch.core.layout import BlockLayout, StripeLayout, TwoLevelLayout, paper_layout
from repro_torch.core.sched import ControllerConfig, IOController, StreamClass
from repro_torch.core.store import (
    AppendHandle,
    EvictionPolicy,
    FlushError,
    ReadMode,
    TwoLevelStore,
    WriteMode,
)
from repro_torch.core.tiers import (
    BlockNotFound,
    CapacityExceeded,
    IntegrityError,
    MemoryTier,
    PFSTier,
    crc32_chunked,
)

__all__ = [
    "AppendHandle",
    "BlockLayout",
    "BlockNotFound",
    "CapacityExceeded",
    "ClusterSpec",
    "ControllerConfig",
    "DStoreStats",
    "DistributedStore",
    "EvictionPolicy",
    "FlushError",
    "GossipBoard",
    "HostRegistry",
    "IOController",
    "LeaseLost",
    "LeaseTable",
    "NotOwner",
    "PeerUnreachable",
    "crc32_chunked",
    "IntegrityError",
    "MemoryTier",
    "PFSTier",
    "ReadMode",
    "StreamClass",
    "StripeLayout",
    "TwoLevelLayout",
    "TwoLevelStore",
    "WriteMode",
    "paper_average_cluster",
    "paper_layout",
    "palmetto_cluster",
    "tpu_v5e_pod",
]
