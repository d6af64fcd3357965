"""Analytic cluster-I/O simulator: storage mountain + TeraSort phase model.

Two artifacts from the paper's evaluation are generated here:

* **Storage mountain** (Fig. 6): read throughput as a 2-D function of data
  size and skip size for the two-level store.  Two ridges — the memory
  tier (high) and the PFS tier (low) — with a slope between them once the
  data outgrows the memory-tier capacity, slopes along the skip axis once
  the skip exceeds the 1 MB app buffer (every access then pays the tier's
  request latency), and a droop at small data sizes where fixed job
  overhead dominates (Section 5.2).

* **TeraSort phase model** (Fig. 7): mapper/reducer phase times for HDFS,
  OrangeFS and the two-level store on the Palmetto calibration.  The
  mapper is ``max(I/O time, CPU time)`` — the paper observes the TLS
  mapper becomes CPU-bound ('pushed the Mapper reaching full CPU usage').

Calibration constants that are *not* in the analytic model of Section 4
are documented inline and exposed as parameters; EXPERIMENTS.md reports
model-vs-paper deltas including where the min-form model over-predicts
(e.g. 12-data-node reduce scaling).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.iomodel import hdfs_read, hdfs_write, ofs_read, ofs_write, tls_write

MB = 2**20


# ---------------------------------------------------------------------------
# Storage mountain (Fig. 6)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MountainConfig:
    mem_capacity_mb: float = 16 * 1024  # 16 GB Tachyon space (Section 5.1)
    access_mb: float = 1.0  # app reads in 1 MB requests
    app_buffer_mb: float = 1.0  # paper: 1 MB app<->Tachyon buffer
    mem_latency_s: float = 60e-6  # per-request latency, memory tier
    pfs_latency_s: float = 4e-3  # per-request latency, PFS tier (network+server)
    fixed_overhead_s: float = 0.6  # scheduling/serialization (small-data droop)


def mountain_read_mbps(
    spec: ClusterSpec,
    data_mb: float,
    skip_mb: float,
    cfg: MountainConfig = MountainConfig(),
) -> float:
    """Modeled TLS read throughput at one (data size, skip size) point.

    The access pattern reads ``access_mb`` then skips ``skip_mb``; only read
    bytes count toward throughput (the paper's 'skip size is a fragment of
    data skipped per MB access').  Blocks beyond the memory-tier capacity
    are served by the PFS tier (read mode f).
    """
    if data_mb <= 0:
        return 0.0
    f = min(1.0, cfg.mem_capacity_mb / data_mb)
    stride = cfg.access_mb + skip_mb
    n_accesses = max(1.0, data_mb / stride)
    read_mb = n_accesses * cfg.access_mb

    # A skip larger than the app buffer breaks the sequential stream: each
    # access pays the tier's request latency.  Sub-buffer skips pay a
    # proportional fraction (partial buffer reuse).
    lat_frac = min(1.0, skip_mb / cfg.app_buffer_mb) if skip_mb > 0 else 0.0

    def tier_time(frac: float, rate_mbps: float, latency_s: float) -> float:
        if frac <= 0.0:
            return 0.0
        accesses = n_accesses * frac
        return (read_mb * frac) / rate_mbps + accesses * latency_s * lat_frac

    q_pfs = ofs_read(spec, 1)  # single compute node in the Fig. 6 experiment
    t = (
        tier_time(f, spec.ram_mbps, cfg.mem_latency_s)
        + tier_time(1.0 - f, q_pfs, cfg.pfs_latency_s)
        + cfg.fixed_overhead_s
    )
    return read_mb / t


def storage_mountain(
    spec: ClusterSpec,
    data_sizes_mb: list[float] | None = None,
    skip_sizes_mb: list[float] | None = None,
    cfg: MountainConfig = MountainConfig(),
) -> dict[tuple[float, float], float]:
    """The full (data size × skip size) -> MB/s surface (Fig. 6)."""
    if data_sizes_mb is None:
        data_sizes_mb = [2.0**k * 1024 for k in range(0, 9)]  # 1 GB .. 256 GB
    if skip_sizes_mb is None:
        skip_sizes_mb = [0.0] + [2.0**k / 1024 for k in range(0, 17)]  # 0 .. 64 MB
    return {
        (d, s): mountain_read_mbps(spec, d, s, cfg)
        for d in data_sizes_mb
        for s in skip_sizes_mb
    }


# ---------------------------------------------------------------------------
# TeraSort phase model (Fig. 7)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TeraSortConfig:
    data_mb: float = 256 * 1024  # 256 GB (Section 5.3)
    cpu_sort_mbps: float = 324.0  # per-node map-side CPU rate; calibrated so the
    # TLS mapper is CPU-bound and the HDFS/TLS ratio matches the measured 5.4x
    page_cache_read_factor: float = 1.55  # data-node page cache boost on reads
    # (Section 5.3: 'OS page caches of data nodes can fully engage')
    hdfs_write_cache_factor: float = 3.0  # compute-node page cache absorbs HDFS
    # replica writes (dirty-page buffering); calibrated to the observed
    # 'Reducer ... on OrangeFS and two-level storage is slightly longer than
    # HDFS' with 2 data nodes
    tls_unidirectional_factor: float = 1.10  # TLS write slightly faster than raw
    # OFS (unidirectional access, Section 5.3)


@dataclasses.dataclass(frozen=True)
class TeraSortPhases:
    storage: str
    map_read_s: float
    map_cpu_s: float
    map_s: float  # max(read, cpu)
    reduce_write_s: float
    reduce_s: float
    total_s: float


def terasort_phases(spec: ClusterSpec, storage: str, cfg: TeraSortConfig = TeraSortConfig()) -> TeraSortPhases:
    """Phase times for one storage organization on ``spec``."""
    n = spec.n_compute
    per_node_mb = cfg.data_mb / n
    if storage == "hdfs":
        q_read = hdfs_read(spec, local=True)
        q_write = min(
            spec.nic_mbps / 2.0,
            spec.backplane_mbps / (2.0 * n),
            cfg.hdfs_write_cache_factor * spec.disk_write_mbps / 3.0,
        )
    elif storage == "ofs":
        boosted = dataclasses.replace(
            spec, data_disk_read_mbps=spec.data_disk_read_mbps * cfg.page_cache_read_factor
        )
        q_read = ofs_read(boosted)
        q_write = ofs_write(spec)
    elif storage == "tls":
        # All input resident in the memory tier (the paper's experiment):
        # mapper reads at RAM speed; reducer write-through is OFS-bound but
        # benefits from unidirectional access.
        q_read = spec.ram_mbps
        q_write = tls_write(spec) * cfg.tls_unidirectional_factor
    else:
        raise ValueError(f"unknown storage {storage!r}")

    map_read = per_node_mb / q_read
    map_cpu = per_node_mb / cfg.cpu_sort_mbps
    map_s = max(map_read, map_cpu)
    reduce_write = per_node_mb / q_write
    reduce_s = max(reduce_write, map_cpu)  # reduce-side merge is also CPU-floored
    return TeraSortPhases(
        storage=storage,
        map_read_s=map_read,
        map_cpu_s=map_cpu,
        map_s=map_s,
        reduce_write_s=reduce_write,
        reduce_s=reduce_s,
        total_s=map_s + reduce_s,
    )


def terasort_report(spec: ClusterSpec, cfg: TeraSortConfig = TeraSortConfig()) -> dict[str, TeraSortPhases]:
    return {s: terasort_phases(spec, s, cfg) for s in ("hdfs", "ofs", "tls")}


def reduce_scaling(spec: ClusterSpec, data_nodes: list[int], cfg: TeraSortConfig = TeraSortConfig()) -> dict[int, float]:
    """Reduce-phase time vs number of data nodes (paper: 1.9x @4, 4.5x @12).

    The min-form model scales writes linearly with M until the CPU floor;
    the paper measures sub-linear gains at M=12 (shuffle/stack overheads) —
    EXPERIMENTS.md reports the delta.
    """
    out = {}
    for m in data_nodes:
        out[m] = terasort_phases(spec.with_nodes(n_data=m), "tls", cfg).reduce_s
    return out


def mountain_summary(surface: dict[tuple[float, float], float]) -> dict[str, float]:
    """Headline features of the mountain for tests/benchmarks."""
    ridge_hi = max(v for (d, s), v in surface.items() if s == 0.0)
    ridge_lo = min(v for (d, s), v in surface.items() if s == 0.0)
    worst = min(surface.values())
    return {
        "tachyon_ridge_mbps": ridge_hi,
        "pfs_ridge_mbps": ridge_lo,
        "worst_mbps": worst,
        "ridge_ratio": ridge_hi / max(ridge_lo, 1e-9),
    }
