"""Analytic I/O-throughput models of the four storage organizations.

Faithful implementation of the paper's Section 4 (Eqs. 1-7, Table 2
notation).  All throughputs are per-compute-node MB/s unless the function
name says ``aggregate``.

    HDFS     Eq. 1 (read: local mu / remote min(rho, Phi/N, mu))
             Eq. 2 (write: min(rho/2, Phi/2N, mu/3)  -- 3x replication)
    OrangeFS Eq. 3 (read = write = min(rho, Phi/N, (M/N) rho, (M/N) mu'))
    Tachyon  Eq. 4 (read: local nu / remote min(rho, Phi/N, nu))
             Eq. 5 (write: nu)
    TLS      Eq. 6 (write = min(tachyon, ofs) = ofs)
             Eq. 7 (read  = 1 / (f/nu + (1-f)/q_ofs_read))

The module also provides the aggregate-throughput curves and the crossover
solver behind Fig. 5 / Section 4.5 — the source of the paper's headline
numbers (43/53/83 nodes @10 GB/s, 211/262/414 @50 GB/s, writes 259/1294,
+25% read at f=0.2, +95% at f=0.5), which `tests/test_iomodel.py` asserts
exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.cluster import ClusterSpec


# ---------------------------------------------------------------------------
# Per-node throughput models (Eqs. 1-7)
# ---------------------------------------------------------------------------


def hdfs_read(spec: ClusterSpec, n: int | None = None, local: bool = True) -> float:
    """Eq. 1 — HDFS read throughput of one compute node."""
    n = spec.n_compute if n is None else n
    if local:
        return spec.disk_read_mbps
    return min(spec.nic_mbps, spec.backplane_mbps / n, spec.disk_read_mbps)


def hdfs_write(spec: ClusterSpec, n: int | None = None) -> float:
    """Eq. 2 — HDFS write with default 3x replication.

    One local copy + two remote copies streamed through the network:
    local disk serves 3 copies cluster-wide (mu/3), the NIC carries 2
    (rho/2), the backplane carries 2N streams (Phi/2N).
    """
    n = spec.n_compute if n is None else n
    return min(spec.nic_mbps / 2.0, spec.backplane_mbps / (2.0 * n), spec.disk_write_mbps / 3.0)


def ofs_read(spec: ClusterSpec, n: int | None = None) -> float:
    """Eq. 3 — parallel-file-system read throughput of one compute node."""
    n = spec.n_compute if n is None else n
    m = spec.n_data
    return min(
        spec.nic_mbps,
        spec.backplane_mbps / n,
        (m / n) * spec.nic_mbps,
        (m / n) * spec.data_disk_read_mbps,
    )


def ofs_write(spec: ClusterSpec, n: int | None = None) -> float:
    """Eq. 3 — parallel-file-system write throughput of one compute node."""
    n = spec.n_compute if n is None else n
    m = spec.n_data
    return min(
        spec.nic_mbps,
        spec.backplane_mbps / n,
        (m / n) * spec.nic_mbps,
        (m / n) * spec.data_disk_write_mbps,
    )


def pfs_write_replicated(spec: ClusterSpec, replication: int, n: int | None = None) -> float:
    """Eq. 2-style replicated PFS write: one compute node's rate at factor r.

    Every logical byte lands ``r`` times across the data servers, so each
    shared resource carries r streams — the NIC ``rho/r``, the backplane
    ``Phi/rN``, the data disks ``(M/N)·mu'/r``.  Algebraically this is
    ``ofs_write / r`` (Eq. 2's ``mu/3`` term generalized to a knob):
    durability is priced as a 1/r throughput multiplier, which is exactly
    what ``PFSTier(replication=r)`` should measure.
    """
    if replication < 1:
        raise ValueError(f"replication must be >= 1, got {replication}")
    return ofs_write(spec, n) / replication


def pfs_read_any(
    spec: ClusterSpec, replication: int, failed: int = 0, n: int | None = None
) -> float:
    """Read-any over ``r`` rotated replicas with ``failed`` servers lost.

    A healthy read costs what a single copy costs (read-any touches one
    replica), so r does not appear in the healthy rate.  Losing servers
    shrinks the pool the surviving reads spread over (``M - failed``)
    until ``failed >= r``: rotated placement then guarantees some stripe
    unit kept *all* its replicas on the failed set — data loss, rate 0.
    """
    if replication < 1:
        raise ValueError(f"replication must be >= 1, got {replication}")
    if failed < 0 or failed > spec.n_data:
        raise ValueError(f"failed must be in [0, n_data], got {failed}")
    if failed >= replication:
        return 0.0
    n = spec.n_compute if n is None else n
    m = spec.n_data - failed
    return min(
        spec.nic_mbps,
        spec.backplane_mbps / n,
        (m / n) * spec.nic_mbps,
        (m / n) * spec.data_disk_read_mbps,
    )


def tachyon_read(spec: ClusterSpec, n: int | None = None, local: bool = True) -> float:
    """Eq. 4 — in-memory file system read throughput of one compute node."""
    n = spec.n_compute if n is None else n
    if local:
        return spec.ram_mbps
    return min(spec.nic_mbps, spec.backplane_mbps / n, spec.ram_mbps)


def tachyon_write(spec: ClusterSpec, n: int | None = None) -> float:
    """Eq. 5 — in-memory write is bounded only by memory throughput."""
    del n
    return spec.nu_write


def tls_write(spec: ClusterSpec, n: int | None = None) -> float:
    """Eq. 6 — synchronous write-through is bounded by the slower (PFS) tier."""
    return min(tachyon_write(spec, n), ofs_write(spec, n))


def tls_read(spec: ClusterSpec, f: float, n: int | None = None) -> float:
    """Eq. 7 — harmonic blend of the memory tier and the PFS tier.

    ``f`` is the fraction of the dataset resident in the memory tier.  The
    paper notes Tachyon inside the TLS never reads from *other* compute
    nodes (locality scheduling), so the fast branch is the local-RAM rate.
    """
    if not 0.0 <= f <= 1.0:
        raise ValueError(f"f must be in [0, 1], got {f}")
    if f == 1.0:
        return spec.ram_mbps
    q_ofs = ofs_read(spec, n)
    return 1.0 / (f / spec.ram_mbps + (1.0 - f) / q_ofs)


# ---------------------------------------------------------------------------
# Eq. 7 over *measured* rates — the online form the IOController runs on
# ---------------------------------------------------------------------------


def blend_read_mbps(nu: float, q: float, f: float) -> float:
    """Eq. 7 with measured tier rates instead of a ClusterSpec calibration.

    ``nu`` is the observed memory-tier read rate, ``q`` the observed PFS
    read rate (both MB/s), ``f`` the in-memory fraction.  This is the form
    ``core/sched.IOController`` evaluates online: the EWMA estimates stand
    in for the paper's Table 2 constants.
    """
    if nu <= 0 or q <= 0:
        raise ValueError("tier rates must be positive")
    if not 0.0 <= f <= 1.0:
        raise ValueError(f"f must be in [0, 1], got {f}")
    return 1.0 / (f / nu + (1.0 - f) / q)


def f_for_read_mbps(nu: float, q: float, target: float) -> float:
    """Invert Eq. 7: the in-memory fraction needed to sustain ``target`` MB/s.

    Clamped to [0, 1]: a target at or below the PFS rate needs no memory
    residency; a target at or above the memory rate needs everything hot
    (and is unreachable beyond ``nu``).  For ``nu == q`` the blend is flat,
    so any f works — 0 is returned (cheapest).
    """
    if nu <= 0 or q <= 0 or target <= 0:
        raise ValueError("rates must be positive")
    if target <= q or nu == q:
        return 0.0
    if target >= nu:
        return 1.0
    # 1/target = f/nu + (1-f)/q  =>  f = (1/q - 1/target) / (1/q - 1/nu)
    return (1.0 / q - 1.0 / target) / (1.0 / q - 1.0 / nu)


# ---------------------------------------------------------------------------
# Compression-adjusted Eq. 7 terms (DESIGN.md §13)
#
# Block compression changes the *cold* leg of the blend only: memory-tier
# bytes are always held uncompressed (hot reads stay zero-copy at ν), but
# a cold read moves ``1/ratio`` physical bytes over the PFS link and then
# pays a decode pass — two serialized stages, so the effective cold rate
# is their harmonic composition.  Substituted into Eq. 7, the same blend
# shape holds with q replaced by q_eff; solving that blend back through
# ``f_for_read_mbps`` with the *raw* q gives an "effective f" — the
# residency an uncompressed store would need to match — which is how a
# ratio-r codec buys model-visible capacity without new hardware.
# ---------------------------------------------------------------------------


def effective_cold_read_mbps(q: float, ratio: float, decode_mbps: float | None = None) -> float:
    """Logical MB/s of a cold read at compression ratio ``ratio``.

    The PFS link moves ``1/ratio`` of the logical bytes at ``q`` physical
    MB/s (so the link leg runs at ``q·ratio`` logical MB/s), serialized
    with the decode pass at ``decode_mbps`` logical MB/s.  ``ratio=1`` or
    ``decode_mbps=None`` degenerates to the uncompressed path.
    """
    if q <= 0 or ratio <= 0:
        raise ValueError("q and ratio must be positive")
    link = q * ratio
    if decode_mbps is None or decode_mbps <= 0:
        return link if ratio != 1.0 else q
    return 1.0 / (1.0 / link + 1.0 / decode_mbps)


def effective_read_mbps(
    nu: float, q: float, f: float, ratio: float = 1.0, decode_mbps: float | None = None
) -> float:
    """Eq. 7 with the cold leg running at the compression-adjusted rate."""
    q_eff = effective_cold_read_mbps(q, ratio, decode_mbps)
    return blend_read_mbps(nu, q_eff, f)


def effective_f(
    nu: float, q: float, f: float, ratio: float = 1.0, decode_mbps: float | None = None
) -> float:
    """The in-memory fraction an *uncompressed* store would need to match
    a compressed store running at physical residency ``f`` — compression's
    capacity gain expressed in the paper's own variable."""
    rate = effective_read_mbps(nu, q, f, ratio, decode_mbps)
    return f_for_read_mbps(nu, q, min(rate, nu))


def compression_wins(q: float, ratio: float, decode_mbps: float | None = None) -> bool:
    """Is a compressed cold read faster than a raw one?  True iff the
    serialized link+decode composition beats the raw PFS rate:
    ``1/(ratio·q) + 1/decode < 1/q``."""
    if ratio <= 1.0:
        return False
    return effective_cold_read_mbps(q, ratio, decode_mbps) > q


# ---------------------------------------------------------------------------
# Aggregate curves (Fig. 5) and crossover analysis (Section 4.5)
# ---------------------------------------------------------------------------


def aggregate(per_node: Callable[[ClusterSpec, int], float], spec: ClusterSpec, n: int) -> float:
    return n * per_node(spec, n)


def hdfs_aggregate_read(spec: ClusterSpec, n: int, local: bool = True) -> float:
    return n * hdfs_read(spec, n, local=local)


def hdfs_aggregate_write(spec: ClusterSpec, n: int) -> float:
    return n * hdfs_write(spec, n)


def ofs_aggregate_read(spec: ClusterSpec, n: int) -> float:
    return n * ofs_read(spec, n)


def ofs_aggregate_write(spec: ClusterSpec, n: int) -> float:
    return n * ofs_write(spec, n)


def tls_aggregate_read(spec: ClusterSpec, n: int, f: float) -> float:
    return n * tls_read(spec, f, n)


def tls_aggregate_write(spec: ClusterSpec, n: int) -> float:
    return n * tls_write(spec, n)


def crossover_n(
    grow: Callable[[int], float],
    bound: Callable[[int], float],
    n_max: int = 100_000,
) -> int:
    """Smallest N at which ``grow(N) > bound(N)`` (Fig. 5 crossover points).

    ``grow`` is the HDFS aggregate (scales ~linearly with N); ``bound`` is a
    PFS/TLS aggregate (asymptotically bounded).  Strictly-greater matches the
    paper's 'need only N nodes to have higher aggregate bandwidth' wording.
    """
    for n in range(1, n_max + 1):
        if grow(n) > bound(n):
            return n
    raise ValueError(f"no crossover below N={n_max}")


@dataclasses.dataclass(frozen=True)
class CrossoverReport:
    """All Section-4.5 headline numbers for one PFS aggregate calibration."""

    pfs_aggregate_gbps: float
    read_vs_ofs: int
    read_vs_tls_f02: int
    read_vs_tls_f05: int
    write_vs_ofs_and_tls: int
    tls_read_gain_f02: float  # asymptotic aggregate-read gain vs OFS
    tls_read_gain_f05: float


def section45_report(spec: ClusterSpec) -> CrossoverReport:
    """Reproduce the Fig. 5 / Section 4.5 analysis for ``spec``."""
    read_vs_ofs = crossover_n(
        lambda n: hdfs_aggregate_read(spec, n), lambda n: ofs_aggregate_read(spec, n)
    )
    read_f02 = crossover_n(
        lambda n: hdfs_aggregate_read(spec, n), lambda n: tls_aggregate_read(spec, n, 0.2)
    )
    read_f05 = crossover_n(
        lambda n: hdfs_aggregate_read(spec, n), lambda n: tls_aggregate_read(spec, n, 0.5)
    )
    write_x = crossover_n(
        lambda n: hdfs_aggregate_write(spec, n), lambda n: ofs_aggregate_write(spec, n)
    )
    # Asymptotic aggregate TLS read: N/(f/nu + (1-f) N / PFS_agg) -> PFS_agg/(1-f)
    # evaluated at the crossover N (the paper quotes 19.6 GB/s at f=0.5, i.e. finite N).
    base = ofs_aggregate_read(spec, read_vs_ofs)
    gain02 = tls_aggregate_read(spec, read_f02, 0.2) / base - 1.0
    gain05 = tls_aggregate_read(spec, read_f05, 0.5) / base - 1.0
    return CrossoverReport(
        pfs_aggregate_gbps=spec.pfs_aggregate_read_mbps / 1000.0,
        read_vs_ofs=read_vs_ofs,
        read_vs_tls_f02=read_f02,
        read_vs_tls_f05=read_f05,
        write_vs_ofs_and_tls=write_x,
        tls_read_gain_f02=gain02,
        tls_read_gain_f05=gain05,
    )


# ---------------------------------------------------------------------------
# Capacity & fault-tolerance cost (Section 1 / Section 7 qualitative claims)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StorageProfile:
    """Capacity and fault-tolerance cost of one storage organization."""

    name: str
    usable_capacity_mb: float
    write_amplification: float  # copies of each byte written
    network_copies: float  # copies that must traverse the network
    recovery: str


def storage_profiles(
    spec: ClusterSpec,
    compute_disk_mb: float,
    compute_ram_mb: float,
    data_node_mb: float,
) -> list[StorageProfile]:
    """Compare the four organizations on capacity + FT cost (DESIGN.md §1)."""
    return [
        StorageProfile(
            "hdfs",
            usable_capacity_mb=spec.n_compute * compute_disk_mb / 3.0,
            write_amplification=3.0,
            network_copies=2.0,
            recovery="re-replication from surviving replicas",
        ),
        StorageProfile(
            "orangefs",
            usable_capacity_mb=spec.n_data * data_node_mb,
            write_amplification=1.0,  # erasure coding inside the data node
            network_copies=1.0,
            recovery="intra-node RAID/erasure rebuild",
        ),
        StorageProfile(
            "tachyon",
            usable_capacity_mb=spec.n_compute * compute_ram_mb,
            write_amplification=1.0,
            network_copies=0.0,
            recovery="lineage recomputation (compute cost, not I/O)",
        ),
        StorageProfile(
            "two-level",
            usable_capacity_mb=spec.n_data * data_node_mb,  # PFS tier bounds capacity
            write_amplification=2.0,  # one RAM copy + one PFS copy
            network_copies=1.0,
            recovery="re-read checkpointed blocks from PFS tier (read mode f)",
        ),
    ]
