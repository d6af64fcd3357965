"""Cluster hardware descriptions used by the paper's I/O throughput models.

The paper (Table 2) parameterizes a cluster by:

    N   number of compute nodes
    M   number of data nodes
    Phi bandwidth of switch backplane / bisection bandwidth (MB/s)
    rho bandwidth of the NIC on every node (MB/s)
    mu  I/O throughput of the local hard drive on *compute* nodes (MB/s)
    mu' I/O throughput of the local hard drive (RAID) on *data* nodes (MB/s)
    nu  I/O throughput of local memory (MB/s)

Two calibrations ship with the framework:

* ``paper_average_cluster`` — the constants the paper uses for Fig. 5
  (Section 4.5: rho = 1170 MB/s, mu_read = 237, mu_write = 116, nu = 6267,
  PFS aggregate throughput of 10 GB/s or 50 GB/s).
* ``tpu_v5e_pod`` — the same equations recalibrated for the TPU-v5e target
  fabric this framework is designed for (hardware-adaptation note in
  DESIGN.md §2): "NIC" -> per-host DCN injection, "backplane" -> DCN
  bisection between pods, "RAM tier" -> host DRAM bandwidth available to the
  input pipeline, "data-node disk" -> PFS/object-store server throughput.
"""

from __future__ import annotations

import dataclasses
import math

MB = 1.0  # All model rates are MB/s; sizes are MB.


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Hardware calibration for the analytic I/O models (paper Table 2)."""

    name: str
    n_compute: int  # N
    n_data: int  # M
    backplane_mbps: float  # Phi
    nic_mbps: float  # rho
    disk_read_mbps: float  # mu (compute-node local disk, read)
    disk_write_mbps: float  # mu (compute-node local disk, write)
    data_disk_read_mbps: float  # mu' (data-node storage, read)
    data_disk_write_mbps: float  # mu' (data-node storage, write)
    ram_mbps: float  # nu
    ram_write_mbps: float | None = None  # defaults to nu if None

    def __post_init__(self) -> None:
        if self.n_compute <= 0 or self.n_data <= 0:
            raise ValueError("node counts must be positive")
        for f in (
            "backplane_mbps",
            "nic_mbps",
            "disk_read_mbps",
            "disk_write_mbps",
            "data_disk_read_mbps",
            "data_disk_write_mbps",
            "ram_mbps",
        ):
            if getattr(self, f) <= 0:
                raise ValueError(f"{f} must be positive")

    @property
    def nu_write(self) -> float:
        return self.ram_write_mbps if self.ram_write_mbps is not None else self.ram_mbps

    @property
    def pfs_aggregate_read_mbps(self) -> float:
        """Aggregate PFS read throughput: M data nodes, each min(NIC, disk)."""
        return self.n_data * min(self.nic_mbps, self.data_disk_read_mbps)

    @property
    def pfs_aggregate_write_mbps(self) -> float:
        return self.n_data * min(self.nic_mbps, self.data_disk_write_mbps)

    def with_nodes(self, n_compute: int | None = None, n_data: int | None = None) -> "ClusterSpec":
        spec = dataclasses.replace(
            self,
            n_compute=self.n_compute if n_compute is None else n_compute,
            n_data=self.n_data if n_data is None else n_data,
        )
        # dataclasses.replace() goes through __init__ (and so __post_init__)
        # today, but the derived spec's validity is this method's contract —
        # keep the check explicit so a future unfrozen/slots refactor that
        # mutates in place cannot silently hand out a spec with zero nodes.
        spec.__post_init__()
        return spec

    def per_host_spec(self) -> "ClusterSpec":
        """One host shard's view of this cluster: a single compute node over
        its fair share of the data servers (at least one).

        This is the calibration a per-host memory shard of the distributed
        two-level store plans against (DESIGN.md §11): node count scales the
        aggregate model (Eqs. 1-7) by N, while each shard's admission /
        readahead decisions see only its own slice of the PFS pool.
        """
        share = max(1, round(self.n_data / self.n_compute))
        return self.with_nodes(n_compute=1, n_data=share)


def paper_average_cluster(
    n_compute: int = 16,
    pfs_aggregate_mbps: float = 10_000.0,
) -> ClusterSpec:
    """The averaged national-HPC calibration the paper uses for Fig. 5.

    Section 4.5: network 1170 MB/s per node; local disk read 237 MB/s and
    write 116 MB/s; local memory 6267 MB/s. The PFS is characterized only by
    aggregate bandwidth (10 GB/s or 50 GB/s); we express that as M data
    nodes whose min(NIC, disk) sums to the aggregate.  The backplane is
    'much higher than the network interface bandwidth' (Section 5.1) — we
    model it as effectively unconstrained (6.4 Tbps Brocade MLXe-32).
    """
    # Express the aggregate as M synthetic data nodes of `data_rate` each,
    # data_rate <= NIC so the per-node NIC is not the binding term.
    data_rate = 1_000.0
    m = max(1, int(round(pfs_aggregate_mbps / data_rate)))
    return ClusterSpec(
        name=f"paper-avg-{int(pfs_aggregate_mbps/1000)}GBs",
        n_compute=n_compute,
        n_data=m,
        backplane_mbps=6.4e6 / 8.0 * 1000.0 / 1000.0,  # 6.4 Tbps = 800,000 MB/s
        nic_mbps=1_170.0,
        disk_read_mbps=237.0,
        disk_write_mbps=116.0,
        data_disk_read_mbps=data_rate,
        data_disk_write_mbps=data_rate,
        ram_mbps=6_267.0,
    )


def palmetto_cluster(n_compute: int = 16, n_data: int = 2) -> ClusterSpec:
    """The experimental testbed of Section 5 (Table 3 + measured rates).

    Concurrent per-compute-node local disk ~60 MB/s; data-node RAID write
    ~200 MB/s, read ~400 MB/s; 10 GbE NICs (~1170 MB/s measured by iperf).
    """
    return ClusterSpec(
        name="palmetto",
        n_compute=n_compute,
        n_data=n_data,
        backplane_mbps=6.4e6 / 8.0,  # 6.4 Tbps backplane
        nic_mbps=1_170.0,
        disk_read_mbps=60.0,
        disk_write_mbps=60.0,
        data_disk_read_mbps=400.0,
        data_disk_write_mbps=200.0,
        ram_mbps=6_267.0,
    )


def tpu_v5e_pod(n_hosts: int = 64, n_storage: int = 16) -> ClusterSpec:
    """TPU-v5e-pod calibration (hardware adaptation, DESIGN.md §2/§6).

    Per-host DCN injection ~ 25 GB/s (200 Gbps NIC), storage servers
    ~ 5 GB/s each (NVMe-backed PFS), host DRAM stream ~ 50 GB/s usable by
    the input pipeline, DCN bisection sized at half injection aggregate.
    Units are MB/s to match the paper's equations.
    """
    return ClusterSpec(
        name="tpu-v5e-pod",
        n_compute=n_hosts,
        n_data=n_storage,
        backplane_mbps=n_hosts * 25_000.0 / 2.0,
        nic_mbps=25_000.0,
        disk_read_mbps=3_000.0,  # host-local NVMe scratch
        disk_write_mbps=1_500.0,
        data_disk_read_mbps=5_000.0,
        data_disk_write_mbps=5_000.0,
        ram_mbps=50_000.0,
    )


# TPU v5e single-chip roofline constants (used by benchmarks/roofline.py).
TPU_V5E_PEAK_BF16_FLOPS = 197e12  # FLOP/s per chip
TPU_V5E_HBM_BW = 819e9  # bytes/s per chip
TPU_V5E_ICI_BW = 50e9  # bytes/s per link


def human_mbps(x: float) -> str:
    if x >= 1000.0:
        return f"{x/1000.0:.2f} GB/s"
    if not math.isfinite(x):
        return "inf"
    return f"{x:.1f} MB/s"
