"""The port's distributed store (``repro_torch.core.dstore``, a copy of the
JAX package's) shares one root with the JAX package's: a host of each
package joins the same namespace, and leases, the peer protocol and the
stripes are the same bytes.  Then the CLIs' ``--distributed`` flags.

Hosts are in-process (threads and sockets over a shared tmp root), with
gossip published explicitly and no wait on a lease's TTL.
"""

import os
import sys

import pytest

import repro.core as jcore
import repro_torch.core as tcore

MB = 2**20
PACKAGES = {"jax_package": jcore, "port": tcore}


def shard(pkg, host_id, root):
    return pkg.DistributedStore(host_id, str(root), mem_capacity_bytes=8 * MB, block_bytes=256 * 1024,
                                n_pfs_servers=2, stripe_bytes=128 * 1024, lease_ttl_s=1.0, auto_gossip=False)


@pytest.mark.parametrize("owner", ["jax_package", "port"])
def test_hosts_of_both_packages_share_one_root(tmp_path, owner):
    """The owner (one package) writes; the other package's host reads the
    owner's hot blocks over the peer protocol, whole and by range, and is
    refused a claim on the owner's live lease."""
    reader = "port" if owner == "jax_package" else "jax_package"
    a = shard(PACKAGES[owner], 1, tmp_path / "pfs")
    b = shard(PACKAGES[reader], 2, tmp_path / "pfs")
    try:
        data = os.urandom(700 * 1024)  # 3 blocks of 256 KiB
        a.put("f", data)
        assert b.get("f") == data
        assert b.stats.peer_hot_blocks == 3 and b.stats.peer_cold_blocks == 0
        assert a.stats.peer_blocks_served == 3
        assert b.get_range("f", 100_000, 400_000) == data[100_000:500_000]
        assert b.get_range("f", 690 * 1024, 64 * 1024) == data[690 * 1024:]
        with pytest.raises(PACKAGES[reader].NotOwner):
            b.claim("f")
        lease = b.leases.read("f")
        assert lease.owner == 1 and b.leases.valid(lease)
    finally:
        b.close()
        a.close()


def test_train_cli_distributed(tmp_path, monkeypatch, capsys):
    """``--distributed --host-id 0``: reduced xlstm trains 2 steps with its
    store I/O on host 0's shard, and prints the shard's stats line."""
    from repro_torch.launch import train

    root = tmp_path / "store"
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "xlstm-125m", "--reduced", "--steps", "2", "--device", "cpu",
                                      "--store", str(root), "--distributed", "--host-id", "0", "--lease-ttl", "2"])
    train.main()
    out = capsys.readouterr().out
    assert "done: 2 steps run (0 restarts)" in out
    line = next(l for l in out.splitlines() if l.startswith("dstore[h0]: "))
    assert "leases" in line and "peer retries" in line
    assert (root / "_dstore" / "hosts" / "h0000.json").exists()
    with jcore.TwoLevelStore(str(root)) as st:  # the corpus, read by the JAX package's store
        assert any(n.startswith("corpus/") for n in st.list_files())


def test_serve_cli_distributed(tmp_path, monkeypatch, capsys):
    """``--store-root --distributed``: the KV pages persist through host 1's
    shard of the root (the JAX package's store reads them there)."""
    from repro_torch.launch import serve

    root = tmp_path / "kvstore"
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen3-8b", "--reduced", "--batch", "2", "--prompt-len", "20",
                                      "--tokens", "6", "--kv-window", "8", "--kv-page", "4", "--store-root", str(root),
                                      "--distributed", "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    line = next(l for l in out.splitlines() if l.startswith(f"store {root}"))
    assert int(line.split(": ")[1].split()[0]) > 0
    assert (root / "_dstore" / "hosts" / "h0001.json").exists()
    with jcore.TwoLevelStore(str(root)) as store:
        assert store.exists("serving/kv/prefix_0/page_000000")
