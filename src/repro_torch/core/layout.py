"""Data-layout mapping between the two tiers (paper Section 3.1, Fig. 3).

The fast tier stores a file as fixed-size logical **blocks** (Tachyon's
unit of caching / data-parallel granularity; 512 MB in the paper's
experiments).  The persistent tier stores a file as **stripes** distributed
round-robin across the M data-node servers (64 MB stripe unit in the
paper's experiments; disk-level RAID inside each server is below our
granularity, cf. DESIGN.md §6).

This module implements the bidirectional byte-range mapping and the
load-balance analysis that the paper identifies as the tuning surface
('This mapping ... can impact the load balance among data nodes and the
aggregate I/O throughputs').
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict


@dataclasses.dataclass(frozen=True)
class Block:
    """One fast-tier logical block of a file."""

    index: int
    offset: int  # byte offset in the logical file
    length: int

    @property
    def end(self) -> int:
        return self.offset + self.length


@dataclasses.dataclass(frozen=True)
class StripeSegment:
    """A contiguous run of bytes on one PFS server's local file.

    ``server``        index of the data-node server in [0, n_servers)
    ``server_offset`` byte offset inside the server-local file
    ``file_offset``   byte offset in the logical file
    ``length``        run length in bytes
    """

    server: int
    server_offset: int
    file_offset: int
    length: int


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """Fixed-size logical blocking (fast tier)."""

    block_size: int

    def __post_init__(self) -> None:
        if self.block_size <= 0:
            raise ValueError("block_size must be positive")

    def n_blocks(self, file_size: int) -> int:
        return max(0, -(-file_size // self.block_size))

    def blocks(self, file_size: int) -> list[Block]:
        out = []
        for i in range(self.n_blocks(file_size)):
            off = i * self.block_size
            out.append(Block(i, off, min(self.block_size, file_size - off)))
        return out

    def block_of(self, file_offset: int) -> int:
        return file_offset // self.block_size


@dataclasses.dataclass(frozen=True)
class StripeLayout:
    """Round-robin striping across PFS servers (OrangeFS simple-stripe)."""

    stripe_size: int
    n_servers: int

    def __post_init__(self) -> None:
        if self.stripe_size <= 0 or self.n_servers <= 0:
            raise ValueError("stripe_size and n_servers must be positive")

    @property
    def full_stripe(self) -> int:
        """Bytes in one full round across all servers."""
        return self.stripe_size * self.n_servers

    def map_range(self, file_offset: int, length: int) -> list[StripeSegment]:
        """Map a logical byte range to the server-local segments covering it.

        Segments are emitted in logical-file order; consecutive segments on
        the same server are not merged (they are separate stripe units).
        """
        if file_offset < 0 or length < 0:
            raise ValueError("offset/length must be non-negative")
        segs: list[StripeSegment] = []
        pos = file_offset
        end = file_offset + length
        while pos < end:
            stripe_idx = pos // self.stripe_size  # global stripe-unit index
            server = stripe_idx % self.n_servers
            round_idx = stripe_idx // self.n_servers
            within = pos % self.stripe_size
            run = min(self.stripe_size - within, end - pos)
            segs.append(
                StripeSegment(
                    server=server,
                    server_offset=round_idx * self.stripe_size + within,
                    file_offset=pos,
                    length=run,
                )
            )
            pos += run
        return segs

    def server_file_size(self, file_size: int, server: int) -> int:
        """Total bytes the server-local file holds for a logical file."""
        if file_size <= 0:
            return 0
        full_units, rem = divmod(file_size, self.stripe_size)
        size = (full_units // self.n_servers) * self.stripe_size
        tail_units = full_units % self.n_servers
        if server < tail_units:
            size += self.stripe_size
        elif server == tail_units and rem:
            size += rem
        return size


@dataclasses.dataclass(frozen=True)
class TwoLevelLayout:
    """The paper's block↔stripe mapping (Fig. 3)."""

    blocks: BlockLayout
    stripes: StripeLayout

    def block_to_segments(self, block: Block) -> list[StripeSegment]:
        return self.stripes.map_range(block.offset, block.length)

    def file_plan(self, file_size: int) -> dict[int, list[StripeSegment]]:
        """Per-block stripe plan for a whole file."""
        return {b.index: self.block_to_segments(b) for b in self.blocks.blocks(file_size)}

    def server_load(self, block_indices: list[int], file_size: int) -> dict[int, int]:
        """Bytes each PFS server must serve for a set of block reads."""
        load: dict[int, int] = defaultdict(int)
        blocks = self.blocks.blocks(file_size)
        for i in block_indices:
            for seg in self.block_to_segments(blocks[i]):
                load[seg.server] += seg.length
        for s in range(self.stripes.n_servers):
            load.setdefault(s, 0)
        return dict(load)

    def imbalance(self, block_indices: list[int], file_size: int) -> float:
        """max/mean server load — 1.0 is perfectly balanced."""
        load = self.server_load(block_indices, file_size)
        vals = list(load.values())
        mean = sum(vals) / len(vals)
        if mean == 0:
            return 1.0
        return max(vals) / mean


def paper_layout(n_servers: int = 2) -> TwoLevelLayout:
    """Section 5.1 experimental layout: 512 MB blocks, 64 MB stripes.

    'The Tachyon block size was set to 512 MB. Each block was striped into
    8 chunks with strip size of 64 MB ... evenly distributed across 2 data
    nodes with round-robin fashion.'
    """
    return TwoLevelLayout(
        blocks=BlockLayout(block_size=512 * 2**20),
        stripes=StripeLayout(stripe_size=64 * 2**20, n_servers=n_servers),
    )
