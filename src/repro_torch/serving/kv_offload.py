"""Two-level KV cache: a hot device ring + paged, incrementally staged cold
host history — the port of ``repro/serving/kv_offload.py``.

The paper's architecture one level down the hierarchy: *device memory*
plays Tachyon (small, memory-speed, holds the hot working set), *pinned
host memory* plays OrangeFS (large, slower, holds everything).  Eq. 7's
blended read applies with ``f = hot_len / total_len``; the decode path is
the paper's read mode — nearest copy first, fall through to the big tier.

Semantics (as in the JAX package):
* ``append(k, v)`` writes the newest token into the hot ring (in place on
  the device) and queues it for **batched** host write-through; pending
  tokens are flushed in one device-to-host copy once two pages have
  accumulated (or on ``flush_host()``).
* ``stage_cold()`` uploads newly completed cold pages into a device
  staging buffer — each page exactly once, since the history is
  append-only.  The buffer's capacity is a block multiple and grows by
  doubling.  With ``page <= window`` every page is complete before the
  first step that needs it; the capacity tail past ``cold_len`` is masked
  by the kernel.
* ``attend(q)`` runs the ring-aware tiered decode kernel over both tiers
  (``impl="kernel"``: the Hopper kernel on CUDA, its plain version on CPU)
  or the plain version wherever the tensors lie (``impl="plain"``).
* ``host_views()`` returns the flushed history; ``rebuild_hot_from_cold()``
  is the device-loss recovery path.

Copies: the device-to-host flush and the host-to-device staging are
synchronous copies on the current stream, so the host tier is complete
before it is read and a staged page is on the device before ``attend``
launches.  Overlapping them on a side stream is later work.

The host tier keeps the JAX package's byte layout: ``(B, KV, max_len, D)``
in the cache dtype, pages ``(B, KV, page, D)`` contiguous when cut out,
k before v.  The store-backed third level (``store=``, the shared page
registry, evict/resume, the memory arbiter) waits for the port's own copy
of the store modules.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops, ref


@dataclasses.dataclass
class TieredKVStats:
    appended: int = 0
    hot_hits_tokens: int = 0
    cold_reads_tokens: int = 0
    bytes_staged: int = 0  # host->device page uploads (each page once)
    pages_staged: int = 0
    bytes_written_through: int = 0  # device->host write-through traffic
    d2h_flushes: int = 0  # batched sync points

    def hot_fraction(self) -> float:
        """The paper's f = hot / (hot + cold) over all attends so far."""
        total = self.hot_hits_tokens + self.cold_reads_tokens
        return self.hot_hits_tokens / total if total else 1.0


class TieredKVCache:
    """Per-layer two-level KV cache for one decoding batch.

    Shapes: k, v tokens are (B, KV, D). Hot ring: (B, KV, W, D) on
    ``device``. Cold tier: a host tensor (B, KV, max_len, D) in the cache
    dtype (pinned when ``device`` is CUDA), staged to the device in
    immutable ``page``-token pages.
    """

    def __init__(
        self,
        batch: int,
        kv_heads: int,
        head_dim: int,
        window: int,
        max_len: int,
        dtype=torch.bfloat16,
        page: int | None = None,
        device="cuda",
        impl: str = "kernel",
    ):
        if window <= 0 or max_len < window:
            raise ValueError("need 0 < window <= max_len")
        page = min(window, 512) if page is None else page
        if not 0 < page <= window:
            # page <= window guarantees a cold page is complete (and
            # flushable) before the first token it holds leaves the ring.
            raise ValueError("need 0 < page <= window")
        if impl not in ("kernel", "plain"):
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        self.batch, self.kv, self.dim = batch, kv_heads, head_dim
        self.window, self.max_len, self.page = window, max_len, page
        self.dtype = dtype
        self.device = torch.device(device)
        self.impl = impl
        self.hot_k = torch.zeros((batch, kv_heads, window, head_dim), dtype=dtype, device=self.device)
        self.hot_v = torch.zeros_like(self.hot_k)
        pin = self.device.type == "cuda"
        host = (batch, kv_heads, max_len, head_dim)
        self.cold_k = torch.zeros(host, dtype=dtype, pin_memory=pin)
        self.cold_v = torch.zeros(host, dtype=dtype, pin_memory=pin)
        # Device staging buffer: paged capacity, a _block_k multiple (the
        # JAX kernel's streaming block), grown by doubling.
        self._block_k = page if page % 8 == 0 else 8 * (-(-page // 8))
        self._cap = self._block_k
        self._cold_k_dev = self._zeros_dev(self._cap)
        self._cold_v_dev = self._zeros_dev(self._cap)
        self._staged_pages = 0  # completed pages valid in the staging buffer
        self._pending_k: list[torch.Tensor] = []  # (B, KV, n, D) blocks awaiting
        self._pending_v: list[torch.Tensor] = []  # batched host write-through
        self._flushed = 0  # tokens on the host tier
        self.length = 0
        self.stats = TieredKVStats()

    def _zeros_dev(self, tokens: int) -> torch.Tensor:
        return torch.zeros((self.batch, self.kv, tokens, self.dim), dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------- append

    def append(self, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write one token (B, KV, D): hot ring slot + queued write-through."""
        self.append_block(k[:, :, None, :], v[:, :, None, :])

    def append_block(self, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write S tokens (B, KV, S, D) — the prefill bulk path."""
        s = k.shape[2]
        if self.length + s > self.max_len:
            raise ValueError("cache full")
        w = self.window
        k = k.to(self.dtype)
        v = v.to(self.dtype)
        n = min(s, w)  # only the last `w` tokens can be in the ring
        slots = torch.remainder(torch.arange(self.length + s - n, self.length + s, device=self.device), w)
        self.hot_k[:, :, slots] = k[:, :, s - n:]
        self.hot_v[:, :, slots] = v[:, :, s - n:]
        self._pending_k.append(k)
        self._pending_v.append(v)
        self.length += s
        self.stats.appended += s
        if self.length - self._flushed >= 2 * self.page:
            self.flush_host()

    # -------------------------------------------------------------- tiers

    @property
    def cold_len(self) -> int:
        """Tokens served from the cold tier: the page-aligned boundary
        covering everything already evicted from the hot ring."""
        evicted = self.length - self.window
        if evicted <= 0:
            return 0
        return -(-evicted // self.page) * self.page  # ceil to a page

    @property
    def hot_len(self) -> int:
        return self.length - self.cold_len

    @property
    def ring_newest(self) -> int:
        """Hot-ring slot of the most recent token."""
        return (self.length - 1) % self.window

    def host_views(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The written-through history [0, length) as host tensors."""
        self.flush_host()
        n = self.length
        return self.cold_k[:, :, :n, :], self.cold_v[:, :, :n, :]

    def flush_host(self) -> None:
        """Batched write-through: one device-to-host copy for all pending
        tokens, synchronous, so the host tier is complete on return."""
        if not self._pending_k:
            return
        ks = torch.cat(self._pending_k, dim=2)
        vs = torch.cat(self._pending_v, dim=2)
        self._pending_k, self._pending_v = [], []
        n = ks.shape[2]
        start = self._flushed
        if start + n != self.length:
            raise RuntimeError("pending run out of sync with the cache length")
        self.cold_k[:, :, start : start + n].copy_(ks)
        self.cold_v[:, :, start : start + n].copy_(vs)
        self._flushed = self.length
        self.stats.d2h_flushes += 1
        self.stats.bytes_written_through += 2 * ks.numel() * ks.element_size()

    def _ensure_capacity(self, tokens: int) -> None:
        if tokens <= self._cap:
            return
        cap = self._cap
        while cap < tokens:
            cap *= 2  # doubling: O(log T) reallocations over a decode
        cap = min(cap, -(-self.max_len // self._block_k) * self._block_k)
        for name in ("_cold_k_dev", "_cold_v_dev"):
            grown = self._zeros_dev(cap)
            grown[:, :, : self._cap] = getattr(self, name)
            setattr(self, name, grown)
        self._cap = cap

    def stage_cold(self) -> None:
        """Upload newly completed cold pages host-to-device — each exactly
        once (append-only history makes completed pages immutable)."""
        need = self.cold_len // self.page
        if need <= self._staged_pages:
            return
        self.flush_host()  # pages to stage are complete, so flushable now
        self._ensure_capacity(need * self.page)
        lo, hi = self._staged_pages * self.page, need * self.page
        self._cold_k_dev[:, :, lo:hi].copy_(self.cold_k[:, :, lo:hi])  # the H2D copies
        self._cold_v_dev[:, :, lo:hi].copy_(self.cold_v[:, :, lo:hi])
        self.stats.pages_staged += need - self._staged_pages
        self.stats.bytes_staged += 2 * self.batch * self.kv * (hi - lo) * self.dim * self.cold_k.element_size()
        self._staged_pages = need

    # ------------------------------------------------------------- attend

    def attend(self, q: torch.Tensor, impl: str | None = None) -> torch.Tensor:
        """Tiered decode attention for q (B, H, 1, D) over both tiers.

        The hot ring goes to the kernel as stored (decode softmax is
        permutation-invariant, so the ring rotation is position arithmetic
        inside the kernel).  ``impl`` overrides the cache's own setting:
        ``"kernel"`` goes through ``ops.tiered_decode_attention`` (the Hopper
        kernel on CUDA, its plain version on CPU), ``"plain"`` runs the plain
        version on the tensors where they lie.
        """
        if self.length == 0:
            raise ValueError("attend on an empty cache")
        impl = impl or self.impl
        self.stage_cold()
        hot_n, cold_n = self.hot_len, self.cold_len
        self.stats.hot_hits_tokens += hot_n
        self.stats.cold_reads_tokens += cold_n
        fn = ops.tiered_decode_attention if impl == "kernel" else ref.tiered_ring_attention_ref
        return fn(q.to(self.dtype).contiguous(), self.hot_k, self.hot_v, self._cold_k_dev, self._cold_v_dev,
                  hot_n, cold_n, self.ring_newest)

    # ----------------------------------------------------------- recovery

    def rebuild_hot_from_cold(self) -> None:
        """Device loss: reconstruct the hot ring from the host tier (one
        vectorised gather, dtype-preserving); the staging buffer is marked
        unstaged so the next attend re-uploads the needed pages."""
        self.flush_host()
        n = min(self.length, self.window)
        pos = torch.arange(self.length - n, self.length)
        ring_k = torch.zeros((self.batch, self.kv, self.window, self.dim), dtype=self.dtype)
        ring_v = torch.zeros_like(ring_k)
        ring_k[:, :, pos % self.window] = self.cold_k[:, :, pos]
        ring_v[:, :, pos % self.window] = self.cold_v[:, :, pos]
        self.hot_k = ring_k.to(self.device)
        self.hot_v = ring_v.to(self.device)
        self._staged_pages = 0  # staging buffer presumed lost with the device

    # --------------------------------------------------------- accounting

    def hot_device_bytes(self) -> int:
        return 2 * self.batch * self.kv * self.window * self.dim * self.hot_k.element_size()

    def staged_device_bytes(self) -> int:
        return 2 * self.batch * self.kv * self._cap * self.dim * self.hot_k.element_size()

    def device_bytes(self) -> int:
        return self.hot_device_bytes() + self.staged_device_bytes()

    def host_bytes(self) -> int:
        return 2 * self.batch * self.kv * self.max_len * self.dim * self.cold_k.element_size()
