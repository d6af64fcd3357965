"""Two-level decode attention on Hopper — the launcher of
``csrc/tiered_decode.cu``, the port of ``repro/kernels/tiered_decode.py``.

The paper's tiered read at the device level: the hot tier is the last
``W`` tokens' KV in a ring, the cold tier the paged history staged from
host memory; one fp32 online softmax merges both.  The valid keys are
numbered cold positions first, then the valid ring slots oldest first, and
split into ``n_split`` contiguous ranges: pass 1 folds each range for a
tile of the query heads of its kv head, pass 2 merges the partial
softmaxes (see the source note for the design).  Lengths are plain launch
arguments, so one built kernel serves every decode step.

The kernel takes every group ``G = H / KV`` in ``GROUPS`` (1 to 16, which
covers the GQA layers of every config of the repository) and every head
dim in ``HEAD_DIMS`` (16 to 256), in fp32 and bf16; ``head_tile`` cuts the
G heads into tiles of a built width.  Any other shape raises.

``head_tile``, ``plan_splits`` and ``split_ranges`` choose the tiles and
ranges (plain Python, tested on the CPU); ``split_merge_plain`` is the
kernel's split-then-merge arithmetic in plain PyTorch.  The plain version
of the op is ``ref.tiered_ring_attention_ref``; ``ops`` chooses.
"""

from __future__ import annotations

import math

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
GROUPS = tuple(range(1, 17))
HEAD_TILES = (1, 2, 4, 6, 8)  # the head-tile widths GT the kernel is built for
MIN_KEYS_PER_SPLIT = 64


def head_tile(group: int) -> tuple[int, int]:
    """(GT, tiles): the query heads a pass-1 block takes and the number of
    tiles for ``group`` query heads per kv head.  As few tiles as the widest
    build allows, each as narrow as the built widths allow; the last tile's
    heads past ``group`` are padding (at most one for a group up to 8)."""
    tiles = -(-group // HEAD_TILES[-1])
    need = -(-group // tiles)
    gt = next(t for t in HEAD_TILES if t >= need)
    return gt, -(-group // gt)


def blocks_per_sm(group: int) -> int:
    """Pass-1 blocks resident on one SM: the kernel's launch bounds ask for
    two up to GT = 4 heads a tile (at most 128 registers a thread, and at
    most 33 KB of shared memory a block), one above."""
    return 2 if head_tile(group)[0] <= 4 else 1


def plan_splits(n_keys: int, rows: int, sms: int, per_sm: int = 2) -> int:
    """Blocks per (b, kv head) row: as many as fit one wave of ``per_sm``
    blocks on each of ``sms`` SMs (a second, partial wave would double the
    time of the last blocks), with at least ``MIN_KEYS_PER_SPLIT`` keys a
    split, and at least one split (also when there is no key)."""
    return max(1, min(per_sm * sms // max(rows, 1), n_keys // MIN_KEYS_PER_SPLIT))


def split_ranges(n_keys: int, n_split: int) -> list[tuple[int, int]]:
    """The key range [k0, k1) of each split, as the kernel computes it."""
    return [(i * n_keys // n_split, (i + 1) * n_keys // n_split) for i in range(n_split)]


def valid_key_rows(hot_len: int, cold_len: int, ring_newest: int, w: int, c: int) -> torch.Tensor:
    """Rows of ``cat([cold, hot], dim=2)`` in the kernel's key order: cold
    positions [0, cold_len), then the valid ring slots, oldest first."""
    hot = torch.remainder(ring_newest - hot_len + 1 + torch.arange(hot_len), w)
    return torch.cat([torch.arange(cold_len), c + hot])


def split_merge_plain(
    q: torch.Tensor,  # (B, H, 1, D)
    hot_k: torch.Tensor,  # (B, KV, W, D)
    hot_v: torch.Tensor,
    cold_k: torch.Tensor,  # (B, KV, C, D)
    cold_v: torch.Tensor,
    hot_len: int,
    cold_len: int,
    ring_newest: int,
    n_split: int,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: fp32 partial softmaxes
    (m, l, acc) over each split's key range in the log2 domain, then their
    merge; a split with no key has m = -inf and adds nothing, and a row with
    no key at all gives 0."""
    b, h, _, d = q.shape
    kv, w, c = hot_k.shape[1], hot_k.shape[2], cold_k.shape[2]
    rows = valid_key_rows(hot_len, cold_len, ring_newest, w, c).to(q.device)
    k = torch.cat([cold_k, hot_k], dim=2)[:, :, rows].float()
    v = torch.cat([cold_v, hot_v], dim=2)[:, :, rows].float()
    qg = q.float().reshape(b, kv, h // kv, d) * (math.log2(math.e) / math.sqrt(d))
    s = torch.einsum("bkgd,bknd->bkgn", qg, k)
    neg_inf = torch.tensor(float("-inf"), device=q.device)
    ms, ls, accs = [], [], []
    for k0, k1 in split_ranges(len(rows), n_split):
        part = s[..., k0:k1]
        m = part.amax(-1) if k1 > k0 else neg_inf.expand(part.shape[:-1])
        p = torch.exp2(part - torch.where(torch.isinf(m), 0.0, m)[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgn,bknd->bkgd", p, v[:, :, k0:k1]))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    top = m.amax(0)
    coef = torch.where(torch.isinf(m), 0.0, torch.exp2(m - torch.where(torch.isinf(top), 0.0, top)))
    big_l = (coef * l).sum(0)
    out = (coef[..., None] * acc).sum(0)
    out = torch.where(big_l[..., None] == 0, 0.0, out / torch.where(big_l == 0, 1.0, big_l)[..., None])
    return out.reshape(b, h, 1, d).to(q.dtype)


def tiered_decode_attention_fwd(
    q: torch.Tensor,  # (B, H, 1, D)
    hot_k: torch.Tensor,  # (B, KV, W, D)
    hot_v: torch.Tensor,
    cold_k: torch.Tensor,  # (B, KV, C, D)
    cold_v: torch.Tensor,
    hot_len: int,
    cold_len: int,
    ring_newest: int,
    n_split: int | None = None,
) -> torch.Tensor:
    """Launch both passes on PyTorch's current stream; no synchronisation.
    ``n_split`` defaults to ``plan_splits`` for this card."""
    from repro_torch.kernels.ops import check, load

    b, h, one, d = q.shape
    _, kv, w, _ = hot_k.shape
    c = cold_k.shape[2]
    tensors = (q, hot_k, hot_v, cold_k, cold_v)
    if one != 1:
        raise ValueError(f"decode takes one query row, got {one}")
    if d not in HEAD_DIMS or kv <= 0 or h % kv or h // kv not in GROUPS:
        raise ValueError(f"tiered decode kernel built for D in {HEAD_DIMS}, H/KV in 1..{GROUPS[-1]}; "
                         f"got D={d}, H={h}, KV={kv}")
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("tiered decode kernel: every operand must be on one CUDA device")
    if not all(t.dtype == q.dtype for t in tensors) or q.dtype not in _DTYPES:
        raise TypeError(f"tiered decode kernel takes float32 or bfloat16 operands of one dtype, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("tiered decode kernel takes contiguous operands on 16-byte boundaries")
    if hot_v.shape != hot_k.shape or cold_v.shape != cold_k.shape or cold_k.shape[:2] != (b, kv) \
            or hot_k.shape[0] != b or cold_k.shape[3] != d or hot_k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} hot {tuple(hot_k.shape)} cold {tuple(cold_k.shape)}")
    if not (0 <= hot_len <= w and 0 <= cold_len <= c):
        raise ValueError(f"lengths out of range: hot_len={hot_len} (W={w}), cold_len={cold_len} (C={c})")
    gt, tiles = head_tile(h // kv)
    if n_split is None:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        n_split = plan_splits(hot_len + cold_len, b * kv * tiles, sms, blocks_per_sm(h // kv))
    out = torch.empty_like(q)
    scratch = torch.empty(b * h * n_split * (d + 2), dtype=torch.float32, device=q.device) if n_split > 1 else None
    lib = load("tiered_decode")
    err = lib.tiered_decode_launch(
        q.data_ptr(), hot_k.data_ptr(), hot_v.data_ptr(), cold_k.data_ptr(), cold_v.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(), b, h, kv, w, c, d,
        int(hot_len), int(cold_len), int(ring_newest), int(n_split), gt, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(err, "tiered_decode_attention")
    return out
