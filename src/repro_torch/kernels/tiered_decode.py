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
G heads into tiles of a built width.  A head dim below 256 that is not built
(the reduced configs' D = 12) runs at the next built one: the launcher
zero-pads q and both tiers along D (a copy a call, at these small shapes
only), passes the score scale 1/sqrt(D) of the caller's D and cuts the
output back; the caches keep their own D.  Any other shape raises.

``head_tile``, ``plan_splits`` and ``split_ranges`` choose the tiles and
ranges (plain Python, tested on the CPU); ``split_merge_plain`` is the
kernel's split-then-merge arithmetic in plain PyTorch.  The plain version
of the op is ``ref.tiered_ring_attention_ref``; ``ops`` chooses.

``tiered_decode_rows_fwd`` launches the per-row entry: N rows (sessions),
each with its own ring, staging buffer of its own capacity and its own
lengths, read where they lie (up to ``MAX_ROWS``); every row splits its own
keys into the same ``n_split`` ranges.  Its plain version is
``ref.tiered_rows_attention_ref``, its split arithmetic
``split_merge_rows_plain``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.ops import built_head_dim, pad_head_dim, sm_count

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
GROUPS = tuple(range(1, 17))
HEAD_TILES = (1, 2, 4, 6, 8)  # the head-tile widths GT the kernel is built for
MIN_KEYS_PER_SPLIT = 64
MAX_ROWS = 64  # the per-row entry's table (csrc/tiered_decode.cu::kMaxRows)


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


def split_merge_rows_plain(q, hot_k, hot_v, cold_k, cold_v, lens, n_split: int) -> torch.Tensor:
    """The per-row kernel's arithmetic in plain PyTorch: row i of q (N, H, 1,
    D) over its own ring, staging buffer and lengths ``lens[i]`` = (hot_len,
    cold_len, ring_newest), its keys cut into ``n_split`` ranges."""
    return torch.cat([split_merge_plain(q[i:i + 1], hot_k[i], hot_v[i], cold_k[i], cold_v[i], *map(int, lens[i]),
                                        n_split) for i in range(q.shape[0])])


def check_shape(h: int, kv: int, d: int) -> int:
    """Raise unless the kernel takes H query heads over KV kv heads of head
    dim D; return the built head dim it runs D at."""
    if kv <= 0 or h % kv or h // kv not in GROUPS:
        raise ValueError(f"tiered decode kernel built for H/KV in 1..{GROUPS[-1]}; got H={h}, KV={kv}")
    return built_head_dim(d, HEAD_DIMS, "tiered decode")


def _check_operands(tensors, q: torch.Tensor) -> None:
    """One dtype the kernel takes, then one CUDA device, contiguous, 16-byte
    aligned (the kernel's loads are 16 bytes a lane)."""
    if not all(t.dtype == q.dtype for t in tensors) or q.dtype not in _DTYPES:
        raise TypeError(f"tiered decode kernel takes float32 or bfloat16 operands of one dtype, got "
                        f"{sorted({str(t.dtype) for t in tensors})}")
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("tiered decode kernel: every operand must be on one CUDA device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("tiered decode kernel takes contiguous operands on 16-byte boundaries")


def rows_plan(q: torch.Tensor, hot_k, hot_v, cold_k, cold_v, lens) -> tuple[list[tuple[int, int, int]], int]:
    """Check the per-row operands, as the launcher does before any launch,
    and return (the lengths as int triples, the planned split count).

    q (N, H, 1, D); N rows (1 <= N <= ``MAX_ROWS``) of hot rings (1, KV, W,
    D), all of one W, KV and D, and staging buffers (1, KV, C_i, D); lens
    (N, 3) = (hot_len, cold_len, ring_newest) a row, 0 <= hot_len <= W and
    0 <= cold_len <= C_i.  Shapes and dtypes are checked before the device,
    so a refusal shows on any machine."""
    n, h, one, d = q.shape
    if one != 1:
        raise ValueError(f"decode takes one query row, got {one}")
    if not 1 <= n <= MAX_ROWS:
        raise ValueError(f"tiered rows kernel takes 1 to {MAX_ROWS} rows, got {n}")
    if not len(hot_k) == len(hot_v) == len(cold_k) == len(cold_v) == len(lens) == n:
        raise ValueError(f"{n} query rows need {n} rings, staging buffers and length triples")
    kv, w = hot_k[0].shape[1], hot_k[0].shape[2]
    check_shape(h, kv, d)
    lens = [tuple(int(x) for x in row) for row in lens]
    for i, (hk, hv, ck, cv, (hot_len, cold_len, _)) in enumerate(zip(hot_k, hot_v, cold_k, cold_v, lens)):
        if hk.shape != (1, kv, w, d) or hv.shape != hk.shape or ck.ndim != 4 or ck.shape[:2] != (1, kv) \
                or ck.shape[3] != d or cv.shape != ck.shape:
            raise ValueError(f"row {i}: every row needs rings (1, {kv}, {w}, {d}) and staging buffers "
                             f"(1, {kv}, C, {d}); got hot {tuple(hk.shape)}, cold {tuple(ck.shape)}")
        if not (0 <= hot_len <= w and 0 <= cold_len <= ck.shape[2]):
            raise ValueError(f"row {i}: lengths out of range: hot_len={hot_len} (W={w}), "
                             f"cold_len={cold_len} (C={ck.shape[2]})")
    _check_operands((q, *hot_k, *hot_v, *cold_k, *cold_v), q)
    tiles = head_tile(h // kv)[1]
    n_keys = max(hot_len + cold_len for hot_len, cold_len, _ in lens)
    return lens, plan_splits(n_keys, n * kv * tiles, sm_count(q.device), blocks_per_sm(h // kv))


def rows_launch_args(q, hot_k, hot_v, cold_k, cold_v, lens, n_split: int, out, scratch,
                     scale: float | None = None) -> tuple:
    """The arguments of one ``tiered_decode_rows_launch`` C call, on checked
    operands of a built head dim (``rows_plan``): the rows' base pointers,
    capacities and lengths as C arrays, the score scale (1/sqrt(D) unless
    given: the unpadded D's) and the current stream."""
    n, h, _, d = q.shape
    _, kv, w, _ = hot_k[0].shape
    ptrs = lambda ts: (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))
    return (q.data_ptr(), ptrs(hot_k), ptrs(hot_v), ptrs(cold_k), ptrs(cold_v),
            (ctypes.c_int * n)(*(c.shape[2] for c in cold_k)), (ctypes.c_int * (3 * n))(*(x for r in lens for x in r)),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(), n, h, kv, w, d, int(n_split),
            head_tile(h // kv)[0], _DTYPES[q.dtype], 1.0 / math.sqrt(d) if scale is None else scale,
            torch.cuda.current_stream(q.device).cuda_stream)


def tiered_decode_rows_fwd(q: torch.Tensor, hot_k, hot_v, cold_k, cold_v, lens,
                           n_split: int | None = None) -> torch.Tensor:
    """Launch the per-row entry's two passes on PyTorch's current stream; no
    synchronisation.  Operands as ``rows_plan`` checks them; ``n_split``
    defaults to its plan for this card."""
    from repro_torch.kernels.ops import check, load

    lens, planned = rows_plan(q, hot_k, hot_v, cold_k, cold_v, lens)
    n_split = planned if n_split is None else n_split
    n, h, _, d = q.shape
    dk = check_shape(h, hot_k[0].shape[1], d)
    q = pad_head_dim(q, dk)
    hot_k, hot_v, cold_k, cold_v = ([pad_head_dim(t, dk) for t in ts] for ts in (hot_k, hot_v, cold_k, cold_v))
    out = torch.empty_like(q)
    scratch = torch.empty(n * h * n_split * (dk + 2), dtype=torch.float32, device=q.device) if n_split > 1 else None
    lib = load("tiered_decode")
    check(lib.tiered_decode_rows_launch(*rows_launch_args(q, hot_k, hot_v, cold_k, cold_v, lens, n_split, out,
                                                          scratch, 1.0 / math.sqrt(d))),
          "tiered_decode_rows_attention")
    return out if dk == d else out[..., :d].contiguous()


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
    dk = check_shape(h, kv, d)
    if hot_v.shape != hot_k.shape or cold_v.shape != cold_k.shape or cold_k.shape[:2] != (b, kv) \
            or hot_k.shape[0] != b or cold_k.shape[3] != d or hot_k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} hot {tuple(hot_k.shape)} cold {tuple(cold_k.shape)}")
    if not (0 <= hot_len <= w and 0 <= cold_len <= c):
        raise ValueError(f"lengths out of range: hot_len={hot_len} (W={w}), cold_len={cold_len} (C={c})")
    _check_operands(tensors, q)
    gt, tiles = head_tile(h // kv)
    if n_split is None:
        n_split = plan_splits(hot_len + cold_len, b * kv * tiles, sm_count(q.device), blocks_per_sm(h // kv))
    q, hot_k, hot_v, cold_k, cold_v = (pad_head_dim(t, dk) for t in tensors)
    out = torch.empty_like(q)
    scratch = torch.empty(b * h * n_split * (dk + 2), dtype=torch.float32, device=q.device) if n_split > 1 else None
    lib = load("tiered_decode")
    err = lib.tiered_decode_launch(
        q.data_ptr(), hot_k.data_ptr(), hot_v.data_ptr(), cold_k.data_ptr(), cold_v.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(), b, h, kv, w, c, dk,
        int(hot_len), int(cold_len), int(ring_newest), int(n_split), gt, _DTYPES[q.dtype], 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(err, "tiered_decode_attention")
    return out if dk == d else out[..., :d].contiguous()
