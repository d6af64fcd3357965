"""Kernel dispatch, launch counts, and the build of the CUDA sources.

Each public op takes its tensors where they lie: on a CUDA tensor it
launches the hand-written Hopper kernel (``csrc/*.cu``) or raises; on a CPU
tensor it runs the kernel's plain PyTorch version from ``ref.py``.  There is
no fallback from one to the other.  The kernels are forward only: on CUDA
tensors that autograd would track, an op raises (``no_backward``) rather
than return a result cut off from the graph.

Each op counts its kernel launches in ``op.launches`` (a plain integer on
the function), incremented only where the kernel is launched, so a run can
show that its main path went through the kernels.

Build: each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, loaded with ``ctypes``.
The libraries go to ``build/repro_torch_kernels/`` at the repository root
(``build/`` is git-ignored), are built at first use from the sources in the
repository only, and are named by a hash of the source and flags, so an
edited source is never served by a stale library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.kernels import ref

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("tiered_decode", "flash_attention", "rglru", "mlstm", "moe_grouped")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile the named sources that have no library yet — one ``nvcc``
    per source, all started together — and return their library paths.
    The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) is kept beside each library as ``<lib>.log``.
    Raises with that output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (p, tmp) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}.cu:\n{log}")
            continue
        paths[n].with_suffix(".log").write_text(log)
        os.replace(tmp, paths[n])  # atomic: a concurrent loader never sees a partial file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def _bind(lib: ctypes.CDLL, name: str) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "tiered_decode":
        fns = [(lib.tiered_decode_launch, [P] * 7 + [I] * 12 + [F, P]),
               (lib.tiered_decode_rows_launch, [P] * 9 + [I] * 8 + [F, P])]
    elif name == "flash_attention":
        args = [P, P, P, P, I, I, I, I, I, I, I, I, F, F]
        fns = [(lib.flash_attention_launch, args + [I, P]), (lib.flash_attention_wgmma_launch, args + [P])]
    elif name == "rglru":
        fns = [(lib.rglru_scan_launch, [P, P, P, I, I, I, I, P])]
    elif name == "moe_grouped":
        fns = [(lib.moe_grouped_launch, [P] * 9 + [I] * 8 + [P])]
    else:
        fns = [(lib.mlstm_chunkwise_launch, [P] * 12 + [I, I, I, I, I, P])]
    for fn, argtypes in fns:
        fn.argtypes = argtypes
        fn.restype = I


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            path = build((name,))[name]
            lib = ctypes.CDLL(str(path))
            _bind(lib, name)
            _libs[name] = lib
        return _libs[name]


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The device's SM count, which the launch planners fill."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def built_head_dim(d: int, built: tuple[int, ...], kernel: str) -> int:
    """The head dim a kernel built for the head dims ``built`` runs a head
    dim ``d`` at: ``d`` itself where it is built, else the smallest built
    one above it (the launcher zero-pads the operands' last dim to it and
    passes the score scale 1/sqrt(d)); raises above the largest."""
    for b in built:
        if 1 <= d <= b:
            return b
    raise ValueError(f"{kernel} kernel built for D up to {built[-1]} (D in {built}, others zero-padded), got D={d}")


def pad_head_dim(x: torch.Tensor, dk: int) -> torch.Tensor:
    """``x`` zero-padded along its last dim to ``dk`` (``x`` itself when it
    has that width already: a built head dim copies nothing)."""
    return x if x.shape[-1] == dk else torch.nn.functional.pad(x, (0, dk - x.shape[-1]))


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def tracked(*tensors) -> bool:
    """Whether autograd would track any of ``tensors`` (tensors, or lists and
    tuples of them): grad is enabled and one of them requires it."""
    if not torch.is_grad_enabled():
        return False
    flat = [t for x in tensors for t in (x if isinstance(x, (list, tuple)) else (x,))]
    return any(isinstance(t, torch.Tensor) and t.requires_grad for t in flat)


def no_backward(op: str, *tensors) -> None:
    """Raise if autograd would track any of ``tensors``: a kernel's output
    has no ``grad_fn``, so handing it back would silently drop the gradient
    of everything upstream."""
    if tracked(*tensors):
        raise RuntimeError(
            f"{op}: the CUDA kernel has no backward, and an input requires grad; "
            "call it under torch.no_grad(), or train through the plain attention (attn_impl='xla')"
        )


def flash_attention(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KV, T, D)
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Tiled attention forward. q: (B,H,S,D); k,v: (B,KV,T,D) -> (B,H,S,D)."""
    if q.is_cuda:
        no_backward("flash_attention", q, k, v)
        from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_path

        out = flash_attention_fwd(q, k, v, causal=causal, window=window, logit_softcap=logit_softcap)
        flash_attention.launches += 1
        flash_attention.path_launches[flash_path(q.dtype, q.shape[-1])] += 1
        return out
    return ref.attention_ref(q, k, v, causal=causal, window=window, logit_softcap=logit_softcap)


def tiered_decode_attention(
    q: torch.Tensor,  # (B, H, 1, D)
    hot_k: torch.Tensor,  # (B, KV, W, D) ring
    hot_v: torch.Tensor,
    cold_k: torch.Tensor,  # (B, KV, C, D) paged capacity buffer
    cold_v: torch.Tensor,
    hot_len: int,
    cold_len: int,
    ring_newest: int | None = None,
) -> torch.Tensor:
    """Two-tier decode attention over a hot ring and a paged cold buffer.

    ``ring_newest`` is the hot-ring slot of the most recent token; ``None``
    means the hot buffer is chronological (valid slots ``[0, hot_len)``)."""
    if ring_newest is None:
        ring_newest = hot_len - 1
    if q.is_cuda:
        no_backward("tiered_decode_attention", q, hot_k, hot_v, cold_k, cold_v)
        from repro_torch.kernels.tiered_decode import tiered_decode_attention_fwd

        out = tiered_decode_attention_fwd(q, hot_k, hot_v, cold_k, cold_v, hot_len, cold_len, ring_newest)
        tiered_decode_attention.launches += 1
        return out
    return ref.tiered_ring_attention_ref(q, hot_k, hot_v, cold_k, cold_v, hot_len, cold_len, ring_newest)


def tiered_decode_rows_attention(
    q: torch.Tensor,  # (N, H, 1, D)
    hot_k,  # N rings (1, KV, W, D)
    hot_v,
    cold_k,  # N staging buffers (1, KV, C_i, D)
    cold_v,
    lens,  # (N, 3): hot_len, cold_len, ring_newest of each row
) -> torch.Tensor:
    """Two-tier decode attention for N rows at N different lengths, each row
    over its own ring and staging buffer (the session plane's batched
    decode).  Counted in its own ``launches``, beside
    ``tiered_decode_attention``'s: one source, two entries."""
    if q.is_cuda:
        no_backward("tiered_decode_rows_attention", q, hot_k, hot_v, cold_k, cold_v)
        from repro_torch.kernels.tiered_decode import tiered_decode_rows_fwd

        out = tiered_decode_rows_fwd(q, hot_k, hot_v, cold_k, cold_v, lens)
        tiered_decode_rows_attention.launches += 1
        return out
    return ref.tiered_rows_attention_ref(q, hot_k, hot_v, cold_k, cold_v, lens)


def moe_grouped_ffn(
    x: torch.Tensor,  # (T, d)
    w_gate: torch.Tensor,  # (E_held, d, f)
    w_up: torch.Tensor,
    w_down: torch.Tensor,  # (E_held, f, d)
    rows: torch.Tensor,  # (R,) int64 flat assignment of each padded row, T * k on padding
    tile_expert: torch.Tensor,  # (R / tile,) int32 local expert of each tile
    gate: torch.Tensor,  # (R,) fp32
    top_k: int,
) -> torch.Tensor:
    """The held experts' gated SwiGLU over each expert's own rows: (R, d),
    row r of a tile of expert e ``gate[r] * (silu(x Wg_e) * (x Wu_e)) Wd_e``
    for its token.  No counterpart in the JAX package (its MoE is a
    capacity-padded einsum over every expert); vLLM's ``fused_moe`` is the
    design: the rows sorted by expert, each expert's run padded to a tile,
    a tile-to-expert table read on the device.  Counted in its own
    ``launches`` (one an op: the gate-up and the down kernels)."""
    if x.is_cuda:
        no_backward("moe_grouped_ffn", x, w_gate, w_up, w_down)
        from repro_torch.kernels.moe_grouped import moe_grouped_ffn_fwd

        out = moe_grouped_ffn_fwd(x, w_gate, w_up, w_down, rows, tile_expert, gate, top_k)
        moe_grouped_ffn.launches += 1
        return out
    return ref.moe_grouped_ref(x, w_gate, w_up, w_down, rows, tile_expert, gate, top_k)


def rglru_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + x_t along S of (B, S, W) inputs from a zero
    carry (fold a carry-in into x_0); fp32 carry, output in x's dtype."""
    if x.is_cuda:
        no_backward("rglru_scan", a, x)
        from repro_torch.kernels.rglru import rglru_scan_fwd

        out = rglru_scan_fwd(a, x)
        rglru_scan.launches += 1
        return out
    return ref.rglru_ref(a, x)


def mlstm_chunkwise(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,
    v: torch.Tensor,
    i_pre: torch.Tensor,  # (B, H, S) log input gate pre-activation
    f_log: torch.Tensor,  # (B, H, S) log-sigmoid forget gate
    state: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """mLSTM over S from the carry ``state`` = (C, n, m) (the empty history
    if None).  Returns (h in q's dtype, the carry-out (C, n, m) in fp32)."""
    if q.is_cuda:
        no_backward("mlstm_chunkwise", q, k, v, i_pre, f_log, state)
        from repro_torch.kernels.mlstm import mlstm_chunkwise_fwd

        out = mlstm_chunkwise_fwd(q, k, v, i_pre, f_log, state)
        mlstm_chunkwise.launches += 1
        grid = mlstm_chunkwise_fwd.last_grid
        mlstm_chunkwise.grid_launches[grid] = mlstm_chunkwise.grid_launches.get(grid, 0) + 1
        return out
    return ref.mlstm_ref(q, k, v, i_pre, f_log, state)


KERNEL_OPS = {
    "tiered_decode": tiered_decode_attention,
    "flash_attention": flash_attention,
    "rglru": rglru_scan,
    "mlstm": mlstm_chunkwise,
}


def reset_launches() -> None:
    for op in KERNEL_OPS.values():
        op.launches = 0
    tiered_decode_rows_attention.launches = 0
    moe_grouped_ffn.launches = 0
    flash_attention.path_launches = {"tensor_core": 0, "cuda_core": 0}
    mlstm_chunkwise.grid_launches = {}


def launches() -> dict[str, int]:
    return {name: op.launches for name, op in KERNEL_OPS.items()}


def flash_path_launches() -> dict[str, int]:
    """The flash op's launches split by kernel (``flash_attention.flash_path``)."""
    return dict(flash_attention.path_launches)


def mlstm_grid_launches() -> list[dict[str, int]]:
    """The mLSTM op's launches by the (value tile, blocks) each launch took."""
    return [dict(tile_v=tv, blocks=blocks, launches=n)
            for (tv, blocks), n in sorted(mlstm_chunkwise.grid_launches.items())]


reset_launches()
