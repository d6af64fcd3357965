"""Kernel dispatch, launch counts, and the build of the CUDA sources.

Each public op takes its tensors where they lie: on a CUDA tensor it
launches the hand-written Hopper kernel (``csrc/*.cu``) or raises; on a CPU
tensor it runs the kernel's plain PyTorch version from ``ref.py``.  There is
no fallback from one to the other.

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
SOURCES = ("tiered_decode", "flash_attention", "rglru", "mlstm")
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
    P, I = ctypes.c_void_p, ctypes.c_int
    if name == "tiered_decode":
        fns = [(lib.tiered_decode_launch, [P] * 7 + [I] * 12 + [P])]
    elif name == "flash_attention":
        args = [P, P, P, P, I, I, I, I, I, I, I, I, ctypes.c_float]
        fns = [(lib.flash_attention_launch, args + [I, P]), (lib.flash_attention_wgmma_launch, args + [P])]
    elif name == "rglru":
        fns = [(lib.rglru_scan_launch, [P, P, P, I, I, I, I, P])]
    else:
        fns = [(lib.mlstm_chunkwise_launch, [P] * 12 + [I, I, I, I, P])]
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


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


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
        from repro_torch.kernels.tiered_decode import tiered_decode_attention_fwd

        out = tiered_decode_attention_fwd(q, hot_k, hot_v, cold_k, cold_v, hot_len, cold_len, ring_newest)
        tiered_decode_attention.launches += 1
        return out
    return ref.tiered_ring_attention_ref(q, hot_k, hot_v, cold_k, cold_v, hot_len, cold_len, ring_newest)


def rglru_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + x_t along S of (B, S, W) inputs from a zero
    carry (fold a carry-in into x_0); fp32 carry, output in x's dtype."""
    if x.is_cuda:
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
        from repro_torch.kernels.mlstm import mlstm_chunkwise_fwd

        out = mlstm_chunkwise_fwd(q, k, v, i_pre, f_log, state)
        mlstm_chunkwise.launches += 1
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
    flash_attention.path_launches = {"tensor_core": 0, "cuda_core": 0}


def launches() -> dict[str, int]:
    return {name: op.launches for name, op in KERNEL_OPS.items()}


def flash_path_launches() -> dict[str, int]:
    """The flash op's launches split by kernel (``flash_attention.flash_path``)."""
    return dict(flash_attention.path_launches)


reset_launches()
