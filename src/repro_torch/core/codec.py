"""Transparent per-block compression codec (DESIGN.md §13).

Cold bytes are the paper's lever: Eqs. 1-7 say aggregate throughput is
governed by the memory fraction ``f`` and the raw PFS rate ``q`` — both
of which rise *per physical byte* when the bytes themselves shrink.  The
store compresses a block once, at flush/spill time (off the caller's
critical path — the same pool/flush threads that already move the
bytes), and decodes on the first cold read; everything between — PFS
stripes, the dstore peer wire, ranged reads — moves the smaller physical
container.

Container format (``TLC1``)::

    header   <4sBBBBIQ>  magic, codec id, filter id, elem width, flags,
                         n_frames (u32), logical_len (u64)
    table    n_frames × u32 — encoded byte length per frame; the high bit
             (RAW_FRAME) marks a frame stored raw (its encoded form was
             not smaller), so incompressible frames cost exactly 4 bytes
             of table entry and zero payload overhead
    frames   concatenated encoded (or raw) frames

Each frame covers ``frame_bytes`` of *logical* data (the last one may be
short), which is what makes ranged reads cheap: a :class:`FrameIndex`
derived from the header maps any logical span to the physical span of
its covering frames, so ``get_range`` reads and decodes only those.

Codecs are a fallback chain of what the stdlib guarantees: ``zlib``
(the lz4-stand-in fast path — level 1 is the default policy choice) and
``lzma`` (high-ratio archival).  Before the codec runs, a vectorized
**byte-shuffle / delta filter** (the dense analogue of
``optim/compression.py``'s sparsification philosophy: transform first so
the entropy coder sees structure) rearranges fp/int tensor chunks:
shuffling groups the k-th byte of every element together (exponent bytes
compress ~free), and delta-of-elements first turns slowly-varying
sequences into near-zero residuals.  A tiny sample probe picks the
winning filter per block — or reports the block incompressible, in which
case the store writes the original bytes untouched (no container at
all, so random data pays zero overhead).

Integrity keeps the store's zero-extra-pass discipline: the *logical*
CRC is folded frame-by-frame while encoding/decoding (the data is in
cache anyway), and the *physical* CRC over the container comes free from
the PFS tier's transfer-folded stripe CRCs.  Any header inconsistency,
codec error, or length mismatch raises
:class:`~repro_torch.core.tiers.IntegrityError` — never silent garbage.
"""

from __future__ import annotations

import dataclasses
import lzma
import struct
import zlib

import numpy as np

from repro_torch.core.tiers import IntegrityError

__all__ = [
    "CodecSpec",
    "Encoded",
    "FrameIndex",
    "encode",
    "decode",
    "parse_index",
    "decode_frames",
    "is_container",
    "index_bytes",
    "CODEC_ZLIB",
    "CODEC_LZMA",
]

MAGIC = b"TLC1"
_HEADER = struct.Struct("<4sBBBBIQ")  # magic, codec, filter, width, flags, n_frames, logical_len
RAW_FRAME = 0x8000_0000  # frame-table high bit: frame stored raw

CODEC_ZLIB = 1
CODEC_LZMA = 2

FILTER_NONE = 0
FILTER_SHUFFLE = 1
FILTER_DELTA_SHUFFLE = 2

#: lzma needs an explicit raw filter chain so frames are self-contained
#: and cheap (no container/stream overhead per frame).
_LZMA_FILTERS = [{"id": lzma.FILTER_LZMA2, "preset": 0}]


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """Encoding policy for one block.

    ``min_gain`` is the probe threshold: the sampled compressed/raw ratio
    must come in *below* it or :func:`encode` declines (returns ``None``)
    and the block is stored raw.
    """

    codec: int = CODEC_ZLIB
    level: int = 1  # zlib level / ignored for lzma (preset fixed raw chain)
    frame_bytes: int = 256 * 1024
    min_gain: float = 0.9
    probe_bytes: int = 16 * 1024

    def __post_init__(self) -> None:
        if self.codec not in (CODEC_ZLIB, CODEC_LZMA):
            raise ValueError(f"unknown codec id {self.codec}")
        if self.frame_bytes < 4096:
            raise ValueError("frame_bytes must be >= 4096")


@dataclasses.dataclass(frozen=True)
class FrameIndex:
    """Parsed container geometry: logical span ↔ physical frame span."""

    codec: int
    filter: int
    width: int
    frame_bytes: int
    logical_len: int
    frame_lens: tuple[int, ...]  # table entries, RAW_FRAME bit included
    data_offset: int  # first frame's byte offset inside the container

    @property
    def physical_len(self) -> int:
        return self.data_offset + sum(n & ~RAW_FRAME for n in self.frame_lens)

    def frame_range(self, lo: int, hi: int) -> tuple[int, int]:
        """Covering frame indexes ``[first, last)`` for logical ``[lo, hi)``."""
        if not 0 <= lo <= hi <= self.logical_len:
            raise ValueError(f"span [{lo}, {hi}) outside logical length {self.logical_len}")
        if lo == hi:
            return 0, 0
        return lo // self.frame_bytes, (hi - 1) // self.frame_bytes + 1

    def physical_span(self, first: int, last: int) -> tuple[int, int]:
        """Byte ``(offset, length)`` inside the container covering frames
        ``[first, last)`` — what a ranged PFS read must fetch."""
        off = self.data_offset
        for i in range(first):
            off += self.frame_lens[i] & ~RAW_FRAME
        length = sum(self.frame_lens[i] & ~RAW_FRAME for i in range(first, last))
        return off, length


@dataclasses.dataclass(frozen=True)
class Encoded:
    """One encoded block: the container plus everything the block table
    needs to serve reads without re-parsing it."""

    payload: bytes
    logical_crc: int
    index: FrameIndex


# ------------------------------------------------------------------ filters


def _apply_filter(frame: bytes, filt: int, width: int) -> bytes:
    if filt == FILTER_NONE or len(frame) < width * 2:
        return frame
    n = len(frame) // width
    head = np.frombuffer(frame, dtype=np.uint8, count=n * width)
    tail = frame[n * width :]
    if filt == FILTER_DELTA_SHUFFLE:
        dt = np.dtype(f"<u{width}")
        vals = head.view(dt)
        # Wrapping first-difference on the unsigned view: exactly invertible
        # by a wrapping cumulative sum, and near-constant streams become
        # near-zero bytes before the shuffle.
        d = np.empty_like(vals)
        d[0] = vals[0]
        np.subtract(vals[1:], vals[:-1], out=d[1:])
        head = d.view(np.uint8)
    shuf = head.reshape(-1, width).T.tobytes()
    return shuf + tail if tail else shuf


def _undo_filter(frame: bytes, filt: int, width: int) -> bytes:
    if filt == FILTER_NONE or len(frame) < width * 2:
        return frame
    n = len(frame) // width
    body = np.frombuffer(frame, dtype=np.uint8, count=n * width)
    tail = frame[n * width :]
    unshuf = np.ascontiguousarray(body.reshape(width, -1).T)
    if filt == FILTER_DELTA_SHUFFLE:
        dt = np.dtype(f"<u{width}")
        vals = unshuf.reshape(-1).view(dt)
        out = np.cumsum(vals, dtype=dt)  # wrapping inverse of the diff
        unshuf = out.view(np.uint8)
    raw = unshuf.tobytes()
    return raw + tail if tail else raw


# ------------------------------------------------------------------- codecs


def _compress(data: bytes, codec: int, level: int) -> bytes:
    if codec == CODEC_ZLIB:
        return zlib.compress(data, level)
    return lzma.compress(data, format=lzma.FORMAT_RAW, filters=_LZMA_FILTERS)


def _decompress(data: bytes, codec: int) -> bytes:
    try:
        if codec == CODEC_ZLIB:
            return zlib.decompress(data)
        return lzma.decompress(data, format=lzma.FORMAT_RAW, filters=_LZMA_FILTERS)
    except (zlib.error, lzma.LZMAError, ValueError) as exc:
        raise IntegrityError(f"compressed frame is corrupt: {exc}") from exc


# -------------------------------------------------------------------- probe

#: Candidate (filter, width) pairs the probe races.  Widths beyond 4/8
#: buy nothing on the byte streams this store carries.
_PROBE_CANDIDATES = (
    (FILTER_NONE, 1),
    (FILTER_SHUFFLE, 4),
    (FILTER_DELTA_SHUFFLE, 4),
    (FILTER_SHUFFLE, 8),
)


def _probe(mv: memoryview, spec: CodecSpec) -> tuple[int, int] | None:
    """Sample-compress two small windows; return the winning (filter,
    width) — or ``None`` when even the best sampled ratio misses
    ``min_gain`` (the block is not worth a container)."""
    total = len(mv)
    half = max(1, spec.probe_bytes // 2)
    windows = [bytes(mv[:half])]
    if total > half * 4:
        mid = (total // 2) & ~7  # 8-aligned so width-8 filters see element grid
        windows.append(bytes(mv[mid : mid + half]))
    sample = b"".join(windows)
    if len(sample) < 64:
        return None  # too small to judge — or to be worth the header
    best: tuple[int, int] | None = None
    best_ratio = spec.min_gain
    for filt, width in _PROBE_CANDIDATES:
        packed = len(_compress(_apply_filter(sample, filt, width), CODEC_ZLIB, 1))
        ratio = packed / len(sample)
        if filt == FILTER_NONE and ratio >= 1.0:
            # Deflate *expanded* the unfiltered sample: the bytes are at
            # full entropy (urandom, encrypted, already-compressed), and
            # no byte permutation lowers entropy — skip the remaining
            # candidates so the decline path costs one sample, not four.
            return None
        if ratio < best_ratio:
            best_ratio = ratio
            best = (filt, width)
    return best


# ------------------------------------------------------------ encode/decode


def encode(data, spec: CodecSpec | None = None) -> Encoded | None:
    """Encode one block.  ``None`` means "store raw": the probe judged the
    bytes incompressible (or empty), so the caller writes the original
    data untouched — zero physical overhead on random blocks."""
    spec = spec or CodecSpec()
    mv = memoryview(data)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    total = len(mv)
    if total == 0:
        return None
    picked = _probe(mv, spec)
    if picked is None:
        return None
    filt, width = picked
    fb = spec.frame_bytes
    n_frames = (total + fb - 1) // fb
    lens: list[int] = []
    frames: list[bytes] = []
    crc = 0
    packed_total = 0
    for i in range(n_frames):
        frame = bytes(mv[i * fb : min((i + 1) * fb, total)])
        crc = zlib.crc32(frame, crc)
        packed = _compress(_apply_filter(frame, filt, width), spec.codec, spec.level)
        if len(packed) < len(frame):
            lens.append(len(packed))
            frames.append(packed)
            packed_total += len(packed)
        else:
            lens.append(len(frame) | RAW_FRAME)
            frames.append(frame)
            packed_total += len(frame)
    overhead = _HEADER.size + 4 * n_frames
    if packed_total + overhead >= total:
        return None  # per-frame compression lost to framing: store raw
    header = _HEADER.pack(MAGIC, spec.codec, filt, width, 0, n_frames, total)
    table = struct.pack(f"<{n_frames}I", *lens)
    index = FrameIndex(
        codec=spec.codec,
        filter=filt,
        width=width,
        frame_bytes=fb,
        logical_len=total,
        frame_lens=tuple(lens),
        data_offset=overhead,
    )
    return Encoded(payload=header + table + b"".join(frames), logical_crc=crc, index=index)


def is_container(data) -> bool:
    mv = memoryview(data)
    return len(mv) >= _HEADER.size and bytes(mv[:4]) == MAGIC


def index_bytes(logical_len: int, frame_bytes: int) -> int:
    """Container bytes covering the header + frame table for a block of
    ``logical_len`` — what a cold ranged read fetches to parse the index
    before touching any frame."""
    n = (logical_len + frame_bytes - 1) // frame_bytes if logical_len else 0
    return _HEADER.size + 4 * n


def parse_index(data, frame_bytes: int = 256 * 1024) -> FrameIndex:
    """Parse a container's header + frame table into a :class:`FrameIndex`.

    ``frame_bytes`` must match the encoder's spec (the store's codec
    spec travels with the store; the header deliberately omits it to
    keep frames dense — flags stay reserved for a future v2).
    """
    mv = memoryview(data)
    if len(mv) < _HEADER.size:
        raise IntegrityError(f"container truncated: {len(mv)} < header {_HEADER.size}")
    magic, codec, filt, width, _flags, n_frames, logical_len = _HEADER.unpack(
        bytes(mv[: _HEADER.size])
    )
    if magic != MAGIC:
        raise IntegrityError(f"bad container magic {magic!r}")
    if codec not in (CODEC_ZLIB, CODEC_LZMA):
        raise IntegrityError(f"unknown codec id {codec}")
    if filt not in (FILTER_NONE, FILTER_SHUFFLE, FILTER_DELTA_SHUFFLE):
        raise IntegrityError(f"unknown filter id {filt}")
    if width not in (1, 2, 4, 8):
        raise IntegrityError(f"bad filter width {width}")
    table_end = _HEADER.size + 4 * n_frames
    if len(mv) < table_end:
        raise IntegrityError("container truncated inside frame table")
    expect_frames = (logical_len + frame_bytes - 1) // frame_bytes if logical_len else 0
    if n_frames != expect_frames:
        raise IntegrityError(
            f"frame count {n_frames} inconsistent with logical_len {logical_len} "
            f"at frame_bytes {frame_bytes}"
        )
    lens = struct.unpack(f"<{n_frames}I", bytes(mv[_HEADER.size : table_end]))
    return FrameIndex(
        codec=codec,
        filter=filt,
        width=width,
        frame_bytes=frame_bytes,
        logical_len=logical_len,
        frame_lens=lens,
        data_offset=table_end,
    )


def decode_frames(payload, index: FrameIndex, first: int, last: int,
                  whole: bool | None = None) -> bytes:
    """Decode frames ``[first, last)`` from ``payload``.

    ``payload`` is either the whole container (``whole=True``) or exactly
    the physical span :meth:`FrameIndex.physical_span` names for these
    frames (``whole=False`` — the ranged-read path fetched only that).
    ``None`` infers it from the payload length.
    """
    mv = memoryview(payload)
    if whole is None:
        whole = len(mv) >= index.physical_len
    off = index.physical_span(first, last)[0] if whole else 0
    out: list[bytes] = []
    total = index.logical_len
    fb = index.frame_bytes
    for i in range(first, last):
        enc_len = index.frame_lens[i] & ~RAW_FRAME
        raw = bool(index.frame_lens[i] & RAW_FRAME)
        if off + enc_len > len(mv):
            raise IntegrityError(
                f"container truncated: frame {i} needs {enc_len} bytes at {off}"
            )
        chunk = bytes(mv[off : off + enc_len])
        off += enc_len
        want = min((i + 1) * fb, total) - i * fb
        if raw:
            frame = chunk
        else:
            frame = _undo_filter(_decompress(chunk, index.codec), index.filter, index.width)
        if len(frame) != want:
            raise IntegrityError(
                f"frame {i} decoded to {len(frame)} bytes, expected {want}"
            )
        out.append(frame)
    return b"".join(out)


def decode(data, frame_bytes: int = 256 * 1024) -> tuple[bytes, int]:
    """Decode a whole container → ``(logical bytes, logical CRC32)``.

    The CRC is folded over the output frames as they are produced — the
    no-extra-pass discipline (DESIGN.md §4) applied to decode.
    """
    index = parse_index(data, frame_bytes)
    n = len(index.frame_lens)
    raw = decode_frames(data, index, 0, n)
    if len(raw) != index.logical_len:
        raise IntegrityError(
            f"container decoded to {len(raw)} bytes, header says {index.logical_len}"
        )
    return raw, zlib.crc32(raw)
