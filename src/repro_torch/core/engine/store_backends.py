"""Segmented storage backends for the condensed distance store.

:class:`~repro_torch.core.engine.store.CondensedDistances` used to keep its
``K (K - 1) / 2`` condensed entries as one flat in-RAM ndarray.  That is
the host-RAM wall at the "millions of clients" scale the roadmap targets
(~2 TB of float32 at K = 10^6), and it made every admission an O(K^2)
re-concatenation.  This module splits the storage layer behind a small
backend interface over **column-range segments** of the condensed vector
(column ``j``'s entries are contiguous at flat offset ``j (j - 1) / 2``,
so any column range ``[c0, c1)`` is one contiguous flat slice):

:class:`RamSegments`
    The whole vector in one growable RAM buffer with geometric capacity
    growth — admission appends into spare tail capacity (amortized
    O(B * K) per admit instead of the old full-vector copy).
:class:`SpilledSegments`
    Cold column-range segments flushed to an append-only spill file and
    memory-mapped read-only; only a hot tail segment (the most recently
    admitted columns) lives in RAM.  Reads fault cold segments in one at
    a time and release them (``madvise(DONTNEED)``) past a residency
    budget, so peak RSS is bounded by the byte budget, not by K.

Both backends hold bitwise-identical float32 values, so every consumer
(row gathers, the HC working matrix, the dendrogram replay) produces
bitwise-identical labels regardless of backend — the repo's cross-tier
parity contract extends to the ``spilled`` memory tier unchanged.

Fork semantics (``fork``): cold segments are immutable once flushed, so
forks share the mmap'd spill file read-only and diverge on append — each
fork flushes its *own* new segments to fresh regions of the shared
append-only file (no double-flush, no cross-fork corruption).  The file
is unlinked when the last backend referencing it is garbage collected.

This module is the only non-test code allowed to touch segment files
(``np.memmap`` / ``mmap``) directly — enforced by repro-lint R3.
"""
from __future__ import annotations

import mmap
import os
import tempfile
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


def _tri(n: int) -> int:
    """Triangular count n(n-1)/2 — flat offset of column ``n``'s block."""
    return n * (n - 1) // 2


@dataclass(frozen=True)
class Segment:
    """One contiguous column-range slice of the condensed vector.

    Covers columns ``[col0, col1)``, i.e. flat offsets
    ``[base, base + values.size)`` with ``base == tri(col0)``.  ``values``
    may be a RAM view or a read-only memory-mapped slice; consumers copy
    out of it and must iterate segments one at a time (bounded residency).
    """

    col0: int
    col1: int
    base: int
    values: np.ndarray


def _release_mapping(arr: np.ndarray) -> None:
    """Drop a cold segment's resident pages (``madvise(MADV_DONTNEED)``).

    Read-only file-backed mappings re-fault from the page cache / disk on
    the next access, so this only trades latency for RSS — values are
    unaffected (bitwise parity is storage-independent).
    """
    mm = getattr(arr, "_mmap", None)
    if mm is None:
        return
    try:
        mm.madvise(mmap.MADV_DONTNEED)
    except (AttributeError, OSError, ValueError):
        pass  # platform without madvise: residency becomes advisory


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


class _SpillFile:
    """Append-only on-disk home of cold segments, shared across forks.

    Every flush appends a fresh region and records its own offset, so
    forks sharing the file can spill independently without coordinating —
    regions are write-once.  The file is unlinked when the last backend
    referencing this object is collected.
    """

    def __init__(self, spill_dir: Optional[str] = None):
        fd, path = tempfile.mkstemp(
            prefix="repro-spill-", suffix=".seg", dir=spill_dir
        )
        os.close(fd)
        self.path = path
        self.size = 0
        self._finalizer = weakref.finalize(self, _unlink_quiet, path)

    def append(self, arr: np.ndarray) -> int:
        """Write ``arr``'s bytes at the end of the file; return the offset."""
        off = self.size
        with open(self.path, "r+b") as f:
            f.seek(off)
            f.write(arr.tobytes())
        self.size = off + arr.nbytes
        return off


class RamSegments:
    """All-RAM backend: one buffer, geometric capacity growth at the tail.

    The degenerate one-segment case of the segmented layout.  ``append``
    writes whole column blocks into spare capacity and only reallocates
    when the buffer is full (capacity doubles), so a stream of admissions
    costs amortized O(entries appended) instead of the old
    O(K^2)-copy-per-admit re-concatenation.  ``reallocs`` /
    ``copied_elems`` expose the growth behavior for the regression test.
    """

    def __init__(self):
        self._buf = np.zeros(0, dtype=np.float32)
        self._len = 0
        self.cols = 0
        self.reallocs = 0
        self.copied_elems = 0

    @classmethod
    def from_values(cls, values: np.ndarray, ncols: int) -> "RamSegments":
        """Adopt an existing flat condensed vector (no copy until growth)."""
        b = cls()
        values = np.asarray(values, dtype=np.float32)
        b._buf = values
        b._len = int(values.size)
        b.cols = int(ncols)
        return b

    @classmethod
    def from_backend(cls, other) -> "RamSegments":
        """Materialize another backend's contents segment by segment."""
        b = cls()
        b._reserve(other.size)
        for seg in other.segments():
            b.append(seg.values, seg.col1 - seg.col0)
        return b

    # -- introspection ------------------------------------------------------

    @property
    def size(self) -> int:
        """Flat condensed entries currently held."""
        return self._len

    @property
    def nbytes(self) -> int:
        """Logical condensed bytes (excludes spare tail capacity)."""
        return 4 * self._len

    @property
    def resident_nbytes(self) -> int:
        """RAM actually held (includes the geometric spare capacity)."""
        return int(self._buf.nbytes)

    @property
    def spilled_nbytes(self) -> int:
        """On-disk bytes — always 0 for the RAM backend."""
        return 0

    # -- reads --------------------------------------------------------------

    def reader(self):
        """Flat source for :func:`repro_torch.core.hc.condensed_row_gather` —
        the raw ndarray view (the fast single-segment path)."""
        return self._buf[: self._len]

    def materialize(self) -> np.ndarray:
        """The full flat vector as one ndarray (a view for this backend)."""
        return self._buf[: self._len]

    def gather_flat(self, flat: np.ndarray) -> np.ndarray:
        """Fancy-gather float32 values at flat condensed offsets."""
        return self._buf[: self._len][np.asarray(flat, dtype=np.int64)]

    def get_flat(self, t: int) -> float:
        """Single flat-offset read."""
        return float(self._buf[int(t)])

    def segments(self) -> Iterator[Segment]:
        """Yield the (single) column-range segment covering everything."""
        yield Segment(0, self.cols, 0, self._buf[: self._len])

    # -- mutation -----------------------------------------------------------

    def _reserve(self, total: int) -> None:
        if total <= self._buf.size:
            return
        cap = max(2 * self._buf.size, int(total))
        buf = np.empty(cap, dtype=np.float32)
        buf[: self._len] = self._buf[: self._len]
        self.copied_elems += self._len
        self._buf = buf
        self.reallocs += 1

    def append(self, flat_vals: np.ndarray, ncols: int) -> None:
        """Append ``ncols`` whole column blocks (one contiguous flat run)."""
        flat_vals = np.asarray(flat_vals, dtype=np.float32)
        want = _tri(self.cols + ncols) - _tri(self.cols)
        if flat_vals.size != want:
            raise ValueError(
                f"append of {ncols} columns onto {self.cols} needs {want} "
                f"entries, got {flat_vals.size}"
            )
        end = self._len + flat_vals.size
        self._reserve(end)
        self._buf[self._len : end] = flat_vals
        self._len = end
        self.cols += int(ncols)

    def fork(self) -> "RamSegments":
        """Independent copy (trimmed to the live length)."""
        b = RamSegments()
        b._buf = self._buf[: self._len].copy()
        b._len = self._len
        b.cols = self.cols
        return b


@dataclass
class _ColdSeg:
    """A flushed, immutable, memory-mapped column-range segment."""

    col0: int
    col1: int
    base: int
    values: np.ndarray  # np.memmap, read-only
    nbytes: int


class SpilledSegments:
    """Cold mmap'd segments + RAM hot tail, under a byte budget.

    The byte budget is split in half: the hot tail (most recently admitted
    columns, append target) is flushed to the spill file once it exceeds
    ``budget // 2``, in chunks of at most ``seg_cols`` columns; cold reads
    track per-segment residency in an LRU and release
    (``madvise(DONTNEED)``) the least-recently-read segments past the
    other half.  Invariant (sanitize rule S4 checks it at runtime): cold
    resident bytes never exceed ``cold_budget`` plus the one segment
    currently being read — so peak RSS tracks the budget, not K.

    Values are bitwise the same float32s the RAM backend holds; only
    where they live differs, so labels are unaffected (parity contract).
    """

    def __init__(
        self,
        *,
        budget: int,
        seg_cols: int,
        spill_dir: Optional[str] = None,
        spill_file: Optional[_SpillFile] = None,
    ):
        self.budget = max(8, int(budget))
        self.seg_cols = max(1, int(seg_cols))
        self._file = spill_file if spill_file is not None else _SpillFile(spill_dir)
        self._cold: list[_ColdSeg] = []
        self._ends = np.zeros(0, dtype=np.int64)  # flat end offset per cold seg
        self._cold_size = 0      # flat entries flushed cold
        self._hot = np.zeros(0, dtype=np.float32)
        self._hot_len = 0
        self._hot_col0 = 0       # first column still hot
        self.cols = 0
        self._resident = OrderedDict()  # cold seg index -> nbytes (LRU)
        self._resident_bytes = 0
        self.cold_reads = 0
        self.flushes = 0
        self.reallocs = 0
        self.copied_elems = 0

    @classmethod
    def from_backend(
        cls,
        other,
        *,
        budget: int,
        seg_cols: int,
        spill_dir: Optional[str] = None,
    ) -> "SpilledSegments":
        """Adopt another backend's contents, spilling as the budget demands
        (streamed segment by segment — never a second full-RAM copy)."""
        b = cls(budget=budget, seg_cols=seg_cols, spill_dir=spill_dir)
        for seg in other.segments():
            b.append(seg.values, seg.col1 - seg.col0)
        return b

    # -- introspection ------------------------------------------------------

    @property
    def size(self) -> int:
        """Flat condensed entries currently held (cold + hot)."""
        return self._cold_size + self._hot_len

    @property
    def nbytes(self) -> int:
        """Logical condensed bytes (cold + hot)."""
        return 4 * self.size

    @property
    def resident_nbytes(self) -> int:
        """RAM held right now: hot tail buffer + resident cold pages."""
        return int(self._hot.nbytes) + self._resident_bytes

    @property
    def spilled_nbytes(self) -> int:
        """Bytes living in the spill file (cold segments)."""
        return 4 * self._cold_size

    @property
    def cold_budget(self) -> int:
        """Residency budget for cold-segment pages."""
        return max(4, self.budget // 2)

    @property
    def hot_budget(self) -> int:
        """Flush threshold for the RAM hot tail."""
        return max(4, self.budget - self.budget // 2)

    @property
    def cold_resident_bytes(self) -> int:
        """Cold bytes currently accounted resident (LRU tracked)."""
        return self._resident_bytes

    @property
    def max_segment_nbytes(self) -> int:
        """Largest single cold segment (the S4 residency-bound slack)."""
        return max((s.nbytes for s in self._cold), default=0)

    @property
    def spill_path(self) -> str:
        """Path of the shared append-only spill file."""
        return self._file.path

    @property
    def _hot_base(self) -> int:
        return _tri(self._hot_col0)

    # -- cold residency -----------------------------------------------------

    def _touch(self, k: int) -> None:
        """Mark cold segment ``k`` read; evict LRU segments past budget."""
        seg = self._cold[k]
        self.cold_reads += 1
        if self._resident.pop(k, None) is None:
            self._resident_bytes += seg.nbytes
        self._resident[k] = seg.nbytes
        self._evict()

    def _evict(self) -> None:
        # the segment just touched sits at the LRU tail, so it is released
        # last — the residency bound is cold_budget + one in-flight segment
        while self._resident_bytes > self.cold_budget and len(self._resident) > 1:
            k0, nb = next(iter(self._resident.items()))
            del self._resident[k0]
            self._resident_bytes -= nb
            _release_mapping(self._cold[k0].values)

    # -- reads --------------------------------------------------------------

    def reader(self):
        """Flat source for :func:`repro_torch.core.hc.condensed_row_gather` —
        the backend itself (segment-aware ``gather_flat``)."""
        return self

    def gather_flat(self, flat: np.ndarray) -> np.ndarray:
        """Fancy-gather float32 values at flat condensed offsets.

        Iterates the touched segments one at a time (ascending), so no
        more than one cold segment is faulted in per step and residency
        stays under ``cold_budget`` + one segment.  Values are bitwise
        what the RAM backend would return.
        """
        flat = np.asarray(flat, dtype=np.int64)
        fr = flat.ravel()
        out = np.empty(fr.size, dtype=np.float32)
        ncold = len(self._cold)
        sid = (
            np.searchsorted(self._ends, fr, side="right")
            if ncold
            else np.zeros(fr.size, dtype=np.int64)
        )
        hot = self._hot[: self._hot_len]
        for k in np.unique(sid):
            sel = sid == k
            if k >= ncold:
                out[sel] = hot[fr[sel] - self._hot_base]
            else:
                seg = self._cold[k]
                self._touch(int(k))
                out[sel] = seg.values[fr[sel] - seg.base]
        return out.reshape(flat.shape)

    def get_flat(self, t: int) -> float:
        """Single flat-offset read (routes through residency accounting)."""
        t = int(t)
        if t >= self._hot_base:
            return float(self._hot[t - self._hot_base])
        k = int(np.searchsorted(self._ends, t, side="right"))
        self._touch(k)
        seg = self._cold[k]
        return float(seg.values[t - seg.base])

    def segments(self) -> Iterator[Segment]:
        """Yield cold segments (ascending, residency-accounted) then the
        hot tail — consumers copying sequentially fault at most one cold
        segment past the residency budget at any instant."""
        for k, seg in enumerate(self._cold):
            self._touch(k)
            yield Segment(seg.col0, seg.col1, seg.base, seg.values)
        if self._hot_len:
            yield Segment(
                self._hot_col0, self.cols, self._hot_base,
                self._hot[: self._hot_len],
            )

    def materialize(self) -> np.ndarray:
        """Full flat vector as one RAM ndarray — the escape hatch the
        spilled tier exists to avoid; sanitize rule S4 forbids it outside
        ``allow_dense()`` while armed."""
        out = np.empty(self.size, dtype=np.float32)
        for seg in self.segments():
            out[seg.base : seg.base + seg.values.size] = seg.values
        return out

    # -- mutation -----------------------------------------------------------

    def _reserve(self, total: int) -> None:
        if total <= self._hot.size:
            return
        cap = max(2 * self._hot.size, int(total))
        buf = np.empty(cap, dtype=np.float32)
        buf[: self._hot_len] = self._hot[: self._hot_len]
        self.copied_elems += self._hot_len
        self._hot = buf
        self.reallocs += 1

    def append(self, flat_vals: np.ndarray, ncols: int) -> None:
        """Append ``ncols`` whole column blocks to the hot tail, flushing
        cold segments once the tail exceeds its half of the budget."""
        flat_vals = np.asarray(flat_vals, dtype=np.float32)
        want = _tri(self.cols + ncols) - _tri(self.cols)
        if flat_vals.size != want:
            raise ValueError(
                f"append of {ncols} columns onto {self.cols} needs {want} "
                f"entries, got {flat_vals.size}"
            )
        end = self._hot_len + flat_vals.size
        self._reserve(end)
        self._hot[self._hot_len : end] = flat_vals
        self._hot_len = end
        self.cols += int(ncols)
        self._maybe_flush()

    def _maybe_flush(self) -> None:
        if 4 * self._hot_len <= self.hot_budget:
            return
        c0, off = self._hot_col0, 0
        while c0 < self.cols:
            c1 = min(c0 + self.seg_cols, self.cols)
            count = _tri(c1) - _tri(c0)
            if count:
                chunk = self._hot[off : off + count]
                file_off = self._file.append(chunk)
                arr = np.memmap(  # repro-lint: ignore[R3]  # port of src/repro/core/engine/store_backends.py, allowlisted there
                    self._file.path, dtype=np.float32, mode="r",
                    offset=file_off, shape=(count,),
                )
                self._cold.append(
                    _ColdSeg(c0, c1, _tri(c0), arr, 4 * count)
                )
                self.flushes += 1
                off += count
            c0 = c1
        self._cold_size += off
        self._hot_len = 0
        self._hot_col0 = self.cols
        self._hot = np.zeros(0, dtype=np.float32)
        self._ends = np.array(
            [s.base + s.nbytes // 4 for s in self._cold], dtype=np.int64
        )

    def fork(self) -> "SpilledSegments":
        """Fork sharing the cold segments read-only (same mmaps, same
        spill file) and copying only the hot tail — appends diverge: each
        fork flushes its own new regions of the shared append-only file,
        so nothing is flushed twice and forks cannot corrupt each other."""
        b = SpilledSegments(
            budget=self.budget, seg_cols=self.seg_cols, spill_file=self._file
        )
        b._cold = list(self._cold)
        b._ends = self._ends
        b._cold_size = self._cold_size
        b._hot = self._hot[: self._hot_len].copy()
        b._hot_len = self._hot_len
        b._hot_col0 = self._hot_col0
        b.cols = self.cols
        b._resident = OrderedDict(self._resident)
        b._resident_bytes = self._resident_bytes
        return b
