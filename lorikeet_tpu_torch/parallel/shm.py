"""A pool worker's pair-HMM batch carried to the parent's device service in
a shared-memory segment, with only a small header on the pipe.

The worker owns one segment (``WorkerSegment``): an anonymous ``memfd``
that it maps, fills with the batch's arrays back to back (each aligned to
:data:`ALIGN` bytes) and announces with a header of each array's key,
dtype, shape and offset.  A new segment's descriptor follows its header on
the same Unix socket (``SCM_RIGHTS``), once; the service keeps it for that
worker's connection (``ServiceSegments``) and maps the batch it describes
only while it enqueues it (``Batch``).  A ``memfd`` has no name and lives
on no mounted file system, so the size of ``/dev/shm`` (often 64 MB in a
container, where a write past it is a ``SIGBUS``) does not bound it.

A span's haplotype SW batch (``"hsw"``: each chunk's packed table and
sequences) travels the same way.

Reuse is safe by the pool's order, not by a lock: a worker has at most one
request outstanding and takes its reply before it sends the next, and the
service replies only after it has copied the batch out of the segment
(``enqueue_grouped_jobs`` pins every array before it returns) and unmapped
it."""
from __future__ import annotations

import mmap
import os
from multiprocessing.reduction import recv_handle, send_handle

import numpy as np

#: every array of a batch starts at a multiple of this many bytes
ALIGN = 64
#: the smallest segment a worker makes, bytes
MIN_BYTES = 1 << 20
#: a new segment's size over the batch that did not fit the old one
GROWTH = 1.5


def _view(mm, dtype, shape, offset) -> np.ndarray:
    """The array at ``offset`` of ``mm``.  ``frombuffer`` holds the
    mapping's buffer while the array lives (``np.ndarray(buffer=...)``
    does not), so ``mm.close()`` refuses to unmap under a live view."""
    count = int(np.prod(shape, dtype=np.int64))
    return np.frombuffer(mm, dtype, count, offset).reshape(shape)


def _layout(arrays) -> tuple:
    """[(key, dtype, shape, offset)] of ``arrays`` [(key, array)] laid out
    back to back at :data:`ALIGN`, and the bytes they span."""
    layout, end = [], 0
    for key, a in arrays:
        off = -(-end // ALIGN) * ALIGN
        layout.append((key, a.dtype.str, a.shape, off))
        end = off + a.nbytes
    return layout, end


class WorkerSegment:
    """A worker's end: the segment it owns, made at its first batch and
    made anew, :data:`GROWTH` times the batch, when one does not fit."""

    def __init__(self):
        self._fd = -1
        self._mm = None
        self._serial = 0

    def send(self, conn, job, tid):
        """``job`` (``prepare_grouped_jobs``' ``(arrays, out_pos)``) into
        the segment, then its header on ``conn`` as ``("lk", header,
        tid)``, and after it a new segment's descriptor."""
        arrays, out_pos = job
        self.put(conn, "lk", arrays, tid, out_pos)

    def put(self, conn, kind, arrays, tid, out_pos=None):
        """The numpy arrays of ``arrays`` into the segment (its other
        values ride in the header's ``extra``), then the header on
        ``conn`` as ``(kind, header, tid)``, and after it a new segment's
        descriptor."""
        entries = [(k, v) for k, v in arrays.items()
                   if isinstance(v, np.ndarray)]
        if out_pos is not None:
            entries.append(("out_pos", out_pos))
        layout, nbytes = _layout(entries)
        new = self._mm is None or nbytes > len(self._mm)
        if new:
            self._grow(nbytes)
        for (_, dtype, shape, off), (_, v) in zip(layout, entries):
            _view(self._mm, dtype, shape, off)[...] = v
        if out_pos is not None:
            layout, out_layout = layout[:-1], layout[-1]
        else:
            out_layout = None
        header = {"segment": (os.getpid(), self._serial),
                  "size": len(self._mm), "new": new, "nbytes": nbytes,
                  "arrays": layout, "out_pos": out_layout,
                  "extra": {k: v for k, v in arrays.items()
                            if not isinstance(v, np.ndarray)}}
        conn.send((kind, header, tid))
        if new:
            send_handle(conn, self._fd, os.getppid())

    def _grow(self, nbytes: int):
        """Drop the old segment (the service drops its descriptor when the
        next header says ``new``) and make one for ``nbytes`` and more."""
        self.close()
        size = max(MIN_BYTES, int(nbytes * GROWTH))
        self._fd = os.memfd_create("lorikeet-lk-batch", os.MFD_CLOEXEC)
        try:
            os.ftruncate(self._fd, size)
            self._mm = mmap.mmap(self._fd, size)
        except BaseException:
            os.close(self._fd)
            self._fd = -1
            raise
        self._serial += 1

    def close(self):
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1


class ServiceSegments:
    """The service's end: for each worker connection, the descriptor and
    size of the segment it last announced.  Holds no mapping between
    batches: a page the parent has mapped counts in its resident set."""

    def __init__(self):
        self._held = {}                  # conn -> (identity, fd, size)

    def receive(self, conn, header) -> "Batch":
        """The batch ``header`` describes, mapped; a new segment's
        descriptor taken from ``conn`` first (EOFError / OSError: the
        worker is gone)."""
        ident = tuple(header["segment"])
        if header["new"]:
            fd = recv_handle(conn)
            self.drop(conn)
            self._held[conn] = (ident, fd, os.fstat(fd).st_size)
            if self._held[conn][2] != header["size"]:
                raise RuntimeError(f"segment {ident} of {header['size']} "
                                   "bytes handed over at another size")
        held = self._held.get(conn)
        if held is None or held[0] != ident:
            raise RuntimeError(f"pair batch in segment {ident}, which its "
                               "worker never handed over")
        _, fd, size = held
        if header["nbytes"] > size:
            raise RuntimeError(f"pair batch of {header['nbytes']} bytes in "
                               f"a segment of {size}")
        try:
            return Batch(fd, header)
        except OSError as err:     # not the worker's end: an error reply
            raise RuntimeError(f"cannot map the pair batch: {err}") from err

    def drop(self, conn):
        """Close the descriptor held for ``conn`` (its worker is gone, or
        announced a new segment)."""
        held = self._held.pop(conn, None)
        if held is not None:
            os.close(held[1])

    def close(self):
        for conn in list(self._held):
            self.drop(conn)


class Batch:
    """One batch mapped from its worker's segment: ``arrays`` (views of
    the segment, the header's ``extra`` beside them) and a pair batch's
    ``out_pos`` (a copy: it is read after the segment is unmapped; None
    for other kinds)."""

    def __init__(self, fd: int, header: dict):
        self._mm = mmap.mmap(fd, max(header["nbytes"], 1),
                             flags=mmap.MAP_SHARED | mmap.MAP_POPULATE)
        self.arrays = dict(header["extra"])
        for key, dtype, shape, off in header["arrays"]:
            self.arrays[key] = _view(self._mm, dtype, shape, off)
        self.out_pos = None if header["out_pos"] is None else _view(
            self._mm, *header["out_pos"][1:]).copy()

    def close(self, strict: bool = True):
        """Unmap.  ``strict``: a view of the segment still alive (kept past
        the enqueue, which the worker's next batch would overwrite) is an
        error; else, on a failed batch whose traceback may hold views, the
        mapping goes with the last of them."""
        self.arrays = None
        try:
            self._mm.close()
        except BufferError:
            if strict:
                raise RuntimeError("a view of a pair batch's segment "
                                   "outlived its enqueue") from None
