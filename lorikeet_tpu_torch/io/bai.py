"""BAI (BAM index) read / write / build + BGZF block-range decompression.

The reference streams every region fetch through htslib's indexed reader
(reference/src/bam_parsing/bam_generator.rs:48 IndexedNamedBamReader;
per-chunk fetch at haplotype_caller_engine.rs:675-725) and builds .bai files
when finishing mapping pipelines (index_bams.rs:17-80 via samtools/htslib).
No htslib exists in this environment, so the framework carries its own index
implementation per the SAM spec §5.2 (UCSC binning) and §4.1.1 (BGZF virtual
file offsets: coffset<<16 | uoffset).

Used by io.bam.StreamingBamReader (O(chunk) region fetches on multi-GB BAMs)
and io.bam_writer.write_bam (index-on-write, the finish_bams role).
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

#: 16 kb linear-index window shift (SAM spec §5.1.3)
LINEAR_SHIFT = 14
#: samtools metadata pseudo-bin id
PSEUDO_BIN = 37450
#: max bin id + 1 for the 5-level 512Mb binning scheme
MAX_BIN = ((1 << 18) - 1) // 7 + 1


def reg2bin(beg: int, end: int) -> int:
    """Smallest bin containing [beg, end) (SAM spec §5.3 C snippet)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> list:
    """All bins that may hold records overlapping [beg, end)."""
    end -= 1
    out = [0]
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        out.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return out


class RefIndex:
    """One reference's index: bins -> chunk list, plus the linear index."""

    __slots__ = ("bins", "ioffset", "n_mapped", "n_unmapped",
                 "off_beg", "off_end")

    def __init__(self):
        self.bins: dict = {}          # bin id -> [(chunk_beg, chunk_end)]
        self.ioffset: list = []       # 16kb-window -> min virtual offset
        self.n_mapped = 0
        self.n_unmapped = 0
        self.off_beg = 0              # first/last record voffsets (metadata)
        self.off_end = 0

    def add(self, beg: int, end: int, v_beg: int, v_end: int,
            unmapped: bool = False):
        """Account one record at [beg, end) stored at [v_beg, v_end)."""
        if unmapped:
            self.n_unmapped += 1
        else:
            self.n_mapped += 1
        if self.off_beg == 0:
            self.off_beg = v_beg
        self.off_end = v_end
        b = reg2bin(beg, max(end, beg + 1))
        chunks = self.bins.setdefault(b, [])
        # merge with the previous chunk when contiguous in the file — the
        # standard htslib coalescing that keeps chunk lists short
        if chunks and chunks[-1][1] == v_beg:
            chunks[-1] = (chunks[-1][0], v_end)
        else:
            chunks.append((v_beg, v_end))
        w0 = beg >> LINEAR_SHIFT
        w1 = max(end - 1, beg) >> LINEAR_SHIFT
        if len(self.ioffset) <= w1:
            self.ioffset.extend([0] * (w1 + 1 - len(self.ioffset)))
        for w in range(w0, w1 + 1):
            if self.ioffset[w] == 0 or v_beg < self.ioffset[w]:
                self.ioffset[w] = v_beg

    def finalize(self):
        """Fill linear-index gaps with the preceding value (htslib save)."""
        last = 0
        for i, v in enumerate(self.ioffset):
            if v == 0:
                self.ioffset[i] = last
            else:
                last = v

    def min_offset(self, beg: int) -> int:
        w = beg >> LINEAR_SHIFT
        if not self.ioffset:
            return 0
        return self.ioffset[min(w, len(self.ioffset) - 1)]

    def query(self, beg: int, end: int) -> list:
        """Merged, sorted (chunk_beg, chunk_end) list covering records that
        may overlap [beg, end), pruned by the linear index."""
        min_off = self.min_offset(beg)
        chunks = []
        for b in reg2bins(beg, end):
            for c_beg, c_end in self.bins.get(b, ()):
                if c_end > min_off:
                    chunks.append((max(c_beg, min_off), c_end))
        chunks.sort()
        merged = []
        for c in chunks:
            if merged and c[0] <= merged[-1][1]:
                if c[1] > merged[-1][1]:
                    merged[-1] = (merged[-1][0], c[1])
            else:
                merged.append(c)
        return merged


def write_bai(path: str, refs: list, n_no_coor: int = 0):
    """Write a .bai for per-reference RefIndex objects (SAM spec §5.2)."""
    with open(path, "wb") as fh:
        fh.write(b"BAI\x01" + struct.pack("<i", len(refs)))
        for r in refs:
            bins = {b: c for b, c in sorted(r.bins.items()) if c}
            n_bin = len(bins) + (1 if (r.n_mapped or r.n_unmapped) else 0)
            fh.write(struct.pack("<i", n_bin))
            for b, chunks in bins.items():
                fh.write(struct.pack("<Ii", b, len(chunks)))
                for c_beg, c_end in chunks:
                    fh.write(struct.pack("<QQ", c_beg, c_end))
            if r.n_mapped or r.n_unmapped:
                # samtools metadata pseudo-bin: file span + mapped/unmapped
                fh.write(struct.pack("<Ii", PSEUDO_BIN, 2))
                fh.write(struct.pack("<QQ", r.off_beg, r.off_end))
                fh.write(struct.pack("<QQ", r.n_mapped, r.n_unmapped))
            fh.write(struct.pack("<i", len(r.ioffset)))
            for v in r.ioffset:
                fh.write(struct.pack("<Q", v))
        fh.write(struct.pack("<Q", n_no_coor))


def read_bai(path: str) -> list:
    """Load a .bai into per-reference RefIndex objects."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"BAI\x01":
        raise ValueError(f"{path}: not a BAI file")
    n_ref = struct.unpack_from("<i", data, 4)[0]
    p = 8
    refs = []
    for _ in range(n_ref):
        r = RefIndex()
        n_bin = struct.unpack_from("<i", data, p)[0]
        p += 4
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", data, p)
            p += 8
            chunks = []
            for _ in range(n_chunk):
                chunks.append(struct.unpack_from("<QQ", data, p))
                p += 16
            if b == PSEUDO_BIN:
                if len(chunks) == 2:
                    r.off_beg, r.off_end = chunks[0]
                    r.n_mapped, r.n_unmapped = chunks[1]
            else:
                r.bins[b] = chunks
        n_intv = struct.unpack_from("<i", data, p)[0]
        p += 4
        r.ioffset = list(struct.unpack_from(f"<{n_intv}Q", data, p))
        p += 8 * n_intv
        refs.append(r)
    return refs


# ---------------------------------------------------------------------------
# BGZF block machinery


def _block_size_at(buf: bytes, off: int) -> int:
    """Total compressed size of the BGZF block starting at off (parses the
    gzip extra field for the BC subfield; SAM spec §4.1)."""
    if buf[off:off + 2] != b"\x1f\x8b":
        raise ValueError("not a BGZF block")
    xlen = struct.unpack_from("<H", buf, off + 10)[0]
    p = off + 12
    end = p + xlen
    while p < end:
        si1, si2, slen = struct.unpack_from("<BBH", buf, p)
        if si1 == 0x42 and si2 == 0x43 and slen == 2:       # 'BC'
            return struct.unpack_from("<H", buf, p + 4)[0] + 1
        p += 4 + slen
    raise ValueError("BGZF block missing BC subfield")


def _inflate_block(buf: bytes, off: int, bsize: int) -> bytes:
    xlen = struct.unpack_from("<H", buf, off + 10)[0]
    cdata = buf[off + 12 + xlen:off + bsize - 8]
    return zlib.decompress(cdata, -15)


class BgzfFile:
    """Random-access BGZF reader over an open file: decompress exactly the
    blocks covering a virtual-offset range (O(range), not O(file))."""

    #: per-block read-ahead when scanning sequentially
    _READ = 1 << 20

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        self._fh.seek(0, os.SEEK_END)
        self.size = self._fh.tell()
        self._cache: dict = {}        # coffset -> (bsize, payload)

    def close(self):
        self._fh.close()

    def _read_at(self, off: int, n: int) -> bytes:
        self._fh.seek(off)
        return self._fh.read(n)

    def block(self, coffset: int):
        """(bsize, payload) of the block at compressed offset coffset."""
        hit = self._cache.get(coffset)
        if hit is not None:
            return hit
        head = self._read_at(coffset, 18)
        if len(head) < 18:
            raise EOFError(f"{self.path}: truncated BGZF block")
        bsize = _block_size_at(head, 0)
        raw = head + self._read_at(coffset + 18, bsize - 18)
        payload = _inflate_block(raw, 0, bsize)
        if len(self._cache) > 64:
            self._cache.clear()
        self._cache[coffset] = (bsize, payload)
        return bsize, payload

    def read_voffset_range(self, v_beg: int, v_end: int) -> bytes:
        """Uncompressed bytes of the virtual-offset range [v_beg, v_end)."""
        c_beg, u_beg = v_beg >> 16, v_beg & 0xFFFF
        c_end, u_end = v_end >> 16, v_end & 0xFFFF
        parts = []
        coff = c_beg
        while coff < c_end or (coff == c_end and u_end > 0):
            bsize, payload = self.block(coff)
            lo = u_beg if coff == c_beg else 0
            hi = u_end if coff == c_end else len(payload)
            parts.append(payload[lo:hi])
            if coff == c_end:
                break
            coff += bsize
            if coff >= self.size:
                break
        return b"".join(parts)

    def blocks_from(self, coffset: int):
        """Yield (coffset, payload) for consecutive blocks from coffset."""
        while coffset < self.size:
            bsize, payload = self.block(coffset)
            yield coffset, payload
            coffset += bsize


# ---------------------------------------------------------------------------
# Index construction by scanning an existing BAM (the `samtools index` role)

_REF_CONSUMING = frozenset(b"MDN=X")
_CIGAR_OPS = b"MIDNSHP=X"


def build_bai(bam_path: str, bai_path: str = None) -> str:
    """Scan a coordinate-sorted BAM and write its .bai (index_bams.rs:17-80
    finish_bams role; equivalent of `samtools index`).  One sequential pass;
    memory is O(one record + index)."""
    bai_path = bai_path or bam_path + ".bai"
    bg = BgzfFile(bam_path)
    try:
        refs, n_no_coor = _scan_records(bg)
    finally:
        bg.close()
    for r in refs:
        r.finalize()
    tmp = bai_path + ".tmp"
    write_bai(tmp, refs, n_no_coor)
    os.replace(tmp, bai_path)
    return bai_path


def _scan_records(bg: BgzfFile):
    """Walk every record tracking virtual offsets; returns (refs, n_no_coor)."""
    blocks = bg.blocks_from(0)
    buf = bytearray()
    # block boundaries inside buf: (buf_offset, coffset); buf is compacted
    # to the current record start, bounds rebased accordingly
    bounds: list = []

    def pull() -> bool:
        try:
            coff, payload = next(blocks)
        except StopIteration:
            return False
        bounds.append((len(buf), coff))
        buf.extend(payload)
        return True

    def voffset_at(o: int) -> int:
        # bounds is short (compaction keeps only the live tail)
        for b_off, coff in reversed(bounds):
            if o >= b_off:
                return (coff << 16) | (o - b_off)
        raise AssertionError("offset before retained window")

    while not buf:
        if not pull():
            raise ValueError(f"{bg.path}: empty BGZF stream")
    if bytes(buf[:4]) != b"BAM\x01":
        raise ValueError(f"{bg.path}: not a BAM file")
    while len(buf) < 12:
        pull()
    l_text = struct.unpack_from("<i", buf, 4)[0]
    while len(buf) < 8 + l_text + 4:
        pull()
    p = 8 + l_text
    n_ref = struct.unpack_from("<i", buf, p)[0]
    p += 4
    for _ in range(n_ref):
        while len(buf) < p + 8:
            pull()
        l_name = struct.unpack_from("<i", buf, p)[0]
        while len(buf) < p + 8 + l_name:
            pull()
        p += 8 + l_name
    refs = [RefIndex() for _ in range(n_ref)]
    n_no_coor = 0

    while True:
        # compact: drop consumed bytes, rebase block bounds (a block of
        # payload length L covers [b, b+L); L <= 65536, so any bound with
        # b + 65536 <= p cannot contain a live offset)
        if p > 0:
            del buf[:p]
            bounds = [(b - p, c) for b, c in bounds if b + 65536 > p]
            p = 0
        while len(buf) < 4:
            if not pull():
                return refs, n_no_coor
        block_size = struct.unpack_from("<i", buf, 0)[0]
        while len(buf) < 4 + block_size:
            if not pull():
                raise ValueError(f"{bg.path}: truncated record")
        v_beg = voffset_at(0)
        # end voffset = one past the record.  A record ending exactly at a
        # block boundary is addressed as (next_block << 16 | 0) — the same
        # convention BgzfWriter.tell_virtual produces, so scan-built and
        # written-inline indexes are byte-identical.
        v_end_off = 4 + block_size
        nb = next((c for b, c in bounds if b == v_end_off), None)
        if nb is None and v_end_off == len(buf) and pull():
            nb = next((c for b, c in bounds if b == v_end_off), None)
            if nb is not None and len(buf) == v_end_off:
                # the "next block" is the empty EOF sentinel: the record is
                # the file's last and the writer addressed its end inside
                # the final data block — do the same
                nb = None
        if nb is not None:
            v_end = nb << 16
        else:
            v_end = voffset_at(v_end_off - 1) + 1
        (tid, pos, l_read_name, _mapq, _bin, n_cigar, flag,
         _l_seq) = struct.unpack_from("<iiBBHHHi", buf, 4)
        if tid < 0 or pos < 0:
            n_no_coor += 1
        else:
            ref_len = 0
            cp = 4 + 32 + l_read_name
            for k in range(n_cigar):
                v = struct.unpack_from("<I", buf, cp + 4 * k)[0]
                if _CIGAR_OPS[v & 0xF] in _REF_CONSUMING:
                    ref_len += v >> 4
            refs[tid].add(pos, pos + max(ref_len, 1), v_beg, v_end,
                          unmapped=bool(flag & 0x4))
        p = v_end_off
