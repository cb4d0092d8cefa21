"""BAM writing (BGZF blocks via zlib).

The reference shells out to samtools for BAM production
(reference/src/bam_parsing/bam_generator.rs:485-560); none of those
tools exist here, so the framework carries its own writer.  Used for cached
mapped reads, per-genome BAM splitting, and test fixtures.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from lorikeet_tpu_torch.io.bam import BamRecord, CIGAR_OPS

_SEQ_CODE = {b: i for i, b in enumerate(b"=ACMGRSVTWYHKDBN")}
_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _bgzf_block(payload: bytes) -> bytes:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    data = comp.compress(payload) + comp.flush()
    # BSIZE = total block size minus 1 (SAM spec 4.1): 18 header + 8 footer
    bsize = len(data) + 25
    header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
              + struct.pack("<H", 6)         # XLEN
              + b"BC" + struct.pack("<HH", 2, bsize))
    footer = struct.pack("<II", zlib.crc32(payload), len(payload))
    return header + data + footer


class BgzfWriter:
    def __init__(self, path: str, block_size: int = 60000):
        self._fh = open(path, "wb")
        self._buf = bytearray()
        self._block_size = block_size
        self._coffset = 0             # compressed bytes flushed so far

    def write(self, data: bytes):
        self._buf += data
        while len(self._buf) >= self._block_size:
            blk = _bgzf_block(bytes(self._buf[:self._block_size]))
            self._fh.write(blk)
            self._coffset += len(blk)
            del self._buf[:self._block_size]

    def tell_virtual(self) -> int:
        """BGZF virtual offset (coffset<<16 | uoffset) of the next byte
        written — valid between whole-record writes (SAM spec §4.1.1);
        feeds the .bai built by write_bam."""
        return (self._coffset << 16) | len(self._buf)

    def close(self):
        if self._buf:
            blk = _bgzf_block(bytes(self._buf))
            self._fh.write(blk)
            self._coffset += len(blk)
            self._buf.clear()
        self._fh.write(_BGZF_EOF)
        self._fh.close()


def _encode_record(rec: BamRecord) -> bytes:
    name_b = rec.name.encode() + b"\0"
    l_seq = len(rec.seq)
    cigar_b = b"".join(
        struct.pack("<I", (n << 4) | CIGAR_OPS.index(op)) for op, n in rec.cigar)
    seq_codes = np.array([_SEQ_CODE.get(b, 15) for b in rec.seq.tobytes()], np.uint8)
    if l_seq % 2:
        seq_codes = np.append(seq_codes, 0)
    packed = ((seq_codes[0::2] << 4) | seq_codes[1::2]).astype(np.uint8).tobytes()
    tags_b = b""
    for tag, val in rec.tags.items():
        if isinstance(val, (bool, np.bool_)):
            continue
        if isinstance(val, (int, np.integer)):
            tags_b += tag.encode() + b"i" + struct.pack("<i", int(val))
        elif isinstance(val, (float, np.floating)):
            tags_b += tag.encode() + b"f" + struct.pack("<f", float(val))
        elif isinstance(val, (list, tuple, np.ndarray)):
            # B array round-trip (decoded as a list by _decode_tags);
            # int32 for integer elements, float32 otherwise
            vals = list(val)
            if all(isinstance(x, (int, np.integer)) for x in vals):
                tags_b += (tag.encode() + b"Bi"
                           + struct.pack(f"<i{len(vals)}i", len(vals),
                                         *[int(x) for x in vals]))
            else:
                tags_b += (tag.encode() + b"Bf"
                           + struct.pack(f"<i{len(vals)}f", len(vals),
                                         *[float(x) for x in vals]))
        elif isinstance(val, str) and len(val) == 1 and tag in ("XT",):
            tags_b += tag.encode() + b"A" + val.encode()
        elif isinstance(val, str):
            tags_b += tag.encode() + b"Z" + val.encode() + b"\0"
    body = struct.pack(
        "<iiBBHHHiiii", rec.tid, rec.pos, len(name_b), rec.mapq,
        _reg2bin(rec.pos, rec.reference_end or rec.pos + 1),
        len(rec.cigar), rec.flag, l_seq, rec.mate_tid, rec.mate_pos, rec.tlen)
    body += name_b + cigar_b + packed + rec.qual.astype(np.uint8).tobytes() + tags_b
    return struct.pack("<i", len(body)) + body


def _reg2bin(beg: int, end: int) -> int:
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


def write_bam(path: str, references: list, lengths: list, records,
              header_text: str = None, index: bool = True):
    """Write a BAM (+ its .bai when ``index``, the index_bams.rs:17-80
    finish_bams role).  ``records`` must be coordinate-sorted by (tid, pos)."""
    if header_text is None:
        header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
            f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in zip(references, lengths))
    w = BgzfWriter(path)
    text = header_text.encode()
    head = b"BAM\x01" + struct.pack("<i", len(text)) + text
    head += struct.pack("<i", len(references))
    for n, l in zip(references, lengths):
        nb = n.encode() + b"\0"
        head += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)
    w.write(head)
    if not index:
        for rec in records:
            w.write(_encode_record(rec))
        w.close()
        return
    from lorikeet_tpu_torch.io.bai import RefIndex, write_bai
    refs = [RefIndex() for _ in references]
    n_no_coor = 0
    for rec in records:
        v_beg = w.tell_virtual()
        w.write(_encode_record(rec))
        v_end = w.tell_virtual()
        if rec.tid < 0 or rec.pos < 0:
            n_no_coor += 1
        else:
            refs[rec.tid].add(rec.pos, max(rec.reference_end, rec.pos + 1),
                              v_beg, v_end, unmapped=rec.is_unmapped)
    w.close()
    for r in refs:
        r.finalize()
    write_bai(path + ".bai", refs, n_no_coor)
