"""FASTA (+ .fai), BAM (BGZF) and BAI writers over whole arrays of records.

A frozen, vectorised rewrite of the port's ``io/bam_writer.py`` and the
index that ``io/bai.py`` writes (SAM spec sections 4.2 and 5.2): the
records are laid out with array operations, the BGZF blocks compress on a
few threads, and the index comes from the records' virtual offsets.
"""
from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench.gen.reads import Reads, offsets

#: uncompressed bytes a BGZF block (htslib's 0xff00)
BLOCK = 0xFF00
LEVEL = 6
THREADS = 8
EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
PSEUDO_BIN = 37450
#: 4-bit BAM codes of the bases ("=ACMGRSVTWYHKDBN"), N for any other byte
SEQ_CODE = np.full(256, 15, np.uint8)
for _i, _b in enumerate(b"=ACMGRSVTWYHKDBN"):
    SEQ_CODE[_b] = _i
NAME_DIGITS = 9
HEAD = np.dtype([("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
                 ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                 ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
                 ("next_ref_id", "<i4"), ("next_pos", "<i4"),
                 ("tlen", "<i4")])


def write_fasta(path: str, contigs: list, width: int = 80):
    """``contigs`` [(name, u8 sequence)] as FASTA records, ``width`` bases
    a line, and the .fai beside it."""
    fai, at_byte = [], 0
    with open(path, "wb") as fh:
        for name, seq in contigs:
            n = seq.size
            rows = -(-n // width)
            text = np.full(rows * (width + 1), ord("\n"), np.uint8)
            at = np.arange(n)
            text[at // width * (width + 1) + at % width] = seq
            head = f">{name}\n".encode()
            fh.write(head)
            fh.write(text[:n + rows].tobytes())
            fai.append(f"{name}\t{n}\t{at_byte + len(head)}\t{width}\t"
                       f"{width + 1}\n")
            at_byte += len(head) + n + rows
    with open(path + ".fai", "w") as fh:
        fh.writelines(fai)


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """Smallest UCSC bin holding [beg, end), per record (SAM spec 5.3)."""
    end = end - 1
    out = np.zeros(beg.size, np.int64)
    done = np.zeros(beg.size, bool)
    for shift, first in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & (beg >> shift == end >> shift)
        out[hit] = first + (beg[hit] >> shift)
        done |= hit
    return out


def _padded(flat: np.ndarray, lens: np.ndarray, width: int) -> np.ndarray:
    """Ragged rows (``lens`` each, end to end in ``flat``) as a zero-padded
    [rows, width] array."""
    if lens.size and (lens == width).all():
        return flat.reshape(lens.size, width)
    out = np.zeros((lens.size, width), flat.dtype)
    out[np.arange(width)[None, :] < lens[:, None]] = flat
    return out


def _records(reads: Reads, sample: str) -> tuple:
    """The records end to end as bytes, and each record's start in them.
    Each record is laid out in a padded row (its CIGAR, bases and
    qualities at their widest) and the padding masked out."""
    n = len(reads)
    if not n:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)
    tag = np.frombuffer(f"RGZ{sample}\0".encode(), np.uint8)
    seq_bytes = (reads.seq_len + 1) // 2
    l_name = NAME_DIGITS + 2                      # "r" + digits + NUL
    size = (HEAD.itemsize + l_name + 4 * reads.n_cigar + seq_bytes
            + reads.seq_len + tag.size)

    head = np.zeros(n, HEAD)
    head["block_size"] = size - 4
    head["ref_id"] = reads.tid
    head["pos"] = reads.pos
    head["l_read_name"] = l_name
    head["mapq"] = reads.mapq
    head["bin"] = reg2bin(reads.pos, reads.pos + np.maximum(reads.ref_len, 1))
    head["n_cigar"] = reads.n_cigar
    head["flag"] = reads.flag
    head["l_seq"] = reads.seq_len
    head["next_ref_id"] = np.where(reads.mate_pos >= 0, reads.tid, -1)
    head["next_pos"] = reads.mate_pos
    head["tlen"] = reads.tlen
    digits = (reads.name[:, None] // 10 ** np.arange(NAME_DIGITS - 1, -1, -1)
              % 10 + ord("0")).astype(np.uint8)
    name = np.concatenate([np.full((n, 1), ord("r"), np.uint8), digits,
                           np.zeros((n, 1), np.uint8)], axis=1)
    n_cig = int(reads.n_cigar.max())
    cigar = _padded(reads.cigar, reads.n_cigar, n_cig).view(np.uint8)
    width = int(reads.seq_len.max())
    codes = _padded(SEQ_CODE[reads.seq], reads.seq_len, width + width % 2)
    packed = (codes[:, 0::2] << 4) | codes[:, 1::2]
    qual = np.full((n, width), reads.qual, np.uint8)
    parts = (head.view(np.uint8).reshape(n, HEAD.itemsize), name, cigar,
             packed, qual, np.broadcast_to(tag, (n, tag.size)))
    used = (None, None, 4 * reads.n_cigar, seq_bytes, reads.seq_len, None)
    rows = np.concatenate(parts, axis=1)
    keep = np.concatenate([
        np.ones((n, p.shape[1]), bool) if u is None
        else np.arange(p.shape[1])[None, :] < u[:, None]
        for p, u in zip(parts, used)], axis=1)
    return rows[keep], offsets(size)


def _bgzf_block(payload: bytes) -> bytes:
    comp = zlib.compressobj(LEVEL, zlib.DEFLATED, -15)
    data = comp.compress(payload) + comp.flush()
    header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
              + struct.pack("<H", 6) + b"BC"
              + struct.pack("<HH", 2, len(data) + 25))
    return header + data + struct.pack("<II", zlib.crc32(payload),
                                       len(payload))


def write_bam(path: str, contigs: list, reads: Reads, sample: str):
    """``reads`` (coordinate-sorted) as a BAM over ``contigs`` [(name,
    length)], read group ``sample``, with its .bai beside it."""
    text = ("@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{name}\tLN:{length}\n" for name, length in contigs)
        + f"@RG\tID:{sample}\tSM:{sample}\n").encode()
    header = b"BAM\x01" + struct.pack("<i", len(text)) + text \
        + struct.pack("<i", len(contigs))
    for name, length in contigs:
        raw = name.encode() + b"\0"
        header += struct.pack("<i", len(raw)) + raw + struct.pack("<i", length)
    body, start = _records(reads, sample)
    stream = np.concatenate([np.frombuffer(header, np.uint8), body])
    chunks = [stream[i:i + BLOCK].tobytes()
              for i in range(0, stream.size, BLOCK)]
    with ThreadPoolExecutor(THREADS) as ex:
        blocks = list(ex.map(_bgzf_block, chunks))
    coffset = np.concatenate([[0], np.cumsum([len(b) for b in blocks])])
    with open(path, "wb") as fh:
        fh.writelines(blocks)
        fh.write(EOF)
    u = np.append(start, body.size) + len(header)
    voff = (coffset[u // BLOCK] << 16) | (u % BLOCK)
    index = [b"BAI\x01", struct.pack("<i", len(contigs))]
    for tid in range(len(contigs)):
        k = np.nonzero(reads.tid == tid)[0]
        index.append(_ref_index(reads.take(k), voff[k.min():k.max() + 2])
                     if k.size else struct.pack("<ii", 0, 0))
    index.append(struct.pack("<Q", 0))
    with open(path + ".bai", "wb") as fh:
        fh.write(b"".join(index))


def _ref_index(reads: Reads, voff: np.ndarray) -> bytes:
    """The index of one reference's records, consecutive in the file at
    virtual offsets ``voff`` (one more: the end of the last record): each
    bin's chunks of consecutive records, the pseudo-bin and the 16 kb
    linear index."""
    n = len(reads)
    end = reads.pos + np.maximum(reads.ref_len, 1)
    bins = reg2bin(reads.pos, end)
    new = np.ones(n, bool)
    new[1:] = bins[1:] != bins[:-1]
    run0 = np.nonzero(new)[0]
    run1 = np.append(run0[1:], n)
    by_bin = {}
    for b, lo, hi in zip(bins[run0].tolist(), run0.tolist(), run1.tolist()):
        by_bin.setdefault(b, []).append((int(voff[lo]), int(voff[hi])))
    out = [struct.pack("<i", len(by_bin) + 1)]
    for b in sorted(by_bin):
        chunks = by_bin[b]
        out.append(struct.pack("<Ii", b, len(chunks)))
        out.extend(struct.pack("<QQ", *c) for c in chunks)
    out.append(struct.pack("<IiQQQQ", PSEUDO_BIN, 2, int(voff[0]),
                           int(voff[n]), n, 0))
    # linear index: the least offset of a record touching each window,
    # empty windows taking the one before (offsets only grow along it)
    w0 = reads.pos >> 14
    w1 = (end - 1) >> 14
    lin = np.full(int(w1.max()) + 1, np.iinfo(np.int64).max, np.int64)
    for k in range(int((w1 - w0).max()) + 1):
        np.minimum.at(lin, np.minimum(w0 + k, w1), voff[:n])
    lin = np.maximum.accumulate(np.where(lin == np.iinfo(np.int64).max, 0,
                                         lin))
    out.append(struct.pack("<i", lin.size))
    out.append(lin.astype("<u8").tobytes())
    return b"".join(out)
