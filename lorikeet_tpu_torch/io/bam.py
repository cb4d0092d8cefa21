"""BAM reading — host I/O layer.

The reference reads BAMs through rust-htslib (C htslib,
reference/src/bam_parsing/bam_generator.rs:19-77); this environment has
no pysam/htslib, so this is a self-contained reader: BGZF decompression via
the stdlib (BGZF is valid multi-member gzip) + record decoding per the SAM
spec.  Small-cohort files are decoded fully into per-contig read lists;
region fetches slice a sorted array.  (A C++ decoder can replace the record
loop if profiling demands; decode cost is off the device hot path.)

Record surface mirrors what the pipeline needs from the reference's
``BirdToolRead`` (reference/src/reads/bird_tool_reads.rs:27): name,
flags, tid/pos/mapq, CIGAR, seq, quals, mate info, tags.
"""
from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass, field

import numpy as np

CIGAR_OPS = "MIDNSHP=X"
# ops that consume query / reference (SAM spec 4.2)
CONSUMES_QUERY = (True, True, False, False, True, False, False, True, True)
CONSUMES_REF = (True, False, True, True, False, False, False, True, True)

_SEQ_NT = np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)
_REF_OPS = frozenset("MDN=X")
_QUERY_OPS = frozenset("MIS=X")

# SAM flags
FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800


@dataclass
class BamRecord:
    name: str
    flag: int
    tid: int
    pos: int                 # 0-based leftmost
    mapq: int
    cigar: list              # [(op_char, length)]
    seq: np.ndarray          # uint8 ASCII bases
    qual: np.ndarray         # uint8 phred
    mate_tid: int = -1
    mate_pos: int = -1
    tlen: int = 0
    tags: dict = field(default_factory=dict)
    sample_index: int = 0    # filled by the pipeline
    # native-decoder filter bits (bam_decode.cpp BamColumns::intrinsic);
    # -1 = unknown (pure-Python decode or synthetic record)
    intrinsic: int = -1

    @property
    def is_paired(self):
        return bool(self.flag & FLAG_PAIRED)

    @property
    def is_proper_pair(self):
        return bool(self.flag & FLAG_PROPER_PAIR)

    @property
    def is_unmapped(self):
        return bool(self.flag & FLAG_UNMAPPED)

    @property
    def is_mate_unmapped(self):
        return bool(self.flag & FLAG_MATE_UNMAPPED)

    @property
    def is_reverse(self):
        return bool(self.flag & FLAG_REVERSE)

    @property
    def is_mate_reverse(self):
        return bool(self.flag & FLAG_MATE_REVERSE)

    @property
    def is_first_in_pair(self):
        return bool(self.flag & FLAG_READ1)

    @property
    def is_secondary(self):
        return bool(self.flag & FLAG_SECONDARY)

    @property
    def is_supplementary(self):
        return bool(self.flag & FLAG_SUPPLEMENTARY)

    @property
    def is_duplicate(self):
        return bool(self.flag & FLAG_DUP)

    @property
    def is_qc_fail(self):
        return bool(self.flag & FLAG_QCFAIL)

    def __len__(self):
        return len(self.seq)

    @property
    def reference_end(self) -> int:
        """0-based exclusive end on the reference.

        Memoized: records are never mutated in place (clipping/realignment go
        through dataclasses.replace, which builds a fresh record and so a
        fresh cache slot).
        """
        end = self.__dict__.get("_reference_end")
        if end is None:
            end = self.pos + sum(n for op, n in self.cigar if op in _REF_OPS)
            self.__dict__["_reference_end"] = end
        return end

    @property
    def query_alignment_length(self) -> int:
        return sum(n for op, n in self.cigar if CONSUMES_QUERY[CIGAR_OPS.index(op)]
                   and op not in "SH")

    def cigar_string(self) -> str:
        return "".join(f"{n}{op}" for op, n in self.cigar) or "*"


def _decode_record(buf: bytes, off: int, end: int) -> BamRecord:
    (ref_id, pos, l_read_name, mapq, _bin, n_cigar_op, flag, l_seq,
     next_ref_id, next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", buf, off)
    p = off + 32
    name = buf[p:p + l_read_name - 1].decode()
    p += l_read_name
    cigar = []
    for k in range(n_cigar_op):
        v = struct.unpack_from("<I", buf, p + 4 * k)[0]
        cigar.append((CIGAR_OPS[v & 0xF], v >> 4))
    p += 4 * n_cigar_op
    nbytes = (l_seq + 1) // 2
    packed = np.frombuffer(buf, np.uint8, nbytes, p)
    hi = packed >> 4
    lo = packed & 0xF
    codes = np.empty(nbytes * 2, np.uint8)
    codes[0::2] = hi
    codes[1::2] = lo
    seq = _SEQ_NT[codes[:l_seq]]
    p += nbytes
    qual = np.frombuffer(buf, np.uint8, l_seq, p).copy()
    p += l_seq
    tags = _decode_tags(buf, p, end)
    return BamRecord(name=name, flag=flag, tid=ref_id, pos=pos, mapq=mapq,
                     cigar=cigar, seq=seq, qual=qual, mate_tid=next_ref_id,
                     mate_pos=next_pos, tlen=tlen, tags=tags)


def _decode_tags(buf: bytes, p: int, end: int) -> dict:
    tags = {}
    while p < end:
        tag = buf[p:p + 2].decode()
        typ = chr(buf[p + 2])
        p += 3
        if typ == "A":
            tags[tag] = chr(buf[p]); p += 1
        elif typ in "cC":
            tags[tag] = struct.unpack_from("<b" if typ == "c" else "<B", buf, p)[0]; p += 1
        elif typ in "sS":
            tags[tag] = struct.unpack_from("<h" if typ == "s" else "<H", buf, p)[0]; p += 2
        elif typ in "iI":
            tags[tag] = struct.unpack_from("<i" if typ == "i" else "<I", buf, p)[0]; p += 4
        elif typ == "f":
            tags[tag] = struct.unpack_from("<f", buf, p)[0]; p += 4
        elif typ in "ZH":
            q = buf.index(b"\0", p)
            tags[tag] = buf[p:q].decode(); p = q + 1
        elif typ == "B":
            sub = chr(buf[p]); n = struct.unpack_from("<i", buf, p + 1)[0]
            size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            # SAM subtype -> struct char (c/s are SIGNED int8/int16, not
            # struct's char/bytes codes)
            code = {"c": "b", "C": "B", "s": "h", "S": "H",
                    "i": "i", "I": "I", "f": "f"}[sub]
            tags[tag] = list(struct.unpack_from(f"<{n}{code}", buf, p + 5))
            p += 5 + n * size
        else:
            raise ValueError(f"unknown tag type {typ!r}")
    return tags


def open_bam(path: str, high_memory: bool = False, streaming: bool = None):
    """Reader factory: whole-file eager decode for small files (fast, the
    common test/cohort case), indexed streaming for large ones (memory
    O(window); the reference's IndexedNamedBamReader role,
    bam_generator.rs:48).  ``high_memory`` (the --high-memory flag) forces
    eager decode; ``streaming`` overrides the size heuristic outright.
    A missing .bai is built on the spot (index_bams.rs finish_bams role)."""
    with open(path, "rb") as _fh:
        magic = _fh.read(26)
    if magic[:2] != b"\x1f\x8b":
        if magic.startswith(b"version https://git-lfs"):
            raise ValueError(
                f"{path} is a git-lfs POINTER, not BAM data — the real "
                "file was never fetched (run `git lfs pull` in that repo)")
        raise ValueError(
            f"{path} is not a BAM file (BGZF gzip magic missing; "
            f"starts with {magic[:8]!r})")
    if streaming is None:
        if high_memory:
            streaming = False
        else:
            import os as _os
            threshold = int(_os.environ.get("LORIKEET_EAGER_BAM_MAX",
                                            str(256 * 1024 * 1024)))
            try:
                streaming = _os.path.getsize(path) > threshold
            except OSError:
                streaming = False
    if streaming:
        return StreamingBamReader(path)
    return BamReader(path)


class BamReader:
    """Whole-file BAM reader with per-contig fetch.

    Decodes the full file on first use (fine for per-genome split BAMs; the
    reference similarly re-reads whole BAMs per genome task).
    """

    #: eager readers hold every record; window preparation is a no-op
    is_streaming = False

    def prepare_span(self, tid: int, start: int, end: int):
        """Hint that the caller is about to work inside [start, end) on tid
        (streaming readers decode that window; eager readers no-op)."""

    def __init__(self, path: str):
        self.path = path
        self._native = False
        data = None
        try:
            from lorikeet_tpu_torch.native import bam_native
            self._buf = bam_native.inflate(path)
            data = self._buf  # numpy uint8; struct reads via buffer protocol
            self._native = True
        except Exception:
            with gzip.open(path, "rb") as fh:
                data = fh.read()
        if bytes(data[:4]) != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        l_text = struct.unpack_from("<i", data, 4)[0]
        self.header_text = bytes(data[8:8 + l_text]).rstrip(b"\0").decode()
        p = 8 + l_text
        n_ref = struct.unpack_from("<i", data, p)[0]
        p += 4
        self.references = []
        self.lengths = []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", data, p)[0]
            name = bytes(data[p + 4:p + 4 + l_name - 1]).decode()
            l_ref = struct.unpack_from("<i", data, p + 4 + l_name)[0]
            self.references.append(name)
            self.lengths.append(l_ref)
            p += 8 + l_name
        self._records_raw = (data, p)
        self._by_tid = None

    @property
    def n_references(self) -> int:
        return len(self.references)

    def tid(self, name: str) -> int:
        return self.references.index(name)

    def _ensure_decoded(self):
        if self._by_tid is not None:
            return
        data, p = self._records_raw
        if self._native:
            self._decode_native(data, p)
            return
        by_tid = {}
        n = len(data)
        while p < n:
            block_size = struct.unpack_from("<i", data, p)[0]
            rec = _decode_record(data, p + 4, p + 4 + block_size)
            by_tid.setdefault(rec.tid, []).append(rec)
            p += 4 + block_size
        for tid in by_tid:
            by_tid[tid].sort(key=lambda r: r.pos)
        self._by_tid = by_tid
        self._starts = {tid: np.array([r.pos for r in recs], np.int64)
                        for tid, recs in by_tid.items()}
        self._ends = {tid: [r.reference_end for r in recs]
                      for tid, recs in by_tid.items()}
        self._ends_cummax = {
            tid: np.maximum.accumulate(np.array(e, np.int64))
            if e else np.zeros(0, np.int64)
            for tid, e in self._ends.items()}
        self._records_raw = None

    def _decode_native(self, data, rec_off: int):
        """Index the C++ columnar parse; BamRecord objects materialize
        lazily per fetch/records_at (most reads are only ever touched by
        the columnar pileup/filter paths and never need a Python object)."""
        from lorikeet_tpu_torch.native import bam_native
        cols = bam_native.parse(data, rec_off)
        order = np.lexsort((cols["pos"], cols["tid"]))
        so = cols["seq_off"]
        seqlen = so[1:] - so[:-1]
        ends = (cols["pos"].astype(np.int64) +
                cols["ref_len"].astype(np.int64))
        # per-tid position/end indexes in record order (pos-sorted); the
        # cummax of ends lets fetch() binary-search its scan start instead
        # of walking every record with pos < end
        tid_sorted = cols["tid"][order]
        pos_sorted = cols["pos"][order].astype(np.int64)
        ends_sorted = ends[order]
        bounds = ([0, *(np.flatnonzero(np.diff(tid_sorted)) + 1).tolist(),
                   len(tid_sorted)] if len(tid_sorted) else [])
        self._by_tid = {}
        self._fi_by_tid = {}
        self._starts, self._ends, self._ends_cummax = {}, {}, {}
        self._cols_by_tid = {}
        flag_sorted = cols["flag"][order]
        mapq_sorted = cols["mapq"][order]
        intr_sorted = cols["intrinsic"][order]
        seqlen_sorted = seqlen[order]
        for b0, b1 in zip(bounds[:-1], bounds[1:]):
            t = int(tid_sorted[b0])
            self._by_tid[t] = [None] * (b1 - b0)
            self._fi_by_tid[t] = order[b0:b1]
            self._starts[t] = pos_sorted[b0:b1]
            e = ends_sorted[b0:b1]
            self._ends[t] = e.tolist()
            self._ends_cummax[t] = np.maximum.accumulate(e)
            self._cols_by_tid[t] = dict(
                flag=flag_sorted[b0:b1], mapq=mapq_sorted[b0:b1],
                intrinsic=intr_sorted[b0:b1], seqlen=seqlen_sorted[b0:b1])
        self._raw_cols = cols
        self._ends_file = ends
        self._op_cols = None
        self._records_raw = None
        self._buf = None

    def _op_columns(self):
        """Whole-file decoded cigar op/length columns (built once)."""
        if self._op_cols is None:
            cigars = self._raw_cols["cigars"]
            self._op_cols = (
                np.array(list(CIGAR_OPS))[cigars & 0xF].tolist(),
                (cigars >> 4).tolist())
        return self._op_cols

    def records_at(self, tid: int, ks, sample_index: int = 0) -> list:
        """Materialize (and cache) the records at sorted-order indices `ks`
        within tid, returned in that order."""
        recs = self._by_tid.get(tid)
        if recs is None:
            return []
        fi = self._fi_by_tid[tid]
        missing = [k for k in (ks.tolist() if hasattr(ks, "tolist") else ks)
                   if recs[k] is None]
        if missing:
            cols = self._raw_cols
            op_chars, op_lens = self._op_columns()
            names = cols["names"]
            seq, qual, tags = cols["seq"], cols["qual"], cols["tags"]
            # one vectorized gather + tolist per column: Python ints come
            # out directly instead of ~14 numpy scalar casts per record
            ii = fi[np.asarray(missing, np.int64)]
            no_l, no1 = cols["name_off"][ii].tolist(), \
                cols["name_off"][ii + 1].tolist()
            co_l, co1 = cols["cigar_off"][ii].tolist(), \
                cols["cigar_off"][ii + 1].tolist()
            so_l, so1 = cols["seq_off"][ii].tolist(), \
                cols["seq_off"][ii + 1].tolist()
            to_l, to1 = cols["tag_off"][ii].tolist(), \
                cols["tag_off"][ii + 1].tolist()
            flag_l, tid_l = cols["flag"][ii].tolist(), \
                cols["tid"][ii].tolist()
            pos_l, mapq_l = cols["pos"][ii].tolist(), \
                cols["mapq"][ii].tolist()
            mtid_l, mpos_l = cols["mate_tid"][ii].tolist(), \
                cols["mate_pos"][ii].tolist()
            tlen_l, intr_l = cols["tlen"][ii].tolist(), \
                cols["intrinsic"][ii].tolist()
            ends_l = self._ends_file[ii].tolist()
            new = BamRecord.__new__
            for t, k in enumerate(missing):
                # direct attribute construction: ~2x faster than the
                # dataclass __init__ for 13 fields at this volume
                rec = new(BamRecord)
                d = rec.__dict__
                d["name"] = names[no_l[t]:no1[t]].decode()
                d["flag"] = flag_l[t]
                d["tid"] = tid_l[t]
                d["pos"] = pos_l[t]
                d["mapq"] = mapq_l[t]
                d["cigar"] = list(zip(op_chars[co_l[t]:co1[t]],
                                      op_lens[co_l[t]:co1[t]]))
                d["seq"] = seq[so_l[t]:so1[t]]
                d["qual"] = qual[so_l[t]:so1[t]].copy()
                d["mate_tid"] = mtid_l[t]
                d["mate_pos"] = mpos_l[t]
                d["tlen"] = tlen_l[t]
                d["tags"] = _LazyTags(tags, to_l[t], to1[t])
                d["sample_index"] = sample_index
                d["intrinsic"] = intr_l[t]
                d["_reference_end"] = ends_l[t]
                recs[k] = rec
        return [recs[k] for k in ks]

    def columnar(self, tid: int):
        """Raw column buffers + per-record (sorted order) offset arrays for
        the zero-object pileup path; None when not native-decoded."""
        self._ensure_decoded()
        if getattr(self, "_raw_cols", None) is None \
                or tid not in self._fi_by_tid:
            return None
        cache = self.__dict__.setdefault("_columnar_cache", {})
        c = cache.get(tid)
        if c is None:
            cols = self._raw_cols
            fi = self._fi_by_tid[tid]
            so, co = cols["seq_off"], cols["cigar_off"]
            ops_np = getattr(self, "_ops_np", None)
            if ops_np is None:
                # file-level decode, shared by every tid's columnar view
                cigars = cols["cigars"]
                ops_np = ((np.frombuffer(CIGAR_OPS.encode(), np.uint8)
                           [cigars & 0xF]),
                          (cigars >> 4).astype(np.int32))
                self._ops_np = ops_np
            ops_u8, lens_i32 = ops_np
            c = dict(
                seq=cols["seq"], qual=cols["qual"],
                ops=ops_u8, lens=lens_i32,
                read_off=so[fi].astype(np.int64),
                read_len=(so[fi + 1] - so[fi]).astype(np.int32),
                cigar_off=co[fi].astype(np.int64),
                cigar_cnt=(co[fi + 1] - co[fi]).astype(np.int32),
                pos=self._starts[tid],
                ends=np.asarray(self._ends[tid], np.int64))
            cache[tid] = c
        return c

    def columnar_ext(self, tid: int):
        """Extra sorted-order columns for the native region finalizer
        (flag/mate/tlen/name/tag offsets) — cached inside the columnar dict
        so streaming windows invalidate both together; None when not
        native-decoded."""
        c = self.columnar(tid)
        if c is None:
            return None
        ext = c.get("ext")
        if ext is None:
            cols = self._raw_cols
            fi = self._fi_by_tid[tid]
            no, to = cols["name_off"], cols["tag_off"]
            ext = dict(
                flag=np.ascontiguousarray(cols["flag"][fi], np.int32),
                mapq=cols["mapq"][fi],
                mate_tid=cols["mate_tid"][fi],
                mate_pos=cols["mate_pos"][fi].astype(np.int64),
                tlen=cols["tlen"][fi].astype(np.int64),
                intrinsic=cols["intrinsic"][fi],
                name_off=no[fi].astype(np.int64),
                name_len=(no[fi + 1] - no[fi]).astype(np.int32),
                tag_off=to[fi].astype(np.int64),
                tag_end=to[fi + 1].astype(np.int64),
                names=cols["names"], tags=cols["tags"])
            c["ext"] = ext
        return ext

    def fetch_indices(self, tid: int, start: int = None, end: int = None,
                      mask=None) -> np.ndarray:
        """Sorted-order indices of records overlapping [start, end) on tid
        (same selection as fetch), without materializing records."""
        self._ensure_decoded()
        starts = self._starts.get(tid)
        if starts is None:
            return np.zeros(0, np.int64)
        n = len(starts)
        if start is None:
            sel = np.arange(n, dtype=np.int64)
        else:
            hi = (int(np.searchsorted(starts, end, side="left"))
                  if end is not None else n)
            lo = int(np.searchsorted(self._ends_cummax[tid], start,
                                     side="right"))
            ends = np.asarray(self._ends[tid][lo:hi], np.int64)
            sel = lo + np.flatnonzero(ends > start)
        if mask is not None:
            m = np.asarray(mask, bool)
            sel = sel[m[sel]]
        return sel


    def filter_mask(self, tid: int, mapq_threshold: int = 20,
                    read_type: str = "short", min_long_read_size: int = 1500,
                    min_long_read_average_base_qual: int = 20,
                    include_improper_pairs: bool = False,
                    include_supplementary: bool = False):
        """Per-record pass/fail for the read_utils.rs:25-90 filter set,
        vectorized over the decode-time columns (record order matches
        fetch).  Returns None when columnar data is unavailable (pure-Python
        decode) — callers then fall back to the per-record predicate."""
        self._ensure_decoded()
        cols = getattr(self, "_cols_by_tid", None)
        if cols is None or tid not in cols:
            return None
        key = (tid, mapq_threshold, read_type, min_long_read_size,
               min_long_read_average_base_qual, include_improper_pairs,
               include_supplementary)
        cache = self.__dict__.setdefault("_filter_mask_cache", {})
        m = cache.get(key)
        if m is not None:
            return m
        c = cols[tid]
        flag, mapq = c["flag"], c["mapq"]
        ok = ((c["seqlen"] >= 30) & (mapq >= mapq_threshold)
              & (mapq != 255) & (c["intrinsic"] == 0))
        drop = FLAG_SECONDARY | FLAG_UNMAPPED | FLAG_DUP | FLAG_QCFAIL
        if not include_supplementary:
            drop |= FLAG_SUPPLEMENTARY
        ok &= (flag & drop) == 0
        if not include_improper_pairs:
            ok &= ~(((flag & FLAG_PAIRED) != 0)
                    & ((flag & FLAG_PROPER_PAIR) == 0))
        if read_type == "long":
            mq = c.get("meanq")
            if mq is None:
                raw = getattr(self, "_raw_cols", None)
                if raw is not None:
                    means = getattr(self, "_meanq_file", None)
                    if means is None:
                        # file-level, cumsum-based segment means: exact for
                        # zero-length segments anywhere (reduceat both
                        # overruns on a trailing empty record and corrupts
                        # the preceding segment's sum); cached across tids
                        so = raw["seq_off"]
                        cs = np.concatenate(
                            ([0.0], np.cumsum(raw["qual"],
                                              dtype=np.float64)))
                        lens = (so[1:] - so[:-1]).astype(np.int64)
                        sums = cs[so[1:]] - cs[so[:-1]]
                        means = np.where(lens > 0,
                                         sums / np.maximum(lens, 1), 0.0)
                        self._meanq_file = means
                    mq = means[self._fi_by_tid[tid]]
                else:
                    mq = np.array(
                        [float(np.mean(r.qual)) if len(r.qual) else 0.0
                         for r in self._by_tid[tid]])
                c["meanq"] = mq
            ok &= ((c["seqlen"] >= min_long_read_size)
                   & (mq >= min_long_read_average_base_qual))
        m = ok.tolist()
        cache[key] = m
        return m

    def fetch(self, tid: int = None, start: int = None, end: int = None,
              mask=None):
        """Yield records overlapping [start, end) on tid (all if None);
        ``mask`` (record-order booleans from filter_mask) pre-filters."""
        self._ensure_decoded()
        lazy = getattr(self, "_raw_cols", None) is not None
        if tid is None:
            for t in sorted(k for k in self._by_tid if k >= 0):
                if lazy:
                    yield from self.records_at(
                        t, range(len(self._by_tid[t])))
                else:
                    yield from self._by_tid[t]
            return
        if lazy:
            yield from self.records_at(
                tid, self.fetch_indices(tid, start, end, mask))
            return
        recs = self._by_tid.get(tid, [])
        if start is None or not recs:
            yield from recs
            return
        # records are position-sorted; reads overlapping [start,end) have
        # pos < end and reference_end > start.  cummax(ends) is monotone, so
        # every record before its upper bound for `start` ends at or before
        # `start` and can be skipped wholesale.
        starts = self._starts.get(tid)
        hi = int(np.searchsorted(starts, end, side="left")) if end is not None else len(recs)
        ends = self._ends[tid]
        lo = int(np.searchsorted(self._ends_cummax[tid], start,
                                 side="right"))
        if mask is None:
            for k in range(lo, hi):
                if ends[k] > start:
                    yield recs[k]
        else:
            for k in range(lo, hi):
                if mask[k] and ends[k] > start:
                    yield recs[k]

    def count(self) -> int:
        self._ensure_decoded()
        return sum(len(v) for k, v in self._by_tid.items())

    def sample_names(self) -> list:
        """Read-group sample names (SM) from the header, in order."""
        samples = []
        for line in self.header_text.splitlines():
            if line.startswith("@RG"):
                for fieldv in line.split("\t"):
                    if fieldv.startswith("SM:"):
                        samples.append(fieldv[3:])
        return samples


class StreamingBamReader(BamReader):
    """Indexed, streaming BAM reader: decodes only the BGZF blocks covering
    the requested window (bam_generator.rs:48 IndexedNamedBamReader /
    haplotype_caller_engine.rs:675-725 per-chunk fetch semantics).

    ``prepare_span(tid, lo, hi)`` decodes one window and exposes the full
    BamReader API over it — filter_mask / columnar / fetch_indices /
    records_at indices are WINDOW-relative (the pipeline only ever uses
    indices against the same window it got them from).  Memory is
    O(window), never O(file).
    """

    is_streaming = True

    def __init__(self, path: str, bai_path: str = None):
        from lorikeet_tpu_torch.io.bai import BgzfFile, build_bai, read_bai
        self.path = path
        self._native = False
        self._bgzf = BgzfFile(path)
        self._read_header()
        bai_path = bai_path or path + ".bai"
        if not os.path.exists(bai_path):
            build_bai(path, bai_path)
        self._bai = read_bai(bai_path)
        if len(self._bai) != len(self.references):
            raise ValueError(f"{bai_path}: indexes {len(self._bai)} refs, "
                             f"BAM has {len(self.references)}")
        self._window = None           # (tid, lo, hi) currently decoded
        self._by_tid = {}

    def _read_header(self):
        """Parse magic + header text + reference dictionary from the leading
        BGZF blocks only."""
        buf = bytearray()
        blocks = self._bgzf.blocks_from(0)

        def need(n):
            while len(buf) < n:
                _, payload = next(blocks)
                buf.extend(payload)

        need(8)
        if bytes(buf[:4]) != b"BAM\x01":
            raise ValueError(f"{self.path}: not a BAM file")
        l_text = struct.unpack_from("<i", buf, 4)[0]
        need(8 + l_text + 4)
        self.header_text = bytes(buf[8:8 + l_text]).rstrip(b"\0").decode()
        p = 8 + l_text
        n_ref = struct.unpack_from("<i", buf, p)[0]
        p += 4
        self.references = []
        self.lengths = []
        for _ in range(n_ref):
            need(p + 8)
            l_name = struct.unpack_from("<i", buf, p)[0]
            need(p + 8 + l_name)
            self.references.append(
                bytes(buf[p + 4:p + 4 + l_name - 1]).decode())
            self.lengths.append(struct.unpack_from("<i", buf,
                                                   p + 4 + l_name)[0])
            p += 8 + l_name

    def _ensure_decoded(self):
        if self._window is None:
            raise RuntimeError(
                "StreamingBamReader: call prepare_span()/fetch() with a "
                "region before index-based access")

    def prepare_span(self, tid: int, start: int, end: int):
        """Decode the window covering [start, end) on tid and (re)build the
        whole BamReader surface over it."""
        if self._window == (tid, start, end):
            return
        # reset per-window caches built lazily by the inherited methods
        for attr in ("_columnar_cache", "_filter_mask_cache", "_ops_np",
                     "_meanq_file", "_raw_cols", "_op_cols"):
            self.__dict__.pop(attr, None)
        data = b""
        chunks = self._bai[tid].query(start, end) \
            if 0 <= tid < len(self._bai) else []
        if chunks:
            # read each merged chunk range separately — the min-to-max
            # ENVELOPE can span most of the file when parent-level bins
            # contribute scattered chunks (measured: 542 MB decompressed
            # for a 250 kb window on a 30 Mbp contig).  Chunk boundaries
            # are record-aligned, so concatenation preserves framing.
            data = b"".join(
                self._bgzf.read_voffset_range(c_beg, c_end)
                for c_beg, c_end in chunks)
        self._window = (tid, start, end)
        if not data:
            self._by_tid = {}
            self._starts, self._ends, self._ends_cummax = {}, {}, {}
            self._cols_by_tid = {}
            self._raw_cols = None
            return
        buf = np.frombuffer(data, np.uint8)
        try:
            from lorikeet_tpu_torch.native import bam_native  # noqa: F401
            self._native = True
            self._decode_native(buf, 0)
        except Exception:  # noqa: BLE001 — fall back to the Python decoder
            self._native = False
            self._decode_python_window(data)
        # the decoded byte range may include same-tid records outside every
        # candidate bin only at its edges; overlap filtering happens in
        # fetch_indices exactly as on the eager reader

    def _decode_python_window(self, data: bytes):
        by_tid = {}
        p, n = 0, len(data)
        while p < n:
            block_size = struct.unpack_from("<i", data, p)[0]
            rec = _decode_record(data, p + 4, p + 4 + block_size)
            by_tid.setdefault(rec.tid, []).append(rec)
            p += 4 + block_size
        for t in by_tid:
            by_tid[t].sort(key=lambda r: r.pos)
        self._by_tid = by_tid
        self._starts = {t: np.array([r.pos for r in recs], np.int64)
                        for t, recs in by_tid.items()}
        self._ends = {t: [r.reference_end for r in recs]
                      for t, recs in by_tid.items()}
        self._ends_cummax = {
            t: np.maximum.accumulate(np.array(e, np.int64))
            if e else np.zeros(0, np.int64)
            for t, e in self._ends.items()}
        self._cols_by_tid = None
        self._raw_cols = None

    def _window_covers(self, tid: int, start, end) -> bool:
        if self._window is None:
            return False
        wt, wlo, whi = self._window
        return (wt == tid and start is not None and end is not None
                and wlo <= start and end <= whi)

    def fetch_indices(self, tid: int, start: int = None, end: int = None,
                      mask=None) -> np.ndarray:
        if not self._window_covers(tid, start, end):
            if start is None:
                raise RuntimeError("StreamingBamReader: whole-tid "
                                   "fetch_indices needs prepare_span")
            self.prepare_span(tid, start, end)
        return super().fetch_indices(tid, start, end, mask)

    def fetch(self, tid: int = None, start: int = None, end: int = None,
              mask=None):
        if tid is None:
            for t in range(len(self.references)):
                yield from self._stream_tid(t)
            return
        if start is None:
            yield from self._stream_tid(t=tid)
            return
        if not self._window_covers(tid, start, end):
            self.prepare_span(tid, start, end)
        yield from super().fetch(tid, start, end, mask)

    def _stream_tid(self, t: int):
        """Sequentially decode every record of one reference (position
        order), without touching the window state."""
        r = self._bai[t]
        v_beg = r.off_beg or min((c[0] for cs in r.bins.values()
                                  for c in cs), default=0)
        v_end = r.off_end or max((c[1] for cs in r.bins.values()
                                  for c in cs), default=0)
        if not v_beg or v_end <= v_beg:
            return
        data = self._bgzf.read_voffset_range(v_beg, v_end)
        p, n = 0, len(data)
        while p < n:
            block_size = struct.unpack_from("<i", data, p)[0]
            rec = _decode_record(data, p + 4, p + 4 + block_size)
            if rec.tid == t:
                yield rec
            p += 4 + block_size

    def count(self) -> int:
        return sum(r.n_mapped + r.n_unmapped for r in self._bai)

    def close(self):
        self._bgzf.close()


class _LazyTags(dict):
    """Tag dict decoded from raw BAM tag bytes on first access."""

    def __init__(self, buf, lo, hi):
        super().__init__()
        self._raw = (buf, lo, hi)

    def _force(self):
        if self._raw is not None:
            buf, lo, hi = self._raw
            self._raw = None
            self.update(_decode_tags(bytes(buf[lo:hi]), 0, hi - lo))

    def __getitem__(self, k):
        self._force()
        return super().__getitem__(k)

    def __contains__(self, k):
        self._force()
        return super().__contains__(k)

    def get(self, k, default=None):
        self._force()
        return super().get(k, default)

    def keys(self):
        self._force()
        return super().keys()

    def items(self):
        self._force()
        return super().items()
