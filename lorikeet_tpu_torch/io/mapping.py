"""Raw-read mapping layer: external mapper subprocess -> sorted cached BAM.

Reference parity: reference/src/bam_parsing/bam_generator.rs builds
`mapper | samtools sort | samtools view -b` shell pipelines over FIFOs
(:460-560, :1049-1113) and src/external_command_checker.rs verifies tool
presence.  This build needs no samtools: the mapper's SAM stdout is
parsed in-process and written with our own BGZF/BAM writer after a host
sort — one process instead of four.

Mapper command shapes follow build_mapping_command (bam_generator.rs:1049):
minimap2 presets sr/map-ont/map-hifi/map-pb (auto-detects interleaved),
bwa/bwa-mem2 with -p for interleaved.  bwa requires an index
(mapping_index_maintenance.rs:218 generate_bwa_index).
"""
from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np

from lorikeet_tpu_torch.io.bam import BamRecord, CIGAR_OPS
from lorikeet_tpu_torch.io.bam_writer import write_bam

MAPPER_PRESETS = {
    "minimap2-sr": ["minimap2", "-a", "-x", "sr"],
    "minimap2-ont": ["minimap2", "-a", "-x", "map-ont"],
    "minimap2-hifi": ["minimap2", "-a", "-x", "map-hifi"],
    "minimap2-pb": ["minimap2", "-a", "-x", "map-pb"],
    "minimap2-no-preset": ["minimap2", "-a"],
    "bwa-mem": ["bwa", "mem"],
    "bwa-mem2": ["bwa-mem2", "mem"],
    "ngmlr-ont": ["ngmlr", "-x", "ont"],
}


def check_for_external_command(name: str) -> bool:
    """external_command_checker.rs:3-71 equivalent (presence only)."""
    return shutil.which(name) is not None


def build_mapper_command(mapper: str, reference: str, read1: str,
                         read2: str = None, interleaved: bool = False,
                         threads: int = 1, params: str = "") -> list:
    if mapper not in MAPPER_PRESETS:
        raise ValueError(f"unknown mapper {mapper!r}; "
                         f"choose from {sorted(MAPPER_PRESETS)}")
    cmd = list(MAPPER_PRESETS[mapper])
    if params:
        cmd += params.split()
    cmd += ["-t", str(threads)]
    if mapper.startswith("ngmlr"):
        # ngmlr takes no positional operands: -r REF -q READS
        cmd += ["-r", reference, "-q", read1]
        return cmd
    if mapper.startswith("bwa") and interleaved:
        cmd.append("-p")
    cmd.append(reference)
    cmd.append(read1)
    if read2 and not interleaved:
        cmd.append(read2)
    return cmd


def ensure_index(mapper: str, reference: str):
    """bwa needs an on-disk index (mapping_index_maintenance.rs:166-218:
    bwa checks .bwt, bwa-mem2 checks .bwt.2bit.64); minimap2/ngmlr index
    on the fly."""
    if not mapper.startswith("bwa"):
        return
    marker = ".bwt" if mapper == "bwa-mem" else ".bwt.2bit.64"
    if not os.path.exists(reference + marker):
        prog = "bwa" if mapper == "bwa-mem" else "bwa-mem2"
        subprocess.run([prog, "index", reference], check=True,
                       capture_output=True)


# --- SAM parsing ------------------------------------------------------------

def _parse_cigar(text: str) -> list:
    if text == "*":
        return []
    out = []
    n = 0
    for ch in text:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            out.append((ch, n))
            n = 0
    return out


def parse_sam_stream(lines) -> tuple:
    """(references, lengths, records, header_text) from SAM text lines."""
    refs, lengths, records = [], [], []
    header_lines = []
    name_to_tid = {}
    for line in lines:
        if not line:
            continue
        if line.startswith("@"):
            header_lines.append(line.rstrip("\n"))
            if line.startswith("@SQ"):
                name = ln = None
                for f in line.rstrip("\n").split("\t")[1:]:
                    if f.startswith("SN:"):
                        name = f[3:]
                    elif f.startswith("LN:"):
                        ln = int(f[3:])
                if name is not None:
                    name_to_tid[name] = len(refs)
                    refs.append(name)
                    lengths.append(ln or 0)
            continue
        f = line.rstrip("\n").split("\t")
        if len(f) < 11:
            continue
        flag = int(f[1])
        tid = name_to_tid.get(f[2], -1)
        seq = (np.frombuffer(f[9].encode(), np.uint8).copy()
               if f[9] != "*" else np.zeros(0, np.uint8))
        if f[10] == "*":
            qual = np.full(len(seq), 255, np.uint8)
        else:
            qual = np.frombuffer(f[10].encode(), np.uint8) - 33
        tags = {}
        for t in f[11:]:
            parts = t.split(":", 2)
            if len(parts) == 3:
                key, typ, val = parts
                if typ == "i":
                    tags[key] = int(val)
                elif typ == "f":
                    tags[key] = float(val)
                else:
                    tags[key] = val
        records.append(BamRecord(
            name=f[0], flag=flag, tid=tid, pos=int(f[3]) - 1,
            mapq=int(f[4]), cigar=_parse_cigar(f[5]),
            seq=seq, qual=qual.copy(),
            mate_tid=(tid if f[6] == "=" else name_to_tid.get(f[6], -1)),
            mate_pos=int(f[7]) - 1, tlen=int(f[8]), tags=tags))
    return refs, lengths, records, "\n".join(header_lines) + "\n"


def map_reads_to_bam(mapper: str, reference: str, out_bam: str,
                     read1: str, read2: str = None,
                     interleaved: bool = False, threads: int = 1,
                     params: str = "", discard_unmapped: bool = False,
                     command_override: list = None,
                     sample_name: str = None,
                     reference_is_index: bool = False) -> str:
    """Run the mapper, sort its SAM output, write a BAM; returns out_bam.

    `command_override` substitutes the mapper invocation (used by tests and
    custom pipelines); it must emit SAM on stdout.  `reference_is_index`
    skips index generation and hands the reference path straight to the
    mapper (cli.rs minimap2-reference-is-index; minimap2 accepts a
    prebuilt .mmi transparently, mapping_index_maintenance.rs:236).
    """
    cmd = command_override or build_mapper_command(
        mapper, reference, read1, read2, interleaved, threads, params)
    if command_override is None and not reference_is_index:
        ensure_index(mapper, reference)
        if not check_for_external_command(cmd[0]):
            raise RuntimeError(
                f"external mapper {cmd[0]!r} not found on PATH "
                "(external_command_checker parity)")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    # drain stderr concurrently: mappers log progress there and block once
    # the OS pipe buffer fills, which would deadlock a stdout-first read
    import threading
    stderr_chunks = []
    drainer = threading.Thread(
        target=lambda: stderr_chunks.append(proc.stderr.read()), daemon=True)
    drainer.start()
    refs, lengths, records, header = parse_sam_stream(proc.stdout)
    drainer.join()
    stderr = stderr_chunks[0] if stderr_chunks else ""
    if proc.wait() != 0:
        raise RuntimeError(f"mapper failed ({cmd[0]}): {stderr[-2000:]}")
    if discard_unmapped:
        records = [r for r in records if not r.is_unmapped]
    records.sort(key=lambda r: (r.tid if r.tid >= 0 else 1 << 30, r.pos))
    if sample_name and "@RG" not in header:
        header += f"@RG\tID:1\tSM:{sample_name}\n"
    os.makedirs(os.path.dirname(os.path.abspath(out_bam)), exist_ok=True)
    write_bam(out_bam, refs, lengths, records, header_text=header)
    return out_bam
