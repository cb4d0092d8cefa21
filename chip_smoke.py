#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lorikeet_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero without the final
``ok`` line:

1. probe   torch/CUDA versions, the card, its capability (9, 0), nvcc.
2. build   compile csrc/pairhmm.cu (grouped, flat and wire decode kernel)
           and csrc/sw.cu
           (warp and CTA form) for sm_90a from the checkout, in parallel,
           and print their ptxas lines and each kernel instantiation's
           registers; a register spill fails the run.
3. kernel  region-shaped pairs (64 regions x 6 haplotypes of 300-650 bp x
           40 reads of 100 bp, with N, IUPAC and unknown bytes and duplicate
           tuples) and a long-read batch (500 bp and 3 kb reads): the
           grouped kernel against its plain torch version on the card
           (|d log10| <= 1e-5 on rows above -28), and after the f64
           escalation against the native f64 kernel (<= 2e-3); median times
           over >= 5 runs (CUDA events), and the host packer's (`pack_ms`).
4. flat_kernel  the same two pair sets, one row per pair, through
           pairhmm_forward_flat on the card: one launch per read-length
           class present, the flat kernel against its plain version and
           against the grouped kernel's results for the same pairs (both
           <= 1e-5), timed like the grouped one; the pairs of each class,
           the useful cells (sum of R * H) and the cells each schedule
           computes (the anti-diagonal schedule the grouped kernel runs,
           and the flat kernel's column one).
5. sw_kernel  the Smith-Waterman kernel against its plain torch version and
           the native aligner, exactly, pair by pair: `region` (64
           haplotypes of 300-650 bp x 40 reads of 100 bp with 1-3
           mismatches and a 1-6 bp indel; warp form), `strategies` (every
           overhang strategy x parameter set), `mixed` (alternates of 1, 31,
           32, 33, 127, 128, 129, 511, 512 and 1,500 bases under every
           strategy: both forms, two launches) and `long` (1-3 kb reads
           against haplotypes near the cap on the CTA form, and refs above
           the cap on the scalar route).
6. call    `lorikeet_tpu_torch.cli call -t 1` on a simulated 1 Mbp x 2
           samples x 30x genome, in turns after a short warm-up run: a card
           leg with the SW on the card (--pallas-sw), the exact f64 host
           pair-HMM (--force-cpu), the f64 pair-HMM with the SW on the card
           (--force-cpu --pallas-sw), the default card leg (the realignment
           on the native host SW), the default card leg with the haplotype
           CIGARs' SW on the native host aligner too (`gpu_hosthap`), then
           a card leg with the device activity chain
           (LORIKEET_DEVICE_ACTIVITY=1).  Same sites, alleles and genotypes,
           QUAL within 0.1, recall >= 0.99, every pair-HMM batch of a card
           leg on the card, realignment pairs of a --pallas-sw leg on the SW
           kernel, every span's activity of the device-activity leg through
           the device chain; every span's haplotype CIGARs' SW one batch on
           the SW kernel on the card legs (`hap_counts`: every SW pair on
           the card; K3 launched by those batches alone without
           --pallas-sw) and on the host on the f64 legs and `gpu_hosthap`,
           the same CIGARs and SW pairs on every leg of the host's activity
           chain; every graph that reaches the seq-graph step recovered
           and zipped in C++ on every leg of every phase (`asm_counts`:
           asm_native_zip == asm_graphs, 0 under --use-adaptive-pruning,
           the -t 4 legs' asm_graphs those of their -t 1 legs); and the
           VCFs byte-identical with and without --pallas-sw
           (card legs; f64 legs) and with the haplotype SW on the card and
           on the host (`gpu_hosthap` and `gpu`).
7. pool    three `call -t 4` legs on the same genome through the span-worker
           pool (four CPU workers; the parent's card serves their batches):
           the default card leg, --pallas-sw, --force-cpu.  Every output
           file byte-identical to its -t 1 leg's; the parent's K2 and SW
           launches, SW routes and escalations equal to the -t 1 leg's (the
           K2 launches and served batches plus one for each span rerun with
           the deletions carried from the span before); one served pair
           batch per span and none on a worker's host; the
           workers' SW batches sent to the service; the -t 1 leg's
           haplotype CIGARs and SW pairs, on a card leg each span's batch a
           `"hsw"` request to the service's K3; no worker with torch
           imported, CUDA initialised or a module of jax or the JAX
           package; and while the
           workers are alive `nvidia-smi` lists one process on the card, and
           two with a spawned child that opens a context (the control).
           Then the user's command line with no -t (the default 8) in a
           process of its own: its VCF is the -t 1 card leg's.
8. genotype  `genotype` at -t 1 and -t 4 on the card, same genome: every
           output file (VCF, strain coverages, the three ANI tables, the
           strain FASTAs) identical.
8b. devices  `call` over a device list of two (--devices auto with the card
           enumeration replaced: the first two cards, or with one card the
           first card twice, `cards_distinct: false`), same genome:
           `gpu_2card` (-t 1, LORIKEET_DEVICE_ACTIVITY=0) writes the `gpu`
           leg's files; `gpu_2card_act` (-t 1, the chain on by the JAX rule)
           the `gpu_act` leg's sites, alleles and genotypes with QUAL within
           0.1, every span through the chain; `gpu_2card_t4` (-t 4) the
           `gpu` leg's files; `gpu_act_t4` (one card, -t 4,
           LORIKEET_DEVICE_ACTIVITY=1) the `gpu_act` leg's files, every
           span's chain an "act" request to the service.  On each two-card
           leg both list positions launch K2 and no batch runs on a host;
           no -t 4 worker imports torch.
8c. strains  `genotype --qual-by-depth-filter 8` on three simulated strain
           mixtures (testkit.strains, built from bench.py's seeds):
           `strains_2` (100 kb, two strains of 40 random SNPs, four samples
           at 30x) and `strains_linked` (40 kb, SNPs every 240 bp at offsets
           0 and 120) at -t 1 and -t 4 on the card and at -t 1 under
           --force-cpu; `strains_12` (1 Mbp, three strains with a SNP about
           every 3 kb each, twelve samples mixed by a seeded Dirichlet, 15x
           each) at -t 4 on the card and under --force-cpu.  The -t 4 files
           equal the -t 1 ones; card and f64 legs call the same sites,
           alleles, GT, VG and ST, QUAL within 0.1; strains_2's variant
           groups are pure and complete and strains_linked's ST sets are the
           planted strains (bench.py's bars); every leg clusters once with
           the port's HDBSCAN (strains_12 after umap_embed) and imports no
           scikit-learn; card legs launch K2 and run no pair batch on a
           host.  The earlier phases' pools are alive, so at -t 4 the two
           small genomes ride a pool as a follow-on genome does.  The
           clustering is timed again on the card leg's VCF (read_vcf ->
           split_contexts -> cluster_variants): umap_embed and HDBSCAN.
8d. modes  the CLI's other modes on the same genome, each a card leg against
           an f64 (--force-cpu) leg: same sites, alleles and genotypes, QUAL
           within 0.1, every card leg's pair batches on K2 with none on a
           host.  `mixed`: a long-read BAM of the planted variants at 10x
           (testkit.longreads: 2-3 kb reads, 2 % substitutions, quality 22)
           beside the short reads (`-l`), --pallas-sw at -t 4 and -t 1 on
           the card (the same files) and -t 4 under --force-cpu; recall >=
           0.99, K3 launches split by form, each pair batch's longest read
           and haplotype, the escalation share, and the -t 1 leg's largest
           K2 and SW batches replayed against their plain versions (the
           `kernel` and `sw_main_path` lines `mixed_reads`, with pack_ms).
           `consensus` (-l, -t 4): the consensus FASTAs byte-identical.
           `summarise` on the mixed card and f64 VCFs: exit 0, the tables
           written, the files that differ reported.  `chunk_shard`: `call
           -t 1` in two processes at once (LORIKEET_PROCESS_INDEX 0 and 1 of
           2; two CUDA contexts on the card), then two under --force-cpu:
           both card processes launch K2, the gatherers' VCFs agree, and the
           files that differ from the one-process -t 1 legs are reported.
           `knobs`: --pcr-indel-model none, --pair-hmm-gap-continuation-
           penalty 20, --phred-scaled-global-read-mismapping-rate 30 with
           --disable-symmetric-hmm-normalizing, --use-adaptive-pruning and
           --features-vcf on the planted truth, each at -t 4.
8e. paths  the CLI's remaining paths on the same genome, each at -t 4 (the
           earlier phases' pools alive) as a card leg against an f64 leg
           with `compare`'s bars (same sites, alleles and genotypes, QUAL
           within 0.1, K2 launched and no pair batch on a host on every card
           leg); one `paths` line a leg.  `dnds_fst`: --calculate-dnds
           --gff-file (testkit.genes: about one CDS a kb) --calculate-fst,
           --qual-by-depth-filter 8; the dN/dS and Fst tables equal
           between card and f64.  `raw_reads`: --single on FASTQ names a
           stub `minimap2` (testkit.mapper) maps to each sample BAM's SAM:
           the BAM-input -t 4 card leg's sites and K2 launches, the cached
           BAMs byte-identical between card and f64; then --pallas-sw on
           the cached BAMs (the same VCF bytes, K3 launched), its largest SW
           batch replayed against the native aligner (`sw_main_path` line
           `raw_reads`).  `limit`: --limiting-interval 200000-700000: no
           site outside, the whole-genome card leg's sites 1 kb inside each
           end, fewer K2 launches.  `cache`: the default card leg into its
           own directory, again (`"cached": true`, no K2 launch, no file
           touched), then --force (K2 again, the same VCF bytes).
           `split_bams`: the genome cut in two at 500 kb (`gA~contig1`,
           `gB~contig1`), the BAMs rewritten against it, --split-bams; each
           genome's card VCF against its f64 VCF.  `steal`: a chunk-shard
           `call -t 1` in which only process 0 of 2 runs, with
           LORIKEET_SHARD_GRACE 3: K2 launched for every unit, its own and
           the stolen ones, and the `chunk_shard` gathered VCF byte for
           byte.  The SAMs and the halves are written in two spawned
           processes while the first legs run.
8f. wire   the wire path on the same genome.  The measured
           host-to-card rate and the auto gate's verdict (`wire_gate`).
           `wire_t1`: -t 1 with LORIKEET_WIRE_COMPRESS=1: every file the
           `gpu` leg's, the decode kernel launched, no batch on a host.
           The -t 4 card legs of `pool` and `knobs` (every -t 4 leg checks
           that each served batch came as a wire or a flat job and each
           wire job was decoded once): their workers packed in the gate's
           form.  Wire against flat at -t 4 (LORIKEET_WIRE_COMPRESS 1 then
           0, each starts its pool, then 0, 1, 1, 0, 0, 1 on the warm
           pools): every file the `gpu` leg's, the decode kernel launched
           on each wire leg, the walls and pair-HMM stages.  The service
           depth (pool.SERVICE_DEPTH set to 1 / 2 on the warm flat pool, in
           turns 1, 2, 2, 1): the same files, the walls.  Then the decode
           kernel on the main-path batch and on it with a haplotype of the
           next odd length above the longest (an odd width): byte for byte
           against its plain version and the flat planes, K2 on its planes
           bit for bit against K2 on the flat ones, the kernel timed alone
           and with its wrapper, the plain version beside them
           (`wire_kernel` lines).
9. main_path  the largest pair-HMM batch of the first card leg, replayed:
           grouped kernel against the plain version, both timed; and the
           same batch one row per pair through the flat kernel
           (flat_kernel line `main_path`).
10. sw_main_path  the largest realignment SW batch of the first card leg,
           replayed: kernel, plain version and native aligner, all timed,
           and the whole align_batch_cuda call (`call_ms`).  Then the
           largest haplotype SW batch of the first card leg (N-padded
           window/haplotype pairs, NEW_SW_PARAMETERS, SOFTCLIP) against
           the plain version and the native aligner (`sw_main_path` line
           `hap_main_path`).
10b. hap_span  one dense span (portbench's short configuration, a 40 kbp
           contig of the strain mix, HAP_SPAN_SEED) through _call_span at
           -t 1 with its haplotype SW one K3 batch and on the host: the
           same haplotypes, CIGARs and pairs region by region, every SW
           pair on the card, both K3 forms launched; the batch replayed
           against the plain version and the native aligner, timed
           (`sw_main_path` line `hap_span`).
11. region_batch  region_batch_step at world size 1 on the flattened
           main-path batch with sample ids and depths from the seed: lk
           against the f64 host kernel after the escalation rule (<= 2e-3),
           the depth totals against numpy.
12. activity  smoothed_activity_device on the longest span of the
           device-activity leg (its real gls and HQ means) against the host
           active_probabilities + band_pass_smooth (atol 2e-3), timed; and
           split over the two-card list (within 1e-5 of one card), timed.
12b. nccl  initialize_distributed at world size 1 on the card (NCCL puts no
           two ranks on one card): an all_reduce, an all_gather and a
           barrier over NCCL, then pairhmm_forward_sharded on the main-path
           batch, region_batch_step and sharded_smoothed_activity on the
           `activity` span under that group, each against its result
           without a group (1e-5; 2e-3 after the escalation and 1e-2 for
           the depth totals; 1e-5); the group destroyed after.
13. dryrun  parallel.dryrun.dryrun(1) on the card: the sharded activity
           step, the region-batch step and a small `call` over a planted SNP.
14. trace  the default card leg, the --pallas-sw one and the -t 4 default
           leg again, each under torch.profiler, for the share of the run
           the card sits idle.
15. entry  entry()'s fn, the batched pair-HMM wavefront (torch ops), on the
           card against the same example on the host (1e-4), timed.

The line before the last lists the four kernels (launches on the path that
runs each, counted from 0 just before it: the wire decode's on the first
-t 4 leg with the wire form forced on; K3's launches by form on the
`mixed` card leg; largest error against the plain version; main-path
times; the bound, the least time the card could take for the same work),
then the card's name and power limit; the last is the
``ok`` line.  Exits 1 when there is no CUDA device.  Needs one card, no
network.
"""
import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time

KERNEL_TOL = 1e-5        # kernel vs plain torch version, same card, f32
EXACT_TOL = 2e-3         # after f64 escalation vs the native f64 kernel
QUAL_TOL = 0.1           # GPU leg vs f64 leg (docs/benchmarks.md:292-298)
MIN_RECALL = 0.99
GENOME_KBP = 1000
ACTIVITY_TOL = 2e-3      # device activity chain (f32) vs the host chain
ACTIVITY_SPLIT_TOL = 1e-5  # the chain split by position vs on one card
TIMED_RUNS = 7
#: published peaks of one H100 SXM (NVIDIA's data sheet): device memory
#: bytes/s, f32 operations/s outside the tensor cores, and int32
#: operations/s (64 INT32 lanes an SM against 128 FP32 lanes whose FMA counts
#: twice: a quarter of the f32 figure)
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_I32_OPS_S = PEAK_F32_OPS_S / 4
#: operations per DP cell that the function needs, counted term by term
#: from its recurrence; index arithmetic, bounds tests, base-bit tests and
#: whatever depends on the read row alone (1 - eps, eps/3, mm, 1 - gg:
#: hoisted out of the cell loop) are not counted.
#: pair-HMM (csrc/pairhmm.cu), f32 multiplies and adds: M = prior * (Pm * mm
#: + Ps * (1 - gg)) 4; I = am * mi + ai * gg 3; D = M * md + D * gg 3; the
#: I + D the next M reads 1; the rescaling of five values and the maximum of
#: three, once in 8 diagonals, 1; the last row's sum is 2 / R and left out.
PAIRHMM_OPS_PER_CELL = 12
#: Smith-Waterman (csrc/sw.cu), int32, with the gap lengths that the native
#: recurrence carries: substitution score (compare, select, add) 3; each of
#: the two gaps (open add, extend add, compare, value select, length add,
#: length select) 6; the choice of three (two maxima, two compares, a
#: negation and two selects for the backtrack value) 7; the floor 1.
SW_OPS_PER_CELL = 23
#: csrc/<name>.cu of every kernel of the main path
KERNEL_SOURCES = ("pairhmm", "sw")
#: the e2e legs in turns, so that drift on the host hits both alike
LEG_ORDER = ("gpu_sw", "f64", "f64_sw", "gpu", "gpu_hosthap", "gpu_act")
#: `call` flags of each leg: "gpu" is the default path on a card (each
#: span's haplotype CIGARs' SW on the SW kernel, the realignment SW on the
#: native host aligner), the "_sw" legs run the realignment SW on the card
#: too; the f64 legs take the haplotype SW on the host
LEG_FLAGS = {"gpu": [], "gpu_sw": ["--pallas-sw"], "f64": ["--force-cpu"],
             "f64_sw": ["--force-cpu", "--pallas-sw"], "gpu_hosthap": [],
             "gpu_act": []}
#: the leg that runs the activity chain on the card
LEG_ENV = {"gpu_act": {"LORIKEET_DEVICE_ACTIVITY": "1"}}
#: the card leg whose haplotype SW runs on the native host aligner
#: (processing._hap_sw_device giving None), as a run without a card's does
HAP_ON_HOST = ("gpu_hosthap",)
#: legs whose VCFs must be byte-identical: only the SW's device differs
#: (the realignment's; the haplotype CIGARs'; the realignment's)
SAME_VCF = (("gpu", "gpu_sw"), ("gpu_hosthap", "gpu"), ("f64", "f64_sw"))
#: the dense span of the `hap_span` phase: portbench's short configuration
#: cut to one contig of this many kbp under its strain mix, and the seed
HAP_SPAN_KBP = 40
HAP_SPAN_SEED = 4200000101
#: -t of the pool legs: four workers beside the parent on the 8 cores
POOL_THREADS = 4
#: the pool legs and the -t 1 legs whose outputs they must equal, in the
#: order they run; the default card leg last, so that its workers are alive
#: for the nvidia-smi reading and the genotype leg takes its pool
POOL_LEGS = (("gpu_sw_t4", "gpu_sw"), ("f64_t4", "f64"), ("gpu_t4", "gpu"))
#: the legs over a device list: (label, -t, two cards, environment, the leg
#: whose outputs it must write, whether they must be byte-identical).  No
#: variable set means LORIKEET_DEVICE_ACTIVITY is unset: the JAX rule
#: decides (on over two cards at -t 1, off at -t 4)
DEVICE_LEGS = (
    ("gpu_2card", 1, True, {"LORIKEET_DEVICE_ACTIVITY": "0"}, "gpu", True),
    ("gpu_2card_act", 1, True, {}, "gpu_act", False),
    ("gpu_2card_t4", POOL_THREADS, True, {}, "gpu", True),
    ("gpu_act_t4", POOL_THREADS, False, {"LORIKEET_DEVICE_ACTIVITY": "1"},
     "gpu_act", True))
#: the `strains` phase's legs: (label, `genotype` flags, -t); each adds
#: STRAIN_FLAGS, as bench.py runs its genotype datasets.  The first card
#: leg is held against the f64 leg; a -t 4 leg against the -t 1 card leg
STRAIN_FLAGS = ["--qual-by-depth-filter", "8"]
STRAIN_LEGS_4 = (("gpu", [], 1), ("gpu_t4", [], POOL_THREADS),
                 ("f64", ["--force-cpu"], 1))
STRAIN_LEGS_12 = (("gpu_t4", [], POOL_THREADS),
                  ("f64_t4", ["--force-cpu"], POOL_THREADS))
#: strains_12's genome (kbp) and its samples; cut the length, never the
#: samples, if the smoke nears its limit
STRAINS_12_KBP = 1000
STRAINS_12_SAMPLES = 12
#: the `modes` phase: the long-read BAM's coverage beside the short reads,
#: and the `knobs` legs' flag sets (None: the planted truth's VCF)
LONG_COVERAGE = 10.0
KNOB_LEGS = (
    ("pcr_indel_none", ["--pcr-indel-model", "none"]),
    ("gap_continuation_20", ["--pair-hmm-gap-continuation-penalty", "20"]),
    ("mismapping_30_asymmetric",
     ["--phred-scaled-global-read-mismapping-rate", "30",
      "--disable-symmetric-hmm-normalizing"]),
    ("adaptive_pruning", ["--use-adaptive-pruning"]),
    ("features_vcf", ["--features-vcf", None]))
ENTRY_TOL = 1e-4         # entry()'s fn on the card vs on the host, f32 both
#: the `paths` phase: dnds_fst's site filter (the planted variants are
#: heterozygous, QD ~12-25: at the default 25 most would not count), the
#: limit leg's interval and the margin inside it where its sites must be
#: the whole genome's, where split_bams cuts the genome in two, and the
#: steal leg's LORIKEET_SHARD_GRACE
PATHS_QD_FILTER = ["--qual-by-depth-filter", "8"]
PATHS_LIMIT = (200_000, 700_000)
PATHS_LIMIT_MARGIN = 1_000
PATHS_SPLIT_AT = 500_000
PATHS_SHARD_GRACE_S = 3
#: the `wire` phase: the -t 1 leg with the wire form forced on; wire
#: against flat at -t 4 and the service depth, in turns
WIRE_LEG_ENV = {"LORIKEET_WIRE_COMPRESS": "1"}
#: LORIKEET_WIRE_COMPRESS a -t 4 leg: the first leg of each setting starts
#: its pool (spawn, BAM decode in the workers) and is reported apart; the
#: next six are timed in turns
WIRE_T4_ORDER = ("1", "0", "0", "1", "1", "0", "0", "1")
#: pool.SERVICE_DEPTH a -t 4 leg on the warm flat pool, in turns
DEPTH_ORDER = (1, 2, 2, 1)
#: cycles the card sleeps before a timed launch, so that the host has
#: issued it (checks, allocations) before the start event: ~1 ms at the
#: H100's clocks, ten times the decode wrapper's host time
QUEUE_CYCLES = 2_000_000


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


def check(cond, msg: str):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_median_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median of ``runs`` timings of fn() after one warm-up, each between
    two CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def queued_median_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median of ``runs`` timings of fn()'s work on the card alone: the
    card sleeps QUEUE_CYCLES first, so fn's launches are queued before the
    start event runs, and the events bracket the kernels, not the host's
    issue of them."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def host_median_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median of ``runs`` host-clock timings of fn() after one warm-up; fn
    leaves no work on the card behind."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def bound(ops: float, peak_ops_s: float, nbytes: int) -> dict:
    """The least time the card could take: the larger of the operations
    over the peak rate for their type and the bytes (each input read once,
    each output written once) over the memory rate."""
    ops_ms = ops / peak_ops_s * 1e3
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_ops": ops, "bound_bytes": nbytes}


def tensor_bytes(*tensors) -> int:
    return int(sum(x.numel() * x.element_size() for x in tensors))


def ptxas_registers(log: str) -> dict:
    """{kernel<K>: registers} from ``ptxas -v``: each "Used N registers"
    line follows its "Compiling entry function" line."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"([a-z_]+kernel)ILi(-?\d+)E", m.group(1))
            name = f"{t.group(1)}<{t.group(2)}>" if t else m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = int(m.group(1))
            name = None
    return out


def flat_work(read_lens, hap_lens, rpad: int) -> dict:
    """Cells of a flat batch: useful (sum of R * H), and computed by a warp
    (32 lanes x strip rows x steps) in the anti-diagonal schedule of
    ``sweep`` with the strip a batch's Rpad gives it (4, 8 or 16 rows a
    lane; scratch strips of ceil((R + 1) / 32) rows past 512), and in the
    flat kernel's column schedule, whose strip is the pair's class K (class
    0 keeps the anti-diagonal one)."""
    import numpy as np

    from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
    R = np.asarray(read_lens, np.int64)
    H = np.asarray(hap_lens, np.int64)
    diagonals = pc._round_up(R + H, pc.GROUP)
    scratch_rows = 32 * ((R + 32) // 32)
    k_old = rpad // 32
    old_rows = next((32 * k for k in (4, 8, 16) if k_old <= k), None)
    old = (old_rows if old_rows else scratch_rows) * diagonals
    kclass = pc.flat_classes(R)
    new = np.where(kclass > 0, 32 * kclass * pc.flat_steps(R, H, kclass),
                   scratch_rows * diagonals)
    return {"useful_cells": int((R * H).sum()),
            "computed_cells_old": int(old.sum()),
            "computed_cells_new": int(new.sum()),
            "mean_read_len": float(R.mean()), "mean_hap_len": float(H.mean())}


def region_pairs(rng, n_regions=64, n_haps=6, n_reads=40, read_len=100):
    """Region-shaped (read x haplotype) cross products with ambiguous bytes
    and duplicate tuples."""
    import numpy as np
    bases = np.frombuffer(b"ACGT", np.uint8)
    odd = np.frombuffer(b"NRYX", np.uint8)
    pairs = []
    for _ in range(n_regions):
        hap_len = int(rng.integers(300, 651))
        ref = bases[rng.integers(0, 4, hap_len)]
        haps = [ref]
        for _ in range(n_haps - 1):
            h = ref.copy()
            h[rng.integers(0, hap_len, 2)] = bases[rng.integers(0, 4, 2)]
            if rng.random() < 0.3:
                h[int(rng.integers(0, hap_len))] = odd[int(rng.integers(0, 4))]
            haps.append(h)
        for _ in range(n_reads):
            lo = int(rng.integers(0, hap_len - read_len + 1))
            read = ref[lo:lo + read_len].copy()
            read[rng.integers(0, read_len, 2)] = bases[rng.integers(0, 4, 2)]
            if rng.random() < 0.2:
                read[int(rng.integers(0, read_len))] = \
                    odd[int(rng.integers(0, 4))]
            q = rng.integers(6, 41, read_len).astype(np.uint8)
            iq = np.full(read_len, 45, np.uint8)
            iq[rng.integers(0, read_len, 5)] = rng.integers(10, 45, 5)
            gcp = np.full(read_len, 10, np.uint8)
            for h in haps:
                pairs.append((h, read, q, iq, iq, gcp))
        pairs.extend(pairs[-3:])                    # duplicate tuples
    return pairs


def long_pairs(rng):
    import numpy as np
    bases = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for read_len in (500, 3000):
        hap_len = read_len + 300
        ref = bases[rng.integers(0, 4, hap_len)]
        haps = [ref, ref.copy()]
        haps[1][rng.integers(0, hap_len, 4)] = bases[rng.integers(0, 4, 4)]
        read = ref[150:150 + read_len].copy()
        read[rng.integers(0, read_len, 3)] = bases[rng.integers(0, 4, 3)]
        q = np.full(read_len, 35, np.uint8)
        o = np.full(read_len, 45, np.uint8)
        g = np.full(read_len, 10, np.uint8)
        pairs.extend((h, read, q, o, o, g) for h in haps)
    return pairs


def kernel_phase(name, pairs, dev, timed: bool) -> dict:
    import numpy as np
    import torch

    from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
    from lorikeet_tpu_torch.ops.pairhmm import (
        F32_SUSPECT_LOG10, pairhmm_forward_checked, pairhmm_forward_f64,
    )

    arrays, out_pos = pc.prepare_grouped_jobs(pairs, wire=False)
    t = pc.to_tensors(arrays, dev)
    pos = torch.from_numpy(out_pos).to(dev)
    launches = pc.LAUNCHES
    got = pc.pairhmm_grouped_cuda(t)[pos]
    torch.cuda.synchronize()
    check(pc.LAUNCHES == launches + 1, f"{name}: kernel launch not counted")
    plain = pc.pairhmm_sweep_torch(t)[pos]
    got = got.cpu().numpy().astype(np.float64)
    plain = plain.cpu().numpy().astype(np.float64)
    check(np.all(np.isfinite(got)), f"{name}: non-finite kernel output")
    keep = plain > F32_SUSPECT_LOG10
    check(keep.any(), f"{name}: no rows above the escalation bound")
    err = float(np.abs(got[keep] - plain[keep]).max())
    check(err <= KERNEL_TOL, f"{name}: kernel vs plain {err} > {KERNEL_TOL}")
    exact = pairhmm_forward_f64(pairs)
    checked = pairhmm_forward_checked(got, pairs)
    err64 = float(np.abs(checked - exact).max())
    check(err64 <= EXACT_TOL, f"{name}: vs f64 {err64} > {EXACT_TOL}")
    uniq = {(id(p[0]), id(p[1])): len(p[0]) * len(p[1]) for p in pairs}
    out = {"pairs": len(pairs), "blocks": int(arrays["tile_tab"].size),
           "rpad": int(arrays["quals"].shape[1]),
           "cells": int(sum(uniq.values())),
           "max_abs_err_vs_plain": err, "max_abs_err_vs_f64": err64,
           "escalated_rows": int((~keep).sum()),
           # unique pairs only: duplicate tuples share one table cell
           **bound(PAIRHMM_OPS_PER_CELL * sum(uniq.values()), PEAK_F32_OPS_S,
                   tensor_bytes(*(v for v in t.values()
                                  if isinstance(v, torch.Tensor)))
                   + 4 * len(uniq))}
    if timed:
        ms = cuda_median_ms(lambda: pc.pairhmm_grouped_cuda(t))
        plain_ms = cuda_median_ms(lambda: pc.pairhmm_sweep_torch(t),
                                  runs=5)
        t0 = time.perf_counter()
        pc.pairhmm_forward_grouped(pairs, dev)
        forward_ms = (time.perf_counter() - t0) * 1e3
        pack_ms = host_median_ms(
            lambda: pc.prepare_grouped_jobs(pairs, wire=False))
        out.update(ms=ms, plain_ms=plain_ms, forward_ms=forward_ms,
                   pack_ms=pack_ms,
                   gcups=out["cells"] / (ms * 1e-3) / 1e9,
                   plain_gcups=out["cells"] / (plain_ms * 1e-3) / 1e9)
    emit("kernel", batch=name, **out)
    return out


def flat_kernel_phase(name, pairs, dev, timed: bool) -> dict:
    """``pairs`` one row per pair through pairhmm_forward_flat on the card:
    against the plain version and against the grouped kernel's results for
    the same pairs."""
    import numpy as np
    import torch

    from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
    from lorikeet_tpu_torch.ops.pairhmm import (
        F32_SUSPECT_LOG10, pack_pairhmm_batch,
    )

    a = pack_pairhmm_batch(pairs)
    args = (a["haps"], a["hap_lens"], a["reads"], a["read_lens"], a["quals"],
            a["ins_quals"], a["del_quals"], a["gcps"])
    arrays = pc.pack_flat_inputs(*args)
    groups = arrays["groups"]
    launches = pc.FLAT_LAUNCHES
    got = pc.pairhmm_forward_flat(*args, device=dev).astype(np.float64)
    check(pc.FLAT_LAUNCHES == launches + len(groups),
          f"{name}: {pc.FLAT_LAUNCHES - launches} flat launches counted for "
          f"classes {groups}")
    check(got.shape == (len(pairs),) and np.all(np.isfinite(got)),
          f"{name}: flat kernel output shape or non-finite values")
    t = pc.to_tensors(arrays, dev)
    plain = pc.pairhmm_flat_torch(t).cpu().numpy().astype(np.float64)
    grouped = pc.pairhmm_forward_grouped(pairs, dev)
    keep = plain > F32_SUSPECT_LOG10
    check(keep.any(), f"{name}: no rows above the escalation bound")
    err = float(np.abs(got[keep] - plain[keep]).max())
    check(err <= KERNEL_TOL,
          f"{name}: flat kernel vs plain {err} > {KERNEL_TOL}")
    err_grouped = float(np.abs(got[keep] - grouped[keep]).max())
    # not equal any more: the flat kernel's column schedule rescales by the
    # same rule at other steps than the grouped kernel's anti-diagonals
    # (exact powers of two), so only log10f of a differently scaled sum,
    # FMA contraction and deep rows' denormals (escalated) differ
    check(err_grouped <= KERNEL_TOL,
          f"{name}: flat vs grouped kernel differ by {err_grouped} > "
          f"{KERNEL_TOL}")
    cells = int((a["read_lens"].astype(np.int64) * a["hap_lens"]).sum())
    out = {"pairs": len(pairs), "rpad": int(t["quals"].shape[1]),
           "hpad": int(t["haps"].shape[1]), "cells": cells,
           "classes": {str(k): {"pairs": hi - lo, "launches": 1}
                       for k, lo, hi in groups},
           "launches": len(groups),
           **flat_work(a["read_lens"], a["hap_lens"], t["quals"].shape[1]),
           "max_abs_err_vs_plain": err, "max_abs_err_vs_grouped": err_grouped,
           "escalated_rows": int((~keep).sum()),
           **bound(PAIRHMM_OPS_PER_CELL * cells, PEAK_F32_OPS_S,
                   tensor_bytes(*(v for v in t.values()
                                  if isinstance(v, torch.Tensor)))
                   + 4 * len(pairs))}
    if timed:
        ms = cuda_median_ms(lambda: pc.pairhmm_flat_cuda(t))
        plain_ms = cuda_median_ms(lambda: pc.pairhmm_flat_torch(t), runs=5)
        t0 = time.perf_counter()
        pc.pairhmm_forward_flat(*args, device=dev)
        forward_ms = (time.perf_counter() - t0) * 1e3
        out.update(ms=ms, plain_ms=plain_ms, forward_ms=forward_ms,
                   gcups=cells / (ms * 1e-3) / 1e9,
                   plain_gcups=cells / (plain_ms * 1e-3) / 1e9)
    emit("flat_kernel", batch=name, **out)
    return out


def region_batch_phase(pairs, dev) -> dict:
    """region_batch_step at world size 1 on the main path's largest batch,
    one row per pair, with sample ids and depths from the seed."""
    import numpy as np

    from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
    from lorikeet_tpu_torch.ops.pairhmm import (
        pack_pairhmm_batch, pairhmm_forward_checked, pairhmm_forward_f64,
    )
    from lorikeet_tpu_torch.parallel.hosts import group_rank_world
    from lorikeet_tpu_torch.parallel.sharding import region_batch_step

    n_samples, n_pos = 8, 64
    rng = np.random.default_rng(1)
    sample_ids = rng.integers(0, n_samples, len(pairs)).astype(np.int32)
    depths = rng.random((len(pairs), n_pos), np.float32)
    a = pack_pairhmm_batch(pairs)
    n_classes = len(set(pc.flat_classes(a["read_lens"]).tolist()))
    launches = pc.FLAT_LAUNCHES
    t0 = time.perf_counter()
    lk, total = region_batch_step(None, n_samples=n_samples, device=dev)(
        a["haps"], a["hap_lens"], a["reads"], a["read_lens"], a["quals"],
        a["ins_quals"], a["del_quals"], a["gcps"], sample_ids, depths)
    step_ms = (time.perf_counter() - t0) * 1e3
    check(pc.FLAT_LAUNCHES == launches + n_classes,
          f"region_batch: {pc.FLAT_LAUNCHES - launches} flat launches for "
          f"{n_classes} read-length classes")
    check(lk.shape == (len(pairs),) and total.shape == (n_samples, n_pos),
          f"region_batch: shapes {lk.shape}, {total.shape}")
    exact = pairhmm_forward_f64(pairs)
    err64 = float(np.abs(pairhmm_forward_checked(lk, pairs) - exact).max())
    check(err64 <= EXACT_TOL, f"region_batch: lk vs f64 {err64} > {EXACT_TOL}")
    want = np.zeros((n_samples, n_pos), np.float64)
    np.add.at(want, sample_ids, depths.astype(np.float64))
    # f32 sums of ~1,500 values in [0, 1) per cell, in the order the card's
    # atomics take them
    err_total = float(np.abs(total - want).max())
    check(err_total <= 1e-2, f"region_batch: depth totals off by {err_total}")
    out = {"world_size": group_rank_world()[1], "pairs": len(pairs),
           "n_samples": n_samples, "positions": n_pos,
           "flat_launches": pc.FLAT_LAUNCHES - launches,
           "max_abs_err_vs_f64": err64, "max_abs_err_total": err_total,
           "step_ms": step_ms}
    emit("region_batch", **out)
    return out


def one_card() -> list:
    """The device list of the one-card legs: the first card."""
    import torch
    return [torch.device("cuda", 0)]


def two_cards() -> list:
    """The device list of the two-card legs: the first two cards, or the
    first card twice on a machine with one."""
    import torch
    n = torch.cuda.device_count()
    return [torch.device("cuda", 0), torch.device("cuda", 1 if n > 1 else 0)]


def activity_phase(span, dev) -> dict:
    """The device activity chain on one real span of the `call` run (the
    arguments processing._call_span passed) against the host chain, on
    one card and split over the two-card list."""
    import numpy as np
    import torch

    from lorikeet_tpu_torch.models.activity import (
        active_probabilities, band_pass_smooth,
    )
    from lorikeet_tpu_torch.parallel.pipeline import smoothed_activity_device

    args, kwargs = span
    kwargs = {**kwargs, "devices": dev}
    gls, hq_mean, ploidy, het, het_std, conf = args
    prop = kwargs["max_prob_propagation"]
    got = smoothed_activity_device(*args, **kwargs)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        host = band_pass_smooth(
            active_probabilities(gls, ploidy, het, het_std, conf), hq_mean,
            max_prob_propagation=prop)
        times.append((time.perf_counter() - t0) * 1e3)
    check(got.shape == host.shape == (gls.shape[1],)
          and np.all(np.isfinite(got)), "activity: shape or non-finite")
    err = float(np.abs(got - host).max())
    check(err <= ACTIVITY_TOL, f"activity: device vs host {err}")
    check(host.max() > 0.0, "activity: the span has no active position")
    ms = cuda_median_ms(lambda: smoothed_activity_device(*args, **kwargs),
                        runs=5)
    cards = two_cards()
    split_kwargs = {**kwargs, "devices": cards}
    split = smoothed_activity_device(*args, **split_kwargs)
    err_split = float(np.abs(split - got).max())
    check(split.shape == got.shape and err_split <= ACTIVITY_SPLIT_TOL,
          f"activity: split over {cards} vs one card {err_split}")
    split_ms = cuda_median_ms(
        lambda: smoothed_activity_device(*args, **split_kwargs), runs=5)
    out = {"samples": int(gls.shape[0]), "positions": int(gls.shape[1]),
           "active_positions": int((host > 0).sum()),
           "max_abs_err_vs_host": err, "ms": ms,
           "host_ms": sorted(times)[1], "two_card_ms": split_ms,
           "max_abs_err_two_card_vs_one": err_split,
           "cards": [str(c) for c in cards],
           "cards_distinct": cards[0] != cards[1]}
    emit("activity", **out)
    return out


def dryrun_phase(dev) -> dict:
    from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
    from lorikeet_tpu_torch.parallel.dryrun import dryrun

    flat, grouped = pc.FLAT_LAUNCHES, pc.LAUNCHES
    t0 = time.perf_counter()
    dryrun(1, device=dev)
    out = {"world_size": 1, "seconds": time.perf_counter() - t0,
           "flat_launches": pc.FLAT_LAUNCHES - flat,
           "grouped_launches": pc.LAUNCHES - grouped}
    check(out["flat_launches"] > 0 and out["grouped_launches"] > 0,
          f"dryrun: launches {out}")
    emit("dryrun", **out)
    return out


def sw_read(rng, hap, read_len):
    """A read of ``hap`` with 1-3 mismatches and one 1-6 bp indel: never
    an exact substring of a random haplotype, so no shortcut takes it."""
    import numpy as np
    bases = np.frombuffer(b"ACGT", np.uint8)
    read_len = min(read_len, len(hap))
    lo = int(rng.integers(0, len(hap) - read_len + 1))
    read = hap[lo:lo + read_len].copy()
    pos = rng.choice(read_len, min(read_len, int(rng.integers(1, 4))),
                     replace=False)
    idx = np.searchsorted(bases, read[pos])
    read[pos] = bases[(idx + rng.integers(1, 4, pos.size)) % 4]
    n, k = int(rng.integers(1, 7)), int(rng.integers(0, read_len + 1))
    if rng.random() < 0.5 or read_len <= n:
        read = np.concatenate([read[:k], bases[rng.integers(0, 4, n)],
                               read[k:]])
    else:
        read = np.delete(read, np.arange(k, min(k + n, read_len)))
    out = read.tobytes()
    if hap.tobytes().rfind(out) >= 0:      # a 1-3 base read may still occur
        out += b"N"
    return out


def sw_region_pairs(rng, n_regions=64, n_reads=40, read_len=100):
    """Realignment-shaped pairs: per region one haplotype of 300-650 bp
    and 40 reads of 100 bp."""
    import numpy as np
    bases = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for _ in range(n_regions):
        hap = bases[rng.integers(0, 4, int(rng.integers(300, 651)))]
        pairs.extend((hap.tobytes(), sw_read(rng, hap, read_len))
                     for _ in range(n_reads))
    return pairs


def sw_strategy_batches(rng, n=64):
    """(strategy, parameters, pairs) for every overhang strategy and
    parameter set: haplotypes of 1-400 bp, reads of 1-150 bp, some longer
    than their haplotype."""
    import numpy as np

    from lorikeet_tpu_torch.ops import smith_waterman as swm
    bases = np.frombuffer(b"ACGT", np.uint8)
    params = (swm.ORIGINAL_DEFAULT, swm.STANDARD_NGS, swm.NEW_SW_PARAMETERS,
              swm.ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS)
    out = []
    for strategy in range(4):
        for p in params:
            pairs = []
            for _ in range(n):
                hap = bases[rng.integers(0, 4, int(rng.integers(1, 401)))]
                if rng.random() < 0.1:      # alt longer than ref
                    pairs.append((hap.tobytes(), b"N" + bases[rng.integers(
                        0, 4, len(hap) + 10)].tobytes()))
                else:
                    pairs.append((hap.tobytes(), sw_read(
                        rng, hap, int(rng.integers(1, 151)))))
            out.append((strategy, p, pairs))
    return out


def sw_mixed_pairs(rng):
    """Alternates on both sides of every strip width of the warp form and
    of its cap, so that one batch runs both forms: each against a ref a
    little longer than itself and against a 40-base ref."""
    import numpy as np
    bases = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for alt_len in (1, 31, 32, 33, 127, 128, 129, 511, 512, 1500):
        hap = bases[rng.integers(0, 4, alt_len + int(rng.integers(0, 200)))]
        alt = hap[:alt_len].copy()
        if alt_len >= 8:          # a 3-base deletion, the length made up
            k = int(rng.integers(1, alt_len - 3))
            alt = np.concatenate([alt[:k], alt[k + 3:],
                                  bases[rng.integers(0, 4, 3)]])
        alt[rng.integers(0, alt_len, 2)] = ord("G")
        alt[0] = ord("N")         # never an exact substring: no shortcut
        pairs.append((hap.tobytes(), alt.tobytes()))
        pairs.append((hap[:40].tobytes(), alt.tobytes()))
    return pairs


def sw_long_pairs(rng):
    """1-3 kb reads against haplotypes near the kernel's cap, then two refs
    above the cap (the scalar route)."""
    import numpy as np
    bases = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for hap_len, read_len in ((8191, 1000), (8000, 2000), (7900, 3000),
                              (8192, 500), (9000, 1500)):
        hap = bases[rng.integers(0, 4, hap_len)]
        pairs.append((hap.tobytes(), sw_read(rng, hap, read_len)))
    return pairs


def sw_phase(name, pairs, params, strategy, dev, timed: bool,
             phase: str = "sw_kernel") -> dict:
    """One batch through align_batch_cuda (routes counted), and its
    batched pairs through the kernel, the plain version and the native
    aligner: all equal.  ``timed`` adds the medians of the kernel (CUDA
    events), the plain version and the native aligner."""
    import torch

    from lorikeet_tpu_torch.ops.smith_waterman import align
    from lorikeet_tpu_torch.ops import sw_cuda as sc

    counts = dict(sc.SW_COUNTS)
    t0 = time.perf_counter()
    routed = sc.align_batch_cuda(pairs, params, strategy, dev)
    batch_ms = (time.perf_counter() - t0) * 1e3
    routes = {k: sc.SW_COUNTS[k] - counts[k] for k in counts}
    t0 = time.perf_counter()
    native = [align(r, a, params, strategy) for r, a in pairs]
    native_ms = (time.perf_counter() - t0) * 1e3
    check(routed == native, f"{name}: align_batch_cuda != native align")
    batched = [(r, a) for r, a in pairs if len(r) <= sc.MAX_REF_LEN
               and not (strategy in (0, 3) and r.rfind(a) >= 0)]
    check(len(batched) == routes["device"],
          f"{name}: routes {routes} for {len(batched)} batched pairs")
    out = {"pairs": len(pairs), "strategy": strategy,
           "params": list(params.__dict__.values()), "routes": routes,
           "batch_ms": batch_ms, "native_ms": native_ms}
    if not batched:
        emit(phase, batch=name, forms={"warp": 0, "cta": 0}, **out)
        return {**out, "forms": {"warp": 0, "cta": 0}}
    t = sc.to_tensors(sc.pack_pairs(batched), dev)
    forms = {"warp": t["n_warp"], "cta": len(batched) - t["n_warp"]}
    launches = sc.SW_LAUNCHES
    got = sc.sw_align(t, params, strategy)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        check(sc.SW_LAUNCHES - launches == sum(n > 0 for n in forms.values()),
              f"{name}: {sc.SW_LAUNCHES - launches} launches counted for "
              f"forms {forms}")
    t0 = time.perf_counter()
    plain = sc.sw_align_torch(t, params, strategy)
    plain_once_ms = (time.perf_counter() - t0) * 1e3
    want = [align(r, a, params, strategy) for r, a in batched]
    vs_plain = sum(g != p for g, p in zip(got, plain))
    vs_native = sum(g != w for g, w in zip(got, want))
    check(len(got) == len(plain) == len(want) and vs_plain == 0,
          f"{name}: kernel != plain version on {vs_plain} pairs")
    check(vs_native == 0, f"{name}: kernel != native align on {vs_native} "
          "pairs")
    cells = sum(len(r) * len(a) for r, a in batched)
    # in: the sequences and the table; out: the CIGAR codes and the
    # (length, offset) table.  The backtrack slab is the kernel's own.
    moved = tensor_bytes(t["seqs"], t["meta"]) + 8 * len(batched) \
        + 4 * sum(len(c) for c, _ in got)
    out.update(batched=len(batched), forms=forms, cells=cells,
               rows_max=t["rows_max"],
               mismatches=vs_plain + vs_native,
               plain_once_ms=plain_once_ms,
               **bound(SW_OPS_PER_CELL * cells, PEAK_I32_OPS_S, moved))
    if timed:
        ms = cuda_median_ms(lambda: sc.sw_kernel_launch(t, params, strategy))
        plain_ms = cuda_median_ms(
            lambda: sc.sw_align_torch(t, params, strategy), runs=3)
        native = []
        for _ in range(3):
            t0 = time.perf_counter()
            [align(r, a, params, strategy) for r, a in batched]
            native.append((time.perf_counter() - t0) * 1e3)
        # the whole call as the main path makes it: routing, packing, the
        # copy in, the launch, the copy back and decoding
        call_ms = host_median_ms(
            lambda: sc.align_batch_cuda(pairs, params, strategy, dev))
        out.update(ms=ms, gcups=cells / (ms * 1e-3) / 1e9, plain_ms=plain_ms,
                   native_batched_ms=sorted(native)[1], call_ms=call_ms)
    emit(phase, batch=name, **out)
    return out


def sw_kernel_phase(rng, dev, timed=True) -> list:
    from lorikeet_tpu_torch.ops.smith_waterman import (
        ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS, OverhangStrategy,
    )
    best, soft = (ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS,
                  OverhangStrategy.SOFTCLIP)
    region = sw_phase("region", sw_region_pairs(rng), best, soft, dev, timed)
    check(region["routes"]["shortcut"] == 0, "region: a pair took the "
          "shortcut")
    out = [region]
    for strategy, p, pairs in sw_strategy_batches(rng):
        out.append(sw_phase(f"strategy{strategy}", pairs, p, strategy, dev,
                            timed=False))
    mixed = sw_mixed_pairs(rng)
    for strategy in range(4):
        m = sw_phase(f"mixed{strategy}", mixed, best, strategy, dev,
                     timed=False)
        check(m["forms"] == {"warp": 16, "cta": 4} and
              m["routes"]["shortcut"] == 0, f"mixed{strategy}: forms "
              f"{m['forms']}, routes {m['routes']}")
        out.append(m)
    long_ = sw_phase("long", sw_long_pairs(rng), best, soft, dev, timed=False)
    check(long_["routes"] == {"device": 3, "shortcut": 0, "scalar_long": 2}
          and long_["forms"] == {"warp": 0, "cta": 3},
          f"long: routes {long_['routes']}, forms {long_['forms']}")
    check(region["forms"]["cta"] == 0, f"region: forms {region['forms']}")
    return out + [long_]


def read_sites(vcf, tags=()):
    """[((POS, REF, ALT, GT..., the INFO values of ``tags``), QUAL)]."""
    sites = []
    for line in open(vcf):
        if line.startswith("#"):
            continue
        f = line.rstrip("\n").split("\t")
        key = (int(f[1]), f[3], f[4]) + tuple(s.split(":")[0] for s in f[9:])
        if tags:
            info = dict(kv.split("=", 1) for kv in f[7].split(";")
                        if "=" in kv)
            key += tuple(info.get(t) for t in tags)
        sites.append((key, float(f[5])))
    return sites


def same_sites(label, vcf, ref_vcf, tags=()) -> tuple:
    """(the sites of ``vcf``, the largest |QUAL| difference) once ``vcf``
    is checked to call the sites, alleles and genotypes (and the INFO
    values of ``tags``) of ``ref_vcf``, QUAL within QUAL_TOL."""
    got, want = read_sites(vcf, tags), read_sites(ref_vcf, tags)
    check([k for k, _ in got] == [k for k, _ in want],
          f"{label}: sites, alleles, genotypes or {list(tags)} differ")
    dq = max((abs(a - b) for (_, a), (_, b) in zip(got, want)), default=0.0)
    check(dq <= QUAL_TOL, f"{label}: QUAL differs by {dq} > {QUAL_TOL}")
    return got, dq


def job_codes(arrays) -> dict:
    """A grouped job's form and, for a wire job, the codebook's and symbol
    table's keys in use (key 0, the pad, and the rest are nonzero; 256 and
    16 entries, so this costs nothing inside a timed leg)."""
    import numpy as np
    if arrays.get("mode") != "wire":
        return {"mode": "flat"}
    return {"mode": "wire",
            "tuples": int(np.count_nonzero(arrays["cb"])) + 1,
            "symbols": int(np.count_nonzero(arrays["sym_tab"])) + 1}


def summarise_jobs(jobs) -> dict:
    """Per form: the jobs the parent enqueued and, for wire jobs, the most
    tuples and symbols one of them held."""
    out = {}
    for job in jobs:
        s = out.setdefault(job["mode"], {"jobs": 0})
        s["jobs"] += 1
        for key in ("tuples", "symbols"):
            if key in job:
                s[key + "_max"] = max(s.get(key + "_max", 0), job[key])
    return out


def call_leg(label, fasta, bams, outdir, extra, env=None, threads=1,
             mode="call", cards=None, hap_on_host=False):
    """One run of ``mode`` (`call`, `genotype` or `consensus`) through the
    CLI at -t ``threads`` on ``bams`` (none: the reads come in ``extra``),
    under the environment variables of ``env`` (None: unset), with
    ``cards`` (default: the first card) in the place of the visible cards
    that --devices auto takes; returns its counters (of the first genome,
    and each genome's VCF and files under ``genomes``).  The
    parent's K2 batches are seen where they are enqueued, so a batch a
    worker packed counts too (``batch_longest``).  The counting
    wrappers below see the work of this process only: at -t above 1 the
    workers' counters come back through the pool, and the parent's service
    moves LAUNCHES, CARD_LAUNCHES, SW_LAUNCHES and SW_COUNTS.  Each span's
    haplotype SW batch is seen at -t 1 (``hap_launches``, the largest
    batch returned last); ``hap_counts`` adds the parent's HAP_COUNTS and
    the workers'.  ``hap_on_host``: that SW on the native host aligner
    although the run has a card."""

    from lorikeet_tpu_torch import cli
    from lorikeet_tpu_torch import processing
    from lorikeet_tpu_torch.assembly import graph
    from lorikeet_tpu_torch.calling import engine
    from lorikeet_tpu_torch.calling import likelihoods as lk
    from lorikeet_tpu_torch.ops import pairhmm as ph
    from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
    from lorikeet_tpu_torch.ops import sw_cuda as sc
    from lorikeet_tpu_torch.parallel import pipeline
    from lorikeet_tpu_torch.parallel import pool
    from lorikeet_tpu_torch.parallel import sharding
    from lorikeet_tpu_torch.utils import cigar
    from lorikeet_tpu_torch.utils import progress

    cards = list(cards or one_card())
    work = {"regions": 0, "batches": 0, "pairs": 0, "cells": 0}
    largest = {"cells": -1, "pairs": None}
    sw_work = {"batches": 0, "device_batches": 0}
    sw_largest = {"device": 0, "pairs": None}
    hap_work = {"batches": 0, "launches": 0}
    hap_largest = {"pairs": 0, "padded": None}
    activity = {"spans": 0, "positions": -1, "span": None}
    batch_longest = []
    jobs = []
    compute = engine.compute_works_likelihoods
    align_batch = sc.align_batch_cuda
    smooth = pipeline.smoothed_activity_device
    enqueue = pc.enqueue_grouped_jobs
    calculate_cigars = cigar.calculate_cigars
    hap_sw_device = processing._hap_sw_device

    def enqueue_seen(arrays, *args, **kwargs):
        # every K2 batch of the parent, its own or served to a worker
        batch_longest.append([int(arrays["read_lens"].max()),
                              int(arrays["hap_lens"].max())])
        jobs.append(job_codes(arrays))
        return enqueue(arrays, *args, **kwargs)

    def activity_counted(*args, **kwargs):
        activity["spans"] += 1
        if args[0].shape[1] > activity["positions"]:
            activity.update(positions=args[0].shape[1], span=(args, kwargs))
        return smooth(*args, **kwargs)

    def sw_counted(pairs, *args, **kwargs):
        before = sc.SW_COUNTS["device"]
        out = align_batch(pairs, *args, **kwargs)
        n = sc.SW_COUNTS["device"] - before
        sw_work["batches"] += 1
        sw_work["device_batches"] += n > 0
        if n > sw_largest["device"]:
            sw_largest.update(device=n, pairs=list(pairs))
        return out

    def hap_counted(pairs, align_batch=None):
        # a span's haplotype CIGARs in this process: its SW batch as the
        # kernel takes it (N-padded, NEW_SW_PARAMETERS, SOFTCLIP)
        def seen(padded, parameters, strategy):
            launches = sc.SW_LAUNCHES
            out = align_batch(padded, parameters, strategy)
            hap_work["batches"] += 1
            hap_work["launches"] += sc.SW_LAUNCHES - launches
            if len(padded) > hap_largest["pairs"]:
                hap_largest.update(pairs=len(padded), padded=[
                    (r.tobytes(), a.tobytes()) for r, a in padded])
            return out
        return calculate_cigars(pairs, seen if align_batch else None)

    def counted(eng, works):
        pairs = [p for w in works for p in w.pairs]
        cells = sum(len(p[0]) * len(p[1]) for p in pairs)
        work["regions"] += len(works)
        work["batches"] += 1
        work["pairs"] += len(pairs)
        work["cells"] += cells
        if cells > largest["cells"]:
            largest.update(cells=cells, pairs=pairs)
        return compute(eng, works)

    visible_cards = sharding.visible_cards
    engine.compute_works_likelihoods = counted
    sc.align_batch_cuda = sw_counted
    pc.enqueue_grouped_jobs = enqueue_seen
    pipeline.smoothed_activity_device = activity_counted
    sharding.visible_cards = lambda: cards
    cigar.calculate_cigars = hap_counted
    if hap_on_host:
        processing._hap_sw_device = lambda cfg: None
    env = dict(env or {})
    saved_env = {k: os.environ.get(k) for k in env}
    for key, value in env.items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value
    progress.GLOBAL_STAGES = {}
    lk.DISPATCH_COUNTS.update(device=0, host=0, remote=0)
    pool.WORKER_COUNTS.update(dict.fromkeys(pool.WORKER_COUNTS, 0))
    processing.HAP_COUNTS.update(dict.fromkeys(processing.HAP_COUNTS, 0))
    graph.take_asm_counts()
    pool.SPAN_RERUNS.update(spans=0)
    pool.WORKER_REPORTS.clear()
    ph.ESCALATIONS.update(checked=0, escalated=0)
    pc.LAUNCHES = 0
    pc.CARD_LAUNCHES.clear()
    pc.WIRE_LAUNCHES = 0
    pc.WIRE_COUNTS.update(wire=0, flat=0)
    sc.SW_LAUNCHES = 0
    sc.SW_FORM_LAUNCHES.update(warp=0, cta=0)
    sc.SW_COUNTS.update(device=0, shortcut=0, scalar_long=0)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main([mode, "-t", str(threads), "-r", fasta,
                           *(["-b", *bams] if bams else []), "-o", outdir,
                           *extra])
    finally:
        engine.compute_works_likelihoods = compute
        sc.align_batch_cuda = align_batch
        pc.enqueue_grouped_jobs = enqueue
        pipeline.smoothed_activity_device = smooth
        sharding.visible_cards = visible_cards
        cigar.calculate_cigars = calculate_cigars
        processing._hap_sw_device = hap_sw_device
        for key, old in saved_env.items():
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old
    wall = time.perf_counter() - t0
    launches = pc.LAUNCHES
    card_launches = dict(pc.CARD_LAUNCHES)
    devices = [str(d) for d in sharding.get_devices()]
    sw_launches = sc.SW_LAUNCHES
    sw_forms = dict(sc.SW_FORM_LAUNCHES)
    stages = dict(progress.GLOBAL_STAGES)
    progress.GLOBAL_STAGES = None
    check(rc == 0, f"{label}: cli exit code {rc}")
    genomes = json.loads(buf.getvalue().strip().splitlines()[-1])[
        "outputs"]["genomes"]
    errors = {g: o["error"] for g, o in genomes.items() if "error" in o}
    check(not errors, f"{label}: genome errors {errors}")
    out = next(iter(genomes.values()))
    esc = dict(ph.ESCALATIONS)
    # the assembly graphs that reached the seq-graph step, the parent's and
    # the workers': every one zipped in C++ with its dangling ends
    # recovered there, none under adaptive pruning (the kmer-graph path)
    asm = {k: n + pool.WORKER_COUNTS[k]
           for k, n in graph.take_asm_counts().items()}
    check(asm["asm_native_zip"] == (0 if "--use-adaptive-pruning" in extra
                                    else asm["asm_graphs"]),
          f"{label}: assembly graphs {asm}")
    leg = {"leg": label, "mode": mode, "threads": threads, "flags": extra,
           "wall_s": wall, **work,
           "pairhmm_s": stages.get("pairhmm"),
           "stages_s": stages, "launches": launches,
           "card_launches": card_launches, "devices": devices,
           "dispatch": dict(lk.DISPATCH_COUNTS),
           "wire_launches": pc.WIRE_LAUNCHES,
           "wire_counts": dict(pc.WIRE_COUNTS),
           "jobs": summarise_jobs(jobs),
           "escalated": esc["escalated"], "checked": esc["checked"],
           "escalation_share": (esc["escalated"] / esc["checked"]
                                if esc["checked"] else 0.0),
           "batch_longest": batch_longest,
           "sw_counts": dict(sc.SW_COUNTS), "sw_launches": sw_launches,
           "sw_form_launches": sw_forms,
           "sw_batches": sw_work["batches"],
           "sw_device_batches": sw_work["device_batches"],
           "spans": work["batches"], "activity_spans": activity["spans"],
           "worker_counts": dict(pool.WORKER_COUNTS),
           "hap_counts": {k: n + pool.WORKER_COUNTS[k]
                          for k, n in processing.HAP_COUNTS.items()},
           "asm_counts": asm,
           "hap_batches": hap_work["batches"],
           "hap_launches": hap_work["launches"],
           "hap_largest_pairs": hap_largest["pairs"],
           "span_reruns": pool.SPAN_RERUNS["spans"],
           "workers": sorted(pool.WORKER_REPORTS.values(),
                             key=lambda r: r["wid"]),
           "env": env, "vcf": out["vcf"], "files": output_files(out),
           "genomes": {g: {"vcf": o["vcf"], "files": output_files(o)}
                       for g, o in genomes.items()},
           "cached": [g for g, o in genomes.items() if o.get("cached")],
           "dnds": out.get("dnds"), "fst": out.get("fst"),
           "consensus": out.get("consensus", []),
           "timings": out.get("timings", {}),
           "n_variant_groups": out.get("n_variant_groups"),
           "n_strains": out.get("n_strains")}
    return (leg, largest["pairs"], sw_largest["pairs"], activity["span"],
            hap_largest["padded"])


def call_phase(root):
    from lorikeet_tpu_torch.io.vcf import read_vcf
    from lorikeet_tpu_torch.testkit.dataset import recall, simulate_dataset

    t0 = time.perf_counter()
    fasta, bams, truth = simulate_dataset(root, GENOME_KBP, 2, 30.0, seed=0)
    emit("simulate", kbp=GENOME_KBP, samples=2, coverage=30,
         variants=len(truth), seconds=time.perf_counter() - t0)
    # a short f64 run builds the host libraries (g++, at first use), so
    # that no timed leg pays for them
    call_leg("warmup", fasta, bams, os.path.join(root, "warmup"),
             ["--force-cpu", "--limiting-interval", "0-30000"])
    legs = {}
    batch = sw_batch = span = hap_batch = None
    for run, label in enumerate(LEG_ORDER):
        leg, largest, sw_largest, leg_span, hap_largest = call_leg(
            label, fasta, bams, os.path.join(root, f"{label}{run}"),
            LEG_FLAGS[label], LEG_ENV.get(label),
            hap_on_host=label in HAP_ON_HOST)
        calls, _, _ = read_vcf(leg["vcf"])
        leg["calls"] = len(calls)
        leg["recall"] = recall(calls, truth)
        emit("call", run=run, **leg)
        if label in LEG_ENV:
            check(leg["activity_spans"] == leg["spans"] > 0,
                  f"{label} leg: {leg['activity_spans']} of {leg['spans']} "
                  "spans took the device activity chain")
            span = leg_span
        else:
            check(leg["activity_spans"] == 0,
                  f"{label} leg ran the device activity chain")
        on_card = label.startswith("gpu")
        sw_on_card = "--pallas-sw" in LEG_FLAGS[label]
        if on_card:
            check(leg["launches"] > 0, f"{label} leg launched no kernel")
            check(leg["dispatch"]["host"] == 0
                  and leg["dispatch"]["device"] > 0,
                  f"{label} leg dispatch {leg['dispatch']}")
            batch = batch or largest
        else:
            check(leg["launches"] == 0 and leg["dispatch"]["device"] == 0,
                  f"{label} leg ran the pair-HMM on the device")
        # every span's haplotype CIGARs: their SW one K3 batch a span on a
        # card leg (processing._span_hap_cigars), the native aligner on
        # the f64 legs and the host-hap leg
        check(leg["asm_counts"]["asm_graphs"] > 0,
              f"{label} leg: assembly graphs {leg['asm_counts']}")
        hap = leg["hap_counts"]
        if on_card and label not in HAP_ON_HOST:
            check(hap["hap_sw_card"] == hap["hap_sw"] > 0
                  and leg["hap_launches"] > 0 and leg["hap_batches"] > 0,
                  f"{label} leg: haplotype SW {hap}, "
                  f"{leg['hap_batches']} batches on the card, "
                  f"{leg['hap_launches']} launches")
            hap_batch = hap_batch or hap_largest
        else:
            check(hap["hap_sw_card"] == 0 < hap["hap_sw"]
                  and leg["hap_launches"] == leg["hap_batches"] == 0,
                  f"{label} leg: haplotype SW {hap}, "
                  f"{leg['hap_batches']} batches on the card")
        if sw_on_card:
            check(leg["sw_launches"] > leg["hap_launches"]
                  and leg["sw_counts"]["device"] > 0,
                  f"{label} leg: SW launches {leg['sw_launches']} "
                  f"({leg['hap_launches']} of the haplotype CIGARs), "
                  f"counts {leg['sw_counts']}")
            sw_batch = sw_batch or sw_largest
        else:
            check(leg["sw_launches"] == leg["hap_launches"]
                  and leg["sw_counts"]["device"] == 0,
                  f"{label} leg ran the realignment SW on the device: "
                  f"{leg['sw_launches']} SW launches, "
                  f"{leg['hap_launches']} of the haplotype CIGARs, "
                  f"routes {leg['sw_counts']}")
        legs[label] = leg
    # the legs on the host's activity chain assemble the same regions: the
    # same haplotype CIGARs and SW pairs wherever the SW ran
    haps = {label: (leg["hap_counts"]["hap_cigars"],
                    leg["hap_counts"]["hap_sw"])
            for label, leg in legs.items() if label not in LEG_ENV}
    check(len(set(haps.values())) == 1, f"haplotype CIGARs and SW pairs "
          f"differ between legs: {haps}")
    for plain_sw, card_sw in SAME_VCF:
        with open(legs[plain_sw]["vcf"], "rb") as a, \
                open(legs[card_sw]["vcf"], "rb") as b:
            check(a.read() == b.read(), f"the {card_sw} VCF is not "
                  f"byte-identical to the {plain_sw} one")
    sg, dq = same_sites("gpu leg against the f64 leg", legs["gpu"]["vcf"],
                        legs["f64"]["vcf"])
    gpu = legs["gpu"]
    check(gpu["recall"] >= MIN_RECALL, f"recall {gpu['recall']}")
    _, dq_act = same_sites("device-activity leg against the default card "
                           "leg", legs["gpu_act"]["vcf"], legs["gpu"]["vcf"])
    emit("compare", sites=len(sg), max_qual_diff=dq, recall=gpu["recall"],
         max_qual_diff_device_activity=dq_act,
         vcfs_identical=[list(p) for p in SAME_VCF],
         **{f"{k}_wall_s": leg["wall_s"] for k, leg in legs.items()},
         **{f"{k}_pairhmm_s": leg["pairhmm_s"] for k, leg in legs.items()})
    return legs, batch, sw_batch, hap_batch, span, (fasta, bams, sg), truth


def output_files(out: dict) -> dict:
    """{file name: path} of every file a genome's run wrote: the VCF, the
    ANI tables, in genotype mode the strain coverages and FASTAs, in
    consensus mode the consensus FASTAs, and the dN/dS and Fst tables."""
    paths = [out["vcf"], *out.get("ani", {}).values(),
             out.get("strain_coverages"), *out.get("strain_fastas", []),
             *out.get("consensus", []), out.get("dnds"), out.get("fst")]
    return {os.path.basename(p): p for p in paths if p}


def same_files(a: dict, b: dict) -> list:
    """Names of the files that differ between two runs' outputs (a file
    only one run wrote differs)."""
    def read(path):
        with open(path, "rb") as fh:
            return fh.read()
    return sorted(n for n in a.keys() | b.keys()
                  if n not in a or n not in b or read(a[n]) != read(b[n]))


def card_processes() -> list:
    """The card's compute processes as nvidia-smi lists them (pids of the
    host's namespace, not this machine's)."""
    import subprocess
    res = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi: {res.stderr.strip()}")
    return [line.strip() for line in res.stdout.splitlines() if line.strip()]


def _hold_a_context(opened, release):
    """Child of the nvidia-smi control: opens a CUDA context and holds it
    until ``release`` is set."""
    import torch
    torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    opened.set()
    release.wait(120)


def card_processes_with_a_child() -> list:
    """nvidia-smi's list while a spawned child holds a context of its own:
    the control that shows a worker with a context would be listed."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    opened, release = ctx.Event(), ctx.Event()
    child = ctx.Process(target=_hold_a_context, args=(opened, release))
    child.start()
    try:
        check(opened.wait(120), "the control child opened no context")
        return card_processes()
    finally:
        release.set()
        child.join(60)
        if child.is_alive():
            child.terminate()
            child.join(10)


def pool_phase(root, fasta, bams, legs) -> dict:
    """The -t 4 legs against their -t 1 legs (see the module docstring)."""
    out = {}
    for label, base in POOL_LEGS:
        ref = legs[base]
        leg, *_ = call_leg(label, fasta, bams, os.path.join(root, label),
                           LEG_FLAGS[base], threads=POOL_THREADS)
        diff = same_files(ref["files"], leg["files"])
        check(not diff, f"{label}: {diff} differ from the {base} leg's")
        on_card = base.startswith("gpu")
        dispatch = leg["dispatch"]
        # a span rerun with the deletions carried into it is one more pair
        # batch (on the card or, under --force-cpu, on a worker's host) and
        # more SW pairs and checked rows than the -t 1 leg has
        reruns = leg["span_reruns"]
        same = (lambda a, b: a == b) if reruns == 0 else \
            (lambda a, b: a >= b)
        check(leg["launches"] == ref["launches"] + (reruns if on_card else 0)
              and dispatch["remote"]
              == (ref["spans"] + reruns if on_card else 0)
              and dispatch["host"]
              == ref["dispatch"]["host"] + (0 if on_card else reruns)
              and dispatch["device"] == 0
              and leg["worker_counts"]["lk_batches"] == dispatch["remote"],
              f"{label}: K2 launches {leg['launches']} (-t 1: "
              f"{ref['launches']}), dispatch {dispatch}, workers sent "
              f"{leg['worker_counts']}; -t 1 spans {ref['spans']}, "
              f"{reruns} reruns")
        check(same(leg["sw_launches"], ref["sw_launches"])
              and all(same(leg["sw_counts"][k], n)
                      for k, n in ref["sw_counts"].items())
              and (leg["worker_counts"]["sw_batches"] > 0)
              == ("--pallas-sw" in ref["flags"]),
              f"{label}: SW launches {leg['sw_launches']} (-t 1: "
              f"{ref['sw_launches']}), routes {leg['sw_counts']} (-t 1: "
              f"{ref['sw_counts']}), workers sent {leg['worker_counts']}, "
              f"{reruns} reruns")
        # the spans' haplotype SW: the -t 1 leg's pairs, a "hsw" request a
        # span to the service's K3 on a card leg, the workers' host on f64
        hap, ref_hap = leg["hap_counts"], ref["hap_counts"]
        check(all(same(hap[k], ref_hap[k]) for k in hap)
              and hap["hap_sw_card"] == (hap["hap_sw"] if on_card else 0)
              and (leg["worker_counts"]["hsw_batches"] > 0) == on_card,
              f"{label}: haplotype SW {hap} (-t 1: {ref_hap}), workers "
              f"sent {leg['worker_counts']}, {reruns} reruns")
        # the pool's workers took the -t 1 leg's graphs to the seq-graph
        # step (call_leg checked that C++ zipped each)
        check(same(leg["asm_counts"]["asm_graphs"],
                   ref["asm_counts"]["asm_graphs"]),
              f"{label}: assembly graphs {leg['asm_counts']} (-t 1: "
              f"{ref['asm_counts']}), {reruns} reruns")
        check(same(leg["checked"], ref["checked"])
              and (reruns > 0 or leg["escalated"] == ref["escalated"]),
              f"{label}: escalations {leg['escalated']}/{leg['checked']}, "
              f"-t 1 {ref['escalated']}/{ref['checked']}, {reruns} reruns")
        workers = leg["workers"]
        check(workers and all(
            not (w["torch_imported"] or w["cuda_initialized"]
                 or w["foreign_modules"]) for w in workers),
              f"{label}: worker reports {workers}")
        check_wire_counts(leg)
        emit("pool", leg=label, t1_leg=base, threads=POOL_THREADS,
             wall_s=leg["wall_s"], t1_wall_s=ref["wall_s"],
             spawn_s=max(w["spawn_s"] for w in workers),
             workers_reporting=len(workers),
             pairhmm_s=leg["pairhmm_s"], t1_pairhmm_s=ref["pairhmm_s"],
             stages_s=leg["stages_s"], t1_stages_s=ref["stages_s"],
             escalation_share=leg["escalation_share"],
             launches=leg["launches"], sw_launches=leg["sw_launches"],
             span_reruns=reruns, dispatch=dispatch, sw_counts=leg["sw_counts"],
             worker_counts=leg["worker_counts"],
             wire_counts=leg["wire_counts"],
             wire_launches=leg["wire_launches"], jobs=leg["jobs"],
             files_identical=sorted(leg["files"]))
        out[label] = leg
    out["default_cli"] = default_cli_leg(root, fasta, bams,
                                         legs["gpu"]["vcf"])
    # the default card leg's workers are alive and idle: the card must
    # list the parent alone; the control shows a second context is seen
    alone = card_processes()
    check(len(alone) == 1, f"nvidia-smi lists {alone} with the pool's "
          "workers alive: a worker holds a context")
    with_child = card_processes_with_a_child()
    emit("pool_card", parent_pid=os.getpid(), listed=alone,
         listed_with_a_context_child=with_child)
    check(len(with_child) == 2, f"nvidia-smi lists {with_child} while a "
          "child holds a context: it cannot show a worker's context")
    return out


def default_cli_leg(root, fasta, bams, want_vcf) -> dict:
    """The user's command line as it stands, `python3 -m
    lorikeet_tpu_torch.cli call -r REF -b BAM... -o OUT`, in a process of
    its own: the default -t 8 (capped at the cores) on the card.  Its VCF
    must be the -t 1 default card leg's."""
    import subprocess
    outdir = os.path.join(root, "default_cli")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "lorikeet_tpu_torch.cli", "call", "-r", fasta,
         "-b", *bams, "-o", outdir], capture_output=True, text=True,
        timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"default cli: exit {res.returncode}: "
          f"{res.stderr[-2000:]}")
    (out,) = json.loads(res.stdout.strip().splitlines()[-1])[
        "outputs"]["genomes"].values()
    check("error" not in out, f"default cli: {out}")
    with open(out["vcf"], "rb") as a, open(want_vcf, "rb") as b:
        check(a.read() == b.read(), "default cli: the VCF is not the -t 1 "
              "card leg's")
    leg = {"wall_s": wall, "threads": min(8, os.cpu_count() or 8)}
    emit("default_cli", **leg)
    return leg


def genotype_phase(root, fasta, bams) -> dict:
    """`genotype` on the card at -t 1 and at -t 4: the same files."""
    g1, *_ = call_leg("genotype_t1", fasta, bams,
                      os.path.join(root, "genotype_t1"), [],
                      mode="genotype")
    g4, *_ = call_leg("genotype_t4", fasta, bams,
                      os.path.join(root, "genotype_t4"), [],
                      threads=POOL_THREADS, mode="genotype")
    diff = same_files(g1["files"], g4["files"])
    check(not diff, f"genotype -t 4: {diff} differ from -t 1")
    check(len(g1["files"]) >= 5, f"genotype wrote {sorted(g1['files'])}")
    reruns = g4["span_reruns"]
    check(g1["launches"] + reruns == g4["launches"] > 0
          and g4["dispatch"]["remote"] == g1["spans"] + reruns
          and g1["dispatch"]["host"] == g4["dispatch"]["host"] == 0,
          f"genotype: launches {g1['launches']} / {g4['launches']}, "
          f"dispatch {g1['dispatch']} / {g4['dispatch']}, {reruns} reruns")
    out = {"files": sorted(g1["files"]), "t1_wall_s": g1["wall_s"],
           "t4_wall_s": g4["wall_s"], "launches": g4["launches"],
           "remote": g4["dispatch"]["remote"], "span_reruns": reruns,
           "stages_s": g4["stages_s"], "t1_stages_s": g1["stages_s"]}
    emit("genotype", **out)
    return out


def devices_phase(root, fasta, bams, legs) -> dict:
    """The legs of DEVICE_LEGS against their one-card legs (see the module
    docstring)."""
    cards = two_cards()
    distinct = cards[0] != cards[1]
    out = {}
    for label, threads, on_two, env, base, identical in DEVICE_LEGS:
        ref = legs[base]
        leg, *_ = call_leg(label, fasta, bams, os.path.join(root, label), [],
                           {"LORIKEET_DEVICE_ACTIVITY": None, **env},
                           threads=threads, cards=cards if on_two else None)
        diff = same_files(ref["files"], leg["files"])
        _, dq = same_sites(f"{label} against the {base} leg", leg["vcf"],
                           ref["vcf"])
        check(not identical or not diff,
              f"{label}: {diff} differ from the {base} leg's")
        dispatch = leg["dispatch"]
        reruns = leg["span_reruns"]
        spans = dispatch["remote"] if threads > 1 else leg["spans"]
        check(dispatch["host"] == 0 and spans == ref["spans"] + reruns > 0,
              f"{label}: dispatch {dispatch}, {leg['spans']} spans, "
              f"{base} leg {ref['spans']}, {reruns} reruns")
        n_cards = 2 if on_two else 1
        check(len(leg["devices"]) == n_cards and sorted(
            leg["card_launches"]) == list(range(n_cards)),
              f"{label}: devices {leg['devices']}, K2 launches by position "
              f"{leg['card_launches']}")
        chain = base == "gpu_act"
        check(leg["activity_spans"] == (spans if chain else 0)
              and leg["worker_counts"]["act_spans"]
              == (spans if chain and threads > 1 else 0),
              f"{label}: {leg['activity_spans']} chains, workers sent "
              f"{leg['worker_counts']}, {spans} spans")
        if threads > 1:
            workers = leg["workers"]
            check(workers and all(
                not (w["torch_imported"] or w["cuda_initialized"]
                     or w["foreign_modules"]) for w in workers),
                  f"{label}: worker reports {workers}")
        emit("devices", leg=label, base_leg=base, threads=threads,
             devices=leg["devices"], cards_distinct=distinct if on_two
             else None, env=env, wall_s=leg["wall_s"],
             base_wall_s=ref["wall_s"], launches=leg["launches"],
             card_launches=leg["card_launches"], dispatch=dispatch,
             activity_spans=leg["activity_spans"],
             worker_counts=leg["worker_counts"], span_reruns=reruns,
             vcf_identical=os.path.basename(leg["vcf"]) not in diff,
             files_differing=diff, max_qual_diff=dq,
             pairhmm_s=leg["pairhmm_s"], stages_s=leg["stages_s"])
        out[label] = leg
    return out


@contextlib.contextmanager
def clustering_clock():
    """{name: [calls, seconds, points of the last call]} of umap_embed and
    of HDBSCAN.fit_predict (the port's, numpy) while the block runs."""
    from lorikeet_tpu_torch.strain import hdbscan, umap
    spent = {"umap_embed": [0, 0.0, 0], "hdbscan": [0, 0.0, 0]}
    embed, fit = umap.umap_embed, hdbscan.HDBSCAN.fit_predict

    def clocked(key, fn, x_arg):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key][0] += 1
                spent[key][1] += time.perf_counter() - t0
                spent[key][2] = len(args[x_arg])
        return run

    umap.umap_embed = clocked("umap_embed", embed, 0)
    hdbscan.HDBSCAN.fit_predict = clocked("hdbscan", fit, 1)
    try:
        yield spent
    finally:
        umap.umap_embed = embed
        hdbscan.HDBSCAN.fit_predict = fit


def clustering_seconds(vcf) -> dict:
    """read_vcf -> split_contexts -> cluster_variants on a `genotype` leg's
    VCF, as run_genotype clusters, timed in the smoke: the whole and its
    umap_embed and HDBSCAN parts."""
    from lorikeet_tpu_torch.io.vcf import read_vcf
    from lorikeet_tpu_torch.strain import genotype_mode
    with clustering_clock() as spent:
        t0 = time.perf_counter()
        contexts, _, _ = read_vcf(vcf)
        split, _ = genotype_mode.split_contexts(contexts, 8.0)
        t1 = time.perf_counter()
        labels, _ = genotype_mode.cluster_variants(split)
        t2 = time.perf_counter()
    return {"split_contexts": len(split),
            "groups": len(set(labels.tolist()) - {-1}),
            "read_split_s": t1 - t0, "cluster_s": t2 - t1,
            "umap_embed_s": spent["umap_embed"][1],
            "hdbscan_s": spent["hdbscan"][1],
            "umap_calls": spent["umap_embed"][0]}


def strain_dataset_phase(root, name, build, legs) -> dict:
    """`genotype` legs on one simulated strain mixture (see the module
    docstring): -t 4 files equal to -t 1's, card against f64 (sites,
    alleles, GT, VG and ST; QUAL within 0.1), K2 on the card legs with no
    host batch, no scikit-learn imported; bench.py's strain checks."""
    from lorikeet_tpu_torch.testkit import strains
    t0 = time.perf_counter()
    fasta, bams, truth = build(os.path.join(root, name))
    emit("strains_simulate", dataset=name, samples=len(bams),
         planted=[len(t) for t in truth], seconds=time.perf_counter() - t0)
    out = {}
    for label, flags, threads in legs:
        with clustering_clock() as spent:
            leg, *_ = call_leg(f"{name}_{label}", fasta, bams,
                               os.path.join(root, f"{name}_{label}"),
                               [*flags, *STRAIN_FLAGS], threads=threads,
                               mode="genotype")
        check("sklearn" not in sys.modules,
              f"{name} {label}: scikit-learn was imported")
        dispatch = leg["dispatch"]
        if "--force-cpu" in flags:
            check_f64_leg(leg)
        else:
            # at -t 4 the pool serves the spans: the earlier phases' pools
            # are alive, so a genome under the pool's size gate rides one
            # (processing._pool_worthwhile)
            check_card_leg(leg)
        check(spent["hdbscan"][0] == 1
              and spent["umap_embed"][0] == (len(bams) > 8),
              f"{name} {label}: clustering calls {spent}")
        score = strains.groups_pure_complete(leg["vcf"], truth)
        leg.update(score, strains_exact=strains.strains_exact(leg["vcf"],
                                                               truth))
        emit("strains", dataset=name, leg=label, threads=threads,
             samples=len(bams), wall_s=leg["wall_s"],
             genotype_s=leg["timings"].get("genotype"),
             call_s=leg["timings"].get("call"),
             n_variant_groups=leg["n_variant_groups"],
             n_strains=leg["n_strains"], launches=leg["launches"],
             dispatch=dispatch, span_reruns=leg["span_reruns"],
             umap_calls=spent["umap_embed"][0],
             hdbscan_calls=spent["hdbscan"][0],
             clustered_contexts=spent["hdbscan"][2], pure=score["pure"],
             complete=score["complete"], strains_exact=leg["strains_exact"],
             stages_s=leg["stages_s"])
        out[label] = leg
    card = next(leg for label, leg in out.items() if label.startswith("gpu"))
    f64 = next(leg for label, leg in out.items() if label.startswith("f64"))
    if "gpu" in out and "gpu_t4" in out:
        diff = same_files(out["gpu"]["files"], out["gpu_t4"]["files"])
        check(not diff, f"{name}: -t 4 files {diff} differ from -t 1's")
    sc, dq = same_sites(f"{name}: card against f64", card["vcf"],
                        f64["vcf"], ("VG", "ST"))
    timing = clustering_seconds(card["vcf"])
    emit("strains_compare", dataset=name, sites=len(sc), max_qual_diff=dq,
         t4_files_identical=True if "gpu_t4" in out and "gpu" in out
         else None,
         n_variant_groups=card["n_variant_groups"],
         n_strains=card["n_strains"], pure=card["pure"],
         complete=card["complete"], pure_complete=card["pure_complete"],
         strains_exact=card["strains_exact"], **timing)
    return out


def strains_phase(root) -> dict:
    """The three strain datasets (see the module docstring)."""
    from lorikeet_tpu_torch.testkit import strains
    t0 = time.perf_counter()
    two = strain_dataset_phase(root, "strains_2", strains.genotype_dataset,
                               STRAIN_LEGS_4)
    check(all(leg["pure_complete"] for leg in two.values()),
          "strains_2: variant groups not pure and complete")
    linked = strain_dataset_phase(root, "strains_linked",
                                  strains.linked_dataset, STRAIN_LEGS_4)
    check(all(leg["strains_exact"] for leg in linked.values()),
          "strains_linked: the ST sets are not the planted strains")
    twelve = strain_dataset_phase(
        root, "strains_12", lambda path: strains.time_series_dataset(
            path, STRAINS_12_KBP * 1000, samples=STRAINS_12_SAMPLES,
            processes=min(8, os.cpu_count() or 1)), STRAIN_LEGS_12)
    emit("strains_done", seconds=time.perf_counter() - t0)
    return {"strains_2": two, "strains_linked": linked,
            "strains_12": twelve}


def check_wire_counts(leg):
    """Every pair batch a -t 4 leg's workers sent came to the service as a
    wire or a flat job, and each wire job was decoded once on each card
    of the list."""
    wc = leg["wire_counts"]
    check(wc["wire"] + wc["flat"] == leg["dispatch"]["remote"]
          and leg["wire_launches"] == wc["wire"] * len(leg["devices"]),
          f"{leg['leg']}: wire / flat jobs {wc}, decode launches "
          f"{leg['wire_launches']}, served batches {leg['dispatch']}")


def check_card_leg(leg):
    """A card leg ran every pair batch on the card: K2 launched, no batch
    on a host, and at -t above 1 every batch served to a worker."""
    dispatch = leg["dispatch"]
    check(leg["launches"] > 0 and dispatch["host"] == 0
          and (dispatch["remote"] > 0) == (leg["threads"] > 1),
          f"{leg['leg']}: K2 launches {leg['launches']}, dispatch "
          f"{dispatch}")


def check_f64_leg(leg):
    check(leg["launches"] == 0 and leg["dispatch"]["device"] == 0
          and leg["dispatch"]["remote"] == 0,
          f"{leg['leg']}: the pair-HMM ran on the device")


def leg_recall(leg, truth) -> float:
    from lorikeet_tpu_torch.io.vcf import read_vcf
    from lorikeet_tpu_torch.testkit.dataset import recall
    calls, _, _ = read_vcf(leg["vcf"])
    return recall(calls, truth)


def mixed_leg(root, fasta, bams, truth, dev) -> dict:
    """`call -b S -l L`: the genome's short reads with a long-read BAM of
    the same variants (see the module docstring)."""
    from lorikeet_tpu_torch.ops.smith_waterman import (
        ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS, OverhangStrategy,
    )
    from lorikeet_tpu_torch.testkit.longreads import add_long_read_bam
    t0 = time.perf_counter()
    long_bam, n_long = add_long_read_bam(
        fasta, truth, os.path.join(root, "long0.bam"), LONG_COVERAGE, seed=0)
    simulate_s = time.perf_counter() - t0
    extra = ["-l", long_bam]
    card, *_ = call_leg("mixed_gpu_sw_t4", fasta, bams,
                        os.path.join(root, "mixed_gpu_sw_t4"),
                        ["--pallas-sw", *extra], threads=POOL_THREADS)
    f64, *_ = call_leg("mixed_f64_t4", fasta, bams,
                       os.path.join(root, "mixed_f64_t4"),
                       ["--force-cpu", *extra], threads=POOL_THREADS)
    t1, largest, sw_largest, *_ = call_leg(
        "mixed_gpu_sw", fasta, bams, os.path.join(root, "mixed_gpu_sw"),
        ["--pallas-sw", *extra])
    sites, dq = same_sites("mixed", card["vcf"], f64["vcf"])
    rec = leg_recall(card, truth)
    check(rec >= MIN_RECALL, f"mixed: recall {rec}")
    for leg in (card, t1):
        check_card_leg(leg)
        check(leg["sw_launches"] > 0 and leg["sw_counts"]["device"] > 0
              and sum(leg["sw_form_launches"].values())
              == leg["sw_launches"],
              f"{leg['leg']}: SW launches {leg['sw_launches']}, forms "
              f"{leg['sw_form_launches']}, routes {leg['sw_counts']}")
    check_f64_leg(f64)
    diff = same_files(t1["files"], card["files"])
    check(not diff, f"mixed: -t 4 files {diff} differ from -t 1's")
    # the -t 1 card leg's largest batches, replayed: K2 against its plain
    # version with the packer timed, K3 against its plain version and the
    # native aligner
    kernel = kernel_phase("mixed_reads", largest, dev, timed=True)
    sw = sw_phase("mixed_reads", sw_largest,
                  ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS,
                  OverhangStrategy.SOFTCLIP, dev, timed=False,
                  phase="sw_main_path")
    emit("modes", leg="mixed", long_reads=n_long, long_coverage=LONG_COVERAGE,
         simulate_s=simulate_s, sites=len(sites), max_qual_diff=dq, recall=rec,
         wall_s=card["wall_s"], f64_wall_s=f64["wall_s"],
         t1_wall_s=t1["wall_s"], launches=card["launches"],
         dispatch=card["dispatch"], sw_launches=card["sw_launches"],
         sw_form_launches=card["sw_form_launches"],
         t1_sw_form_launches=t1["sw_form_launches"],
         sw_counts=card["sw_counts"], span_reruns=card["span_reruns"],
         batch_longest=card["batch_longest"],
         escalation_share=card["escalation_share"],
         t1_escalation_share=t1["escalation_share"],
         pack_ms=kernel["pack_ms"], largest_batch_pairs=kernel["pairs"],
         largest_batch_rpad=kernel["rpad"],
         longest_sw_alt=max(len(a) for _, a in sw_largest),
         t4_files_identical_to_t1=sorted(card["files"]),
         stages_s=card["stages_s"])
    return {"long_bam": long_bam, "card": card, "f64": f64, "kernel": kernel,
            "sw": sw}


def consensus_leg(root, fasta, bams, truth, extra) -> dict:
    """`consensus` on the card and on the f64 host, -t 4, short and long
    reads: the consensus FASTAs byte-identical, the VCFs as `mixed`'s."""
    card, *_ = call_leg("consensus_gpu_t4", fasta, bams,
                        os.path.join(root, "consensus_gpu_t4"), extra,
                        threads=POOL_THREADS, mode="consensus")
    f64, *_ = call_leg("consensus_f64_t4", fasta, bams,
                       os.path.join(root, "consensus_f64_t4"),
                       ["--force-cpu", *extra], threads=POOL_THREADS,
                       mode="consensus")
    fastas = {n: p for n, p in card["files"].items()
              if p in card["consensus"]}
    f64_fastas = {n: p for n, p in f64["files"].items()
                  if p in f64["consensus"]}
    check(len(fastas) == len(bams) + 1,
          f"consensus: FASTAs {sorted(fastas)}")
    diff = same_files(fastas, f64_fastas)
    check(not diff, f"consensus: FASTAs {diff} differ between card and f64")
    sites, dq = same_sites("consensus", card["vcf"], f64["vcf"])
    rec = leg_recall(card, truth)
    check(rec >= MIN_RECALL, f"consensus: recall {rec}")
    check_card_leg(card)
    check_f64_leg(f64)
    emit("modes", leg="consensus", fastas=sorted(fastas), sites=len(sites),
         max_qual_diff=dq, recall=rec, wall_s=card["wall_s"],
         f64_wall_s=f64["wall_s"], launches=card["launches"],
         dispatch=card["dispatch"], consensus_s=card["timings"].get(
             "consensus"))
    return {"card": card, "f64": f64}


def summarise_leg(root, vcfs) -> dict:
    """`summarise` on the card leg's VCF, then on the f64 leg's: each
    exits 0 and writes its tables; the files that differ are reported."""
    from lorikeet_tpu_torch import cli
    written = {}
    for label, vcf in vcfs.items():
        outdir = os.path.join(root, f"summarise_{label}")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["summarise", "-i", vcf, "-o", outdir])
        check(rc == 0, f"summarise {label}: exit {rc}")
        files = {n: os.path.join(d, n) for d, _, names in os.walk(outdir)
                 for n in names}
        check(len(files) >= 3 and all(os.path.getsize(p) for p in
                                      files.values()),
              f"summarise {label}: wrote {sorted(files)}")
        written[label] = (files, time.perf_counter() - t0)
    (card, card_s), (f64, f64_s) = written.values()
    out = {"files": sorted(card), "files_differing": same_files(card, f64),
           "seconds": card_s, "f64_seconds": f64_s}
    emit("modes", leg="summarise", **out)
    return out


#: one process of a chunk-shard run: the CLI, then its counters as JSON
SHARD_PROCESS = """
import contextlib, io, json, sys
from lorikeet_tpu_torch import cli
from lorikeet_tpu_torch.calling import likelihoods as lk
from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = cli.main(json.loads(sys.argv[1]))
(out,) = json.loads(buf.getvalue().strip().splitlines()[-1])[
    "outputs"]["genomes"].values()
print(json.dumps({"rc": rc, "out": out, "launches": pc.LAUNCHES,
                  "dispatch": dict(lk.DISPATCH_COUNTS),
                  "foreign": sorted(m for m in sys.modules if m.split(".")[0]
                                    in ("jax", "jaxlib", "lorikeet_tpu"))}))
"""


def chunk_shard_run(root, label, fasta, bams, flags, indices=(0, 1),
                    extra_env=None) -> tuple:
    """`call -t 1` in the processes of ``indices`` (LORIKEET_PROCESS_INDEX
    of LORIKEET_PROCESS_COUNT 2, started together, with the variables of
    ``extra_env`` added) into one output directory: (the processes'
    reports, gatherer first, wall)."""
    import subprocess
    argv = ["call", "-t", "1", "-r", fasta, "-b", *bams, "-o",
            os.path.join(root, label), *flags]
    procs = []
    t0 = time.perf_counter()
    for index in indices:
        env = dict(os.environ, **(extra_env or {}),
                   LORIKEET_PROCESS_INDEX=str(index),
                   LORIKEET_PROCESS_COUNT="2")
        env.pop("LORIKEET_DEVICE_ACTIVITY", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", SHARD_PROCESS, json.dumps(argv)],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for index, (p, (_, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{label} process {index}: exit "
              f"{p.returncode}: {err[-2000:]}")
    reports = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    gatherer, *workers = reports
    check(gatherer["out"].get("vcf")
          and all(w["out"].get("vcf") is None
                  and w["out"].get("role") == "worker" for w in workers)
          and not any(r["foreign"] for r in reports),
          f"{label}: gatherer {gatherer['out']}, workers "
          f"{[w['out'] for w in workers]}, foreign modules "
          f"{[r['foreign'] for r in reports]}")
    return reports, wall


def chunk_shard_leg(root, fasta, bams, legs) -> dict:
    """Two `call -t 1` processes on the one card (two CUDA contexts on
    cuda:0), then two on the f64 host; the gatherers' VCFs held against
    each other, and against the one-process -t 1 legs (reported)."""
    card, card_wall = chunk_shard_run(root, "shard_gpu", fasta, bams, [])
    f64, f64_wall = chunk_shard_run(root, "shard_f64", fasta, bams,
                                    ["--force-cpu"])
    for index, rep in enumerate(card):
        check(rep["launches"] > 0 and rep["dispatch"]["host"] == 0,
              f"chunk_shard card process {index}: K2 launches "
              f"{rep['launches']}, dispatch {rep['dispatch']}")
    for index, rep in enumerate(f64):
        check(rep["launches"] == 0 and rep["dispatch"]["device"] == 0,
              f"chunk_shard f64 process {index}: the pair-HMM ran on the "
              "device")
    sites, dq = same_sites("chunk_shard", card[0]["out"]["vcf"],
                           f64[0]["out"]["vcf"])
    out = {"sites": len(sites), "max_qual_diff": dq, "wall_s": card_wall,
           "f64_wall_s": f64_wall,
           "launches": [rep["launches"] for rep in card],
           "dispatch": [rep["dispatch"] for rep in card],
           "units": card[1]["out"].get("units"),
           "files_differing": same_files(
               legs["gpu"]["files"], output_files(card[0]["out"])),
           "f64_files_differing": same_files(
               legs["f64"]["files"], output_files(f64[0]["out"]))}
    emit("modes", leg="chunk_shard", **out)
    return {**out, "vcf": card[0]["out"]["vcf"],
            "files": output_files(card[0]["out"]),
            "f64_vcf": f64[0]["out"]["vcf"]}


def card_f64_legs(root, label, fasta, bams, flags, env=None) -> tuple:
    """A card leg and an f64 leg of ``flags`` at -t 4 (``label``_gpu_t4,
    ``label``_f64_t4): the same sites, alleles and genotypes with QUAL
    within 0.1, every pair batch of the card leg on K2 and none of the f64
    leg's on the card.  Returns (card leg, f64 leg, the fields of its
    line)."""
    card, *_ = call_leg(f"{label}_gpu_t4", fasta, bams,
                        os.path.join(root, f"{label}_gpu_t4"), flags,
                        env=env, threads=POOL_THREADS)
    f64, *_ = call_leg(f"{label}_f64_t4", fasta, bams,
                       os.path.join(root, f"{label}_f64_t4"),
                       ["--force-cpu", *flags], env=env,
                       threads=POOL_THREADS)
    check_card_leg(card)
    check_wire_counts(card)
    check_f64_leg(f64)
    sites, dq = same_sites(label, card["vcf"], f64["vcf"])
    return card, f64, {
        "sites": len(sites), "max_qual_diff": dq, "wall_s": card["wall_s"],
        "f64_wall_s": f64["wall_s"], "launches": card["launches"],
        "sw_launches": card["sw_launches"], "dispatch": card["dispatch"],
        "wire_counts": card["wire_counts"],
        "wire_launches": card["wire_launches"], "jobs": card["jobs"],
        "files_differing": same_files(card["files"], f64["files"])}


def knobs_leg(root, fasta, bams, truth_vcf, legs) -> dict:
    """One card and one f64 -t 4 leg per flag set of KNOB_LEGS: the same
    sites with QUAL within 0.1, every pair batch on the card."""
    out = {}
    for name, flags in KNOB_LEGS:
        flags = [truth_vcf if f is None else f for f in flags]
        card, _, fields = card_f64_legs(root, f"knob_{name}", fasta, bams,
                                        flags)
        out[name] = {"flags": flags, **fields,
                     "escalation_share": card["escalation_share"],
                     "vcf_moved_from_default": os.path.basename(
                         card["vcf"]) in same_files(legs["gpu"]["files"],
                                                    card["files"])}
        emit("modes", leg="knobs", knob=name, **out[name])
    return out


def modes_phase(root, fasta, bams, truth, legs, dev) -> dict:
    """The CLI's other modes on the `call` phase's genome (see the module
    docstring): mixed, consensus, summarise, chunk_shard, knobs.  Returns
    the `mixed` and `chunk_shard` legs and the knobs' lines."""
    from lorikeet_tpu_torch.testkit.dataset import write_truth_vcf
    t0 = time.perf_counter()
    mixed = mixed_leg(root, fasta, bams, truth, dev)
    consensus_leg(root, fasta, bams, truth, ["-l", mixed["long_bam"]])
    summarise_leg(root, {"gpu": mixed["card"]["vcf"],
                         "f64": mixed["f64"]["vcf"]})
    shard = chunk_shard_leg(root, fasta, bams, legs)
    knobs = knobs_leg(root, fasta, bams, write_truth_vcf(
        os.path.join(root, "truth.vcf"), fasta, truth), legs)
    emit("modes_done", seconds=time.perf_counter() - t0)
    return {"mixed": mixed, "chunk_shard": shard, "knobs": knobs}

def write_halves(fasta, bam, root, index, cut) -> tuple:
    """The genome cut in two at ``cut``: one FASTA with the contigs
    `gA~contig1` and `gB~contig1` (two genomes by their names) and the
    sample BAM ``bam`` rewritten against it; a read across the cut is left
    out, a mate on the other half keeps its place there.  Returns (FASTA,
    BAM); the FASTA is written by ``index`` 0."""
    from lorikeet_tpu_torch.io.bam import BamReader, BamRecord
    from lorikeet_tpu_torch.io.bam_writer import write_bam
    from lorikeet_tpu_torch.io.fasta import FastaReader
    reader = FastaReader(fasta)
    (contig,) = reader.names
    length = reader.length(contig)
    names = [f"gA~{contig}", f"gB~{contig}"]
    halves = os.path.join(root, "halves.fna")
    if index == 0:
        seq = bytes(reader.fetch(contig)).decode()
        with open(halves, "w") as fh:
            fh.write(f">{names[0]}\n{seq[:cut]}\n>{names[1]}\n{seq[cut:]}\n")
    reader.close()

    def place(pos):
        return (0, pos) if pos < cut else (1, pos - cut)

    recs = []
    for r in BamReader(bam).fetch():
        if r.pos < cut < r.reference_end:
            continue
        tid, pos = place(r.pos)
        mate_tid, mate_pos = place(r.mate_pos) if r.mate_tid >= 0 \
            else (-1, -1)
        recs.append(BamRecord(
            name=r.name, flag=r.flag, tid=tid, pos=pos, mapq=r.mapq,
            cigar=r.cigar, seq=r.seq, qual=r.qual, mate_tid=mate_tid,
            mate_pos=mate_pos, tlen=r.tlen if mate_tid == tid else 0,
            tags=dict(r.tags.items())))
    path = os.path.join(root, f"halves{index}.bam")
    write_bam(path, names, [cut, length - cut], recs)
    return halves, path


def paths_inputs(root, fasta, bams):
    """Start writing the `raw_reads` SAMs and the `split_bams` inputs in
    two spawned processes (host set-up, overlapped with the first legs);
    returns their futures and the pool."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    from lorikeet_tpu_torch.testkit.mapper import write_sam
    reads = os.path.join(root, "reads")
    os.makedirs(reads, exist_ok=True)
    pool = ProcessPoolExecutor(2, mp_context=mp.get_context("spawn"))
    sams = [pool.submit(write_sam, bam, os.path.join(reads, f"sample{s}.sam"))
            for s, bam in enumerate(bams)]
    halves = [pool.submit(write_halves, fasta, bam, root, s, PATHS_SPLIT_AT)
              for s, bam in enumerate(bams)]
    return sams, halves, pool


def read_lines(path) -> list:
    with open(path) as fh:
        return fh.read().splitlines()


def dnds_fst_leg(root, fasta, bams) -> dict:
    """`--calculate-dnds --gff-file --calculate-fst` over about a CDS a
    kb (testkit.genes): the card leg's dN/dS and Fst tables equal the f64
    leg's, row for row."""
    from lorikeet_tpu_torch.testkit.genes import write_gff
    gff = write_gff(os.path.join(root, "genes.gff"), "contig1",
                    GENOME_KBP * 1000, seed=0)
    n_cds = len(read_lines(gff)) - 1
    card, f64, out = card_f64_legs(
        root, "paths_dnds_fst", fasta, bams,
        [*PATHS_QD_FILTER, "--calculate-dnds", "--gff-file", gff,
         "--calculate-fst"])
    for table in ("dnds", "fst"):
        check(card[table] and f64[table],
              f"dnds_fst: no {table} table ({card[table]}, {f64[table]})")
        a, b = read_lines(card[table]), read_lines(f64[table])
        differ = [(x, y) for x, y in zip(a, b) if x != y]
        check(len(a) == len(b) and not differ,
              f"dnds_fst: the {table} tables differ between card and f64 "
              f"({len(a)} / {len(b)} rows): {differ[:5]}")
    rows = [line.split("\t") for line in read_lines(card["dnds"])]
    snp_cols = [k for k, c in enumerate(rows[0]) if c.endswith("_snps")]
    with_snps = sum(any(int(r[k]) for k in snp_cols) for r in rows[1:])
    check(len(rows) - 1 == n_cds and with_snps > 0,
          f"dnds_fst: {len(rows) - 1} rows for {n_cds} CDS, {with_snps} "
          "with a SNP")
    out.update(cds=n_cds, cds_with_snps=with_snps,
               fst_rows=len(read_lines(card["fst"])) - 1,
               tables_identical=["dnds", "fst"])
    emit("paths", leg="dnds_fst", **out)
    return out


def raw_reads_leg(root, fasta, sams, base, dev) -> dict:
    """`call --single` on FASTQ names that a stub `minimap2` maps to the
    sample BAMs' SAM (testkit.mapper): the sites and K2 launches of the
    BAM-input card leg ``base``, the cached BAMs of the card and f64 legs
    byte-identical; then `--pallas-sw` on the card leg's cached BAMs, its
    largest SW batch replayed against the native aligner."""
    from lorikeet_tpu_torch.ops.smith_waterman import (
        ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS, OverhangStrategy,
    )
    from lorikeet_tpu_torch.testkit.mapper import install_stub_mapper
    routes, fastqs = {}, []
    for s, sam in enumerate(sams):
        fastqs.append(os.path.join(os.path.dirname(sam), f"reads{s}.fq"))
        with open(fastqs[-1], "w") as fh:
            fh.write("@r\nACGT\n+\nIIII\n")
        routes[os.path.basename(fastqs[-1])] = sam
    bindir = os.path.join(root, "bin")
    install_stub_mapper(bindir, "minimap2", routes)
    env = {"PATH": bindir + os.pathsep + os.environ.get("PATH", "")}
    reads = ["--single", *fastqs]
    card, _, out = card_f64_legs(root, "paths_raw_reads", fasta, [], reads,
                                 env)
    caches = {}
    for label in ("gpu", "f64"):
        d = os.path.join(root, f"paths_raw_reads_{label}_t4", "bams")
        caches[label] = {n: os.path.join(d, n) for n in os.listdir(d)}
    want = sorted(f"reads{s}.bam{x}" for s in range(len(sams))
                  for x in ("", ".bai"))
    diff = same_files(caches["gpu"], caches["f64"])
    check(sorted(caches["gpu"]) == want and not diff,
          f"raw_reads: cached BAMs {sorted(caches['gpu'])}, differing "
          f"between card and f64: {diff}")
    _, dq_bam = same_sites("raw_reads against the BAM-input card leg",
                           card["vcf"], base["vcf"])
    check(card["launches"] == base["launches"],
          f"raw_reads: {card['launches']} K2 launches, the BAM-input leg "
          f"{base['launches']}")
    sw, _, sw_largest, *_ = call_leg(
        "paths_raw_reads_gpu_sw_t4", fasta, [],
        os.path.join(root, "paths_raw_reads_gpu_sw_t4"),
        ["--pallas-sw", *reads, "--bam-file-cache-directory",
         os.path.dirname(caches["gpu"][want[0]])], env=env,
        threads=POOL_THREADS)
    check_card_leg(sw)
    check(sw["sw_launches"] > 0 and sw["sw_counts"]["device"] > 0
          and sw_largest, f"raw_reads --pallas-sw: SW launches "
          f"{sw['sw_launches']}, routes {sw['sw_counts']}")
    with open(sw["vcf"], "rb") as a, open(card["vcf"], "rb") as b:
        check(a.read() == b.read(), "raw_reads: the --pallas-sw VCF is not "
              "byte-identical to the card leg's")
    replay = sw_phase("raw_reads", sw_largest,
                      ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS,
                      OverhangStrategy.SOFTCLIP, dev, timed=False,
                      phase="sw_main_path")
    out.update(bam_input_launches=base["launches"],
               max_qual_diff_vs_bam_input=dq_bam,
               cached_bams_identical=want, sw_wall_s=sw["wall_s"],
               sw_leg_launches=sw["launches"],
               sw_leg_sw_launches=sw["sw_launches"],
               sw_form_launches=sw["sw_form_launches"],
               sw_largest_batch=len(sw_largest),
               sw_mismatches=replay.get("mismatches", 0))
    emit("paths", leg="raw_reads", **out)
    return replay


def limit_leg(root, fasta, bams, base) -> dict:
    """`--limiting-interval` PATHS_LIMIT: no site outside it, the sites of
    the whole-genome card leg ``base`` inside it (PATHS_LIMIT_MARGIN in
    from each end), fewer K2 launches."""
    lo, hi = PATHS_LIMIT
    card, _, out = card_f64_legs(root, "paths_limit", fasta, bams,
                                 ["--limiting-interval", f"{lo}-{hi}"])
    got = read_sites(card["vcf"])
    outside = [k for k, _ in got if not lo <= k[0] - 1 < hi]
    check(got and not outside, f"limit: {len(got)} sites, outside "
          f"[{lo}, {hi}): {outside[:5]}")

    def inner(sites):
        return [(k, q) for k, q in sites if lo + PATHS_LIMIT_MARGIN
                <= k[0] - 1 < hi - PATHS_LIMIT_MARGIN]
    a, b = inner(got), inner(read_sites(base["vcf"]))
    check([k for k, _ in a] == [k for k, _ in b],
          f"limit: {len(a)} sites inside the margin, the whole-genome leg "
          f"{len(b)}")
    dq = max((abs(x - y) for (_, x), (_, y) in zip(a, b)), default=0.0)
    check(dq <= QUAL_TOL, f"limit: QUAL differs from the whole-genome leg "
          f"by {dq}")
    check(card["launches"] < base["launches"],
          f"limit: {card['launches']} K2 launches, the whole genome "
          f"{base['launches']}")
    out.update(interval=[lo, hi], sites_inside_margin=len(a),
               max_qual_diff_vs_whole=dq, whole_launches=base["launches"])
    emit("paths", leg="limit", **out)
    return out


def cache_leg(root, fasta, bams, base, f64_base) -> dict:
    """The default card leg into an output directory of its own (the files
    of the pool phase's ``base``), again (cached: no K2 launch, no file
    touched), then with --force (K2 again, the same VCF bytes); the first
    run's sites against the f64 -t 4 leg ``f64_base``."""
    outdir = os.path.join(root, "paths_cache")
    first, *_ = call_leg("paths_cache_gpu_t4", fasta, bams, outdir, [],
                         threads=POOL_THREADS)
    check_card_leg(first)
    diff = same_files(base["files"], first["files"])
    check(not first["cached"] and not diff,
          f"cache: first run cached {first['cached']}, files {diff} differ "
          "from the pool leg's")
    with open(first["vcf"], "rb") as fh:
        vcf = fh.read()
    stamps = {n: os.stat(p).st_mtime_ns for n, p in first["files"].items()}
    again, *_ = call_leg("paths_cache_again_t4", fasta, bams, outdir, [],
                         threads=POOL_THREADS)
    check(again["cached"] == list(again["genomes"]) and again["launches"] == 0
          and not any(again["dispatch"].values())
          and stamps == {n: os.stat(p).st_mtime_ns
                         for n, p in first["files"].items()},
          f"cache: rerun cached {again['cached']}, K2 launches "
          f"{again['launches']}, dispatch {again['dispatch']}")
    forced, *_ = call_leg("paths_cache_force_gpu_t4", fasta, bams, outdir,
                          ["--force"], threads=POOL_THREADS)
    check_card_leg(forced)
    with open(forced["vcf"], "rb") as fh:
        check(not forced["cached"] and fh.read() == vcf
              and os.stat(forced["vcf"]).st_mtime_ns > stamps[
                  os.path.basename(forced["vcf"])],
              "cache: the --force VCF was not rewritten with the same bytes")
    sites, dq = same_sites("paths cache", first["vcf"], f64_base["vcf"])
    out = {"sites": len(sites), "max_qual_diff": dq,
           "wall_s": first["wall_s"], "f64_wall_s": f64_base["wall_s"],
           "cached_wall_s": again["wall_s"], "force_wall_s": forced["wall_s"],
           "launches": first["launches"],
           "cached_launches": again["launches"],
           "force_launches": forced["launches"],
           "sw_launches": first["sw_launches"], "dispatch": first["dispatch"],
           "files_differing": same_files(first["files"], f64_base["files"])}
    emit("paths", leg="cache", **out)
    return out


def split_bams_leg(root, halves) -> dict:
    """`--split-bams` over the two genomes of write_halves: each genome's
    card VCF against its f64 VCF.  Both legs share one split cache: the
    f64 leg reuses the BAMs the card leg split."""
    (fasta, bam0), (_, bam1) = halves
    cache = os.path.join(root, "paths_split_cache")
    flags = ["--split-bams", "--bam-file-cache-directory", cache]
    card, *_ = call_leg("paths_split_bams_gpu_t4", fasta, [bam0, bam1],
                        os.path.join(root, "paths_split_bams_gpu_t4"), flags,
                        threads=POOL_THREADS)
    f64, *_ = call_leg("paths_split_bams_f64_t4", fasta, [bam0, bam1],
                       os.path.join(root, "paths_split_bams_f64_t4"),
                       ["--force-cpu", *flags], threads=POOL_THREADS)
    check_card_leg(card)
    check_f64_leg(f64)
    genomes = sorted(card["genomes"])
    split = sorted(os.listdir(cache))
    want = sorted(f"halves{s}_{g}.bam{x}" for s in range(2) for g in genomes
                  for x in ("", ".bai"))
    check(genomes == ["gA", "gB"] == sorted(f64["genomes"])
          and [n for n in split if not n.startswith(".")] == want,
          f"split_bams: genomes {genomes} / {sorted(f64['genomes'])}, "
          f"split cache {split}")
    per_genome, differing = {}, []
    for g in genomes:
        sites, dq = same_sites(f"split_bams {g}", card["genomes"][g]["vcf"],
                               f64["genomes"][g]["vcf"])
        per_genome[g] = {"sites": len(sites), "max_qual_diff": dq}
        differing += [f"{g}/{n}" for n in same_files(
            card["genomes"][g]["files"], f64["genomes"][g]["files"])]
    out = {"genomes": per_genome, "wall_s": card["wall_s"],
           "f64_wall_s": f64["wall_s"], "launches": card["launches"],
           "sw_launches": card["sw_launches"], "dispatch": card["dispatch"],
           "files_differing": differing, "split_bams": want}
    emit("paths", leg="split_bams", **out)
    return out


def steal_leg(root, fasta, bams, shard) -> dict:
    """A chunk-shard `call` in which only process 0 of 2 runs: after
    LORIKEET_SHARD_GRACE it computes the missing units on the card too,
    launching K2 as the two processes of `chunk_shard` did together, and
    writes their gathered VCF byte for byte."""
    reports, wall = chunk_shard_run(
        root, "paths_steal", fasta, bams, [], indices=(0,),
        extra_env={"LORIKEET_SHARD_GRACE": str(PATHS_SHARD_GRACE_S)})
    (gatherer,) = reports
    check(gatherer["launches"] == sum(shard["launches"])
          and gatherer["dispatch"]["host"] == 0,
          f"steal: K2 launches {gatherer['launches']} (chunk_shard "
          f"{shard['launches']} over {shard['units']} units), dispatch "
          f"{gatherer['dispatch']}")
    with open(gatherer["out"]["vcf"], "rb") as a, \
            open(shard["vcf"], "rb") as b:
        check(a.read() == b.read(), "steal: the VCF is not the chunk_shard "
              "card leg's gathered VCF")
    sites, dq = same_sites("paths steal", gatherer["out"]["vcf"],
                           shard["f64_vcf"])
    out = {"sites": len(sites), "max_qual_diff": dq, "wall_s": wall,
           "f64_wall_s": shard["f64_wall_s"], "grace_s": PATHS_SHARD_GRACE_S,
           "launches": gatherer["launches"], "sw_launches": 0,
           "dispatch": gatherer["dispatch"], "units": shard["units"],
           "files_differing": same_files(
               shard["files"], output_files(gatherer["out"]))}
    emit("paths", leg="steal", **out)
    return out


def paths_phase(root, fasta, bams, pool_legs, shard, dev) -> dict:
    """The CLI's remaining paths on the `call` phase's genome at -t 4 (see
    the module docstring): dnds_fst, raw_reads, limit, cache, split_bams,
    steal.  Returns the raw-read SW replay."""
    t0 = time.perf_counter()
    sams, halves, inputs = paths_inputs(root, fasta, bams)
    try:
        base, f64_base = pool_legs["gpu_t4"], pool_legs["f64_t4"]
        dnds_fst_leg(root, fasta, bams)
        replay = raw_reads_leg(root, fasta, [f.result() for f in sams], base,
                               dev)
        limit_leg(root, fasta, bams, base)
        cache_leg(root, fasta, bams, base, f64_base)
        split_bams_leg(root, [f.result() for f in halves])
        steal_leg(root, fasta, bams, shard)
    finally:
        inputs.shutdown(cancel_futures=True)
    emit("paths_done", seconds=time.perf_counter() - t0)
    return replay


def odd_width_pairs(pairs):
    """``pairs`` with one pair more whose haplotype is the shortest odd
    length above the longest: an odd haplotype width, the case where the
    wire form pads the nibble rows."""
    import numpy as np
    hmax = max(len(p[0]) for p in pairs)
    hap = np.resize(pairs[0][0], hmax + 1 + hmax % 2)
    return list(pairs) + [(hap,) + tuple(pairs[0][1:])]


def wire_kernel_phase(name, pairs, dev) -> dict:
    """``pairs`` packed in the wire form: the decode kernel against its
    plain version on the card and against the flat job's planes, byte for
    byte (``mismatches``: bytes that differ), and K2 on the decoded planes
    against K2 on the flat ones, bit for bit.  Timed with CUDA events,
    median of 7: the kernel alone (``ms``, queued behind a sleep on the
    card), the wrapper as a whole (``wrapper_ms``: its checks and output
    allocations too) and the plain version.  The bound: the bytes the
    decode reads and writes over the memory rate (no arithmetic to speak
    of)."""
    import numpy as np
    import torch

    from lorikeet_tpu_torch.ops import pairhmm_cuda as pc

    wire, out_pos = pc.prepare_grouped_jobs(pairs, wire=True)
    flat, _ = pc.prepare_grouped_jobs(pairs, wire=False)
    check(wire["mode"] == "wire", f"{name}: the batch went flat")
    t = pc.to_tensors(wire, dev)
    launches = pc.WIRE_LAUNCHES
    got = pc.wire_decode_cuda(t)
    torch.cuda.synchronize()
    check(pc.WIRE_LAUNCHES == launches + 1,
          f"{name}: decode launch not counted")
    plain = pc.wire_decode_torch(t)
    width = flat["haps"].shape[1]
    mismatches = sum(int((got[k] != plain[k]).sum()) for k in plain)
    vs_flat = sum(int((got[k].cpu().numpy() != flat[k]).sum())
                  for k in pc._PLANES)
    haps = got["haps"].cpu().numpy()
    vs_flat += int((haps[:, :width] != flat["haps"]).sum())
    vs_flat += int(np.count_nonzero(haps[:, width:]))
    check(mismatches == 0 and vs_flat == 0,
          f"{name}: decode kernel vs plain {mismatches} bytes, vs the flat "
          f"planes {vs_flat} bytes")
    # the pairs' values only: K2 writes nothing for a tile's pad rows
    pos = torch.from_numpy(out_pos).to(dev)
    k2_wire = pc.pairhmm_grouped_cuda(pc._planes(t))[pos]
    k2_flat = pc.pairhmm_grouped_cuda(pc.to_tensors(flat, dev))[pos]
    check(torch.equal(k2_wire, k2_flat),
          f"{name}: K2 on the decoded planes differs from K2 on the flat")
    out = {"pairs": len(pairs), "rows": int(wire["qidx"].shape[0]),
           "rpad": int(wire["qidx"].shape[1]),
           "haps": int(wire["hap_nib"].shape[0]), "hmax": int(width),
           "hpad": int(haps.shape[1]), "mismatches": mismatches,
           "mismatches_vs_flat": vs_flat,
           "tuples": int(np.count_nonzero(wire["cb"])) + 1,
           "symbols": int(np.count_nonzero(wire["sym_tab"])) + 1,
           "wire_bytes": tensor_bytes(*(t[k] for k in pc.WIRE_NAMES)),
           "flat_bytes": int(sum(flat[k].nbytes
                                 for k in (*pc._PLANES, "haps"))),
           **bound(0, PEAK_F32_OPS_S,
                   tensor_bytes(*(t[k] for k in pc.WIRE_NAMES))
                   + tensor_bytes(*got.values())),
           "ms": queued_median_ms(lambda: pc.wire_decode_cuda(t)),
           "wrapper_ms": cuda_median_ms(lambda: pc.wire_decode_cuda(t)),
           "plain_ms": cuda_median_ms(lambda: pc.wire_decode_torch(t))}
    emit("wire_kernel", batch=name, **out)
    return out


def wire_phase(root, fasta, bams, legs, t4_legs, batch, dev) -> tuple:
    """The wire path (see the module docstring).  Returns
    the first forced-wire -t 4 leg (K6's counted path) and the decode
    kernel's checks on the main-path batch and the odd-width one."""
    from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
    from lorikeet_tpu_torch.parallel import pool
    t0 = time.perf_counter()
    gate = pc._wire_enabled()
    emit("wire_gate", link_bps=pc._link_bps(), wire_enabled=gate,
         LORIKEET_WIRE_COMPRESS=os.environ.get("LORIKEET_WIRE_COMPRESS"))
    gpu = legs["gpu"]
    wire, *_ = call_leg("wire_t1", fasta, bams, os.path.join(root, "wire_t1"),
                        [], env=WIRE_LEG_ENV)
    diff = same_files(gpu["files"], wire["files"])
    check(not diff, f"wire_t1: {diff} differ from the gpu leg's")
    check(wire["wire_launches"] > 0 and wire["dispatch"]["host"] == 0
          and wire["launches"] == gpu["launches"]
          and wire["wire_counts"]["wire"] + wire["wire_counts"]["flat"]
          == wire["launches"],
          f"wire_t1: decode launches {wire['wire_launches']}, jobs "
          f"{wire['wire_counts']}, K2 launches {wire['launches']} (gpu "
          f"{gpu['launches']}), dispatch {wire['dispatch']}")
    emit("wire", leg="wire_t1", wall_s=wire["wall_s"],
         gpu_wall_s=gpu["wall_s"], pairhmm_s=wire["pairhmm_s"],
         gpu_pairhmm_s=gpu["pairhmm_s"], launches=wire["launches"],
         wire_launches=wire["wire_launches"],
         wire_counts=wire["wire_counts"], jobs=wire["jobs"],
         dispatch=wire["dispatch"], files_identical=sorted(wire["files"]))
    # the default -t 4 call legs: the workers packed in the gate's form
    t4 = {label: {"wire_counts": leg["wire_counts"],
                  "wire_launches": leg["wire_launches"], "jobs": leg["jobs"]}
          for label, leg in t4_legs.items()}
    check(all((leg["wire_counts"]["wire"] > 0) == gate for leg in t4.values()),
          f"a -t 4 call leg's workers did not follow the gate ({gate}): {t4}")
    emit("wire", leg="t4_legs", gate=gate, legs=t4)
    # wire against flat at -t 4, then the service depth on the flat pool
    walls, started, first_wire = {}, {}, None
    for run, setting in enumerate(WIRE_T4_ORDER):
        label = f"{'wire' if setting == '1' else 'flat'}_t4"
        leg, *_ = call_leg(f"{label}_{run}", fasta, bams,
                           os.path.join(root, f"{label}_{run}"), [],
                           env={"LORIKEET_WIRE_COMPRESS": setting},
                           threads=POOL_THREADS)
        check_card_leg(leg)
        check_wire_counts(leg)
        wc = leg["wire_counts"]
        check((wc["wire"] > 0) == (setting == "1") and (
            setting == "1" or wc["flat"] == leg["dispatch"]["remote"]),
              f"{label}_{run}: jobs {wc}")
        diff = same_files(gpu["files"], leg["files"])
        check(not diff, f"{label}_{run}: {diff} differ from the gpu leg's")
        if setting == "1" and first_wire is None:
            first_wire = leg
        sample = (leg["wall_s"], leg["pairhmm_s"])
        if label in started:
            walls.setdefault(label, []).append(sample)
        else:
            started[label] = sample
        emit("wire", leg=label, run=run, wall_s=leg["wall_s"],
             pairhmm_s=leg["pairhmm_s"], dispatch=leg["dispatch"],
             wire_counts=wc, wire_launches=leg["wire_launches"],
             jobs=leg["jobs"], files_identical=sorted(leg["files"]))
    emit("wire", leg="wire_vs_flat_t4", walls_pairhmm_s=walls,
         pool_start_walls_pairhmm_s=started)
    depth = {}
    saved = pool.SERVICE_DEPTH
    try:
        for run, setting in enumerate(DEPTH_ORDER):
            pool.SERVICE_DEPTH = setting
            label = f"depth{setting}_t4"
            leg, *_ = call_leg(f"{label}_{run}", fasta, bams,
                               os.path.join(root, f"{label}_{run}"), [],
                               env={"LORIKEET_WIRE_COMPRESS": "0"},
                               threads=POOL_THREADS)
            check_card_leg(leg)
            diff = same_files(gpu["files"], leg["files"])
            check(not diff, f"{label}_{run}: {diff} differ from the gpu leg's")
            depth.setdefault(label, []).append(leg["wall_s"])
    finally:
        pool.SERVICE_DEPTH = saved
    emit("wire", leg="depth_t4", walls_s=depth)
    checks = [wire_kernel_phase("main_path", batch, dev),
              wire_kernel_phase("odd_width", odd_width_pairs(batch), dev)]
    check(checks[1]["hmax"] % 2 == 1, "odd_width: the width is even")
    emit("wire_done", seconds=time.perf_counter() - t0)
    return first_wire, checks


def nccl_phase(pairs, span, dev) -> dict:
    """`initialize_distributed` at world size 1 on the card (an NCCL group:
    NCCL puts no two ranks on one card), a collective of each kind on it,
    then PR 3's group forms under it against their results without a
    group: pairhmm_forward_sharded on the main-path batch (as the flat
    kernel alone, KERNEL_TOL), region_batch_step (lk after the escalation
    within EXACT_TOL, depth totals within 1e-2) and
    sharded_smoothed_activity on the `activity` span (ACTIVITY_SPLIT_TOL).
    The group is destroyed before the phase ends."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
    from lorikeet_tpu_torch.ops.pairhmm import (
        pack_pairhmm_batch, pairhmm_forward_checked,
    )
    from lorikeet_tpu_torch.parallel.hosts import initialize_distributed
    from lorikeet_tpu_torch.parallel.pipeline import (
        sharded_smoothed_activity, smoothed_activity_device,
    )
    from lorikeet_tpu_torch.parallel.sharding import region_batch_step

    a = pack_pairhmm_batch(pairs)
    flat = [a[k] for k in ("haps", "hap_lens", "reads", "read_lens", "quals",
                           "ins_quals", "del_quals", "gcps")]
    rng = np.random.default_rng(1)
    sample_ids = rng.integers(0, 8, len(pairs)).astype(np.int32)
    depths = rng.random((len(pairs), 64), np.float32)
    (gls, hq, ploidy, het, het_std, conf), kwargs = span
    act_kw = dict(snp_heterozygosity=het, heterozygosity_stdev=het_std,
                  stand_min_conf=conf,
                  max_prob_propagation=kwargs["max_prob_propagation"])
    # the results without a group are for comparison: their flat launches
    # are not the path's
    launches = pc.FLAT_LAUNCHES
    alone = {"lk": pc.pairhmm_forward_flat(*flat, device=dev),
             "step": region_batch_step(None, device=dev)(
                 *flat, sample_ids, depths),
             "act": smoothed_activity_device(gls, hq, ploidy, devices=dev,
                                             **act_kw)}
    pc.FLAT_LAUNCHES = launches
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    t0 = time.perf_counter()
    context = initialize_distributed(coordinator, 1, 0)
    init_s = time.perf_counter() - t0
    try:
        check(dist.get_backend() == "nccl" and context == (0, 1),
              f"nccl: backend {dist.get_backend()}, context {context}")
        x = torch.arange(8, dtype=torch.float32, device=dev)
        dist.all_reduce(x)
        parts = [torch.empty_like(x)]
        dist.all_gather(parts, x)
        dist.barrier()
        check(torch.equal(parts[0].cpu(), torch.arange(8.0)),
              "nccl: all_reduce / all_gather at world size 1 changed data")
        t0 = time.perf_counter()
        launches = pc.FLAT_LAUNCHES
        lk = pc.pairhmm_forward_sharded(*flat, device=dev)
        step_lk, step_total = region_batch_step(None, device=dev)(
            *flat, sample_ids, depths)
        act = sharded_smoothed_activity(gls, hq, ploidy, device=dev,
                                        **act_kw)
        torch.cuda.synchronize()
        forms_s = time.perf_counter() - t0
        launches = pc.FLAT_LAUNCHES - launches
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "nccl: the group outlived the phase")
    err_lk = float(np.abs(lk - alone["lk"]).max())
    check(err_lk <= KERNEL_TOL, f"nccl: pairhmm_forward_sharded vs flat "
          f"{err_lk}")
    err_step = float(np.abs(pairhmm_forward_checked(step_lk, pairs)
                            - pairhmm_forward_checked(alone["step"][0],
                                                      pairs)).max())
    err_total = float(np.abs(step_total - alone["step"][1]).max())
    check(err_step <= EXACT_TOL and err_total <= 1e-2,
          f"nccl: region_batch_step lk {err_step}, totals {err_total}")
    err_act = float(np.abs(act - alone["act"]).max())
    check(act.shape == alone["act"].shape
          and err_act <= ACTIVITY_SPLIT_TOL,
          f"nccl: sharded_smoothed_activity vs one card {err_act}")
    out = {"backend": "nccl", "world_size": 1, "coordinator": coordinator,
           "init_s": init_s, "forms_s": forms_s, "flat_launches": launches,
           "pairs": len(pairs),
           "positions": int(gls.shape[1]),
           "max_abs_err_sharded_pairhmm": err_lk,
           "max_abs_err_region_batch": err_step,
           "max_abs_err_region_batch_total": err_total,
           "max_abs_err_activity": err_act}
    emit("modes", leg="nccl", **out)
    return out


def entry_phase(dev) -> dict:
    """entry()'s fn (the batched pair-HMM wavefront, K5, torch ops) on the
    card against the same example on the host, timed with CUDA events."""
    import numpy as np

    from lorikeet_tpu_torch.entry import entry
    fn, args = entry()
    got = fn(*args)
    plain_fn, plain_args = entry(device="cpu")
    plain = plain_fn(*plain_args)
    check(got.device.type == "cuda" and got.shape == plain.shape == (32,),
          f"entry: {got.device}, shapes {got.shape}, {plain.shape}")
    got = got.cpu().numpy()
    err = float(np.abs(got - plain.numpy()).max())
    check(np.all(np.isfinite(got)) and np.all(got < 0)
          and err <= ENTRY_TOL, f"entry: card vs host {err}")
    ms = cuda_median_ms(lambda: fn(*args))
    t0 = time.perf_counter()
    plain_fn(*plain_args)
    plain_ms = (time.perf_counter() - t0) * 1e3
    B, R = args[2].shape
    H = args[0].shape[1]
    cells = B * R * H
    out = {"batch": [B, R, H], "max_abs_err_vs_host": err, "ms": ms,
           "host_ms": plain_ms, "steps": R + H,
           **bound(PAIRHMM_OPS_PER_CELL * cells, PEAK_F32_OPS_S,
                   sum(x.nbytes for x in args) + 4 * B)}
    emit("modes", leg="entry", **out)
    return out


def sw_main_path_phase(pairs, dev) -> dict:
    """The largest realignment SW batch of the first card leg, replayed at
    the main path's own settings: kernel, plain version and native aligner
    agree, each timed."""
    from lorikeet_tpu_torch.ops.smith_waterman import (
        ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS, OverhangStrategy,
    )
    return sw_phase("sw_main_path", pairs,
                    ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS,
                    OverhangStrategy.SOFTCLIP, dev, timed=True,
                    phase="sw_main_path")


def hap_main_path_phase(padded, dev) -> dict:
    """The largest haplotype SW batch of the first card leg (a span's
    N-padded window/haplotype pairs), replayed at the main path's settings:
    kernel, plain version and native aligner agree."""
    from lorikeet_tpu_torch.ops.smith_waterman import (
        NEW_SW_PARAMETERS, OverhangStrategy,
    )
    return sw_phase("hap_main_path", padded, NEW_SW_PARAMETERS,
                    OverhangStrategy.SOFTCLIP, dev, timed=False,
                    phase="sw_main_path")


def hap_span_phase(root, dev) -> dict:
    """One dense span (portbench's short configuration, one contig of
    HAP_SPAN_KBP under the strain mix) through processing._call_span at
    -t 1 twice: its haplotype SW one K3 batch, then on the native host
    aligner.  The same works (haplotypes, CIGARs, pairs), both K3 forms
    launched, every SW pair on the card; the batch replayed and timed."""
    from lorikeet_tpu_torch import processing
    from lorikeet_tpu_torch.calling.engine import (
        CallerConfig, HaplotypeCallerEngine,
    )
    from lorikeet_tpu_torch.io.bam import open_bam
    from lorikeet_tpu_torch.io.fasta import FastaReader
    from lorikeet_tpu_torch.ops import sw_cuda as sc
    from lorikeet_tpu_torch.ops.smith_waterman import (
        NEW_SW_PARAMETERS, OverhangStrategy,
    )
    from lorikeet_tpu_torch.utils import cigar
    from portbench.gen import dataset

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "portbench", "configs",
                           "mag_short_pe150_2s30x.json")) as fh:
        config = {**json.load(fh), "contigs": 1, "contig_kbp": HAP_SPAN_KBP}
    with open(os.path.join(here, "portbench", "traffic",
                           "strains_1pct.json")) as fh:
        mix = json.load(fh)
    data = dataset.build(os.path.join(root, "hap_span"), config, mix,
                         HAP_SPAN_SEED, 0)
    fasta = FastaReader(data.fasta)
    bams = [open_bam(p) for p in data.bams]
    contig = next(iter(data.contigs))
    batches = []
    calculate_cigars = cigar.calculate_cigars
    hap_sw_device = processing._hap_sw_device

    def caught(pairs, align_batch=None):
        def seen(padded, parameters, strategy):
            batches.append([(r.tobytes(), a.tobytes()) for r, a in padded])
            return align_batch(padded, parameters, strategy)
        return calculate_cigars(pairs, seen if align_batch else None)

    def span(device):
        processing._hap_sw_device = lambda cfg: device
        processing.HAP_COUNTS.update(dict.fromkeys(processing.HAP_COUNTS, 0))
        cfg = CallerConfig()
        t0 = time.perf_counter()
        _, works = processing._call_span(
            fasta, bams, contig, cfg, HaplotypeCallerEngine(cfg), 0,
            fasta.length(contig), defer=True)
        seconds = time.perf_counter() - t0
        return works, dict(processing.HAP_COUNTS), seconds

    def haps(works):
        return [(w.window_start, w.active_start, w.active_end,
                 [(h.bases, h.cigar, h.score, h.is_ref, h.kmer_size)
                  for h in w.haplotypes],
                 [tuple(x.tobytes() if hasattr(x, "tobytes") else x
                        for x in p) for p in w.pairs]) for w in works]

    forms = dict(sc.SW_FORM_LAUNCHES)
    cigar.calculate_cigars = caught
    try:
        card, counts, card_s = span(dev)
        forms = {k: sc.SW_FORM_LAUNCHES[k] - n for k, n in forms.items()}
        host, host_counts, host_s = span(None)
    finally:
        cigar.calculate_cigars = calculate_cigars
        processing._hap_sw_device = hap_sw_device
    check(len(batches) == 1, f"hap_span: {len(batches)} SW batches in one "
          "span on the card")
    check(haps(card) == haps(host) and len(card) > 0,
          f"hap_span: the K3 span's {len(card)} works differ from the host "
          f"span's {len(host)}")
    check(counts["hap_sw_card"] == counts["hap_sw"] == host_counts["hap_sw"]
          == len(batches[0]) > 0 and host_counts["hap_sw_card"] == 0
          and counts["hap_cigars"] == host_counts["hap_cigars"],
          f"hap_span: counts {counts}, host {host_counts}, batch "
          f"{len(batches[0])} pairs")
    check(forms["warp"] > 0 and forms["cta"] > 0,
          f"hap_span: K3 launches by form {forms}")
    replay = sw_phase("hap_span", batches[0], NEW_SW_PARAMETERS,
                      OverhangStrategy.SOFTCLIP, dev, timed=True,
                      phase="sw_main_path")
    out = {"contig_kbp": HAP_SPAN_KBP, "seed": HAP_SPAN_SEED,
           "regions": len(card), "counts": counts, "form_launches": forms,
           "span_s": card_s, "host_span_s": host_s,
           "alt_max": max(len(a) for _, a in batches[0]),
           "ref_max": max(len(r) for r, _ in batches[0])}
    emit("hap_span", **out)
    return {**out, "replay": replay}


def trace_phase(root, fasta, bams, sites, label, threads=1):
    """The card leg ``label`` once more under the profiler (--profile-dir),
    at -t ``threads``: how much of the run the card is busy.  It runs last,
    since the profiler's hooks can slow later launches; the timed legs run
    untraced."""
    prof = os.path.join(root, f"prof_{label}_t{threads}")
    traced, *_ = call_leg(f"{label}_t{threads}_traced", fasta, bams,
                          os.path.join(root, f"traced_{label}_t{threads}"),
                          [*LEG_FLAGS[label], "--profile-dir", prof],
                          threads=threads)
    busy = device_busy(os.path.join(prof, "trace.json"), traced["wall_s"])
    check(read_sites(traced["vcf"]) == sites, f"traced {label} leg calls "
          "differ")
    emit("trace", leg=label, threads=threads, **busy)


def device_busy(trace_path: str, wall_s: float) -> dict:
    """Card time by kind from a torch.profiler Chrome trace, against the
    run's wall time (None where the trace holds no card activity)."""
    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])

    def seconds(pred):
        return sum(e.get("dur", 0) for e in events if pred(e)) * 1e-6

    kernel_s = seconds(lambda e: e.get("cat") == "kernel")
    copy_s = seconds(lambda e: e.get("cat") in ("gpu_memcpy", "gpu_memset"))
    seen = any(e.get("cat") == "kernel" for e in events)
    return {"wall_s": wall_s, "kernel_s": kernel_s if seen else None,
            "pairhmm_kernel_s": seconds(
                lambda e: e.get("cat") == "kernel"
                and "grouped_kernel" in e.get("name", "")) if seen else None,
            "sw_kernel_s": seconds(
                lambda e: e.get("cat") == "kernel" and any(
                    k in e.get("name", "") for k in
                    ("sw_warp_kernel", "sw_kernel"))) if seen else None,
            "copy_s": copy_s if seen else None,
            "idle_share": 1.0 - (kernel_s + copy_s) / wall_s
            if seen else None}


def main() -> int:
    started = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import numpy as np

    from lorikeet_tpu_torch import device
    from lorikeet_tpu_torch.ops import _build

    info = device.probe()
    emit("probe", **info)
    check(info["capability"] == [9, 0],
          f"capability {info['capability']}: the kernel is built for sm_90a")
    check(info["nvidia_smi"], "nvidia-smi did not report the card")

    _build.load_all(KERNEL_SOURCES)     # one nvcc per source, together
    for name in KERNEL_SOURCES:
        ptxas = [line.strip() for line in _build.BUILD_LOG.get(
            name, "").splitlines() if "registers" in line or "spill" in line]
        emit("build", kernel=name, seconds=_build.BUILD_SECONDS[name],
             registers=ptxas_registers(_build.BUILD_LOG.get(name, "")),
             ptxas=ptxas)
        spills = [line for line in ptxas if any(int(n) for n in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", line))]
        check(not spills, f"{name}: ptxas reports register spills: {spills}")

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    region, long_ = region_pairs(rng), long_pairs(rng)
    checks = [kernel_phase("region", region, dev, timed=True),
              kernel_phase("long", long_, dev, timed=False)]
    flat_checks = [flat_kernel_phase("region", region, dev, timed=True),
                   flat_kernel_phase("long", long_, dev, timed=False)]
    sw_checks = sw_kernel_phase(rng, dev)

    from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
    from lorikeet_tpu_torch.parallel import pool
    with tempfile.TemporaryDirectory() as root:
        legs, batch, sw_batch, hap_batch, span, dataset, truth = \
            call_phase(root)
        gpu, gpu_sw = legs["gpu"], legs["gpu_sw"]
        pool_legs = pool_phase(root, *dataset[:2], legs)
        genotype_phase(root, *dataset[:2])
        devices_phase(root, *dataset[:2], legs)
        strains_phase(root)
        modes = modes_phase(root, *dataset[:2], truth, legs, dev)
        mixed = modes["mixed"]
        raw_sw = paths_phase(root, *dataset[:2], pool_legs,
                             modes["chunk_shard"], dev)
        t4_legs = {label: pool_legs[label] for label in ("gpu_t4",
                                                         "gpu_sw_t4")}
        t4_legs.update((f"knob_{name}", knob)
                       for name, knob in modes["knobs"].items())
        wire_t4, wire_checks = wire_phase(root, *dataset[:2], legs, t4_legs,
                                          batch, dev)
        # the main path's largest batches, replayed after the counted run:
        # each kernel at the shapes the main path gives it
        main_batch = kernel_phase("main_path", batch, dev, timed=True)
        flat_main = flat_kernel_phase("main_path", batch, dev, timed=True)
        sw_main = sw_main_path_phase(sw_batch, dev)
        hap_main = hap_main_path_phase(hap_batch, dev)
        hap_span = hap_span_phase(root, dev)
        # the flat kernel's own path, counted from 0: the region-batch step
        # on the main path's batch, then the dry run's three steps
        pc.FLAT_LAUNCHES = 0
        region_batch_phase(batch, dev)
        activity_phase(span, dev)
        nccl_phase(batch, span, dev)
        dryrun_phase(dev)
        flat_launches = pc.FLAT_LAUNCHES
        check(flat_launches > 0, "the flat kernel's path launched no kernel")
        for label in ("gpu", "gpu_sw"):
            trace_phase(root, *dataset, label)
        trace_phase(root, *dataset, "gpu", threads=POOL_THREADS)
        pool.shutdown_pool()
    entry_phase(dev)
    checks += [main_batch, mixed["kernel"]]
    flat_checks.append(flat_main)
    sw_checks += [sw_main, mixed["sw"], raw_sw, hap_main, hap_span["replay"]]

    foreign = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "lorikeet_tpu", "bench_e2e"))
    check(not foreign, f"modules outside the port were imported: {foreign}")

    emit("elapsed", seconds=time.perf_counter() - started)

    def times(c):
        # no single PyTorch call computes a pair-HMM forward or an
        # affine-gap Smith-Waterman with traceback: no library time
        return {"ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": None}

    print(json.dumps({"kernels": [{
        "name": "pairhmm_grouped", "route": "cuda",
        "source": "lorikeet_tpu_torch/csrc/pairhmm.cu",
        "replaces": "lorikeet_tpu/ops/pairhmm_pallas.py:461",
        "launches": gpu["launches"],
        "max_abs_err": max(c["max_abs_err_vs_plain"] for c in checks),
        **times(main_batch)}, {
        "name": "sw_align", "route": "cuda",
        "source": "lorikeet_tpu_torch/csrc/sw.cu",
        "replaces": "lorikeet_tpu/ops/sw_pallas.py:59",
        "launches": gpu_sw["sw_launches"],
        "mixed_leg_form_launches": mixed["card"]["sw_form_launches"],
        # exact: 0.0 when every (CIGAR, offset) matched, as checked above
        "max_abs_err": float(max(c.get("mismatches", 0) for c in sw_checks)),
        **times(sw_main)}, {
        "name": "pairhmm_flat", "route": "cuda",
        "source": "lorikeet_tpu_torch/csrc/pairhmm.cu",
        "replaces": "lorikeet_tpu/ops/pairhmm_pallas.py:91",
        "launches": flat_launches,
        "max_abs_err": max(c["max_abs_err_vs_plain"] for c in flat_checks),
        **times(flat_main)}, {
        "name": "pairhmm_wire_decode", "route": "cuda",
        "source": "lorikeet_tpu_torch/csrc/pairhmm.cu",
        "replaces": "lorikeet_tpu/ops/pairhmm_pallas.py:865",
        # the wire path: the first -t 4 leg with the wire form forced on
        "launches": wire_t4["wire_launches"],
        # exact: bytes that differ from the plain version's, 0 as checked
        "max_abs_err": float(max(c["mismatches"] for c in wire_checks)),
        **times(wire_checks[0])}]}),
        flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
