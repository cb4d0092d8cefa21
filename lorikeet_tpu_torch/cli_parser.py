"""Argument parser and the parser-side helpers of the command line.

The subcommand surface of the reference (reference/src/cli.rs:1017-1184:
call / genotype / consensus / summarise) with the semantic knob set: the
parser, the man-page and shell-completion generators, the warning for
flags that parse but change nothing, and the concatenated mapping
reference.  ``cli.py`` owns the entry point and fills the config from the arguments.
"""
from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lorikeet-tpu",
        description="strain-level variant analysis on one CUDA card "
                    "(call, consensus, summarise, genotype)")
    sub = p.add_subparsers(dest="command", required=True)

    def add_common(sp):
        sp.add_argument("--full-help", "--full-help-roff", nargs=0,
                        action=_FullHelpAction, help=argparse.SUPPRESS)
        sp.add_argument("-r", "--reference", "-f", "--genome-fasta-files",
                        nargs="+", default=None,
                        help="reference FASTA file(s); contigs named "
                             "genome~contig group into genomes "
                             "(-f/--genome-fasta-files: cli.rs parity alias)")
        sp.add_argument("-d", "--genome-fasta-directory", default=None,
                        help="directory of genome FASTAs")
        sp.add_argument("-x", "--genome-fasta-extension", default="fna")
        sp.add_argument("-b", "--bam-files", nargs="+", default=None,
                        help="sorted BAM files, one per sample")
        sp.add_argument("-1", "--read1", dest="read1", nargs="+",
                        default=None, help="forward FASTQ files (with -2)")
        sp.add_argument("-2", "--read2", dest="read2", nargs="+",
                        default=None, help="reverse FASTQ files (with -1)")
        sp.add_argument("-c", "--coupled", nargs="+", default=None,
                        help="forward/reverse FASTQ files alternating "
                             "(f1 r1 f2 r2 ...)")
        sp.add_argument("--single", nargs="+", default=None,
                        help="unpaired FASTQ files")
        sp.add_argument("--interleaved", nargs="+", default=None,
                        help="interleaved paired FASTQ files")
        sp.add_argument("--longreads", nargs="+", default=None,
                        help="long-read FASTQ files")
        sp.add_argument("-p", "--mapper", default="minimap2-sr",
                        help="short-read mapper preset")
        sp.add_argument("--longread-mapper", default="minimap2-ont")
        sp.add_argument("--minimap2-params", default="")
        sp.add_argument("--bwa-params", default="")
        sp.add_argument("--bam-file-cache-directory", default=None,
                        help="where mapped BAMs are cached "
                             "(default {output}/bams)")
        sp.add_argument("-t", "--threads", type=int, default=8)
        sp.add_argument("--parallel-genomes", type=int, default=1,
                        help="genomes analysed concurrently "
                             "(lorikeet_engine.rs scoped threadpool role)")
        sp.add_argument("--split-bams", action="store_true",
                        help="pre-split input BAMs into per-genome BAMs "
                             "in the cache directory (index_bams.rs:84)")
        sp.add_argument("-l", "--longread-bam-files", nargs="+", default=None,
                        help="long-read BAM files (listed after short-read "
                             "samples)")
        sp.add_argument("--min-long-read-size", type=int, default=1500)
        sp.add_argument("--min-long-read-average-base-qual", type=int,
                        default=20)
        sp.add_argument("--min-read-aligned-length", type=int, default=0)
        sp.add_argument("--min-read-percent-identity", type=float, default=0.0)
        sp.add_argument("--min-read-aligned-percent", type=float, default=0.0)
        sp.add_argument("--min-read-aligned-length-pair", type=int, default=0)
        sp.add_argument("--min-read-percent-identity-pair", type=float,
                        default=0.0)
        sp.add_argument("--min-read-aligned-percent-pair", type=float,
                        default=0.0)
        sp.add_argument("--min-sv-qual", type=int, default=3,
                        help="QUAL filter for svim structural variants")
        sp.add_argument("-o", "--output-directory", default="./lorikeet_out")
        sp.add_argument("--force", action="store_true",
                        help="overwrite cached per-genome outputs")
        sp.add_argument("--ploidy", type=int, default=2)
        sp.add_argument("--min-base-quality", type=int, default=10)
        sp.add_argument("--min-mapq", type=int, default=20)
        sp.add_argument("--standard-min-confidence-threshold-for-calling",
                        dest="stand_min_conf", type=float, default=25.0)
        sp.add_argument("--snp-heterozygosity", type=float, default=0.001)
        sp.add_argument("--indel-heterozygosity", type=float, default=0.000125)
        sp.add_argument("--heterozygosity-stdev", type=float, default=0.01)
        sp.add_argument("--kmer-sizes", type=int, nargs="+", default=[21, 33])
        sp.add_argument("--profile", default=None,
                        choices=["very-fast", "fast", "precise", "sensitive",
                                 "super-sensitive"],
                        help="assembly preset (kmer list + pruning)")
        sp.add_argument("--use-adaptive-pruning", action="store_true")
        sp.add_argument("--initial-error-rate-for-pruning", type=float,
                        default=0.001)
        sp.add_argument("--pruning-log-odds-threshold", type=float,
                        default=1.0)
        sp.add_argument("--pruning-seeding-log-odds-threshold", type=float,
                        default=4.0)
        sp.add_argument("--max-unpruned-variants", type=int, default=100)
        sp.add_argument("--qual-by-depth-filter", type=float, default=25.0,
                        help="QD threshold for ANI/strain site qualification")
        sp.add_argument("--depth-per-sample-filter", type=int, default=5,
                        help="min per-sample depth for comparable bases")
        sp.add_argument("--graph-output", default=None,
                        help="append per-region assembly-graph DOT dumps "
                             "to this file (base_graph.rs:505)")
        sp.add_argument("--min-prune-factor", dest="prune_factor", type=int,
                        default=1)
        sp.add_argument("--num-pruning-samples", type=int, default=1,
                        help="number of samples whose top multiplicities "
                             "set an edge's pruning multiplicity")
        sp.add_argument("--disable-prune-factor-correction",
                        action="store_true",
                        help="do not rescale the prune factor by region "
                             "coverage")
        sp.add_argument("--max-allowed-path-for-read-threading-assembler",
                        type=int, default=128,
                        help="cap on k-best haplotype paths per graph")
        sp.add_argument("--dont-increase-kmer-sizes-for-cycles",
                        action="store_true",
                        help="fail assembly at a kmer size instead of "
                             "retrying larger odd sizes on cycles")
        sp.add_argument("--disable-automatic-kmer-adjustment",
                        action="store_true",
                        help="do not add extra kmer sizes in high "
                             "activity-density regions")
        sp.add_argument("--allow-non-unique-kmers-in-ref",
                        action="store_true",
                        help="assemble kmer sizes whose reference window "
                             "repeats a kmer")
        sp.add_argument("--do-not-recover-dangling-branches",
                        action="store_true",
                        help="disable dangling tail/head recovery")
        sp.add_argument("--recover-all-dangling-branches",
                        action="store_true",
                        help="walk through forks when recovering dangling "
                             "branches")
        sp.add_argument("--min-dangling-branch-length", type=int, default=1,
                        help="minimum dangling branch length to attempt "
                             "recovery")
        sp.add_argument("--min-matching-bases-to-dangling-end-recovery",
                        type=int, default=-1,
                        help="junction bases that must match to merge a "
                             "dangling end (-1 = legacy any-match)")
        sp.add_argument("--dont-use-soft-clipped-bases",
                        action="store_true",
                        help="hard-clip soft clips before assembly instead "
                             "of reverting them")
        sp.add_argument("--soft-clip-low-quality-ends",
                        action="store_true",
                        help="soft-clip (keep) low-quality tails instead "
                             "of hard-clipping them")
        sp.add_argument("--snp-padding-for-genotyping", type=int, default=20,
                        help="region-trim padding around SNPs")
        sp.add_argument("--indel-padding-for-genotyping", type=int,
                        default=75, help="region-trim padding around indels")
        sp.add_argument("--str-padding-for-genotyping", type=int, default=75,
                        help="region-trim padding around tandem-repeat "
                             "indels (plus the repeat run length)")
        sp.add_argument("--max-extension-into-region-padding", type=int,
                        default=25,
                        help="legacy-trim cap on extension into the padded "
                             "region")
        sp.add_argument("--max-prob-propagation-distance", type=int,
                        default=50,
                        help="cap on soft-clip activity propagation in the "
                             "band-pass profile")
        sp.add_argument("--min-contig-size", type=int, default=0,
                        help="skip contigs shorter than this")
        sp.add_argument("--allow-improper-pairs", action="store_true",
                        help="keep improperly paired reads")
        sp.add_argument("--include-secondary", action="store_true",
                        help="keep secondary alignments in the BAM filter "
                             "layer (the caller still drops them, "
                             "read_utils.rs:44)")
        sp.add_argument("--exclude-supplementary", action="store_true",
                        help="drop supplementary alignments")
        sp.add_argument("--keep-unmapped", action="store_true",
                        help="keep unmapped reads in cached mapper BAMs")
        sp.add_argument("--do-not-call-svs", action="store_true",
                        help="skip svim structural-variant calling on "
                             "long-read samples")
        sp.add_argument("--prodigal-params", default="",
                        help="extra arguments for prodigal when "
                             "--calculate-dnds has no --gff-file")
        sp.add_argument("--minimap2-reference-is-index", action="store_true",
                        help="treat -r as a prebuilt minimap2 .mmi index")
        sp.add_argument("--high-memory", action="store_true",
                        help="decode whole BAMs into RAM up front instead "
                             "of streaming region fetches through the .bai "
                             "index (hidden no-op in the reference, "
                             "cli.rs:1420; functional here)")
        # accepted for reference CLI parity; declared but never read by the
        # reference either (cli.rs defines them; no non-CLI use sites).
        # Using one prints a warning so the inertness is never silent.
        for inert in ("--sharded", "--no-zeros",
                      "--error-correct-reads", "--use-linked-debruijn-graph",
                      "--enable-legacy-graph-cycle-detection",
                      "--debug-graph-transformations", "--disable-avx"):
            sp.add_argument(inert, action="store_true",
                            help=argparse.SUPPRESS)
        for inert, dv in (("--min-covered-fraction", 0.0),
                          ("--trim-min", 0.05), ("--trim-max", 0.95),
                          ("--contig-end-exclusion", 0.0)):
            sp.add_argument(inert, type=float, default=dv,
                            help=argparse.SUPPRESS)
        sp.add_argument("--kmer-length-for-read-error-correction", type=int,
                        default=25, help=argparse.SUPPRESS)
        sp.add_argument("--min-observations-for-kmers-to-be-solid", type=int,
                        default=20, help=argparse.SUPPRESS)
        # the reference defines BOTH spellings (cli.rs:1736,1749); both inert
        sp.add_argument("--min-observation-for-kmer-to-be-solid", type=int,
                        default=20, help=argparse.SUPPRESS)
        sp.add_argument("--exclude-genomes-from-deshard", default=None,
                        help=argparse.SUPPRESS)
        sp.add_argument("--debug-graph-output", default=None,
                        help=argparse.SUPPRESS)
        sp.add_argument("--max-mnp-distance", type=int, default=0)
        sp.add_argument("--pcr-indel-model", default="conservative",
                        choices=["none", "hostile", "aggressive",
                                 "conservative"],
                        help="PCR indel error model aggressiveness "
                             "(pcr-indel-model)")
        sp.add_argument("--pair-hmm-gap-continuation-penalty", type=int,
                        default=10,
                        help="phred gap-continuation penalty for the "
                             "pair-HMM")
        sp.add_argument("--base-quality-score-threshold", type=int,
                        default=18,
                        help="base quals below this are reduced to the "
                             "minimum usable quality (6)")
        sp.add_argument("--disable-cap-base-qualities-to-map-quality",
                        action="store_true",
                        help="do not cap base qualities at the read's MAPQ "
                             "in the pair-HMM")
        sp.add_argument("--phred-scaled-global-read-mismapping-rate",
                        type=int, default=45,
                        help="cap per-read likelihood spread at this phred "
                             "rate (normalize_likelihoods); negative "
                             "disables")
        sp.add_argument("--disable-symmetric-hmm-normalizing",
                        action="store_true",
                        help="normalize against the best ALT likelihood "
                             "instead of the overall best")
        sp.add_argument("--disable-dynamic-read-disqualification-for-"
                        "genotyping", dest="disable_dynamic_disq",
                        action="store_true",
                        help="use only the static threshold when dropping "
                             "poorly modeled reads")
        sp.add_argument("--dynamic-read-disqualification-threshold",
                        type=float, default=1.0,
                        help="constant K in the dynamic read "
                             "disqualification threshold")
        sp.add_argument("--expected-mismatch-rate-for-read-disqualification",
                        type=float, default=0.02,
                        help="expected per-base error rate for read "
                             "disqualification")
        sp.add_argument("--allele-informative-reads-overlap-margin",
                        type=int, default=2,
                        help="likelihood window margin around each variant "
                             "for informative reads")
        sp.add_argument("--disable-spanning-event-genotyping",
                        action="store_true",
                        help="do not genotype deletions spanning a locus "
                             "as '*' alleles")
        sp.add_argument("--do-not-run-physical-phasing",
                        action="store_true",
                        help="skip physical phasing (PGT/PID/PS)")
        sp.add_argument("--genotype-assignment-method",
                        default="UsePLsToAssign",
                        choices=["UsePLsToAssign",
                                 "UsePosteriorProbabilities",
                                 "BestMatchToOriginal", "SetToNoCall",
                                 "DoNotAssignGenotypes"],
                        help="how GT is assigned after allele subsetting")
        sp.add_argument("--use-posteriors-to-calculate-qual",
                        action="store_true",
                        help="derive QUAL from genotype posteriors (GP) "
                             "when present")
        sp.add_argument("--annotate-with-num-discovered-alleles",
                        action="store_true",
                        help="add NDA (number of discovered alt alleles) "
                             "to INFO")
        sp.add_argument("--qual-threshold", type=float, default=150.0,
                        help="minimum QUAL for ANI/strain site "
                             "qualification")
        sp.add_argument("--min-variant-depth-for-genotyping", type=int,
                        default=10,
                        help="minimum summed alt depth for an allele to "
                             "enter strain genotyping")
        sp.add_argument("--abundance-mode", default="leftover",
                        choices=["leftover", "reference"],
                        help="strain abundance estimator: 'leftover' "
                             "(improved alt-mass estimator, default) or "
                             "'reference' (Lorikeet's ref-mass-duplication "
                             "EM, abundance_calculator_engine.rs:190-215)")
        sp.add_argument("--mapping-quality-threshold-for-genotyping",
                        type=int, default=20,
                        help="mapq gate on reads entering per-region "
                             "calling")
        sp.add_argument("--disable-optimizations", action="store_true",
                        help="keep processing regions with no assembled "
                             "variation")
        sp.add_argument("--dont-trim-active-regions", action="store_true",
                        help="keep full-window haplotypes/reads instead of "
                             "trimming to the variant span")
        sp.add_argument("--checkpoint", action="store_true",
                        help="resume long jobs from per-contig checkpoints "
                             "under {genome}/.chunks")
        sp.add_argument("--min-assembly-region-size", type=int, default=50)
        sp.add_argument("--max-assembly-region-size", type=int, default=300)
        sp.add_argument("--assembly-region-padding", type=int, default=100)
        sp.add_argument("--active-probability-threshold", type=float,
                        default=0.002)
        sp.add_argument("--features-vcf", default=None,
                        help="VCF of alleles to force-call "
                             "(assembly_region_walker.rs features-vcf)")
        sp.add_argument("--max-input-depth", type=int, default=200_000,
                        help="per-sample read cap per assembly region")
        sp.add_argument("--force-cpu", action="store_true",
                        help="use the exact f64 host pair-HMM; without this flag "
                             "the pair-HMM needs a CUDA card")
        sp.add_argument("--devices", default="auto",
                        help="CUDA cards to split each pair batch over "
                             "('auto' = every visible card, N = the first "
                             "N, an error when fewer are visible; with more "
                             "than one at -t 1 the activity chain runs on "
                             "them too); ignored under --force-cpu")
        sp.add_argument("--pallas-sw", action="store_true",
                        help="batch realignment Smith-Waterman on device "
                             "(bit-identical; wins at high region depth)")
        sp.add_argument("--limiting-interval", default=None,
                        help="restrict to start-end (applies per contig)")
        sp.add_argument("--calculate-dnds", action="store_true")
        sp.add_argument("--gff-file", default=None,
                        help="gene models for --calculate-dnds (prodigal GFF3;"
                             " prodigal is not shipped, supply the file)")
        sp.add_argument("--calculate-fst", action="store_true")
        sp.add_argument("-v", "--verbose", action="count", default=0)
        sp.add_argument("-q", "--quiet", action="store_true")
        sp.add_argument("--profile-dir", default=None,
                        help="write a torch profiler trace here")

    for cmd, desc in (("call", "variant calling"),
                      ("consensus", "consensus genomes per sample"),
                      ("genotype", "strain-resolved genotyping")):
        sp = sub.add_parser(cmd, help=desc, description=desc)
        add_common(sp)

    ssum = sub.add_parser("summarise", help="re-analyse existing VCFs (ANI)",
                          description="re-analyse existing VCFs (ANI)")
    ssum.add_argument("--full-help", "--full-help-roff", nargs=0,
                      action=_FullHelpAction, help=argparse.SUPPRESS)
    ssum.add_argument("-i", "--vcfs", nargs="+", required=True)
    ssum.add_argument("-o", "--output-directory", default="./lorikeet_out")
    ssum.add_argument("--calculate-fst", action="store_true")
    # site-qualification knobs (cli.rs:3560-3577 summarise parity)
    ssum.add_argument("--qual-by-depth-filter", type=float, default=25.0)
    ssum.add_argument("--qual-threshold", type=float, default=150.0,
                      help="accepted for reference parity; the reference's "
                           "log10_p_error comparison is trivially true "
                           "(see strain/ani.py)")
    ssum.add_argument("--depth-per-sample-filter", type=int, default=5)
    ssum.add_argument("-t", "--threads", type=int, default=8)

    scomp = sub.add_parser("shell-completion",
                           help="emit a shell completion script "
                                "(cli.rs:1153-1184 parity)")
    scomp.add_argument("--shell", default="bash", choices=["bash", "zsh"])
    scomp.add_argument("-o", "--output-file", default=None)

    sman = sub.add_parser("man", help="emit roff man pages "
                                      "(cli.rs:702-1016 full-help parity)")
    sman.add_argument("subcommand", nargs="?", default=None,
                      choices=["call", "consensus", "genotype", "summarise"])
    sman.add_argument("-o", "--output-directory", default=None,
                      help="write lorikeet-tpu-<cmd>.1 files here "
                           "(default: print to stdout)")
    return p


def _roff_escape(text: str) -> str:
    return text.replace("\\", "\\\\").replace("-", "\\-")


def _man_page(parser: argparse.ArgumentParser, cmd: str) -> str:
    """roff man page for one subcommand, generated from the argparse
    definition (the role of the bird_tool_utils-man roff output at
    cli.rs:702-1016 + build_manuals.sh)."""
    sp = parser._subparsers._group_actions[0].choices[cmd]
    return _man_page_from_sub(sp, cmd)


class _FullHelpAction(argparse.Action):
    """--full-help / --full-help-roff on every analysis subcommand
    (cli.rs:702-1016): print the extended page and exit, bypassing
    required-argument checks exactly like --help."""

    def __call__(self, parser, namespace, values, option_string=None):
        cmd = parser.prog.split()[-1]
        if option_string == "--full-help-roff":
            print(_man_page_from_sub(parser, cmd))
        else:
            print(parser.format_help())
        parser.exit(0)


def _man_page_from_sub(sp: argparse.ArgumentParser, cmd: str) -> str:
    import datetime
    lines = [
        f'.TH "LORIKEET\\-TPU\\-{cmd.upper()}" "1" '
        f'"{datetime.date.today():%B %Y}" "lorikeet-tpu" "User Commands"',
        ".SH NAME",
        f"lorikeet\\-tpu\\-{cmd} \\- {_roff_escape(sp.description or sp.format_usage().strip())}",
        ".SH SYNOPSIS",
        ".B lorikeet\\-tpu",
        f".I {cmd}",
        "[\\fIOPTIONS\\fR]",
        ".SH OPTIONS",
    ]
    for a in sp._actions:
        if not a.option_strings and a.dest in ("==SUPPRESS==",):
            continue
        flags = ", ".join(f"\\fB{_roff_escape(f)}\\fR"
                          for f in a.option_strings) or f"\\fI{a.dest}\\fR"
        metavar = ""
        if a.option_strings and a.nargs != 0 and not isinstance(
                a, (argparse._StoreTrueAction, argparse._CountAction)):
            metavar = f" \\fI{(a.metavar or a.dest).upper()}\\fR"
        lines.append(".TP")
        lines.append(flags + metavar)
        help_text = a.help or ""
        if a.default not in (None, False, 0, argparse.SUPPRESS, "==SUPPRESS=="):
            help_text += f" [default: {a.default}]"
        lines.append(_roff_escape(help_text) if help_text else "\\ ")
    lines += [
        ".SH SEE ALSO",
        "\\fBlorikeet\\-tpu\\fR(1)",
        ".SH AUTHORS",
        "lorikeet\\-tpu contributors",
    ]
    return "\n".join(lines) + "\n"


def _completion_script(parser: argparse.ArgumentParser, shell: str) -> str:
    subs = ["call", "consensus", "genotype", "summarise", "shell-completion"]
    opts = sorted({o for sp in parser._subparsers._group_actions[0]
                   .choices.values()
                   for a in sp._actions for o in a.option_strings})
    if shell == "zsh":
        return ("#compdef lorikeet-tpu\n"
                f"_arguments '1: :({' '.join(subs)})' '*: :({' '.join(opts)})'\n")
    return (
        "_lorikeet_tpu() {\n"
        "  local cur=${COMP_WORDS[COMP_CWORD]}\n"
        "  if [ $COMP_CWORD -eq 1 ]; then\n"
        f"    COMPREPLY=( $(compgen -W '{' '.join(subs)}' -- $cur) )\n"
        "  else\n"
        f"    COMPREPLY=( $(compgen -W '{' '.join(opts)}' -f -- $cur) )\n"
        "  fi\n"
        "}\n"
        "complete -F _lorikeet_tpu lorikeet-tpu\n")


#: flags accepted only for reference CLI drop-in compatibility (inert in the
#: reference too); (dest, default) pairs checked after parsing
_INERT_FLAGS = (
    ("sharded", False), ("no_zeros", False), ("error_correct_reads", False),
    ("use_linked_debruijn_graph", False),
    ("enable_legacy_graph_cycle_detection", False),
    ("debug_graph_transformations", False), ("disable_avx", False),
    ("min_covered_fraction", 0.0), ("trim_min", 0.05), ("trim_max", 0.95),
    ("contig_end_exclusion", 0.0),
    ("kmer_length_for_read_error_correction", 25),
    ("min_observations_for_kmers_to_be_solid", 20),
    ("min_observation_for_kmer_to_be_solid", 20),
    ("exclude_genomes_from_deshard", None), ("debug_graph_output", None),
)


def _warn_inert_flags(args) -> None:
    """Non-default inert flags get a stderr warning: the flag parses (CLI
    drop-in parity with the reference, which also ignores them —
    cli.rs hidden Args with no non-CLI use sites) but changes nothing."""
    for dest, default in _INERT_FLAGS:
        if getattr(args, dest, default) != default:
            print(f"[lorikeet-tpu] warning: --{dest.replace('_', '-')} is "
                  "accepted for reference CLI parity but has no effect",
                  file=sys.stderr)



def _mapping_reference(args, cache: str) -> str | None:
    """Reference FASTA for raw-read mapping.  Multiple genomes (several -r
    files and/or -d) are concatenated into one mapping+calling reference
    with '<genome_stem>~<contig>' names
    (mapping_index_maintenance.rs:250-340
    generate_concatenated_fasta_file); downstream genome discovery then
    splits on '~'.  Returns None when no references were supplied."""
    import glob as _glob
    refs = list(args.reference or [])
    if args.genome_fasta_directory:
        refs.extend(sorted(_glob.glob(os.path.join(
            args.genome_fasta_directory,
            f"*.{args.genome_fasta_extension}"))))
    if not refs:
        return None
    if len(refs) == 1:
        return refs[0]
    stems = [os.path.splitext(os.path.basename(p))[0] for p in refs]
    if len(set(stems)) != len(stems):
        raise ValueError("multiple reference files share a genome name "
                         "(file stem); rename them to be distinct")
    os.makedirs(cache, exist_ok=True)
    concat = os.path.join(cache, "concatenated_reference.fna")
    if not os.path.exists(concat) or args.force:
        tmp = concat + ".tmp"
        with open(tmp, "w") as out_fh:
            for path, stem in zip(refs, stems):
                with open(path) as in_fh:
                    line = "\n"
                    for line in in_fh:
                        if line.startswith(">"):
                            contig = line[1:].strip().split(" ")[0]
                            out_fh.write(f">{stem}~{contig}\n")
                        else:
                            out_fh.write(line)
                    if not line.endswith("\n"):
                        out_fh.write("\n")
        os.replace(tmp, concat)
    # the concatenated file becomes the calling reference too, so mapped
    # contig names and genome discovery stay consistent
    args.reference = [concat]
    args.genome_fasta_directory = None
    return concat
