"""Command-line interface of the port.

``python -m lorikeet_tpu_torch.cli call -r REF -b BAM... -o OUT`` runs the
`call` path with the pair-HMM on the CUDA kernel; ``-t N`` (default 8)
spreads the chunk spans over N CPU worker processes whose pair-HMM batches
the parent's cards run, as the JAX CLI's ``-t`` does.  The argument parser
and the parser-side helpers are in ``cli_parser``; this module owns the
entry point and fills the configs, which point at the port's processing
and map the device flags: the pair-HMM runs on the card (an error without
one) unless ``--force-cpu`` selects the exact f64 host pair-HMM,
``--pallas-sw`` runs the realignment Smith-Waterman on the CUDA kernel
(independent of ``--force-cpu``, and an error without a card), and
``--devices`` picks the cards: ``auto`` (the default) every visible card,
``N`` the first N (an error when fewer are visible).  Each pair batch's
table blocks are split over them, and with more than one at ``-t 1`` the
activity chain runs on them too, split by position.
"""
from __future__ import annotations

import json
import os
import sys

from lorikeet_tpu_torch.cli_parser import (
    _completion_script, _man_page, _mapping_reference, _warn_inert_flags,
    build_parser,
)


def _caller_config(args):
    cfg = _base_config(args)
    cfg.prune_factor = args.prune_factor
    cfg.use_adaptive_pruning = args.use_adaptive_pruning
    cfg.initial_error_rate_for_pruning = args.initial_error_rate_for_pruning
    cfg.pruning_log_odds_threshold = args.pruning_log_odds_threshold
    cfg.max_unpruned_variants = args.max_unpruned_variants
    cfg.min_assembly_region_size = args.min_assembly_region_size
    cfg.max_assembly_region_size = args.max_assembly_region_size
    cfg.assembly_region_padding = args.assembly_region_padding
    cfg.active_prob_threshold = args.active_probability_threshold
    cfg.max_input_depth = args.max_input_depth
    cfg.features_vcf = args.features_vcf
    cfg.pruning_seeding_log_odds_threshold = \
        args.pruning_seeding_log_odds_threshold
    cfg.qual_by_depth_filter = args.qual_by_depth_filter
    cfg.abundance_mode = getattr(args, "abundance_mode", "leftover")
    cfg.depth_per_sample_filter = args.depth_per_sample_filter
    cfg.graph_output = args.graph_output
    cfg.threads = args.threads
    cfg.num_pruning_samples = args.num_pruning_samples
    cfg.disable_prune_factor_correction = args.disable_prune_factor_correction
    cfg.max_allowed_path_for_read_threading_assembler = \
        args.max_allowed_path_for_read_threading_assembler
    cfg.dont_increase_kmer_sizes_for_cycles = \
        args.dont_increase_kmer_sizes_for_cycles
    cfg.disable_automatic_kmer_adjustment = \
        args.disable_automatic_kmer_adjustment
    cfg.allow_non_unique_kmers_in_ref = args.allow_non_unique_kmers_in_ref
    cfg.recover_dangling_branches = not args.do_not_recover_dangling_branches
    cfg.recover_all_dangling_branches = args.recover_all_dangling_branches
    cfg.min_dangling_branch_length = args.min_dangling_branch_length
    cfg.min_matching_bases_to_dangling_end_recovery = \
        args.min_matching_bases_to_dangling_end_recovery
    cfg.dont_use_soft_clipped_bases = args.dont_use_soft_clipped_bases
    cfg.soft_clip_low_quality_ends = args.soft_clip_low_quality_ends
    cfg.snp_padding_for_genotyping = args.snp_padding_for_genotyping
    cfg.indel_padding_for_genotyping = args.indel_padding_for_genotyping
    cfg.str_padding_for_genotyping = args.str_padding_for_genotyping
    cfg.max_extension_into_region_padding = \
        args.max_extension_into_region_padding
    cfg.max_prob_propagation_distance = args.max_prob_propagation_distance
    cfg.min_contig_size = args.min_contig_size
    cfg.do_not_call_svs = args.do_not_call_svs
    cfg.high_memory = args.high_memory
    cfg.devices = args.devices
    from lorikeet_tpu_torch.io.filter import FlagFilter
    cfg.flag_filter = FlagFilter(
        include_improper_pairs=args.allow_improper_pairs,
        include_secondary=args.include_secondary,
        include_supplementary=not args.exclude_supplementary)
    if getattr(args, "profile", None):
        # profile presets override the knobs they cover
        # (haplotype_caller_engine.rs:246-298)
        cfg.apply_profile(args.profile)
    return cfg


def _base_config(args):
    from lorikeet_tpu_torch.calling.engine import CallerConfig
    return CallerConfig(
        ploidy=args.ploidy,
        snp_heterozygosity=args.snp_heterozygosity,
        indel_heterozygosity=args.indel_heterozygosity,
        heterozygosity_stdev=args.heterozygosity_stdev,
        stand_min_conf=args.stand_min_conf,
        max_mnp_distance=args.max_mnp_distance,
        pcr_indel_model=args.pcr_indel_model,
        pair_hmm_gcp=args.pair_hmm_gap_continuation_penalty,
        base_quality_score_threshold=args.base_quality_score_threshold,
        disable_cap_base_qualities_to_map_quality=
        args.disable_cap_base_qualities_to_map_quality,
        phred_global_read_mismapping_rate=
        args.phred_scaled_global_read_mismapping_rate,
        disable_symmetric_hmm_normalizing=
        args.disable_symmetric_hmm_normalizing,
        disable_dynamic_read_disqualification=args.disable_dynamic_disq,
        dynamic_read_disqualification_threshold=
        args.dynamic_read_disqualification_threshold,
        expected_mismatch_rate_for_read_disqualification=
        args.expected_mismatch_rate_for_read_disqualification,
        allele_informative_reads_overlap_margin=
        args.allele_informative_reads_overlap_margin,
        disable_spanning_event_genotyping=
        args.disable_spanning_event_genotyping,
        do_not_run_physical_phasing=args.do_not_run_physical_phasing,
        genotype_assignment_method=args.genotype_assignment_method,
        use_posteriors_to_calculate_qual=
        args.use_posteriors_to_calculate_qual,
        annotate_with_num_discovered_alleles=
        args.annotate_with_num_discovered_alleles,
        qual_threshold=args.qual_threshold,
        min_variant_depth_for_genotyping=
        args.min_variant_depth_for_genotyping,
        mapping_quality_threshold_for_genotyping=
        args.mapping_quality_threshold_for_genotyping,
        disable_optimizations=args.disable_optimizations,
        dont_trim_active_regions=args.dont_trim_active_regions,
        checkpoint=args.checkpoint,
        min_base_quality=args.min_base_quality,
        mapq_threshold=args.min_mapq,
        kmer_sizes=tuple(args.kmer_sizes),
        # --force-cpu selects the exact f64 native kernel; otherwise the
        # CUDA kernel runs, and a machine without a card is an error
        use_cuda=False if args.force_cpu else None,
        use_cuda_sw=bool(getattr(args, "pallas_sw", False)),
    )


def main(argv=None) -> int:
    """One command of the CLI; with spans on (utils.progress), the whole
    command is the span ``call``, its genomes in its attributes."""
    from lorikeet_tpu_torch.utils.progress import global_stage
    with global_stage("call"):
        return _main(argv)


def _main(argv) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    _warn_inert_flags(args)

    if args.command == "man":
        cmds = ([args.subcommand] if args.subcommand
                else ["call", "consensus", "genotype", "summarise"])
        for cmd in cmds:
            page = _man_page(parser, cmd)
            if args.output_directory:
                os.makedirs(args.output_directory, exist_ok=True)
                path = os.path.join(args.output_directory,
                                    f"lorikeet-tpu-{cmd}.1")
                with open(path, "w") as fh:
                    fh.write(page)
                print(path)
            else:
                print(page)
        return 0

    if args.command == "shell-completion":
        script = _completion_script(parser, args.shell)
        if args.output_file:
            with open(args.output_file, "w") as fh:
                fh.write(script)
        else:
            print(script)
        return 0

    if args.command == "summarise":
        from lorikeet_tpu_torch.strain.ani import run_summarise
        out = run_summarise(args.vcfs, args.output_directory,
                            calculate_fst=args.calculate_fst,
                            qual_by_depth_filter=args.qual_by_depth_filter,
                            depth_per_sample_filter=args.depth_per_sample_filter,
                            threads=args.threads)
        print(json.dumps({"mode": "summarise", "outputs": out}))
        return 0

    # shared parser (interval_utils.rs parity: a bare number is ignored)
    from lorikeet_tpu_torch.utils.intervals import parse_limiting_interval
    iv = parse_limiting_interval(args.limiting_interval)
    limit = (iv.start, iv.end) if iv is not None else None

    if not args.reference and not args.genome_fasta_directory:
        print("supply -r and/or -d", file=sys.stderr)
        return 2
    if args.calculate_dnds and not args.gff_file:
        from lorikeet_tpu_torch.io.mapping import check_for_external_command
        if not check_for_external_command("prodigal"):
            print("--calculate-dnds needs --gff-file or prodigal on PATH",
                  file=sys.stderr)
            return 2

    # raw-read inputs: map to cached BAMs first (bam_generator.rs role)
    bam_files = list(args.bam_files or [])
    long_bam_files = list(args.longread_bam_files or [])
    if args.read1 or args.coupled or args.single or args.interleaved \
            or args.longreads:
        from lorikeet_tpu_torch.io.mapping import map_reads_to_bam
        cache = args.bam_file_cache_directory or os.path.join(
            args.output_directory, "bams")
        ref = _mapping_reference(args, cache)
        if ref is None:
            print("raw reads need -r and/or -d references", file=sys.stderr)
            return 2

        def _params_for(mapper):
            return (args.minimap2_params if "minimap2" in mapper
                    else args.bwa_params if "bwa" in mapper else "")

        used_stems = {}

        def _map(r1, r2=None, interleaved=False, mapper=None):
            mapper = mapper or args.mapper
            stem = os.path.splitext(os.path.basename(r1))[0]
            # same-named FASTQs from different directories must not share
            # one cached BAM
            if used_stems.setdefault(stem, r1) != r1:
                import hashlib
                stem = f"{stem}_" + hashlib.md5(
                    os.path.abspath(r1).encode()).hexdigest()[:8]
            out = os.path.join(cache, f"{stem}.bam")
            if not os.path.exists(out) or args.force:
                map_reads_to_bam(mapper, ref, out, r1, r2,
                                 interleaved=interleaved,
                                 threads=args.threads,
                                 params=_params_for(mapper),
                                 sample_name=stem,
                                 discard_unmapped=not args.keep_unmapped,
                                 reference_is_index=
                                 args.minimap2_reference_is_index)
            return out

        for i, r1 in enumerate(args.read1 or []):
            r2 = args.read2[i] if args.read2 and i < len(args.read2) else None
            bam_files.append(_map(r1, r2))
        coupled = args.coupled or []
        if len(coupled) % 2:
            print("--coupled needs an even number of files", file=sys.stderr)
            return 2
        for i in range(0, len(coupled), 2):
            bam_files.append(_map(coupled[i], coupled[i + 1]))
        for r1 in args.single or []:
            bam_files.append(_map(r1))
        for r1 in args.interleaved or []:
            bam_files.append(_map(r1, interleaved=True))
        for r1 in args.longreads or []:
            long_bam_files.append(_map(r1, mapper=args.longread_mapper))
    if not bam_files and not long_bam_files:
        print("supply reads: -b/-l BAMs or -1/-2/--single/--interleaved/"
              "--longreads FASTQs", file=sys.stderr)
        return 2
    args.bam_files = bam_files
    args.longread_bam_files = long_bam_files or None

    cfg = _caller_config(args)
    from lorikeet_tpu_torch.utils.progress import set_log_level
    from lorikeet_tpu_torch.processing import start_engine
    from lorikeet_tpu_torch.utils.progress import annotate, maybe_profile
    set_log_level(args.verbose, args.quiet)
    cfg.min_long_read_size = args.min_long_read_size
    cfg.min_long_read_average_base_qual = args.min_long_read_average_base_qual
    cfg.min_sv_qual = args.min_sv_qual
    from lorikeet_tpu_torch.io.filter import AlignmentThresholds
    cfg.alignment_thresholds = AlignmentThresholds(
        args.min_read_aligned_length, args.min_read_percent_identity,
        args.min_read_aligned_percent, args.min_read_aligned_length_pair,
        args.min_read_percent_identity_pair,
        args.min_read_aligned_percent_pair)
    with maybe_profile(args.profile_dir):
        results = start_engine(args.command, args.reference or [],
                               args.bam_files, args.output_directory, cfg,
                               genome_dir=args.genome_fasta_directory,
                               extension=args.genome_fasta_extension,
                               limit=limit, force=args.force,
                               long_bam_paths=args.longread_bam_files,
                               parallel_genomes=args.parallel_genomes,
                               split_bams=args.split_bams,
                               bam_cache_dir=args.bam_file_cache_directory)
    annotate(genomes=sorted(results))

    for genome, out in results.items():
        if out.get("cached") or "vcf" not in out:
            # failed genomes carry {'error': ...}; leave them reported
            # rather than crashing the post-run annotations
            continue
        gdir = os.path.join(args.output_directory, genome)
        if args.calculate_dnds:
            from lorikeet_tpu_torch.strain.dnds import calculate_dnds, check_for_gff
            # dN/dS runs against the FASTA the genome's contigs live in
            ref = _fasta_for_genome(args, genome)
            gff = args.gff_file or check_for_gff(ref, gdir,
                                                 args.prodigal_params)
            if gff is None:
                print(f"no GFF for {genome} and prodigal unavailable; "
                      "skipping dN/dS", file=sys.stderr)
            else:
                out["dnds"] = calculate_dnds(ref, out["vcf"], gff, gdir)
        if args.calculate_fst:
            from lorikeet_tpu_torch.io.vcf import read_vcf
            from lorikeet_tpu_torch.strain.fst import write_fst
            contexts, _, samples = read_vcf(out["vcf"])
            samples = samples or ["sample0"]
            out["fst"] = write_fst(contexts, len(samples), samples, gdir,
                                   genome)

    # legacy single-genome shape: surface the lone VCF at top level
    flat = {"genomes": results}
    if len(results) == 1:
        flat.update(next(iter(results.values())))
    print(json.dumps({"mode": args.command, "outputs": flat},
                     default=str))
    return 0


def _fasta_for_genome(args, genome: str) -> str:
    from lorikeet_tpu_torch.processing import discover_genomes
    for spec in discover_genomes(args.reference or [],
                                 args.genome_fasta_directory,
                                 args.genome_fasta_extension):
        if spec.name == genome:
            return spec.fasta
    return (args.reference or [None])[0]


if __name__ == "__main__":
    sys.exit(main())
