"""Command line of the port: `python -m svtrek_tpu_torch.cli {audt,disc} ...`.

The flags are `svtrek_tpu`'s (svtrek_tpu.cli.build_parser) plus
`--device {cuda,cpu}` on `audt` and `disc`: cuda (the default) runs the
device steps on the card, through the CUDA kernels where the step has one
(K1 for the breakpoint consensus; K2 and K3 for the star POA of
`--ins-consensus` and of disc's insertion clusters), and fails where there
is no card; cpu runs the plain PyTorch path.  The `scan` mode, and the
options the port does not run yet (`--data-shards` > 1, `--extract
device`, `--no-native-io`, `--poa-engine graph`), exit with an error that
names the ROADMAP item porting them.
"""
from __future__ import annotations

import argparse
import sys

from svtrek_tpu import cli as tpu_cli
from svtrek_tpu.config import AudtConfig, DiscConfig


def build_parser() -> argparse.ArgumentParser:
    ap = tpu_cli.build_parser()
    ap.prog = "svtrek_tpu_torch"
    ap.description = "SV audit (audt) and discovery (disc) on PyTorch + CUDA."
    sub = next(a for a in ap._actions
               if isinstance(a, argparse._SubParsersAction))
    for mode in ("audt", "disc"):
        sub.choices[mode].add_argument(
            "--device", choices=("cuda", "cpu"), default="cuda",
            help="cuda = the CUDA kernels on the card (default; an error "
                 "where there is none), cpu = the plain PyTorch path")
    return ap


def config_from_args(args) -> AudtConfig:
    return AudtConfig(
        bam_file=args.bam, vcf_file=args.vcf, output_file=args.output,
        thread_number=args.threads, verbose=args.verbose,
        wider_interval=args.wider_interval,
        median_interval=args.median_interval,
        narrow_interval=args.narrow_interval,
        consensus_interval_range=args.consensus_interval_range,
        consensus_interval=args.consensus_interval,
        consensus_min_count=args.consensus_min_count,
        batch_windows=args.batch_windows,
        max_candidates=args.max_candidates,
        use_native_io=not args.no_native_io,
        chrom_by_name=args.chrom_by_name,
        extract=args.extract,
        cand_width=args.cand_width,
        sweep_width=args.sweep_width,
        device=args.device,
        refined_vcf=args.refined_vcf,
        data_shards=args.data_shards,
        num_shards=args.num_shards,
        shard_index=args.shard_index,
        resume=args.resume,
        trace_dir=args.trace_dir,
        refine_inv=args.refine_inv,
        ins_consensus=args.ins_consensus,
        poa_engine=args.poa_engine,
    )


def disc_config_from_args(args) -> DiscConfig:
    """svtrek_tpu.cli's disc mapping (its main, mode "disc")."""
    return DiscConfig(
        gfa_file=args.gfa, gaf_file=args.gaf, fq_file=args.fq,
        output_file=args.output, thread_number=args.threads,
        verbose=args.verbose,
        consensus_interval_range=args.consensus_interval_range,
        consensus_interval=args.consensus_interval,
        consensus_min_count=args.consensus_min_count,
        sv_min_length=args.sv_min_length,
        cluster_window=args.cluster_window,
        resume=args.resume,
        data_shards=args.data_shards,
        poa_engine=args.poa_engine,
    )


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.mode == "scan":
        print("[ERROR] scan mode is not ported to svtrek_tpu_torch yet "
              "(ROADMAP queue 1 item 7); use svtrek_tpu.cli.",
              file=sys.stderr)
        return 1
    if args.mode not in ("audt", "disc"):
        ap.print_help()
        return 1
    from .device import DeviceUnavailable
    from .refusals import Unsupported

    try:
        if args.mode == "audt":
            from .pipeline.audit import run_audit

            cfg = config_from_args(args)
            tpu_cli.validate_file(cfg.bam_file,
                                  "[ERROR] BAM file is not provided.")
            tpu_cli.validate_file(cfg.vcf_file,
                                  "[ERROR] VCF file is not provided.")
            # Lines stream to stdout and the output file; not also held.
            run_audit(cfg, collect_lines=False)
        else:
            from .pipeline.discover import run_discover

            cfg = disc_config_from_args(args)
            tpu_cli.validate_file(cfg.gfa_file,
                                  "[ERROR] r/GFA file is not provided.")
            tpu_cli.validate_file(cfg.gaf_file,
                                  "[ERROR] GAF file is not provided.")
            tpu_cli.validate_file(cfg.fq_file,
                                  "[ERROR] FASTQ file is not provided.")
            run_discover(cfg, device=args.device)
    except (Unsupported, DeviceUnavailable) as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
