"""Command line of the port: `python -m svtrek_tpu_torch.cli audt ...`.

The flags are `svtrek_tpu`'s (svtrek_tpu.cli.build_parser) plus
`--device {cuda,cpu}`: cuda (the default) runs the device steps on the
card through the CUDA kernels (K1 for the breakpoint consensus; K2 and K3
for the `--ins-consensus` star POA) and fails where there is no card; cpu
runs the plain PyTorch path.  `scan` and `disc`, and the `audt` options
the port does not run yet (`--data-shards` > 1, `--extract device`,
`--no-native-io`, `--poa-engine graph`), exit with an error that names the
ROADMAP item porting them.
"""
from __future__ import annotations

import argparse
import sys

from svtrek_tpu import cli as tpu_cli
from svtrek_tpu.config import AudtConfig


def build_parser() -> argparse.ArgumentParser:
    ap = tpu_cli.build_parser()
    ap.prog = "svtrek_tpu_torch"
    ap.description = "SV audit (audt) on PyTorch + CUDA."
    sub = next(a for a in ap._actions
               if isinstance(a, argparse._SubParsersAction))
    sub.choices["audt"].add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="cuda = the CUDA kernels on the card (default; an error where "
             "there is none), cpu = the plain PyTorch path")
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


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.mode in ("scan", "disc"):
        item = 7 if args.mode == "scan" else 6
        print(f"[ERROR] {args.mode} mode is not ported to svtrek_tpu_torch "
              f"yet (ROADMAP queue 1 item {item}); use svtrek_tpu.cli.",
              file=sys.stderr)
        return 1
    if args.mode != "audt":
        ap.print_help()
        return 1
    from .device import DeviceUnavailable
    from .pipeline.audit import Unsupported, run_audit

    cfg = config_from_args(args)
    try:
        tpu_cli.validate_file(cfg.bam_file, "[ERROR] BAM file is not provided.")
        tpu_cli.validate_file(cfg.vcf_file, "[ERROR] VCF file is not provided.")
        # Lines stream to stdout and the output file; not also held.
        run_audit(cfg, collect_lines=False)
    except (Unsupported, DeviceUnavailable) as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
