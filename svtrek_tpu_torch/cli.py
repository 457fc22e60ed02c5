"""Command line of the port:
`python -m svtrek_tpu_torch.cli {audt,scan,disc} ...`.

The flags are the JAX package's (its `cli.build_parser`, copied here with
its option names and defaults) plus `--device {cuda,cpu}` on every mode:
cuda (the default) runs the device steps on the card, through the CUDA
kernels where the step has one (K1 for the breakpoint consensus, on the
host-extract path and on the device evidence walk of `--extract device`
and `--no-native-io`; K2 and K3 for the star POA of `--ins-consensus` and
of disc's insertion clusters, G1 for their graph POA, `--poa-engine
graph`), and fails where there is no card; cpu runs the plain PyTorch
path.  `--data-shards N` (audt and disc) splits each batch over N shards
of the visible cards (one card may hold several, each on its own stream)
or of the CPU; with SVTREK_COORDINATOR, SVTREK_NUM_PROCS and
SVTREK_PROC_ID exported, each process of a multi-process run joins a
`torch.distributed` group first (NCCL on the cards, gloo on the CPU).
"""
from __future__ import annotations

import argparse
import sys

from . import constants as C
from .config import AudtConfig, DiscConfig, ScanConfig


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("-o", "--output", default="svtrek.out",
                   help="Output filename [Default: svtrek.out]")
    p.add_argument("-t", dest="threads", type=int, default=C.THREAD_NUMBER,
                   help=f"Thread number [Default: {C.THREAD_NUMBER}]")
    p.add_argument("--verbose", action="store_true", default=False)
    p.add_argument("--consensus-interval-range", type=int,
                   default=C.CONSENSUS_INTERVAL_RANGE)
    p.add_argument("--consensus-interval", type=int,
                   default=C.CONSENSUS_INTERVAL)
    p.add_argument("--consensus-min-count", type=int,
                   default=C.CONSENSUS_MIN_COUNT)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="svtrek_tpu_torch",
        description="SV audit (audt), windowed INS discovery (scan) and "
                    "discovery (disc) on PyTorch + CUDA.",
    )
    sub = ap.add_subparsers(dest="mode")

    audt = sub.add_parser("audt", help="Audit reported variations on VCF using BAM.")
    audt.add_argument("-b", "--bam", required=True)
    audt.add_argument("-v", "--vcf", required=True)
    _add_common(audt)
    audt.add_argument("--wider-interval", type=int, default=C.WIDER_INTERVAL)
    audt.add_argument("--median-interval", type=int, default=C.MEDIAN_INTERVAL)
    audt.add_argument("--narrow-interval", type=int, default=C.NARROW_INTERVAL)
    audt.add_argument("--batch-windows", type=int, default=512,
                      help="[TPU] windows per device batch")
    audt.add_argument("--max-candidates", type=int, default=1024,
                      help="[TPU] device-walk candidate width of a "
                      "window's first pass; a window past it takes a "
                      "second pass on the device at its width (up to "
                      "16,384, past that the host oracle)")
    audt.add_argument("--no-native-io", action="store_true",
                      help="[TPU] disable the C BAM reader fast path")
    audt.add_argument("--chrom-by-name", action="store_true",
                      help="[TPU] resolve VCF CHROM names against the BAM "
                      "header (chr-prefix tolerant) instead of the "
                      "reference's numeric tid = chrom-1 assumption; "
                      "also prints the CHROM name in result lines")
    audt.add_argument("--extract", choices=("auto", "host", "device"),
                      default="auto",
                      help="[TPU] evidence-walk placement: host = C walk "
                      "ships only candidates (default with native IO), "
                      "device = ship packed CIGARs to the accelerator")
    audt.add_argument("--cand-width", type=int, default=128,
                      help="[TPU] host-extract candidate width of a "
                      "window's first pass; a window past it takes a "
                      "second pass on the device at its width (up to "
                      "16,384, past that the C scalar consensus)")
    audt.add_argument("--sweep-width", type=int, default=128,
                      help="[TPU] anchors the first consensus pass folds; "
                      "a row whose sweep passes it takes the full sweep "
                      "on the device")
    audt.add_argument("--refined-vcf", default="",
                      help="[TPU] write a refined VCF (SVELDT=SUCCESS/"
                           "PARTIAL/INCORRECT) to this path")
    audt.add_argument("--data-shards", type=int, default=0,
                      help="[TPU] mesh shards per device batch "
                           "(0 = all local devices)")
    audt.add_argument("--num-shards", type=int, default=1,
                      help="[TPU] split records across N independent "
                           "jobs/hosts (whole-genome scale-out)")
    audt.add_argument("--shard-index", type=int, default=0,
                      help="[TPU] which record shard this job owns")
    audt.add_argument("--resume", action="store_true", default=False,
                      help="[TPU] append to --output, skipping records "
                           "whose result lines are already there")
    audt.add_argument("--trace-dir", default="",
                      help="write a torch.profiler trace of the run "
                           "(host threads and card, with the svtrek.* "
                           "stage ranges) to DIR/audt_trace.json")
    audt.add_argument("--ins-consensus", action="store_true", default=False,
                      help="[TPU] emit a POA consensus of the inserted "
                           "sequence on refined INS lines (', seq: ...'):"
                           " the audt-mode partial-order-alignment path "
                           "the reference's unused abPOA submodule "
                           "intends; default off = exact output parity")
    audt.add_argument("--poa-engine", choices=("star", "graph"),
                      default="star",
                      help="[TPU] consensus engine for --ins-consensus: "
                           "star = iteratively-refined star MSA "
                           "(default; measured quality >= POA on ONT-"
                           "realistic divergence), graph = true "
                           "partial-order alignment")
    audt.add_argument("--refine-inv", action="store_true", default=False,
                      help="[TPU] real INV refinement: soft-clip + D>50 "
                           "evidence at both breakpoints through the "
                           "consensus (the reference intends this but its "
                           "refine_point collects nothing, so INV always "
                           "prints NA; default off = exact parity)")

    scan = sub.add_parser(
        "scan",
        help="Windowed INS discovery over a BAM region "
             "(the reference's dead sliding_window_ins made real).",
    )
    scan.add_argument("-b", "--bam", required=True)
    scan.add_argument("-c", "--chrom", required=True,
                      help="Numeric chromosome (1-based, tid = chrom-1), "
                      "or a reference name with --chrom-by-name")
    scan.add_argument("-s", "--start", type=int, required=True)
    scan.add_argument("-e", "--end", type=int, required=True)
    _add_common(scan)
    scan.add_argument("--window-size", type=int, default=1000)
    scan.add_argument("--slide-size", type=int, default=1)
    scan.add_argument("--batch-windows", type=int, default=8192,
                      help="[TPU] sub-windows per device batch")
    scan.add_argument("--no-native-io", action="store_true")
    scan.add_argument("--chrom-by-name", action="store_true",
                      help="[TPU] resolve -c against the BAM header "
                      "(chr-prefix tolerant) instead of the reference's "
                      "numeric tid = chrom-1 assumption")

    disc = sub.add_parser("disc", help="Variation discovery on graph alignment result.")
    disc.add_argument("-r", "--gfa", required=True)
    disc.add_argument("-a", "--gaf", required=True)
    disc.add_argument("-q", "--fq", required=True)
    _add_common(disc)
    disc.add_argument("--sv-min-length", type=int, default=C.SV_MIN_LENGTH,
                      help="[TPU] minimum SV length for discovery")
    disc.add_argument("--cluster-window", type=int, default=100,
                      help="[TPU] max gap (bp) between consecutive sorted "
                           "signals chained into one cluster")
    disc.add_argument("--resume", action="store_true", default=False,
                      help="[TPU] restore the detection phase from "
                           "<output>.ckpt.npz (written on every run with "
                           "an output file; invalidated when the GFA/GAF "
                           "inputs change)")
    disc.add_argument("--data-shards", type=int, default=0,
                      help="[TPU] mesh shards per detection batch "
                           "(0 = all local devices)")
    disc.add_argument("--poa-engine", choices=("star", "graph"),
                      default="star",
                      help="[TPU] INS consensus engine (see audt "
                           "--poa-engine)")
    for p in (audt, scan, disc):
        p.add_argument(
            "--device", choices=("cuda", "cpu"), default="cuda",
            help="cuda = the CUDA kernels on the card (default; an error "
                 "where there is none), cpu = the plain PyTorch path")
    return ap


def validate_file(filename: str, message: str):
    """Reference: init.c:35-47 (but exits cleanly instead of crashing on
    fclose(NULL) as the C would)."""
    import os

    if not filename:
        print(message, file=sys.stderr)
        raise SystemExit(1)
    if not os.path.exists(filename):
        print(f"[ERROR]: File couldn't be opened {filename}", file=sys.stderr)
        raise SystemExit(1)


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
    """The disc mapping of the JAX package's CLI (its main, mode "disc")."""
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


def scan_config_from_args(args) -> ScanConfig | None:
    """The scan mapping of the JAX package's CLI (its main, mode "scan");
    None, after an error message, for a non-numeric -c without
    --chrom-by-name."""
    if args.chrom_by_name:
        chrom, chrom_name = 0, args.chrom
    else:
        try:
            chrom, chrom_name = int(args.chrom), ""
        except ValueError:
            print(f"[ERROR] -c {args.chrom!r} is not numeric; use "
                  f"--chrom-by-name to pass a reference name.",
                  file=sys.stderr)
            return None
    return ScanConfig(
        bam_file=args.bam, chrom=chrom, chrom_name=chrom_name,
        chrom_by_name=args.chrom_by_name, start=args.start,
        end=args.end, window_size=args.window_size,
        slide_size=args.slide_size, output_file=args.output,
        thread_number=args.threads, verbose=args.verbose,
        consensus_interval_range=args.consensus_interval_range,
        consensus_interval=args.consensus_interval,
        consensus_min_count=args.consensus_min_count,
        batch_windows=args.batch_windows,
        use_native_io=not args.no_native_io,
    )


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.mode not in ("audt", "scan", "disc"):
        ap.print_help()
        return 1
    from .device import DeviceUnavailable
    from .pipeline.audit import NativeReaderUnavailable
    from .refusals import Unsupported

    try:
        if args.mode == "scan":
            from .pipeline.scan import run_scan

            cfg = scan_config_from_args(args)
            if cfg is None:
                return 1
            validate_file(cfg.bam_file, "[ERROR] BAM file is not provided.")
            run_scan(cfg, device=args.device)
        elif args.mode == "audt":
            from .pipeline.audit import run_audit

            cfg = config_from_args(args)
            validate_file(cfg.bam_file,
                                  "[ERROR] BAM file is not provided.")
            validate_file(cfg.vcf_file,
                                  "[ERROR] VCF file is not provided.")
            # Lines stream to stdout and the output file; not also held.
            run_audit(cfg, collect_lines=False)
        else:
            from .pipeline.discover import run_discover

            cfg = disc_config_from_args(args)
            validate_file(cfg.gfa_file,
                                  "[ERROR] r/GFA file is not provided.")
            validate_file(cfg.gaf_file,
                                  "[ERROR] GAF file is not provided.")
            validate_file(cfg.fq_file,
                                  "[ERROR] FASTQ file is not provided.")
            run_discover(cfg, device=args.device)
    except (Unsupported, DeviceUnavailable, NativeReaderUnavailable) as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
