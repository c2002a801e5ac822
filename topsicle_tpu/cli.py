"""`topsicle` console entry point — flag-compatible with the reference
CLI (main.py:314-345; 15 flags, same names/defaults) plus a device-runtime
group (--engine, --batchSize, ...).

The run-log line sequence mirrors the reference's (parameter echo,
separators, per-stage lines, completion sentinel, elapsed time) so
existing log-scraping workflows keep working (README.md:272 greps the
sentinel line).
"""

from __future__ import annotations

import argparse
import sys
import time

from topsicle_tpu.config import TopsicleConfig
from topsicle_tpu.io.writer import RunLog


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="topsicle",
        description="Topsicle - Telomere length estimation from long reads (JAX engine)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--inputDir", "-i", type=str, metavar="FILE/FOLDER", required=True,
                   help="FASTA/FASTQ input: one file or a directory tree (gzip OK)")
    p.add_argument("--outputDir", "-o", type=str, metavar="FOLDER", required=True,
                   help="Directory where the CSV, log, subset files, and plots go")
    p.add_argument("--pattern", metavar="CHAR", type=str, required=True,
                   help="Telomere repeat unit, written 5'->3' (A. thaliana: CCCTAAA; human: CCCTAA)")
    p.add_argument("--minSeqLength", metavar="INT", type=int, default=9000,
                   help="Skip reads whose length is not strictly greater than this")
    p.add_argument("--rawcountpattern", action="store_true",
                   help="Also emit per-window, per-k-mer count tables (rawcount_{k}_{n}.csv)")
    p.add_argument("--telophrase", nargs="+", metavar="INT", type=int,
                   help="k-mer size(s) to scan with; omitted => len(pattern) - 2")
    p.add_argument("--cutoff", nargs="+", metavar="FLOAT", type=float, default=0.7,
                   help="TRC threshold(s); the minimum filters reads, the first anchors the quadratic fit")
    p.add_argument("--windowSize", metavar="INT", type=int, default=100,
                   help="Width (bp) of the step-2 scan window")
    p.add_argument("--slide", metavar="INT", type=int,
                   help="Distance between window starts; omitted => len(pattern)")
    p.add_argument("--trimfirst", metavar="INT", type=int, default=100,
                   help="Bases to drop from the telomeric end before the window scan")
    p.add_argument("--maxlengthtelo", metavar="INT", type=int, default=20000,
                   help="Cap (bp) on how far into each read the boundary search goes")
    p.add_argument("--plot", action="store_true",
                   help="Save a window-signal + changepoint figure for every passing read")
    p.add_argument("--rangecp", metavar="INT", type=int,
                   help="x-axis limit of the per-read changepoint figure (defaults to maxlengthtelo)")
    p.add_argument("--read_check", metavar="STR", type=str,
                   help="Restrict step 2 to a single read ID (debugging aid)")
    p.add_argument("--override", "-ov", action="store_true",
                   help="Replace an existing non-empty telolengths_all.csv; subset files are reused")
    p.add_argument("--threads", "-t", metavar="INT", type=int, default=None,
                   help="Host parse/encode workers: up to N input files are read "
                        "concurrently (the current one plus N-1 ahead of the device). "
                        "Default: all available cores; 1 = fully serial")
    # --- device runtime (no reference analog) ---
    p.add_argument("--engine", choices=["jax", "oracle"], default="jax",
                   help="Compute engine: 'jax' (GPU/accelerator) or 'oracle' (pure-CPU reference semantics)")
    p.add_argument("--batchSize", metavar="INT", type=int, default=128,
                   help="Reads per device batch")
    p.add_argument("--resume", action="store_true",
                   help="Continue an interrupted run: keep completed (file, k) units from the existing CSV/manifest and recompute only the rest")
    p.add_argument("--traceDir", metavar="FOLDER", type=str, default=None,
                   help="Write a jax.profiler trace of the run to this directory")
    p.add_argument("--precompile", action="store_true",
                   help="Compile every device program this configuration "
                        "uses into the persistent compile cache, then exit "
                        "without reading input (run once per machine/cache "
                        "volume so later jobs start warm)")
    p.add_argument("--scanLengthMode", choices=["static", "bucket"], default="static",
                   help="Step-2 padding: 'static' = one device program for the whole "
                        "run (fast startup); 'bucket' = pad per batch (less compute "
                        "on short-read data, one compile per length bucket)")
    # --- multi-host (reference analog: manual SLURM job splitting,
    # README.md:261-270 — here it is automatic and deterministic) ---
    p.add_argument("--coordinator", metavar="HOST:PORT", type=str, default=None,
                   help="jax.distributed coordinator address for multi-host runs")
    p.add_argument("--processId", metavar="INT", type=int, default=None,
                   help="This process's index (with --processCount; inferred from jax.distributed otherwise)")
    p.add_argument("--processCount", metavar="INT", type=int, default=None,
                   help="Total processes sharing the run (input files are sharded round-robin; process 0 merges)")
    p.add_argument("--shardMode", choices=["files", "global"], default="files",
                   help="Multi-host layout: 'files' = each process computes its own files; "
                        "'global' = one batch sharded over every chip of every host (needs --coordinator)")
    return p


def config_from_args(args: argparse.Namespace) -> TopsicleConfig:
    return TopsicleConfig(
        input_dir=args.inputDir,
        output_dir=args.outputDir,
        pattern=args.pattern,
        min_seq_length=args.minSeqLength,
        rawcountpattern=args.rawcountpattern,
        telophrase=args.telophrase,
        cutoff=args.cutoff,
        window_size=args.windowSize,
        slide=args.slide,
        trimfirst=args.trimfirst,
        maxlengthtelo=args.maxlengthtelo,
        plot=args.plot,
        rangecp=args.rangecp,
        read_check=args.read_check,
        override=args.override,
        threads=args.threads,
        engine=args.engine,
        batch_size=args.batchSize,
        resume=args.resume,
        trace_dir=args.traceDir,
        scan_length_mode=args.scanLengthMode,
        process_id=args.processId,
        process_count=args.processCount,
        shard_mode=args.shardMode,
    )


def main(argv=None) -> int:
    start_time = time.time()
    args = build_parser().parse_args(argv)
    log = RunLog(args.outputDir)

    log.plain("---- Topsicle run parameters ---")
    for k, v in vars(args).items():
        log(f"{k}: {v}")
    log.plain("---------------------")
    log("Starting Topsicle analysis")

    cfg = config_from_args(args)
    try:
        cfg.validate()
    except ValueError as e:
        log(str(e))
        return 2

    if args.telophrase is None:
        log(f"No telophrase provided, use kmer: {cfg.telophrases()}")

    if args.coordinator:
        from topsicle_tpu.parallel.mesh import initialize_distributed

        initialize_distributed(args.coordinator, args.processCount, args.processId)
    cache_dir = None
    if cfg.engine == "jax":
        import jax

        from topsicle_tpu.utils.compile_cache import enable_compilation_cache

        cache_dir = enable_compilation_cache()
        log(f"compile cache: {cache_dir}")
        log(f"devices: {[str(d) for d in jax.devices()]}")
    log.plain("---------------------")

    from topsicle_tpu.pipeline import make_engine

    if args.precompile:
        if cfg.engine != "jax":
            log("--precompile only applies to the jax engine")
            return 2
        from topsicle_tpu.pipeline import JaxEngine

        n = JaxEngine(cfg, log=log).precompile()
        log(f"precompiled {n} device programs into {cache_dir}")
        print(f"Elapsed time(s): {time.time() - start_time:.2f} seconds")
        return 0

    try:
        make_engine(cfg, log=log).run()
    except FileExistsError as e:
        log(str(e))
        return 1
    except ValueError as e:
        log(str(e))
        return 2

    elapsed = time.time() - start_time
    print(f"Elapsed time(s): {elapsed:.2f} seconds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
