"""Tool-suite entry point — counterparts of the reference's standalone
benchmark/validation binaries (loading_time/, dot_prod/, af_stats/,
lockstep_loader/) and the xcf.cpp test-data generators.

    python -m xsqueezeit_tpu.bench loading_time  FILE
    python -m xsqueezeit_tpu.bench dot_prod      FILE [--seed N]
    python -m xsqueezeit_tpu.bench af_stats      FILE [--summary]
    python -m xsqueezeit_tpu.bench lockstep      FILE_A FILE_B
    python -m xsqueezeit_tpu.bench unphase       IN OUT [--random --seed N]
    python -m xsqueezeit_tpu.bench sprinkle-missing IN OUT [--rate F --seed N]
    python -m xsqueezeit_tpu.bench phase-switch-errors TEST REF
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    from ..utils.malltune import tune_glibc_malloc
    tune_glibc_malloc()

    p = argparse.ArgumentParser(prog="xsqueezeit-tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("loading_time")
    s.add_argument("file")
    s.add_argument("--native", action="store_true",
                   help="read through the C++ accessor library (XSI only)")
    s = sub.add_parser("dot_prod")
    s.add_argument("file")
    s.add_argument("--seed", type=int, default=42)
    s.add_argument("--device", action="store_true",
                   help="block-batched device matmul path (XSI input only)")
    s = sub.add_parser("af_stats")
    s.add_argument("file")
    s.add_argument("--summary", action="store_true",
                   help="print only counts, not per-record stats")
    s.add_argument("--annotate", default=None,
                   help="write the variant BCF with AC/AN patched into INFO")
    s = sub.add_parser("lockstep")
    s.add_argument("file_a")
    s.add_argument("file_b")
    s = sub.add_parser("unphase")
    s.add_argument("infile")
    s.add_argument("outfile")
    s.add_argument("--random", action="store_true")
    s.add_argument("--seed", type=int, default=None)
    s = sub.add_parser("sprinkle-missing")
    s.add_argument("infile")
    s.add_argument("outfile")
    s.add_argument("--rate", type=float, default=0.01)
    s.add_argument("--seed", type=int, default=None)
    s = sub.add_parser("phase-switch-errors")
    s.add_argument("test_file")
    s.add_argument("ref_file")
    s = sub.add_parser("phase")
    s.add_argument("infile")
    s.add_argument("outfile")
    s.add_argument("--windows", action="store_true",
                   help="word-window parsimony phaser "
                        "(PhasingMachineryNew) instead of the "
                        "PBWT-neighbour heuristic")
    s.add_argument("--word-bits", type=int, default=64)
    s = sub.add_parser("stats")
    s.add_argument("file")
    s = sub.add_parser("e2e")
    s.add_argument("--records", type=int, default=20000)
    s.add_argument("--samples", type=int, default=2504)
    s.add_argument("--dir", default=None,
                   help="working directory (kept); default: temp")
    s.add_argument("--device", default="auto",
                   choices=["auto", "jax", "numpy", "native"])
    s.add_argument("--zstd", action="store_true")
    s.add_argument("--missing", type=float, default=0.0,
                   help="fraction of genotype slots sprinkled missing "
                        "(exception-track stress regime)")

    s = sub.add_parser("hrc", help="HRC-width (64976 hap) file-level "
                                   "round trip + streamed lockstep")
    s.add_argument("--records", type=int, default=16384)
    s.add_argument("--samples", type=int, default=32488)
    s.add_argument("--block-length", type=int, default=4096)
    s.add_argument("--device", default="numpy")
    s.add_argument("--dir", default=None)

    s = sub.add_parser("warmup", help="pre-compile device executables for "
                                      "a geometry (the compile cache "
                                      "persists them)")
    s.add_argument("--samples", type=int, required=True)
    s.add_argument("--block-length", type=int, default=8192)
    s.add_argument("--maf-threshold", type=int, default=None)
    s.add_argument("--fracs", default="1.0,0.7,0.45,0.2")

    s = sub.add_parser("scaling", help="multi-process compress scaling "
                                       "curve (jax.distributed, CPU)")
    s.add_argument("--records", type=int, default=20000)
    s.add_argument("--samples", type=int, default=500)
    s.add_argument("--block-length", type=int, default=1024)
    s.add_argument("--procs", default="1,2,4")
    s.add_argument("--dir", default=None)

    args = p.parse_args(argv)

    if args.cmd == "loading_time":
        from .tools import loading_time
        print(json.dumps(loading_time(args.file, native=args.native)))
    elif args.cmd == "dot_prod":
        if args.device:
            from .tools import dot_prod_device
            print(json.dumps(dot_prod_device(args.file, seed=args.seed)))
        else:
            from .tools import dot_prod
            print(json.dumps(dot_prod(args.file, seed=args.seed)))
    elif args.cmd == "af_stats":
        from .tools import af_stats
        out = af_stats(args.file, annotate_out=args.annotate)
        if args.summary:
            out = {"records": out["records"], "seconds": out["seconds"]}
        print(json.dumps(out))
    elif args.cmd == "lockstep":
        from .tools import lockstep_load
        try:
            print(json.dumps(lockstep_load(args.file_a, args.file_b)))
        except AssertionError as e:
            print(f"MISMATCH: {e}", file=sys.stderr)
            return 1
    elif args.cmd == "unphase":
        from ..utils.mutate import unphase, unphase_random
        n = (unphase_random(args.infile, args.outfile, seed=args.seed)
             if args.random else unphase(args.infile, args.outfile))
        print(json.dumps({"records": n}))
    elif args.cmd == "sprinkle-missing":
        from ..utils.mutate import sprinkle_missing
        n = sprinkle_missing(args.infile, args.outfile, rate=args.rate,
                             seed=args.seed)
        print(json.dumps({"records": n}))
    elif args.cmd == "phase-switch-errors":
        from ..utils.mutate import compute_phase_switch_errors
        out = compute_phase_switch_errors(args.test_file, args.ref_file)
        out.pop("per_sample")
        print(json.dumps(out))
    elif args.cmd == "phase":
        if args.windows:
            from ..utils.phasing import phase_file_windows
            print(json.dumps(phase_file_windows(
                args.infile, args.outfile, word_bits=args.word_bits)))
        else:
            from ..utils.phasing import phase_file
            print(json.dumps(phase_file(args.infile, args.outfile)))
    elif args.cmd == "stats":
        from ..utils.stats import xsi_block_stats
        print(json.dumps(xsi_block_stats(args.file)))
    elif args.cmd == "e2e":
        from .e2e import run
        print(json.dumps(run(n_records=args.records, n_samples=args.samples,
                             workdir=args.dir, device=args.device,
                             zstd=args.zstd, missing_frac=args.missing)))
    elif args.cmd == "hrc":
        from .tools import hrc_scale
        print(json.dumps(hrc_scale(
            n_records=args.records, n_samples=args.samples,
            block_length=args.block_length, device=args.device,
            workdir=args.dir)))
    elif args.cmd == "warmup":
        from .tools import warmup
        print(json.dumps(warmup(
            args.samples, block_length=args.block_length,
            mac_threshold=args.maf_threshold,
            fracs=tuple(float(f) for f in args.fracs.split(",")))))
    elif args.cmd == "scaling":
        from .tools import scaling_curve
        procs = tuple(int(x) for x in args.procs.split(",") if x)
        print(json.dumps(scaling_curve(
            n_records=args.records, n_samples=args.samples,
            procs=procs, block_length=args.block_length,
            workdir=args.dir)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
