"""xsqueezeit-compatible command line interface.

Flags mirror the reference CLI (/root/reference/include/xsqueezeit.hpp:36-93):

    xsqueezeit -c -f in.{vcf,vcf.gz,bcf} -o out.xsi [--zstd] [--maf F]
               [--variant-block-length N] [--zstd-level L]
               [--wah-encode-missing] [-v]
    xsqueezeit -x -f out.xsi -o out.bcf [-O b|u|z|v|x] [-r REGIONS]
               [-t TARGETS] [-s SAMPLES] [-S FILE] [-H] [-p]
    xsqueezeit -i -f out.xsi
"""
from __future__ import annotations

import argparse
import os
import struct
import sys

from .format.constants import (
    DEFAULT_BLOCK_LENGTH,
    DEFAULT_MAF,
    DEFAULT_ZSTD_LEVEL,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="xsqueezeit",
        description="xSqueezeIt - VCF/BCF Compressor (JAX rebuild)")
    p.add_argument("-f", "--file", default="-", help="Input file name")
    p.add_argument("-o", "--output", default="-", help="Output file name")
    p.add_argument("-O", "--output-type", default="b", choices="buzvx",
                   help="Output type b|u|z|v|x")
    p.add_argument("-p", "--fast-pipe", action="store_true",
                   help="Outputs uncompressed BCF (-Ou) when writing to stdout")
    p.add_argument("-c", "--compress", action="store_true", help="Compress")
    p.add_argument("-d", "--decompress", action="store_true", help="Decompress")
    p.add_argument("-x", "--extract", action="store_true",
                   dest="decompress", help="Extract (Decompress)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Verbose, prints progress")
    p.add_argument("--zstd", action="store_true", help="Compress blocks with zstd")
    p.add_argument("--zstd-level", "--zl", type=int, default=DEFAULT_ZSTD_LEVEL,
                   help="zstd compression level")
    p.add_argument("--maf", type=float, default=DEFAULT_MAF,
                   help="Minor Allele Frequency threshold")
    p.add_argument("-i", "--info", action="store_true", help="Get info on file")
    p.add_argument("--variant-block-length", type=int,
                   default=DEFAULT_BLOCK_LENGTH,
                   help="Number of VCF lines to compress together")
    p.add_argument("--wah-encode-missing", action="store_true",
                   help="Encode missing alleles with WAH strategy")
    p.add_argument("-s", "--samples", default="",
                   help='Comma-separated samples to include ("^" to exclude)')
    p.add_argument("-S", "--samples-file", default="",
                   help="File of sample names (one per line)")
    p.add_argument("-r", "--regions", default="",
                   help="chr|chr:pos|chr:beg-end[,...]")
    p.add_argument("-R", "--regions-file", default="", help="Region file")
    p.add_argument("-t", "--targets", default="",
                   help="Targets (POS-only filter, streamed)")
    p.add_argument("-H", "--no-header", action="store_true",
                   help="Suppress the header in VCF output")
    p.add_argument("--profile", default="",
                   help="Write a JAX profiler trace of the run to this "
                        "directory (view with TensorBoard / xprof)")
    p.add_argument("--count-xcf", action="store_true",
                   help="Count the variant entries of a VCF/BCF and print "
                        "the elapsed time (reference debug utility)")
    p.add_argument("--distributed", default="", metavar="HOST:PORT",
                   help="Multi-host compression: jax.distributed coordinator "
                        "address; launch one identical process per host with "
                        "--dist-nproc/--dist-procid (process 0 writes output)")
    p.add_argument("--dist-nproc", type=int, default=None,
                   help="Total number of processes of the distributed run")
    p.add_argument("--dist-procid", type=int, default=None,
                   help="This process's id (0-based) in the distributed run")
    p.add_argument("--dist-devices", default=None, metavar="IDS",
                   help="Comma list of the local accelerator ids this "
                        "process uses (one process per card on a shared "
                        "host); default: every local device")
    return p


def main(argv: list[str] | None = None) -> int:
    from .utils.malltune import tune_glibc_malloc
    tune_glibc_malloc()

    args = build_parser().parse_args(argv)

    if args.variant_block_length is not None and args.variant_block_length < 1:
        print("xsqueezeit: error: --variant-block-length must be >= 1",
              file=sys.stderr)
        return 1

    if args.profile:
        # the aux-subsystem counterpart of the reference's wall-clock
        # printElapsedTime tracing (SURVEY §5): full device+host trace
        import contextlib
        import jax

        profile_cm = jax.profiler.trace(args.profile)
    else:
        import contextlib
        profile_cm = contextlib.nullcontext()

    try:
        with profile_cm:
            return _dispatch(args)
    except BrokenPipeError:
        # downstream closed the pipe (`-x -O u -o - | head`, the roh
        # workflow): exit quietly like htslib tools, no traceback.
        # stdout is already broken — detach it so interpreter shutdown
        # doesn't print a second error trying to flush.
        # (MUST precede the OSError containment clause below: it is an
        # OSError subclass.)
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 141  # 128 + SIGPIPE, the shell's convention
    except KeyboardInterrupt:
        return 130
    except (ValueError, OSError, EOFError, NotImplementedError,
            struct.error) as exc:
        # Top-level error containment (reference parity: codec throws are
        # caught in main and printed as one line,
        # xsqueezeit.cpp:123-126,138-141,183-186).  User-level failures —
        # missing/corrupt files, bad regions, unknown samples, empty
        # selections — exit nonzero with a diagnostic, not a traceback.
        # XSI_DEBUG=1 re-raises for development.
        if os.environ.get("XSI_DEBUG"):
            raise
        msg = str(exc) or exc.__class__.__name__
        print(f"xsqueezeit: error: {msg}", file=sys.stderr)
        return 1


def _device_ids(text: str | None) -> list[int] | None:
    if not text:
        return None
    return [int(x) for x in text.split(",") if x]


def _dispatch(args) -> int:
    import sys

    if args.info:
        from .format.header import XsiHeader
        with open(args.file, "rb") as f:
            header = XsiHeader.unpack(f.read(256))
        print(header.info_string(), file=sys.stderr)
        return 0

    if args.count_xcf:
        # reference parity: --count-xcf (xsqueezeit.cpp:58-64 ->
        # count_entries, xcf.cpp:318-340)
        import time as _time
        from .io.unified import count_entries
        t0 = _time.perf_counter()
        count = count_entries(args.file)
        elapsed = _time.perf_counter() - t0
        print(f"INFO : Number of entries is : {count}", file=sys.stderr)
        print(f"Time taken : {elapsed:.6f} s", file=sys.stderr)
        return 0

    if args.compress:
        from .codec.compressor import CompressorOptions, compress_file
        opts = CompressorOptions(
            maf=args.maf, block_length=args.variant_block_length,
            zstd=args.zstd, zstd_level=args.zstd_level,
            wah_encode_missing=args.wah_encode_missing,
            verbose=args.verbose)
        if args.distributed:
            from .parallel.distributed import compress_file_multihost
            stats = compress_file_multihost(
                args.file, args.output, opts,
                coordinator=args.distributed,
                num_processes=args.dist_nproc,
                process_id=args.dist_procid,
                local_device_ids=_device_ids(args.dist_devices))
            if stats is None:      # non-zero process: encode + gather only
                return 0
        else:
            stats = compress_file(args.file, args.output, opts)
        if args.verbose:
            print(f"Compressed {stats['entries']} entries "
                  f"({stats['variants']} variants) of {stats['n_samples']} "
                  f"samples into {stats['xsi_bytes']} + "
                  f"{stats['variant_bytes']} bytes", file=sys.stderr)
        return 0

    if args.decompress:
        from .codec.decompressor import Decompressor, DecompressorOptions
        regions = args.regions
        if args.regions_file:
            with open(args.regions_file) as f:
                file_regions = []
                for line in f:
                    parts = line.split()
                    if not parts or line.startswith("#"):
                        continue
                    if len(parts) >= 3:
                        file_regions.append(f"{parts[0]}:{parts[1]}-{parts[2]}")
                    elif len(parts) == 2:
                        file_regions.append(f"{parts[0]}:{parts[1]}")
                    else:
                        file_regions.append(parts[0])
            regions = ",".join([r for r in [regions] if r] + file_regions)
        output_type = args.output_type
        out = args.output
        if out == "-" and output_type == "b":
            # text to stdout unless -p, which pipes uncompressed BCF (-Ou)
            output_type = "u" if args.fast_pipe else "v"
        if out.endswith(".vcf"):
            output_type = "v" if output_type in ("b", "u") else output_type
        opts = DecompressorOptions(
            regions=regions, targets=args.targets, samples=args.samples,
            samples_file=args.samples_file, output_type=output_type,
            no_header=args.no_header, verbose=args.verbose)
        if args.distributed:
            from .parallel.distributed import decompress_file_multihost
            decompress_file_multihost(
                args.file, out, opts,
                coordinator=args.distributed,
                num_processes=args.dist_nproc,
                process_id=args.dist_procid,
                local_device_ids=_device_ids(args.dist_devices))
            return 0
        Decompressor(args.file, opts).decompress(out)
        return 0

    build_parser().print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
