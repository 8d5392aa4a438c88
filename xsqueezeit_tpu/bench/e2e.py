"""End-to-end file-level benchmark: CLI wall-clock, file -> file.

The reference's decompression profile is dominated by host serialization
(>60% bcf_write1, ~15% bcf_update_genotypes,
reference include/gt_decompressor_new.hpp:308,315), so kernel GB/s
alone overstates user-visible speed.  This tool measures what a user sees:

    synth  — write a chr20-like synthetic BCF (2504 samples, rare-heavy
             site-frequency mix, phased diploid)
    run    — time `cli -c` (BCF -> .xsi) and `cli -x -O b` (.xsi -> BCF)
             wall-clock, verify the round trip on sampled records, and
             print MB/s over the logical htslib genotype bytes plus the
             host/device time split of the extract phase.

    python -m xsqueezeit_tpu.bench e2e [--records N] [--samples N] [--dir D]
"""
from __future__ import annotations

import os
import time

import numpy as np


def synth_bcf(path: str, n_records: int, n_samples: int, seed: int = 5,
              block: int = 4096, missing_frac: float = 0.0) -> None:
    """Vectorised synthetic chr20-like BCF writer (phased diploid).

    missing_frac sprinkles that fraction of genotype slots missing
    (phase bit kept), the reference's own stress fixture
    (sprinkle_missing_xcf, xcf.cpp:444-578) — every record then carries
    a missing exception track."""
    from ..io.bcf import (
        BcfHeader,
        BcfWriter,
        pack_type_descriptor,
        pack_typed_int,
    )
    from ..io.sites import encode_shared_from_vcf_cols

    rng = np.random.default_rng(seed)
    h = BcfHeader.from_text(
        "##fileformat=VCFv4.2\n"
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
        "##contig=<ID=20,length=63025520>\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(f"S{i}" for i in range(n_samples)))
    w = BcfWriter(path, h)
    H = n_samples * 2
    gt_key = h.str2idx["GT"]
    prefix = pack_typed_int(gt_key) + pack_type_descriptor(1, 2)
    pos = 60000
    for start in range(0, n_records, block):
        n = min(block, n_records - start)
        kind = rng.random(n)
        freqs = np.where(
            kind < 0.55, rng.uniform(0.0, 0.0015, n),
            np.where(kind < 0.80, rng.uniform(0.0015, 0.05, n),
                     rng.uniform(0.05, 0.95, n)))
        # u16-threshold draw instead of float64 uniforms: the float matrix
        # alone was ~530 MB/block and dominated HRC-scale synthesis (the
        # 1/65536 frequency quantisation is irrelevant for a fixture).
        draw = rng.integers(0, 65536, (n, H), dtype=np.uint16)
        thresh = (freqs * 65536.0).astype(np.uint16)
        alleles = (draw < thresh[:, None]).astype(np.int8)
        codes = ((alleles + 1) << 1) | 1
        codes[:, ::2] &= ~1          # phase bit on second slots only
        if missing_frac:
            m = rng.random((n, H)) < missing_frac
            codes[m] &= 1            # allele -> missing, phase bit kept
        for i in range(n):
            shared = encode_shared_from_vcf_cols(
                h, ["20", str(pos), f"rs{start+i}", "G", "A", ".", "PASS",
                    "."], n_fmt=1, n_sample=n_samples)
            w.write_raw(shared, prefix + codes[i].tobytes())
            pos += 37
    w.close()


def run(n_records: int = 20000, n_samples: int = 2504,
        workdir: str | None = None, device: str = "auto",
        zstd: bool = False, missing_frac: float = 0.0) -> dict:
    import tempfile

    from ..cli import main as cli_main
    from ..io.unified import GtInput

    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="xsi_e2e_")
    os.makedirs(workdir, exist_ok=True)
    inp = os.path.join(workdir, "in.bcf")
    xsi = os.path.join(workdir, "out.xsi")
    back = os.path.join(workdir, "roundtrip.bcf")

    saved_device = os.environ.get("XSI_DEVICE")
    try:
        t0 = time.perf_counter()
        synth_bcf(inp, n_records, n_samples, missing_frac=missing_frac)
        t_synth = time.perf_counter() - t0

        # device="native": host (numpy) compress + the native C++ extract
        # loop (the default route for an unfiltered `-x -O b` under auto).
        os.environ["XSI_DEVICE"] = "numpy" if device == "native" else device

        t0 = time.perf_counter()
        rc = cli_main(["-c", "-f", inp, "-o", xsi]
                      + (["--zstd"] if zstd else []))
        t_compress = time.perf_counter() - t0
        assert rc == 0

        if device == "native":
            os.environ["XSI_DEVICE"] = "auto"
        t0 = time.perf_counter()
        rc = cli_main(["-x", "-f", xsi, "-o", back, "-O", "b"])
        t_extract = time.perf_counter() - t0
        assert rc == 0

        # verify: sampled lockstep (full lockstep is the bench/lockstep tool)
        a, b = GtInput(inp), GtInput(back)
        step = max(n_records // 64, 1)
        for i, (ra, rb) in enumerate(zip(a, b)):
            if i % step == 0 and not np.array_equal(ra.gt, rb.gt):
                raise AssertionError(f"round-trip mismatch at record {i}")
        a.close()
        b.close()

        logical = n_records * n_samples * 2 * 4
        return {
            "records": n_records,
            "samples": n_samples,
            "missing_frac": missing_frac,
            "logical_mb": round(logical / 1e6, 1),
            "input_bcf_mb": round(os.path.getsize(inp) / 1e6, 2),
            "xsi_mb": round(os.path.getsize(xsi) / 1e6, 3),
            "synth_s": round(t_synth, 2),
            "compress_s": round(t_compress, 2),
            "extract_s": round(t_extract, 2),
            "compress_mb_s": round(logical / t_compress / 1e6, 1),
            "extract_mb_s": round(logical / t_extract / 1e6, 1),
            "workdir": workdir if not own else "(temp)",
        }
    finally:
        if saved_device is None:
            os.environ.pop("XSI_DEVICE", None)
        else:
            os.environ["XSI_DEVICE"] = saved_device
        if own:
            import shutil
            shutil.rmtree(workdir, ignore_errors=True)
