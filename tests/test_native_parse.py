"""Native batch BCF parse (native/gt_batch.cpp) vs the Python reader.

The native walker is the read-side counterpart of the native extract loop:
it must deliver byte-identical shared blocks and identical decoded GT
arrays for every record class the Python reader handles (reference
analog: htslib bcf_read/bcf_get_genotypes, xcf.hpp traversal).
"""
import os
import subprocess

import numpy as np
import pytest

from tests.fixtures import vcf_to_bcf
from xsqueezeit_tpu.io.unified import GtInput

REF_BCF = "/root/reference/test/test_files/test_region_target.bcf"


def _read_all(path, native: bool):
    os.environ["XSI_NATIVE_PARSE"] = "1" if native else "0"
    try:
        inp = GtInput(path)
        out = [(r.shared, None if r.gt is None else r.gt.copy(),
                r.n_alleles, r.ploidy) for r in inp]
        inp.close()
        return out
    finally:
        os.environ.pop("XSI_NATIVE_PARSE", None)


def _assert_same(path):
    py = _read_all(path, native=False)
    nat = _read_all(path, native=True)
    assert len(py) == len(nat) and len(py) > 0
    for i, (a, b) in enumerate(zip(py, nat)):
        assert a[0] == b[0], f"shared differs at record {i}"
        np.testing.assert_array_equal(a[1], b[1],
                                      err_msg=f"gt differs at record {i}")
        assert a[2:] == b[2:], f"n_alleles/ploidy differ at record {i}"


def test_native_parse_synth_block(tmp_path):
    from xsqueezeit_tpu.bench.e2e import synth_bcf

    p = str(tmp_path / "s.bcf")
    synth_bcf(p, 700, 213)
    _assert_same(p)


@pytest.mark.skipif(not os.path.exists(REF_BCF),
                    reason="reference fixture absent")
def test_native_parse_htslib_produced_file():
    """An actual htslib-written BCF (reference test fixture)."""
    _assert_same(REF_BCF)


def test_native_parse_exception_classes(tmp_path):
    """Missing cells, mixed in-line ploidy (EOV), haploid records,
    unphased cells, multi-allelic records — plus enough ALT alleles to
    force int16-typed GT values (BCF typed widths 1 AND 2)."""
    vcf = tmp_path / "m.vcf"
    rng = np.random.default_rng(3)
    n = 7
    with open(vcf, "w") as f:
        f.write("##fileformat=VCFv4.2\n"
                '##FORMAT=<ID=GT,Number=1,Type=String,Description="G">\n'
                "##contig=<ID=20,length=100000>\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(f"S{i}" for i in range(n)) + "\n")
        rows = [
            ("A", ["0|1", ".|.", "1|1", "0", "0|0", "1", ".|1"]),     # EOV+miss
            ("A", ["0"] * n),                                          # haploid
            ("A,T,C", ["0|2", "3|1", "2/3", "0|0", "1|2", "3|3", "."]),
            ("A", ["0/1", "1/0", "0/0", "1/1", "0|1", "./1", "1|."]),  # unphased
        ]
        # 70 ALTs: allele index 69 -> gt code (70+1)<<1 = 142 > int8 range
        alts70 = ",".join("A" * (k + 1) for k in range(1, 71))
        cells = [f"{rng.integers(60, 71)}|{rng.integers(60, 71)}"
                 for _ in range(n)]
        rows.append((alts70, cells))
        pos = 500
        for alt, cc in rows:
            f.write(f"20\t{pos}\t.\tG\t{alt}\t.\t.\t.\tGT\t"
                    + "\t".join(cc) + "\n")
            pos += 10
    bcf = str(tmp_path / "m.bcf")
    vcf_to_bcf(str(vcf), bcf)
    _assert_same(bcf)


def test_native_parse_truncated_fails_cleanly(tmp_path):
    from xsqueezeit_tpu.bench.e2e import synth_bcf

    p = str(tmp_path / "t.bcf")
    synth_bcf(p, 60, 50)
    data = open(p, "rb").read()
    # chop inside the record stream: re-BGZF a truncated decompressed body
    from xsqueezeit_tpu.io.bgzf import BgzfReader, BgzfWriter
    body = BgzfReader(p).read()
    cut = str(tmp_path / "cut.bcf")
    w = BgzfWriter(cut)
    w.write(body[: len(body) - 37])
    w.close()
    assert len(data) > 0
    os.environ["XSI_NATIVE_PARSE"] = "1"
    try:
        inp = GtInput(cut)
        with pytest.raises((ValueError, OSError)):
            for _ in inp:
                pass
    finally:
        os.environ.pop("XSI_NATIVE_PARSE", None)


def test_compress_byte_identical_across_parsers(tmp_path):
    """The whole compress pipeline must produce identical containers from
    either parser (the .xsi, the variant file and its index)."""
    import hashlib

    from xsqueezeit_tpu.bench.e2e import synth_bcf
    from xsqueezeit_tpu.codec.compressor import (
        CompressorOptions,
        compress_file,
    )

    inp = str(tmp_path / "in.bcf")
    synth_bcf(inp, 600, 97)
    sums = {}
    for mode in ("0", "1"):
        os.environ["XSI_NATIVE_PARSE"] = mode
        try:
            sub = tmp_path / ("m" + mode)
            sub.mkdir()
            out = str(sub / "o.xsi")
            compress_file(inp, out, CompressorOptions(block_length=256,
                                                      device="numpy"))
            sums[mode] = tuple(
                hashlib.sha256(open(out + s, "rb").read()).hexdigest()
                for s in ("", "_var.bcf", "_var.bcf.csi"))
        finally:
            os.environ.pop("XSI_NATIVE_PARSE", None)
    assert sums["0"] == sums["1"]


def test_native_parse_after_skip_records(tmp_path):
    """skip_records + iteration must expose the same slice on both parsers
    (the multi-process workers position their slice this way)."""
    from xsqueezeit_tpu.bench.e2e import synth_bcf

    p = str(tmp_path / "s.bcf")
    synth_bcf(p, 120, 40)

    def slice_from(native, lo):
        os.environ["XSI_NATIVE_PARSE"] = "1" if native else "0"
        try:
            inp = GtInput(p)
            assert inp.skip_records(lo) == lo
            out = [(r.shared, r.gt.copy()) for r in inp]
            inp.close()
            return out
        finally:
            os.environ.pop("XSI_NATIVE_PARSE", None)

    for lo in (0, 1, 57, 119, 120):
        a, b = slice_from(False, lo), slice_from(True, lo)
        assert len(a) == len(b) == 120 - lo
        for i, (x, y) in enumerate(zip(a, b)):
            assert x[0] == y[0], (lo, i)
            np.testing.assert_array_equal(x[1], y[1])
