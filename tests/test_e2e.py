"""End-to-end compress -> decompress round-trip tests (the cukinia matrix)."""
import os

import numpy as np
import pytest

from xsqueezeit_tpu.cli import main as cli_main
from xsqueezeit_tpu.io.unified import GtInput
from tests import fixtures

def read_all(path):
    """Parse a VCF/BCF into a list of (fixed_cols_site_key, gt_list, ploidy)."""
    inp = GtInput(path)
    out = []
    for rec in inp:
        out.append((rec.n_alleles,
                    None if rec.gt is None else rec.gt.tolist(), rec.ploidy))
    inp.close()
    return out, inp.samples


def roundtrip_compare(vcf_path, tmp_path, extra_compress=(), extra_extract=(),
                      out_ext="vcf"):
    xsi = str(tmp_path / "out.xsi")
    out = str(tmp_path / f"roundtrip.{out_ext}")
    assert cli_main(["-c", "-f", vcf_path, "-o", xsi, *extra_compress]) == 0
    assert cli_main(["-x", "-f", xsi, "-o", out, *extra_extract]) == 0
    orig, samples_in = read_all(vcf_path)
    got, samples_out = read_all(out)
    assert samples_in == samples_out
    assert len(orig) == len(got)
    for i, (o, g) in enumerate(zip(orig, got)):
        assert o == g, f"record {i} differs:\n  orig {o}\n  got  {g}"
    return xsi, out


@pytest.mark.parametrize("name", sorted(fixtures.ALL_MICRO))
def test_micro_roundtrip_vcf(name, tmp_path):
    vcf = fixtures.ALL_MICRO[name](str(tmp_path / f"{name}.vcf"))
    roundtrip_compare(vcf, tmp_path)


@pytest.mark.parametrize("name", ["micro_basic", "micro_missing", "micro_eov"])
def test_micro_roundtrip_bcf_output(name, tmp_path):
    vcf = fixtures.ALL_MICRO[name](str(tmp_path / f"{name}.vcf"))
    roundtrip_compare(vcf, tmp_path, out_ext="bcf", extra_extract=["-O", "b"])


def test_micro_roundtrip_wah_missing(tmp_path):
    vcf = fixtures.micro_missing(str(tmp_path / "m.vcf"))
    roundtrip_compare(vcf, tmp_path, extra_compress=["--wah-encode-missing"])


def test_random_roundtrip(tmp_path):
    vcf = fixtures.random_vcf(str(tmp_path / "rand.vcf"), n_samples=127,
                              n_records=300, seed=1)
    roundtrip_compare(vcf, tmp_path, extra_compress=["--maf", "0.002"])


def test_random_roundtrip_zstd_multiblock(tmp_path):
    vcf = fixtures.random_vcf(str(tmp_path / "rand.vcf"), n_samples=63,
                              n_records=500, seed=2)
    xsi, _ = roundtrip_compare(
        vcf, tmp_path,
        extra_compress=["--zstd", "--variant-block-length", "128"])
    from xsqueezeit_tpu.format.container import XsiReader
    r = XsiReader(xsi)
    assert r.n_blocks() == (500 + 127) // 128
    assert r.header.zstd


def test_bcf_input_roundtrip(tmp_path):
    """BCF input (multiallelic, rare and common sites) -> xsi -> bcf
    preserves genotypes."""
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=57,
                              n_records=260, seed=12, p_multi=0.15)
    bcf = fixtures.vcf_to_bcf(vcf, str(tmp_path / "in.bcf"))
    xsi = str(tmp_path / "ref.xsi")
    out = str(tmp_path / "ref_out.bcf")
    assert cli_main(["-c", "-f", bcf, "-o", xsi,
                     "--variant-block-length", "100"]) == 0
    assert cli_main(["-x", "-f", xsi, "-o", out, "-O", "b"]) == 0
    orig, s_in = read_all(bcf)
    got, s_out = read_all(out)
    assert s_in == s_out
    assert orig == got


def test_region_query(tmp_path):
    vcf = fixtures.random_vcf(str(tmp_path / "rand.vcf"), n_samples=20,
                              n_records=100, seed=3)
    xsi = str(tmp_path / "o.xsi")
    out = str(tmp_path / "region.vcf")
    cli_main(["-c", "-f", vcf, "-o", xsi])
    # positions are 60000 + i*37; select a middle slice
    cli_main(["-x", "-f", xsi, "-o", out, "-r", "20:60500-61000"])
    got, _ = read_all(out)
    orig, _ = read_all(vcf)
    lo = [i for i in range(100) if 60500 <= 60000 + i * 37 <= 61000]
    assert len(got) == len(lo)
    assert got == [orig[i] for i in lo]


def test_sample_subset(tmp_path):
    vcf = fixtures.random_vcf(str(tmp_path / "rand.vcf"), n_samples=20,
                              n_records=50, seed=4)
    xsi = str(tmp_path / "o.xsi")
    out = str(tmp_path / "subset.vcf")
    cli_main(["-c", "-f", vcf, "-o", xsi])
    cli_main(["-x", "-f", xsi, "-o", out, "-s", "S005,S002,S019"])
    got, samples = read_all(out)
    assert samples == ["S005", "S002", "S019"]
    orig, _ = read_all(vcf)
    for (na_o, gt_o, pl), (na_g, gt_g, _) in zip(orig, got):
        assert na_o == na_g
        gt_o = np.array(gt_o).reshape(20, pl)
        want = gt_o[[5, 2, 19]].reshape(-1).tolist()
        assert gt_g == want


def test_sample_subset_exclude(tmp_path):
    vcf = fixtures.random_vcf(str(tmp_path / "rand.vcf"), n_samples=10,
                              n_records=20, seed=5)
    xsi = str(tmp_path / "o.xsi")
    out = str(tmp_path / "subset.vcf")
    cli_main(["-c", "-f", vcf, "-o", xsi])
    cli_main(["-x", "-f", xsi, "-o", out, "-s", "^S000,S003"])
    _, samples = read_all(out)
    assert samples == [f"S{i:03d}" for i in range(10) if i not in (0, 3)]


def test_recompress_to_xsi(tmp_path):
    vcf = fixtures.random_vcf(str(tmp_path / "rand.vcf"), n_samples=16,
                              n_records=60, seed=6)
    xsi = str(tmp_path / "o.xsi")
    xsi2 = str(tmp_path / "o2.xsi")
    out = str(tmp_path / "final.vcf")
    cli_main(["-c", "-f", vcf, "-o", xsi])
    cli_main(["-x", "-f", xsi, "-o", xsi2, "-O", "x"])
    cli_main(["-x", "-f", xsi2, "-o", out])
    got, _ = read_all(out)
    orig, _ = read_all(vcf)
    assert got == orig


def test_info_flag(tmp_path, capsys):
    vcf = fixtures.micro_basic(str(tmp_path / "b.vcf"))
    xsi = str(tmp_path / "o.xsi")
    cli_main(["-c", "-f", vcf, "-o", xsi])
    assert cli_main(["-i", "-f", xsi]) == 0
    err = capsys.readouterr().err
    assert "Haplotype samples  : 20" in err
    assert "VCF records : 5" in err


def test_targets_query(tmp_path):
    """-t filters by exact position, streamed (reference: -t targets)."""
    vcf = fixtures.random_vcf(str(tmp_path / "rand.vcf"), n_samples=12,
                              n_records=60, seed=6)
    xsi = str(tmp_path / "o.xsi")
    out = str(tmp_path / "tgt.vcf")
    cli_main(["-c", "-f", vcf, "-o", xsi])
    # positions are 60000 + i*37
    picks = [60000 + i * 37 for i in (3, 17, 42)]
    cli_main(["-x", "-f", xsi, "-o", out,
              "-t", ",".join(f"20:{p}" for p in picks)])
    got, _ = read_all(out)
    orig, _ = read_all(vcf)
    assert got == [orig[i] for i in (3, 17, 42)]


def test_region_plus_samples(tmp_path):
    vcf = fixtures.random_vcf(str(tmp_path / "rand.vcf"), n_samples=15,
                              n_records=80, seed=7)
    xsi = str(tmp_path / "o.xsi")
    out = str(tmp_path / "combo.vcf")
    cli_main(["-c", "-f", vcf, "-o", xsi])
    cli_main(["-x", "-f", xsi, "-o", out, "-r", "20:60400-61200",
              "-s", "S010,S001"])
    got, samples = read_all(out)
    assert samples == ["S010", "S001"]
    orig, _ = read_all(vcf)
    keep = [i for i in range(80) if 60400 <= 60000 + i * 37 <= 61200]
    assert len(got) == len(keep)
    for (na_g, gt_g, _), i in zip(got, keep):
        na_o, gt_o, pl = orig[i]
        assert na_g == na_o
        want = np.array(gt_o).reshape(15, pl)[[10, 1]].reshape(-1).tolist()
        assert gt_g == want


def test_no_header_flag(tmp_path):
    vcf = fixtures.micro_basic(str(tmp_path / "b.vcf"))
    xsi = str(tmp_path / "o.xsi")
    out = str(tmp_path / "nohdr.vcf")
    cli_main(["-c", "-f", vcf, "-o", xsi])
    cli_main(["-x", "-f", xsi, "-o", out, "-H"])
    lines = open(out).read().splitlines()
    assert lines and not any(l.startswith("#") for l in lines)
    # body matches the headered output
    full = str(tmp_path / "full.vcf")
    cli_main(["-x", "-f", xsi, "-o", full])
    body = [l for l in open(full).read().splitlines() if not l.startswith("#")]
    assert lines == body


def test_samples_file(tmp_path):
    vcf = fixtures.random_vcf(str(tmp_path / "rand.vcf"), n_samples=8,
                              n_records=15, seed=8)
    xsi = str(tmp_path / "o.xsi")
    cli_main(["-c", "-f", vcf, "-o", xsi])
    sfile = tmp_path / "samples.txt"
    sfile.write_text("S006\nS004\n")
    out = str(tmp_path / "sf.vcf")
    cli_main(["-x", "-f", xsi, "-o", out, "-S", str(sfile)])
    _, samples = read_all(out)
    assert samples == ["S006", "S004"]


def test_regions_file(tmp_path):
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=9,
                              n_records=60, seed=61)
    xsi = str(tmp_path / "o.xsi")
    cli_main(["-c", "-f", vcf, "-o", xsi])
    rf = tmp_path / "regions.txt"
    rf.write_text("20\t60100\t60500\n20\t60900\t61100\n")
    out_f = str(tmp_path / "rf.vcf")
    out_r = str(tmp_path / "rr.vcf")
    cli_main(["-x", "-f", xsi, "-o", out_f, "-R", str(rf)])
    cli_main(["-x", "-f", xsi, "-o", out_r,
              "-r", "20:60100-60500,20:60900-61100"])
    assert open(out_f).read() == open(out_r).read()
    assert sum(1 for l in open(out_f) if not l.startswith("#")) > 0


def test_mixed_ploidy_at_scale(tmp_path):
    """Haploid lines interspersed through multiple blocks (the NumPy
    fallback path for non-uniform blocks)."""
    import numpy as np
    rng = np.random.default_rng(71)
    n_samples, n_records = 13, 120
    p = tmp_path / "mixed.vcf"
    with open(p, "w") as f:
        f.write("##fileformat=VCFv4.2\n"
                '##FORMAT=<ID=GT,Number=1,Type=String,Description="G">\n'
                "##contig=<ID=20>\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(f"S{i}" for i in range(n_samples)) + "\n")
        for r in range(n_records):
            hap = rng.random() < 0.3
            cells = []
            for s in range(n_samples):
                if hap:
                    cells.append(str(rng.integers(0, 2)))
                else:
                    cells.append(f"{rng.integers(0, 2)}|{rng.integers(0, 2)}")
            f.write(f"20\t{60000 + r * 13}\trs{r}\tG\tA\t.\tPASS\t.\tGT\t"
                    + "\t".join(cells) + "\n")
    xsi = str(tmp_path / "m.xsi")
    out = str(tmp_path / "m.out.vcf")
    assert cli_main(["-c", "-f", str(p), "-o", xsi,
                     "--variant-block-length", "32"]) == 0
    assert cli_main(["-x", "-f", xsi, "-o", out]) == 0
    orig, _ = read_all(str(p))
    got, _ = read_all(out)
    assert got == orig


def test_recompress_with_sample_subset(tmp_path):
    """-O x combined with -s: subset-recompress-extract must equal the
    direct subset extraction (reference BM-rewrite semantics,
    gt_decompressor_new.hpp:432-543)."""
    vcf = fixtures.random_vcf(str(tmp_path / "rand.vcf"), n_samples=16,
                              n_records=60, seed=9)
    xsi = str(tmp_path / "o.xsi")
    xsi2 = str(tmp_path / "sub.xsi")
    out_via_xsi = str(tmp_path / "via_xsi.vcf")
    out_direct = str(tmp_path / "direct.vcf")
    keep = "S002,S005,S010,S011"
    cli_main(["-c", "-f", vcf, "-o", xsi])
    cli_main(["-x", "-f", xsi, "-o", xsi2, "-O", "x", "-s", keep])
    cli_main(["-x", "-f", xsi2, "-o", out_via_xsi])
    cli_main(["-x", "-f", xsi, "-o", out_direct, "-s", keep])
    got, samples = read_all(out_via_xsi)
    want, samples_direct = read_all(out_direct)
    assert samples == samples_direct == keep.split(",")
    assert got == want


def test_recompress_with_region(tmp_path):
    """-O x combined with -r: the re-compressed XSI holds only the region
    and extracts identically to a direct region query."""
    vcf = fixtures.random_vcf(str(tmp_path / "rand.vcf"), n_samples=12,
                              n_records=80, seed=10)
    xsi = str(tmp_path / "o.xsi")
    xsi2 = str(tmp_path / "rgn.xsi")
    out_via_xsi = str(tmp_path / "via_xsi.vcf")
    out_direct = str(tmp_path / "direct.vcf")
    region = "20:60300-61500"
    cli_main(["-c", "-f", vcf, "-o", xsi])
    cli_main(["-x", "-f", xsi, "-o", xsi2, "-O", "x", "-r", region])
    cli_main(["-x", "-f", xsi2, "-o", out_via_xsi])
    cli_main(["-x", "-f", xsi, "-o", out_direct, "-r", region])
    got, _ = read_all(out_via_xsi)
    want, _ = read_all(out_direct)
    assert len(want) > 0
    assert got == want


def test_recompress_with_region_and_samples(tmp_path):
    vcf = fixtures.random_vcf(str(tmp_path / "rand.vcf"), n_samples=10,
                              n_records=70, seed=11)
    xsi = str(tmp_path / "o.xsi")
    xsi2 = str(tmp_path / "rs.xsi")
    out_via_xsi = str(tmp_path / "via_xsi.vcf")
    out_direct = str(tmp_path / "direct.vcf")
    cli_main(["-c", "-f", vcf, "-o", xsi])
    cli_main(["-x", "-f", xsi, "-o", xsi2, "-O", "x",
              "-r", "20:60200-61800", "-s", "^S001"])
    cli_main(["-x", "-f", xsi2, "-o", out_via_xsi])
    cli_main(["-x", "-f", xsi, "-o", out_direct,
              "-r", "20:60200-61800", "-s", "^S001"])
    got, samples = read_all(out_via_xsi)
    want, samples_direct = read_all(out_direct)
    assert samples == samples_direct
    assert len(want) > 0
    assert got == want


def test_count_xcf(tmp_path, capsys):
    vcf = fixtures.random_vcf(str(tmp_path / "c.vcf"), n_samples=8,
                              n_records=37, seed=13)
    assert cli_main(["--count-xcf", "-f", vcf]) == 0
    assert "Number of entries is : 37" in capsys.readouterr().err
    xsi = str(tmp_path / "c.xsi")
    cli_main(["-c", "-f", vcf, "-o", xsi])
    assert cli_main(["--count-xcf", "-f", xsi + "_var.bcf"]) == 0
    assert "Number of entries is : 37" in capsys.readouterr().err


def test_pipe_closed_downstream_exits_quietly(tmp_path):
    """`-x -O u -o - | head`-style early pipe close (the roh pipe
    workflow) must exit with 141 and print nothing — htslib-tool
    behavior, no traceback."""
    import subprocess
    import sys

    from xsqueezeit_tpu.bench.e2e import synth_bcf
    from xsqueezeit_tpu.codec.compressor import (
        CompressorOptions,
        compress_file,
    )

    inp = str(tmp_path / "in.bcf")
    synth_bcf(inp, 400, 40)
    xsi = str(tmp_path / "o.xsi")
    compress_file(inp, xsi, CompressorOptions(device="numpy"))

    p = subprocess.Popen(
        [sys.executable, "-m", "xsqueezeit_tpu.cli", "-x", "-f", xsi,
         "-O", "u", "-o", "-"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, XSI_DEVICE="numpy"), cwd="/root/repo")
    p.stdout.read(64)
    p.stdout.close()
    _, err = p.communicate(timeout=120)
    assert p.returncode == 141, (p.returncode, err.decode()[-2000:])
    assert not err.strip(), err.decode()[-2000:]


def test_fused_recompress_byte_identity(tmp_path, monkeypatch):
    """The fused -O x path (re-encode inside the decode loop, no
    intermediate BCF) must produce bytes identical to the legacy
    decode->BCF->compress detour, across zstd/subset/region/missing."""
    from xsqueezeit_tpu.utils import mutate

    base = fixtures.random_vcf(str(tmp_path / "rand.vcf"), n_samples=16,
                               n_records=150, seed=42, p_multi=0.15)
    sprinkled = str(tmp_path / "miss.vcf")
    mutate.sprinkle_missing(base, sprinkled, rate=0.05, seed=3)

    cases = [
        (base, []),
        (base, ["--zstd"]),
        (base, ["-s", "S001,S004,S007"]),
        (base, ["-r", "20:60500-63000"]),
        (sprinkled, []),
    ]
    for i, (vcf, extra) in enumerate(cases):
        xsi = str(tmp_path / f"src{i}.xsi")
        cargs = ["-c", "-f", vcf, "-o", xsi, "--variant-block-length", "32"]
        if "--zstd" in extra:
            cargs.append("--zstd")
        assert cli_main(cargs) == 0
        # same basename in two dirs: the var header embeds ##XSI=<basename>
        (tmp_path / f"fused{i}").mkdir()
        (tmp_path / f"detour{i}").mkdir()
        fused = str(tmp_path / f"fused{i}" / "out.xsi")
        detour = str(tmp_path / f"detour{i}" / "out.xsi")
        xargs = ["-x", "-f", xsi, "-O", "x"] + [a for a in extra
                                                if a != "--zstd"]
        monkeypatch.setenv("XSI_FUSED_RECOMPRESS", "1")
        assert cli_main(xargs + ["-o", fused]) == 0
        monkeypatch.setenv("XSI_FUSED_RECOMPRESS", "0")
        assert cli_main(xargs + ["-o", detour]) == 0
        monkeypatch.delenv("XSI_FUSED_RECOMPRESS")
        for ext in ("", "_var.bcf"):
            a = open(fused + ext, "rb").read()
            b = open(detour + ext, "rb").read()
            assert a == b, f"case {i} {extra} {ext or 'container'} differs"
