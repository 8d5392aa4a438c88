"""Which engine does the block work, and what the device path needs:
device selection, the compile cache location, the --zstd layer without
the zstandard module, the device Accessor and dot product, and the
chip smoke script's refusal to run off a GPU."""
import os
import subprocess
import sys

import numpy as np
import pytest

from tests import fixtures
from tests.gt_synth import make_record
from xsqueezeit_tpu.codec import BLOCK_COUNTS
from xsqueezeit_tpu.codec.compressor import (
    CompressorOptions,
    compress_file,
    use_device_codec,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_subprocess(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("device selection started a subprocess")
    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(subprocess, "run", refuse)


@pytest.mark.parametrize("device, want", [("auto", "encode_host"),
                                          ("jax", "encode_device")])
def test_device_selection(device, want, tmp_path, monkeypatch):
    """auto on a CPU backend takes the host codec; XSI_DEVICE=jax takes
    the device on whatever backend JAX has; neither probes anything."""
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=30,
                              n_records=40, seed=3)
    from xsqueezeit_tpu.interop.native import build_native
    build_native()                   # before subprocesses are refused
    monkeypatch.setenv("XSI_DEVICE", device)
    _no_subprocess(monkeypatch)
    assert use_device_codec() == (device == "jax")
    before = dict(BLOCK_COUNTS)
    compress_file(vcf, str(tmp_path / "o.xsi"),
                  CompressorOptions(block_length=16))
    got = {k: BLOCK_COUNTS[k] - before.get(k, 0) for k in BLOCK_COUNTS}
    other = "encode_device" if want == "encode_host" else "encode_host"
    assert got.get(want) == 3 and not got.get(other)


@pytest.mark.parametrize("set_env", [True, False])
def test_compile_cache_location(set_env, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code;
    without it the cache is <checkout>/.jax_cache."""
    code = ("import jax; from xsqueezeit_tpu.utils import jaxcache; "
            "jaxcache.ensure_compilation_cache(); "
            "print(jaxcache.cache_dir()); "
            "print(jax.config.jax_compilation_cache_dir)")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if set_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    where, configured = out.stdout.split("\n")[:2]
    if set_env:
        assert where == configured == str(tmp_path / "cc")
    else:
        assert where == configured == os.path.join(REPO, ".jax_cache")


def test_package_imports_no_pallas():
    """No module of the package imports jax.experimental.pallas (the old
    kernels are gone; the plain XLA formulations run everywhere)."""
    code = ("import importlib, pkgutil, sys, xsqueezeit_tpu\n"
            "for m in pkgutil.walk_packages(xsqueezeit_tpu.__path__, "
            "'xsqueezeit_tpu.'):\n"
            "    if not m.name.endswith('__main__'):\n"
            "        importlib.import_module(m.name)\n"
            "print(sorted(k for k in sys.modules if 'pallas' in k))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
    for root, _, files in os.walk(os.path.join(REPO, "xsqueezeit_tpu")):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                assert "experimental.pallas" not in text, f


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(alone, tmp_path):
    """On a CPU backend, and as a lone copy outside the checkout, the
    smoke script fails without printing a result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        import shutil
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "chip_smoke: FAIL" in out.stderr


def test_dot_prod_device_within_float32_of_host(tmp_path):
    """The device dot product (HIGHEST-precision float32 matmul) holds
    the host float64 walk's checksum to rtol 1e-5."""
    from xsqueezeit_tpu.bench.tools import dot_prod, dot_prod_device

    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=301,
                              n_records=200, seed=8, p_multi=0.05)
    xsi = str(tmp_path / "d.xsi")
    compress_file(vcf, xsi, CompressorOptions(block_length=64))
    host, dev = dot_prod(xsi, seed=3), dot_prod_device(xsi, seed=3)
    assert dev["variants"] == host["variants"] > 0
    np.testing.assert_allclose(dev["checksum"], host["checksum"], rtol=1e-5)


def _hide_zstandard(monkeypatch):
    import builtins
    real = builtins.__import__

    def imp(name, *a, **k):
        if name == "zstandard":
            raise ImportError("no zstandard")
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", imp)


def test_zstd_layer_native_without_zstandard(tmp_path, monkeypatch):
    """Without the zstandard module the --zstd layer runs on the native
    library's libzstd: same container bytes, same round trip."""
    from xsqueezeit_tpu.cli import main as cli_main
    from xsqueezeit_tpu.interop.native import NativeZstd
    try:
        NativeZstd()
    except OSError as exc:
        pytest.fail(f"native library lacks zstd here: {exc}")
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=40,
                              n_records=120, seed=5)
    a, b = str(tmp_path / "a.xsi"), str(tmp_path / "b.xsi")
    assert cli_main(["-c", "-f", vcf, "-o", a, "--zstd",
                     "--variant-block-length", "32"]) == 0
    _hide_zstandard(monkeypatch)
    assert cli_main(["-c", "-f", vcf, "-o", b, "--zstd",
                     "--variant-block-length", "32"]) == 0
    assert open(a, "rb").read() == open(b, "rb").read()
    out = str(tmp_path / "o.vcf")
    assert cli_main(["-x", "-f", b, "-o", out]) == 0
    from tests.test_e2e import read_all
    assert read_all(out)[0] == read_all(vcf)[0]


def test_zstd_layer_unavailable_is_one_line_error(tmp_path, monkeypatch,
                                                  capsys):
    from xsqueezeit_tpu.cli import main as cli_main
    from xsqueezeit_tpu.interop import native

    vcf = fixtures.micro_basic(str(tmp_path / "m.vcf"))
    _hide_zstandard(monkeypatch)

    def no_zstd():
        raise OSError("the native library was built without zstd")
    monkeypatch.setattr(native, "NativeZstd", no_zstd)
    assert cli_main(["-c", "-f", vcf, "-o", str(tmp_path / "o.xsi"),
                     "--zstd"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "--zstd needs the zstandard module" in err[0]


def test_accessor_device_blocks_match_host(tmp_path, monkeypatch):
    """Accessor.get_genotypes through whole-block device decodes equals
    the host decoder, including zero-ALT and multiallelic records; blocks
    with exception tracks stay on the host decoder."""
    from xsqueezeit_tpu.accessor import Accessor
    from xsqueezeit_tpu.io.bcf import BcfReader

    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=45,
                              n_records=150, seed=9, p_multi=0.2)
    xsi = str(tmp_path / "a.xsi")
    compress_file(vcf, xsi, CompressorOptions(block_length=64))

    def read(device):
        monkeypatch.setenv("XSI_DEVICE", device)
        acc = Accessor(xsi)
        r = BcfReader(acc.variant_filename())
        out = [acc.get_genotypes(rec) for rec in r]
        r.close()
        return out

    before = BLOCK_COUNTS["decode_device"]
    dev = read("jax")
    assert BLOCK_COUNTS["decode_device"] - before == 3
    host = read("numpy")
    assert len(dev) == len(host) == 150
    for i, (a, b) in enumerate(zip(dev, host)):
        np.testing.assert_array_equal(a, b, err_msg=f"record {i}")


@pytest.mark.parametrize("aet, p_missing", [(np.uint16, 0.0),
                                            (np.uint32, 0.02)])
def test_device_serialize_equals_host_encoder(aet, p_missing):
    """The full DeviceBlockEncoder.serialize payload (compact cores,
    gathered WAH/sparse rows, fused exception tracks) equals the host
    encoder's bytes on the plain XLA path."""
    from xsqueezeit_tpu.codec.encoder_jax import DeviceBlockEncoder
    from xsqueezeit_tpu.codec.gt_block import GtBlockEncoder

    rng = np.random.default_rng(66)
    kw = dict(block_bcf_lines=100, mac_threshold=3, default_phasing=1,
              aet_dtype=aet)
    ref, dev = GtBlockEncoder(70, **kw), DeviceBlockEncoder(70, **kw)
    for i in range(60):
        gt, na = make_record(rng, 70, p_alt=[0.01, 0.3, 0.6, 0.99][i % 4],
                             p_missing=p_missing if i % 3 == 0 else 0.0)
        ref.encode_record(gt, na)
        dev.encode_record(gt, na)
    assert ref.serialize() == dev.serialize()
