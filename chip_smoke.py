#!/usr/bin/env python
"""On-card smoke test of the XSI codec: the CLI and Accessor main path on
one GPU at population-reference width, every device block program
checked bit-exact against the host codec and the input.

    python chip_smoke.py             # one card, phases 1-5
    python chip_smoke.py --cards 4   # the four-card mesh + --distributed
                                     # phase only (one host, four cards)

Phases (one card):
  1. platform: a GPU backend, the card's name and power limit, no TPU
     Pallas module loaded, the native library built;
  2. panel: a seeded 2,504-sample BCF (three full 8,192-line blocks and a
     partial one), clean and with 1% missing calls: `-c` in auto mode
     (device block encode) against `XSI_DEVICE=numpy` (the host codec),
     `-x -O b` decoded on the device and compared record by record with
     the input, one `-r` region extract and an Accessor sample;
  3. one in-memory 8,192-line block at 5,008 and at 64,976 haplotypes:
     device payload == host encoder payload, both device decode forms
     bit-exact;
  4. the exception fixture (mixed ploidy, haploid, multiallelic, missing,
     unphased) through the device codec;
  5. the device dot product against the host compressed walk.

Each phase prints its cold and warm wall time (first and second run of
its device steps), the compiles it triggered and the device's peak
memory so far.  Any failure exits non-zero; the last line of a passing
run is {"ok": true, "device": {...}}.  It refuses to run without a GPU
and outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

N_SAMPLES = 2504            # 1000 Genomes phase 3 panel: 5,008 haplotypes
BLOCK = 8192                # default --variant-block-length
N_RECORDS = 3 * BLOCK + 1424
HRC_HAPS = 64976            # imputation-reference (HRC) width


class SmokeError(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- helpers
_compiles = [0]


def _count_compiles() -> None:
    import jax

    def on_duration(event: str, _secs: float, **_kw) -> None:
        if event == "/jax/core/compile/backend_compile_duration":
            _compiles[0] += 1

    jax.monitoring.register_event_duration_secs_listener(on_duration)


def _peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def report(name: str, cold: float, warm: float, compiles: int) -> None:
    log(f"phase={name} cold_s={cold:.3f} warm_s={warm:.3f} "
        f"compiles={compiles} peak_bytes_in_use={_peak_bytes()}")


@contextlib.contextmanager
def env(**kv):
    """Set (or with None, unset) environment variables for a block."""
    saved = {k: os.environ.get(k) for k in kv}
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cli(*argv: str) -> float:
    """Run the CLI in process; returns its wall time."""
    from xsqueezeit_tpu.cli import main as cli_main

    t0 = time.perf_counter()
    with env(XSI_DEBUG="1"):
        rc = cli_main(list(argv))
    check(rc == 0, f"cli {' '.join(argv)} exited {rc}")
    return time.perf_counter() - t0


def nvidia_smi(*args: str) -> str:
    try:
        r = subprocess.run(["nvidia-smi", *args], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise SmokeError(f"nvidia-smi: {exc}") from None
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def counts() -> dict:
    from xsqueezeit_tpu.codec import BLOCK_COUNTS

    return dict(BLOCK_COUNTS)


def delta(before: dict, key: str) -> int:
    return counts().get(key, 0) - before.get(key, 0)


def var_records(path: str) -> list[tuple[bytes, bytes]]:
    from xsqueezeit_tpu.io.bcf import BcfReader

    r = BcfReader(path)
    out = [(rec.shared, rec.indiv) for rec in r]
    r.close()
    return out


def input_gts(path: str, keep=None) -> dict[int, np.ndarray]:
    from xsqueezeit_tpu.io.unified import GtInput

    inp = GtInput(path)
    out = {i: rec.gt.copy() for i, rec in enumerate(inp)
           if keep is None or i in keep}
    inp.close()
    return out


# ----------------------------------------------------------------- phases
def phase_platform(n_cards: int):
    """Phase 1.  Returns the first device."""
    import jax

    check(jax.default_backend() == "gpu",
          f"JAX backend is {jax.default_backend()!r}, not a GPU")
    devs = jax.devices()
    check(len(devs) == n_cards,
          f"{len(devs)} devices visible, this run needs {n_cards}")
    for line in nvidia_smi("--query-gpu=name,power.limit",
                           "--format=csv,noheader").splitlines():
        log(line.strip())

    import importlib
    import pkgutil

    import xsqueezeit_tpu

    check(os.path.dirname(os.path.abspath(xsqueezeit_tpu.__file__))
          == os.path.join(HERE, "xsqueezeit_tpu"),
          "xsqueezeit_tpu is not the package beside this script")
    for mod in pkgutil.walk_packages(xsqueezeit_tpu.__path__,
                                     "xsqueezeit_tpu."):
        if not mod.name.endswith("__main__"):
            importlib.import_module(mod.name)
    check("jax.experimental.pallas.tpu" not in sys.modules,
          "a TPU Pallas module was imported")

    from xsqueezeit_tpu.codec.compressor import _host_encoder_cls
    from xsqueezeit_tpu.interop.native import (
        NativeBlockEncoder,
        NativeZstd,
        build_native,
    )

    lib = build_native()
    check(os.path.exists(lib), "native library did not build")
    check(_host_encoder_cls() is NativeBlockEncoder,
          "host block encoder is not the native one")
    try:
        NativeZstd()
        zstd = "native"
    except OSError as exc:
        zstd = f"off ({exc})"
    try:
        import zstandard  # noqa: F401
        zstd = "zstandard module"
    except ImportError:
        pass
    log(f"native: {os.path.relpath(lib, HERE)} built; block encoder, "
        f"batch BCF parse, variant pass and extract loop native; "
        f"--zstd layer: {zstd}")
    d = devs[0]
    log(f"device: platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    return d


def phase_panel(work: str, name: str, n_samples: int, n_records: int,
                block: int, missing_frac: float, seed: int) -> str:
    """Phase 2 for one file.  Returns the device-compressed .xsi path."""
    from xsqueezeit_tpu.bench.e2e import synth_bcf
    from xsqueezeit_tpu.bench.tools import lockstep_load

    bcf = os.path.join(work, f"{name}.bcf")
    synth_bcf(bcf, n_records, n_samples, seed=seed,
              missing_frac=missing_frac)
    n_blocks = -(-n_records // block)
    n_full = n_records // block
    bl = ["--variant-block-length", str(block)]
    c0 = _compiles[0]

    dev_xsi = os.path.join(work, f"{name}.dev.xsi")
    before = counts()
    cold = cli("-c", "-f", bcf, "-o", dev_xsi, *bl)
    enc_dev = delta(before, "encode_device")
    check(enc_dev >= n_full and enc_dev + delta(before, "encode_host")
          == n_blocks,
          f"{name}: {enc_dev} of {n_blocks} blocks encoded on the device")

    host_xsi = os.path.join(work, f"{name}.host.xsi")
    before = counts()
    with env(XSI_DEVICE="numpy"):
        cli("-c", "-f", bcf, "-o", host_xsi, *bl)
    check(delta(before, "encode_device") == 0,
          f"{name}: the host codec run used the device")
    with open(dev_xsi, "rb") as a, open(host_xsi, "rb") as b:
        check(a.read() == b.read(),
              f"{name}: device and host .xsi files differ")
    check(var_records(dev_xsi + "_var.bcf")
          == var_records(host_xsi + "_var.bcf"),
          f"{name}: device and host _var.bcf records differ")

    back = os.path.join(work, f"{name}.back.bcf")
    before = counts()
    t_x = cli("-x", "-f", dev_xsi, "-o", back, "-O", "b")
    cold += t_x
    check(delta(before, "decode_device") == n_blocks
          and delta(before, "decode_host") == 0,
          f"{name}: {delta(before, 'decode_device')} of {n_blocks} "
          f"blocks decoded on the device")
    lock = lockstep_load(bcf, back)
    check(lock["records"] == n_records,
          f"{name}: lockstep saw {lock['records']} records")

    # a region across the first block boundary (positions 60000 + 37 i)
    lo_i, hi_i = block - 300, block + 300
    region = f"20:{60000 + 37 * lo_i}-{60000 + 37 * hi_i}"
    reg = os.path.join(work, f"{name}.region.bcf")
    cli("-x", "-f", dev_xsi, "-o", reg, "-O", "b", "-r", region)
    want = input_gts(bcf, set(range(lo_i, hi_i + 1)))
    got = [g for _, g in input_gts(reg).items()]
    check(len(got) == len(want), f"{name}: region returned {len(got)} "
          f"records, want {len(want)}")
    for (i, w), g in zip(sorted(want.items()), got):
        check(np.array_equal(w, g), f"{name}: region record {i} differs")

    from xsqueezeit_tpu.accessor import Accessor
    from xsqueezeit_tpu.io.bcf import BcfReader

    sample = set(range(0, n_records, max(n_records // 40, 1)))
    want = input_gts(bcf, sample)
    acc = Accessor(dev_xsi)
    reader = BcfReader(acc.variant_filename())
    n_checked = 0
    for i, rec in enumerate(reader):
        if i in sample:
            check(np.array_equal(acc.get_genotypes(rec), want[i]),
                  f"{name}: Accessor record {i} differs")
            n_checked += 1
    reader.close()
    acc.close()
    check(n_checked == len(sample), f"{name}: Accessor sample incomplete")

    # warm: the device steps again, compiled
    warm = cli("-c", "-f", bcf, "-o", dev_xsi, *bl)
    warm += cli("-x", "-f", dev_xsi, "-o", back, "-O", "b")
    report(f"panel_{name}", cold, warm, _compiles[0] - c0)
    log(f"panel_{name}: {n_records} records x {2 * n_samples} haplotypes, "
        f"{n_blocks} blocks on the device both ways; .xsi "
        f"{os.path.getsize(dev_xsi)} bytes, device == host, "
        f"{lock['gt_entries']} GT entries lockstep-identical")
    return dev_xsi


def make_block(rng, n_lines: int, n_haps: int) -> np.ndarray:
    """Rare-heavy allele matrix (bench.py's chr20-like site-frequency mix):
    int8 [n_lines, n_haps]."""
    kind = rng.random(n_lines)
    freqs = np.where(
        kind < 0.53, rng.uniform(0.0, 0.0015, n_lines),
        np.where(kind < 0.78, rng.uniform(0.0015, 0.05, n_lines),
                 np.where(kind < 0.98, rng.uniform(0.05, 0.95, n_lines),
                          rng.uniform(0.999, 1.0, n_lines))))
    draw = rng.integers(0, 65536, (n_lines, n_haps), dtype=np.uint16)
    return (draw < (freqs * 65536.0).astype(np.uint16)[:, None]) \
        .astype(np.int8)


def phase_block(n_haps: int, n_lines: int, seed: int) -> None:
    """Phase 3 at one width: one in-memory block."""
    import jax
    import jax.numpy as jnp

    from xsqueezeit_tpu.codec.compressor import _host_encoder_cls
    from xsqueezeit_tpu.codec.decoder_jax import (
        DeviceBlockDecoder,
        _decode_block_full_gt,
        decode_block_records,
    )
    from xsqueezeit_tpu.codec.encoder_jax import DeviceBlockEncoder

    n_samples = n_haps // 2
    alleles = make_block(np.random.default_rng(seed), n_lines, n_haps)
    codes = ((alleles.astype(np.int32) + 1) << 1).reshape(-1)
    offs = np.arange(n_lines + 1, dtype=np.int64) * n_haps
    na = np.full(n_lines, 2, np.int32)
    kw = dict(n_samples=n_samples, block_bcf_lines=n_lines,
              mac_threshold=int(n_haps * 0.001), default_phasing=0,
              aet_dtype=np.uint16 if n_haps <= 0xFFFF else np.uint32)
    c0 = _compiles[0]

    def encode(cls):
        enc = cls(**kw)
        enc.encode_records(codes, offs, na, 0, n_lines)
        t0 = time.perf_counter()
        payload = enc.serialize()
        return payload, time.perf_counter() - t0

    payload, enc_cold = encode(DeviceBlockEncoder)
    _, enc_warm = encode(DeviceBlockEncoder)
    host, _ = encode(_host_encoder_cls())
    check(payload == host,
          f"H={n_haps}: device payload differs from the host encoder's")

    dec = DeviceBlockDecoder(payload, n_samples, n_haps, kw["aet_dtype"])
    check(dec.eligible, f"H={n_haps}: block not device-decodable")
    hi = dec.host_inputs()

    def fused():
        t0 = time.perf_counter()
        gt = _decode_block_full_gt(*(jnp.asarray(x) for x in hi[:7]),
                                   jnp.int32(0), hi[7], hi[8])
        gt = np.asarray(jax.block_until_ready(gt))[:n_lines]
        return gt, time.perf_counter() - t0

    def extract_form():
        t0 = time.perf_counter()
        d = DeviceBlockDecoder(payload, n_samples, n_haps, kw["aet_dtype"])
        gts = decode_block_records(payload, n_samples, n_haps,
                                   kw["aet_dtype"], list(na), predecoded=d)
        return np.stack(gts), time.perf_counter() - t0

    gt, dec_cold = fused()
    _, dec_warm = fused()
    check(np.array_equal((gt >> 1) - 1, alleles) and not (gt & 1).any(),
          f"H={n_haps}: fused device decode differs from the input")
    del gt
    gt2, x_cold = extract_form()
    _, x_warm = extract_form()
    check(np.array_equal(gt2, (alleles.astype(np.int32) + 1) << 1),
          f"H={n_haps}: extract-form device decode differs from the input")
    report(f"block{n_haps}", enc_cold + dec_cold + x_cold,
           enc_warm + dec_warm + x_warm, _compiles[0] - c0)
    log(f"block{n_haps}: {n_lines} lines, payload {len(payload)} bytes; "
        f"encode cold {enc_cold:.3f} s warm {enc_warm:.3f} s; fused "
        f"decode cold {dec_cold:.3f} s warm {dec_warm:.3f} s; extract "
        f"form (bits + host fold) cold {x_cold:.3f} s warm {x_warm:.3f} s")


def phase_exceptions(work: str) -> None:
    """Phase 4: mixed ploidy, haploid, multiallelic, missing, unphased."""
    from __graft_entry__ import _write_workload_vcf

    vcf = os.path.join(work, "exc.vcf")
    _write_workload_vcf(vcf, n_samples=200, n_records=192)
    xsi = os.path.join(work, "exc.xsi")
    out = os.path.join(work, "exc.out.vcf")
    c0 = _compiles[0]
    with env(XSI_DEVICE="jax"):
        before = counts()
        cold = cli("-c", "-f", vcf, "-o", xsi, "--variant-block-length",
                   "32")
        cold += cli("-x", "-f", xsi, "-o", out, "-O", "v")
        check(delta(before, "encode_device") == 6
              and delta(before, "decode_device") == 6,
              f"exceptions: blocks on the device: {counts()}")
        warm = cli("-c", "-f", vcf, "-o", xsi, "--variant-block-length",
                   "32")
        warm += cli("-x", "-f", xsi, "-o", out, "-O", "v")

    def gt_cols(p):
        return [ln.rstrip("\n").split("\t")[9:] for ln in open(p)
                if not ln.startswith("#")]

    check(gt_cols(vcf) == gt_cols(out),
          "exceptions: round-tripped genotypes differ from the input")
    report("exceptions", cold, warm, _compiles[0] - c0)


def phase_dot(xsi: str) -> None:
    """Phase 5: `bench dot_prod --device` against the host walk.  The
    device sums in float32 in another order than the host's float64."""
    from xsqueezeit_tpu.bench.__main__ import main as bench_main

    def run(*extra):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = bench_main(["dot_prod", xsi, *extra])
        check(rc == 0, f"bench dot_prod {extra} exited {rc}")
        return json.loads(buf.getvalue()), time.perf_counter() - t0

    c0 = _compiles[0]
    dev, cold = run("--device")
    _, warm = run("--device")
    host, _ = run()
    check(dev["variants"] == host["variants"],
          "dot_prod: variant counts differ")
    check(np.isclose(dev["checksum"], host["checksum"], rtol=1e-5, atol=0),
          f"dot_prod: device {dev['checksum']} vs host {host['checksum']}")
    report("dot_prod", cold, warm, _compiles[0] - c0)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def phase_cards(work: str, n_cards: int, n_samples: int, n_records: int,
                block: int) -> None:
    """The multi-card phase: the distributed compress (one process per
    card; this process holds no card while they run), then the in-process
    mesh compress and extract over all cards.  Both .xsi files must equal
    the single-card one byte for byte."""
    from xsqueezeit_tpu.bench.e2e import synth_bcf
    from xsqueezeit_tpu.interop.native import build_native

    n_gpus = sum(ln.startswith("GPU ") for ln in nvidia_smi("-L").splitlines())
    check(n_gpus >= n_cards, f"{n_gpus} GPUs on this host, need {n_cards}")
    bcf = os.path.join(work, "clean.bcf")
    synth_bcf(bcf, n_records, n_samples, seed=11)
    build_native()
    bl = ["--variant-block-length", str(block)]
    dist_xsi = os.path.join(work, "dist.xsi")
    coord = f"localhost:{_free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "xsqueezeit_tpu.cli", "-c", "-f", bcf,
         "-o", dist_xsi, *bl, "--distributed", coord, "--dist-nproc",
         str(n_cards), "--dist-procid", str(i), "--dist-devices", str(i)],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(n_cards)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        for i, o in enumerate(outs):
            print(f"--- worker {i} (rc {rcs[i]}) ---\n{o[-3000:]}",
                  file=sys.stderr)
    check(not any(rcs), f"distributed workers exited {rcs}")
    t_dist = time.perf_counter() - t0

    dev = phase_platform(n_cards)
    _count_compiles()
    c0 = _compiles[0]
    one_xsi = os.path.join(work, "one.xsi")
    with env(XSI_LOCAL_DEVICES="1"):
        t_one = cli("-c", "-f", bcf, "-o", one_xsi, *bl)
    mesh_xsi = os.path.join(work, "mesh.xsi")
    t_mesh = cli("-c", "-f", bcf, "-o", mesh_xsi, *bl)
    one = open(one_xsi, "rb").read()
    check(open(mesh_xsi, "rb").read() == one,
          f"{n_cards}-card mesh .xsi differs from the single-card one")
    check(open(dist_xsi, "rb").read() == one,
          f"{n_cards}-process --distributed .xsi differs from the "
          f"single-card one")

    from xsqueezeit_tpu.bench.tools import lockstep_load

    back = os.path.join(work, "mesh.back.bcf")
    before = counts()
    t_x = cli("-x", "-f", mesh_xsi, "-o", back, "-O", "b")
    n_blocks = -(-n_records // block)
    check(delta(before, "decode_device") == n_blocks,
          f"mesh extract: {delta(before, 'decode_device')} of {n_blocks} "
          f"blocks decoded on the device")
    lock = lockstep_load(bcf, back)
    check(lock["records"] == n_records, "mesh extract: record count")
    log(f"cards={n_cards}: distributed compress {t_dist:.3f} s "
        f"({n_cards} processes, one card each), single-card compress "
        f"{t_one:.3f} s, mesh compress {t_mesh:.3f} s, mesh extract "
        f"{t_x:.3f} s; .xsi byte-identical across all three "
        f"({len(one)} bytes); {lock['gt_entries']} GT entries "
        f"lockstep-identical after the mesh extract; compiles "
        f"{_compiles[0] - c0}; peak_bytes_in_use {_peak_bytes()}")
    return dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card mesh and --distributed "
                         "phase")
    args = ap.parse_args(argv)
    check(os.path.isdir(os.path.join(HERE, "xsqueezeit_tpu")),
          "xsqueezeit_tpu/ is not beside this script: run it from a "
          "checkout of the repository")
    os.chdir(HERE)
    t_start = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.cards > 1:
            dev = phase_cards(work, args.cards, N_SAMPLES, N_RECORDS, BLOCK)
        else:
            dev = phase_platform(1)
            _count_compiles()
            clean = phase_panel(work, "clean", N_SAMPLES, N_RECORDS, BLOCK,
                                0.0, seed=11)
            phase_panel(work, "missing", N_SAMPLES, N_RECORDS, BLOCK,
                        0.01, seed=12)
            phase_block(2 * N_SAMPLES, BLOCK, seed=20)
            phase_block(HRC_HAPS, BLOCK, seed=21)
            phase_exceptions(work)
            phase_dot(clean)
    finally:
        import shutil
        shutil.rmtree(work, ignore_errors=True)
    import jax

    log(f"total_s={time.perf_counter() - t_start:.3f}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
