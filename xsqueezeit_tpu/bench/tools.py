"""Benchmark & validation tools — counterparts of the reference's L8 apps.

  loading_time    load every record's genotype array (BCF or XSI path)
  dot_prod        GWAS-style dot product; XSI path operates directly on the
                  compressed WAH/sparse forms ("compressive acceleration")
  af_stats        recompute AC/AN for every record from allele counts only
  lockstep_load   walk two files (any mix of BCF/XSI) and assert identical
                  genotypes record by record -- the scalable bit-exactness
                  checker (reference: lockstep_loader/gt_lockstep_loader.hpp)
"""
from __future__ import annotations

import sys
import time

import numpy as np

from ..accessor import Accessor
from ..io.bcf import BcfReader
from ..io.unified import GtInput
from ..ops import wah_np


def _is_xsi(path: str) -> bool:
    if path.endswith(".xsi"):
        return True
    try:
        with open(path, "rb") as f:
            head = f.read(8)
            return len(head) == 8 and head[4:8] == bytes.fromhex("6717edfe")
    except OSError:
        return False


def iter_genotypes(path: str):
    """Yields (n_alleles, gt int32 array) for a BCF/VCF or XSI file."""
    if _is_xsi(path):
        acc = Accessor(path)
        reader = BcfReader(acc.variant_filename())
        for rec in reader:
            yield rec.n_allele, acc.get_genotypes(rec)
        reader.close()
    else:
        inp = GtInput(path)
        for rec in inp:
            yield rec.n_alleles, rec.gt
        inp.close()


def loading_time(path: str, native: bool = False) -> dict:
    """Load every record's gt array; returns timing stats.

    `native=True` reads an XSI file through the C++ accessor library
    (the zero-JAX integration path, reference: loading_time/ NewLoader)."""
    t0 = time.perf_counter()
    n_records = 0
    n_gt = 0
    if native:
        from ..interop.native import NativeAccessor
        acc = NativeAccessor(path)
        for n_alleles, gt in acc:
            n_records += 1
            n_gt += gt.shape[0]
        acc.close()
    else:
        for n_alleles, gt in iter_genotypes(path):
            n_records += 1
            if gt is not None:
                n_gt += gt.shape[0]
    elapsed = time.perf_counter() - t0
    return {"records": n_records, "gt_entries": n_gt, "seconds": elapsed,
            "gt_per_second": n_gt / elapsed if elapsed else 0.0}


def dot_prod(path: str, seed: int = 42) -> dict:
    """Dot product of each bi-allelic variant's dosage with a random
    phenotype vector.  On XSI input the sums run over the compressed forms:
    sparse lines sum y at the stored indices; WAH lines walk words, skipping
    zero fills and bulk-adding one fills through the arrangement."""
    t0 = time.perf_counter()
    checksum = 0.0
    n = 0
    if _is_xsi(path):
        acc = Accessor(path)
        n_samples = len(acc.get_sample_list())
        rng = np.random.default_rng(seed)
        y = rng.random(n_samples)
        reader = BcfReader(acc.variant_filename())
        for rec in reader:
            if rec.n_allele != 2:
                continue
            bm = acc.position_from_bm_entry(rec)
            ia = acc.get_internal_access(bm, rec.n_allele)
            if ia.sparse[0]:
                stream = ia.pointers[0]
                msb = 1 << (stream.dtype.itemsize * 8 - 1)
                head = int(stream[0])
                cnt = head & (msb - 1)
                if head & msb:
                    # negated sparse: full decode fallback (ref parity:
                    # dot_prod/main.cpp treats negated lines the same way)
                    gt = acc.fill_genotype_array(bm, rec.n_allele)
                    alleles = (gt >> 1) - 1
                    carriers = np.flatnonzero(alleles == 1)
                    checksum += y[carriers >> 1].sum()
                else:
                    idx = stream[1:1 + cnt].astype(np.int64)
                    checksum += y[idx >> 1].sum()
            else:
                words = ia.pointers[0]
                bits, _ = wah_np.wah_decode(words, acc.n_haps)
                carriers = ia.a[np.flatnonzero(bits[:acc.n_haps])]
                checksum += y[carriers >> 1].sum()
            n += 1
        reader.close()
    else:
        inp = GtInput(path)
        n_samples = len(inp.samples)
        rng = np.random.default_rng(seed)
        y = rng.random(n_samples)
        for rec in inp:
            if rec.n_alleles != 2 or rec.gt is None:
                continue
            alleles = (rec.gt >> 1) - 1
            carriers = np.flatnonzero(alleles == 1)
            checksum += y[carriers // rec.ploidy].sum()
            n += 1
        inp.close()
    return {"variants": n, "checksum": round(float(checksum), 6),
            "seconds": time.perf_counter() - t0}


def dot_prod_device(path: str, seed: int = 42) -> dict:
    """GWAS dot product on the device: whole blocks decode on device and
    the per-variant dosage dot products run as ONE [lines, haps] x [haps]
    matmul per block -- the batched formulation of the reference's
    compressive dot product (dot_prod/dot_prod.hpp walks WAH words on the
    CPU).  Checksum-compatible with dot_prod() to float32 rounding: the
    matmul runs at HIGHEST precision (a GPU would otherwise take TF32,
    about three decimal digits) and sums in float32, in another order
    than the host's float64 walk."""
    import time as _time

    import jax
    import jax.numpy as jnp

    from ..codec.decoder_jax import DeviceBlockDecoder
    from ..io.bcf import BcfReader as _BcfReader

    t0 = _time.perf_counter()
    acc = Accessor(path)
    n_samples = len(acc.get_sample_list())
    rng = np.random.default_rng(seed)
    y = rng.random(n_samples)
    y2 = jnp.asarray(np.repeat(y, 2).astype(np.float32))  # y[h // 2]

    # group records by block
    reader = _BcfReader(acc.variant_filename())
    blocks: dict[int, list[int]] = {}
    order: list[int] = []
    for rec in reader:
        bm = acc.position_from_bm_entry(rec)
        blk = bm >> 15
        if blk not in blocks:
            blocks[blk] = []
            order.append(blk)
        blocks[blk].append(rec.n_allele)
    reader.close()

    checksum = 0.0
    n = 0
    dot = jax.jit(lambda v, y2: jnp.matmul(
        v.astype(jnp.float32), y2, precision=jax.lax.Precision.HIGHEST))
    for blk in order:
        n_alleles = blocks[blk]
        payload = acc.xsi.gt_block_payload(blk)
        dev = DeviceBlockDecoder(payload, acc.n_samples, acc.n_haps,
                                 acc.xsi.aet_dtype)
        if not dev.eligible:
            # haploid/weird blocks: host per-record fallback
            first = 0
            m = dev.meta
            for na in n_alleles:
                if na == 2:
                    m.seek(first)
                    gt = m.fill_genotype_array_advance(na)
                    carriers = np.flatnonzero(((gt >> 1) - 1) == 1)
                    checksum += float(y[carriers >> 1].sum())
                    n += 1
                first += max(na - 1, 0)
            continue
        vals = dev.decode_all()
        # binary line l belongs to record r with first_line(r) <= l; keep
        # only bi-allelic records (one line each)
        first = 0
        keep = []
        for na in n_alleles:
            if na == 2:
                keep.append(first)
                n += 1
            first += max(na - 1, 0)
        if not keep:
            continue
        dots = np.asarray(dot(jnp.asarray(vals[keep]), y2))
        checksum += float(dots.sum())
    return {"variants": n, "checksum": round(float(checksum), 6),
            "seconds": _time.perf_counter() - t0}


def af_stats(path: str, annotate_out: str | None = None) -> dict:
    """Recompute AC/AN per record using allele counts only (no gt arrays).

    With `annotate_out`, also writes the variant BCF with AC/AN patched
    into INFO (reference: af_stats/ Annotator writes an annotated variant
    file)."""
    t0 = time.perf_counter()
    out = []
    n_haps = 0
    if _is_xsi(path):
        from ..io.bcf import BcfHeader, BcfRecord, BcfWriter
        from ..io.sites import encode_shared_from_vcf_cols, render_vcf_cols

        acc = Accessor(path)
        n_haps = acc.n_haps
        nat = acc._native()
        if nat is not False and not annotate_out:
            # fully native walk: ONE crossing scans every (BM, n_allele)
            # off the variant file, ONE crossing counts every record off
            # the compressed streams — no Python record objects at all.
            # Any native error demotes to the guarded Python-reader path
            # below (same contract as Accessor.fill_allele_counts_range).
            try:
                bms, nas = nat.scan_records()
                flat = nat.count_alleles_range(bms, nas)
            except Exception as exc:
                print(f"xsi: native af_stats walk failed ({exc}) — "
                      "falling back to the record reader", file=sys.stderr)
                acc._nat_acc = False
            else:
                offs = np.zeros(len(nas) + 1, np.int64)
                np.cumsum(nas, out=offs[1:])
                for i in range(len(nas)):
                    counts = flat[offs[i]:offs[i + 1]]
                    out.append((int(counts.sum()),
                                [int(c) for c in counts[1:]]))
                acc.close()
                seconds = time.perf_counter() - t0
                logical = len(out) * n_haps * 4
                return {"records": len(out), "stats": out,
                        "seconds": seconds,
                        "records_per_s": (round(len(out) / seconds, 1)
                                          if seconds else 0),
                        "logical_gb_s": (round(logical / seconds / 1e9, 3)
                                         if seconds and logical else None)}
        reader = BcfReader(acc.variant_filename())
        writer = None
        hdr = reader.header
        if annotate_out:
            hdr.ensure_string(
                "AC", '##INFO=<ID=AC,Number=A,Type=Integer,Description='
                      '"Allele count in genotypes">')
            hdr.ensure_string(
                "AN", '##INFO=<ID=AN,Number=1,Type=Integer,Description='
                      '"Total number of alleles in called genotypes">')
            writer = BcfWriter(annotate_out, hdr)
        # one batched native crossing for the whole file's counts
        # (count-only walk: sparse heads + WAH run-word popcounts)
        recs = list(reader)
        nas = np.fromiter((r.n_allele for r in recs), np.int32, len(recs))
        bms = np.fromiter((acc.position_from_bm_entry(r) for r in recs),
                          np.int32, len(recs))
        flat = acc.fill_allele_counts_range(bms, nas)
        offs = np.zeros(len(recs) + 1, np.int64)
        np.cumsum(nas, out=offs[1:])
        for i, rec in enumerate(recs):
            counts = flat[offs[i]:offs[i + 1]]
            an = int(counts.sum())
            acs = [int(c) for c in counts[1:]]
            out.append((an, acs))
            if writer is not None:
                cols = render_vcf_cols(hdr, rec)
                info = [kv for kv in cols[7].split(";")
                        if kv and not kv.startswith(("AC=", "AN="))
                        and kv != "."]
                info.append("AC=" + ",".join(str(c) for c in acs))
                info.append(f"AN={an}")
                cols[7] = ";".join(info)
                shared = encode_shared_from_vcf_cols(
                    hdr, cols, rec.n_fmt, rec.n_sample)
                writer.write_raw(shared, rec.indiv)
        if writer is not None:
            writer.close()
        reader.close()
        acc.close()
    else:
        for n_alleles, gt in iter_genotypes(path):
            alleles = (gt >> 1) - 1
            valid = (alleles >= 0) & (gt != np.int32(-0x7FFFFFFF))
            counts = np.bincount(alleles[valid], minlength=n_alleles)
            out.append((int(valid.sum()), [int(c) for c in counts[1:n_alleles]]))
    seconds = time.perf_counter() - t0
    # throughput over the logical htslib gt bytes the counts stand in for
    # (the reference's "compressive genomics" pitch: AC/AN without gt
    # materialization, af_stats/main.cpp)
    logical = len(out) * n_haps * 4
    return {"records": len(out), "stats": out, "seconds": seconds,
            "records_per_s": round(len(out) / seconds, 1) if seconds else 0,
            "logical_gb_s": (round(logical / seconds / 1e9, 3)
                             if seconds and logical else None)}


def lockstep_load(path_a: str, path_b: str) -> dict:
    """Walk two files in lockstep asserting identical genotypes."""
    t0 = time.perf_counter()
    n_records = 0
    n_entries = 0
    it_a = iter_genotypes(path_a)
    it_b = iter_genotypes(path_b)
    import itertools
    for (na, ga), (nb, gb) in itertools.zip_longest(
            it_a, it_b, fillvalue=(None, None)):
        if na is None or nb is None:
            raise AssertionError(
                f"files differ in record count at record {n_records}")
        if na != nb:
            raise AssertionError(
                f"record {n_records}: n_allele {na} != {nb}")
        if (ga is None) != (gb is None):
            raise AssertionError(f"record {n_records}: GT presence differs")
        if ga is not None and not np.array_equal(ga, gb):
            raise AssertionError(f"record {n_records}: genotypes differ")
        n_records += 1
        n_entries += 0 if ga is None else ga.shape[0]
    return {"records": n_records, "gt_entries": n_entries,
            "identical": True, "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# HRC-scale file-level validation (reference README.md:404-408 claims a
# 17.4B-entry chrX bit-exact round trip at 64976 haplotypes)
# ---------------------------------------------------------------------------
def hrc_scale(n_records: int = 16384, n_samples: int = 32488,
              block_length: int = 4096, workdir: str | None = None,
              device: str = "numpy", keep: bool = False) -> dict:
    """Synthesize an HRC-width (2*n_samples = 64976 haplotypes) multi-block
    BCF, CLI-compress it, extract back to BCF through the native loop, and
    stream a chunked lockstep compare of every genotype (bounded memory:
    one record in flight per side).  Defaults give ~1.06e9 GT entries —
    within 20x of the reference's 17.4B chrX claim — with peak RSS
    reported."""
    import os
    import resource
    import tempfile

    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="xsi_hrc_")
    os.makedirs(workdir, exist_ok=True)
    inp = os.path.join(workdir, "hrc.bcf")
    xsi = os.path.join(workdir, "hrc.xsi")
    out = os.path.join(workdir, "hrc.out.bcf")

    from .e2e import synth_bcf
    t0 = time.perf_counter()
    synth_bcf(inp, n_records, n_samples)
    t_synth = time.perf_counter() - t0

    from ..codec.compressor import CompressorOptions, compress_file
    t0 = time.perf_counter()
    stats = compress_file(inp, xsi, CompressorOptions(
        block_length=block_length, device=device))
    t_comp = time.perf_counter() - t0

    from ..codec.decompressor import Decompressor, DecompressorOptions
    t0 = time.perf_counter()
    Decompressor(xsi, DecompressorOptions(output_type="b")).decompress(out)
    t_ext = time.perf_counter() - t0

    lock = lockstep_load(inp, out)
    assert lock["identical"] and lock["records"] == n_records

    peak_rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    result = {
        "n_records": n_records,
        "n_haplotypes": n_samples * 2,
        "gt_entries": lock["gt_entries"],
        "identical": True,
        "input_bcf_mb": round(os.path.getsize(inp) / 1e6, 1),
        "xsi_mb": round(os.path.getsize(xsi) / 1e6, 1),
        "logical_gb": round(n_records * n_samples * 2 * 4 / 1e9, 2),
        "synth_s": round(t_synth, 1),
        "compress_s": round(t_comp, 1),
        "extract_s": round(t_ext, 1),
        "lockstep_s": round(lock["seconds"], 1),
        "n_blocks": -(-n_records // block_length),
        "entries": stats["entries"],
        "peak_rss_gb": round(peak_rss_gb, 2),
    }
    if own and not keep:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    return result


# ---------------------------------------------------------------------------
# Multi-process scaling curve (BASELINE.md: >=80% efficiency at 4 hosts)
# ---------------------------------------------------------------------------
def _scaling_worker(cfg_json: str) -> None:
    """Entry point of one scaling-bench OS process (see scaling_curve)."""
    import json

    cfg = json.loads(cfg_json)
    import jax
    jax.config.update("jax_platforms", "cpu")

    from ..codec.compressor import CompressorOptions
    from ..parallel.distributed import compress_file_multihost

    perf: dict = {}
    stats = compress_file_multihost(
        cfg["input"], cfg["output"],
        CompressorOptions(block_length=cfg["block_length"], device="numpy"),
        coordinator=cfg["coordinator"],
        num_processes=cfg["nproc"], process_id=cfg["procid"],
        perf=perf)
    perf["procid"] = cfg["procid"]
    if stats is not None:
        perf["xsi_bytes"] = stats["xsi_bytes"]
    with open(cfg["perf_out"], "w") as f:
        json.dump(perf, f)


def _gather_only_worker(cfg_json: str) -> None:
    """Replay ONLY the overlapped gather's collective rounds (same round
    structure and byte sizes as the real run, synthetic payloads, no
    encode): the pure-communication cost sample for the scaling model.
    The contended run's measured gather_s is dominated by straggler WAIT
    (a fast process blocks in the collective until the slowest finishes
    its chunk — barrier skew, not bytes), so the dedicated-host model
    needs this isolated number."""
    import json
    import os

    cfg = json.loads(cfg_json)
    import jax
    jax.config.update("jax_platforms", "cpu")

    from ..parallel.distributed import gather_round_to_host0, init_distributed

    init_distributed(cfg["coordinator"], cfg["nproc"], cfg["procid"])
    lens = cfg["payload_lens"]
    chunk = max(1, int(cfg.get("chunk", 8)))
    rounds = cfg["rounds"]
    payloads = [b"\xAB" * n for n in lens]
    all_n = cfg["all_counts"]
    # warmup round (backend/socket setup is not per-byte cost)
    gather_round_to_host0([b"x"])
    t0 = time.perf_counter()
    import numpy as _np
    for r in range(rounds):
        batch = payloads[r * chunk:(r + 1) * chunk]
        kc = _np.asarray([max(min(chunk, n_i - r * chunk), 0)
                          for n_i in all_n], _np.int32)
        gather_round_to_host0(batch, known_counts=kc)
    wall = time.perf_counter() - t0
    with open(cfg["perf_out"], "w") as f:
        json.dump({"procid": cfg["procid"], "comm_s": wall,
                   "rounds": rounds}, f)


def scaling_curve(n_records: int = 20000, n_samples: int = 500,
                  procs: tuple = (1, 2, 4), block_length: int = 1024,
                  workdir: str | None = None) -> dict:
    """Wall-clock scaling of `compress_file_multihost` at 1/2/4 OS
    processes on a synthetic input (CPU backend, real jax.distributed with
    a localhost coordinator), with the gather overhead broken out.

    Real multi-host hardware is not available in this sandbox (nor more
    than one CPU core), so two curves are reported:
      * measured wall clock — all processes share the sandbox's core, so
        it cannot show speedup; it validates overhead, not parallelism;
      * modeled wall clock — scan + max(per-process encode) + gather +
        assembly, i.e. the wall clock on a host pool where processes run
        concurrently.  Efficiency_N = T1 / (N * T_N) over the model.
    Outputs are verified byte-identical to single-process compress_file
    at every process count.
    """
    import json
    import os
    import socket
    import subprocess
    import sys
    import tempfile

    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="xsi_scaling_")
    os.makedirs(workdir, exist_ok=True)
    inp = os.path.join(workdir, "in.bcf")
    from .e2e import synth_bcf
    synth_bcf(inp, n_records, n_samples)
    if os.environ.get("XSI_SCAN_CACHE", "0") not in ("0", "off", "no"):
        # warm-index mode: prime the sidecar once so every point (incl.
        # the 1-process baseline) reads the same warm scan — the steady
        # state for repeated compressions of a static input
        from ..io.unified import count_entries_offsets
        count_entries_offsets(inp, block_length)

    # single-process reference bytes
    from ..codec.compressor import CompressorOptions, compress_file
    ref = os.path.join(workdir, "ref.xsi")
    t0 = time.perf_counter()
    compress_file(inp, ref, CompressorOptions(block_length=block_length,
                                              device="numpy"))
    t_single = time.perf_counter() - t0
    ref_bytes = open(ref, "rb").read()

    def free_port() -> int:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    results = []
    for n in procs:
        out = os.path.join(workdir, f"out_{n}.xsi")
        coord = f"127.0.0.1:{free_port()}"
        cfgs = []
        for i in range(n):
            cfgs.append(dict(
                input=inp, output=out, block_length=block_length,
                coordinator=coord, nproc=n, procid=i,
                perf_out=os.path.join(workdir, f"perf_{n}_{i}.json")))
        # opts.device="numpy" + jax_platforms=cpu already keep workers off
        # the device codec; XSI_DEVICE is NOT forced so the native paths
        # (var pass, parse, encode) run in production config when the
        # parent env allows them.
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        t0 = time.perf_counter()
        logf = open(os.path.join(workdir, f"workers_{n}.log"), "wb")
        children = [subprocess.Popen(
            [sys.executable, "-c",
             "import sys; from xsqueezeit_tpu.bench.tools import "
             "_scaling_worker; _scaling_worker(sys.argv[1])",
             json.dumps(cfg)], env=env, cwd=os.getcwd(),
            stdout=logf, stderr=logf)
            for cfg in cfgs]
        rcs = [c.wait() for c in children]
        wall = time.perf_counter() - t0
        if any(rcs):
            raise RuntimeError(f"scaling worker failed: rcs={rcs}")
        assert open(out, "rb").read() == ref_bytes, \
            f"{n}-process output differs from single-process bytes"

        perfs = [json.load(open(c["perf_out"])) for c in cfgs]
        perfs_by_id = {p["procid"]: p for p in perfs}
        p0 = perfs_by_id[0]
        # CPU times are contention-immune: on dedicated hosts (one busy
        # process each) they equal wall time, so the model below is the
        # wall clock of a real N-host run.  Process 0 runs the variant
        # pass on a thread overlapped with its encode (both release the
        # GIL), so its span is max(varpass, encode0).  Gather is
        # communication — keep its measured wall (localhost gloo under
        # N-on-1-core contention, so a pessimistic bound; real network cost
        # for these byte counts is milliseconds) and report efficiency
        # both with and without it.
        scan_max = max(p["scan_cpu_s"] for p in perfs)
        var0 = p0.get("varpass_cpu_s", 0.0)
        enc0 = p0["encode_cpu_s"]
        enc_others = max([p["encode_cpu_s"] for p in perfs
                          if p["procid"] != 0], default=0.0)
        span = max(var0, enc0, enc_others)
        gather_max = max(p.get("gather_s", 0.0) for p in perfs)
        assemble = p0.get("assemble_cpu_s", 0.0)
        gather_bytes = sum(p.get("payload_bytes", 0)
                           for p in perfs if p["procid"] != 0)
        modeled = scan_max + span + gather_max + assemble

        # SOLO pass: each worker's compute slice re-run alone (fresh
        # process, no contention) — on this one-core sandbox even CPU
        # times inflate 2-3x when N processes share the core (cache
        # thrash), so the dedicated-host model must sample each slice
        # uncontended.  p0's span is max(varpass, encode): on a real
        # host they run on separate threads/cores.
        solo_perfs = []
        for i in range(n):
            solo_cfg = dict(
                input=inp, output=os.path.join(workdir, f"solo_{n}_{i}.xsi"),
                block_length=block_length, nproc=n, procid=i,
                n_samples=n_samples, mac_threshold=int(
                    2 * n_samples * 0.001),
                perf_out=os.path.join(workdir, f"solo_{n}_{i}.json"))
            best: dict = {}
            for _rep in range(2):   # min-of-2: stray sandbox contention
                rc = subprocess.run(
                    [sys.executable, "-c",
                     "import sys; from xsqueezeit_tpu.bench.tools import "
                     "_scaling_solo_worker; _scaling_solo_worker(sys.argv[1])",
                     json.dumps(solo_cfg)], env=env, cwd=os.getcwd(),
                    capture_output=True, text=True)
                if rc.returncode != 0:
                    raise RuntimeError(
                        f"solo worker failed: {rc.stderr[-500:]}")
                got = json.load(open(solo_cfg["perf_out"]))
                for k, v in got.items():
                    best[k] = min(best[k], v) if k in best else v
            solo_perfs.append(best)
        solo_scan = max(p["scan_s"] for p in solo_perfs)
        solo_var0 = max(p.get("varpass_s", 0.0) for p in solo_perfs)
        # per-host span: encode and the (possibly distributed) variant
        # pass run on threads of the same host — take the busiest host
        solo_span = max(max(p["encode_s"], p.get("varpass_s", 0.0))
                        for p in solo_perfs)

        # Pure-communication sample: replay ONLY the gather rounds (same
        # structure/bytes, synthetic payloads).  The contended gather_s is
        # straggler wait, not bytes (see _gather_only_worker).  With the
        # overlapped gather, communication hides behind encode; the
        # dedicated-host residual is what cannot hide: the tail round,
        # or the spill when comm_total exceeds the encode span.
        comm_total = 0.0
        rounds = max(int(p.get("gather_rounds", 0)) for p in perfs)
        if n > 1 and rounds:
            gcoord = f"127.0.0.1:{free_port()}"
            gcfgs = [dict(coordinator=gcoord, nproc=n, procid=i,
                          payload_lens=perfs_by_id[i].get("payload_lens", []),
                          rounds=rounds,
                          chunk=max(int(p.get("gather_chunk", 8))
                                    for p in perfs),
                          all_counts=[len(perfs_by_id[j].get(
                              "payload_lens", [])) for j in range(n)],
                          perf_out=os.path.join(workdir, f"go_{n}_{i}.json"))
                     for i in range(n)]
            gchildren = [subprocess.Popen(
                [sys.executable, "-c",
                 "import sys; from xsqueezeit_tpu.bench.tools import "
                 "_gather_only_worker; _gather_only_worker(sys.argv[1])",
                 json.dumps(cfg)], env=env, cwd=os.getcwd(),
                stdout=logf, stderr=logf) for cfg in gcfgs]
            grcs = [c.wait() for c in gchildren]
            if any(grcs):
                raise RuntimeError(f"gather-only worker failed: {grcs}")
            comm_total = max(json.load(open(c["perf_out"]))["comm_s"]
                             for c in gcfgs)
        comm_residual = (max(comm_total - solo_span, comm_total / rounds)
                         if rounds else 0.0)
        solo_wall = solo_scan + solo_span + comm_residual + assemble

        results.append(dict(
            procs=n, wall_s=round(wall, 2), scan_cpu_s=round(scan_max, 2),
            varpass_cpu_s=round(var0, 2),
            encode_max_cpu_s=round(max(enc0, enc_others), 2),
            gather_s=round(gather_max, 3),
            assemble_cpu_s=round(assemble, 3), gather_mb=round(
                gather_bytes / 1e6, 3),
            solo_scan_s=round(solo_scan, 2),
            solo_varpass_s=round(solo_var0, 2),
            solo_encode_max_s=round(
                max(p["encode_s"] for p in solo_perfs), 2),
            comm_total_s=round(comm_total, 3),
            comm_residual_s=round(comm_residual, 3),
            solo_wall_s=round(solo_wall, 2),
            solo_compute_wall_s=round(solo_wall - comm_residual, 2),
            modeled_wall_s=round(modeled, 2),
            compute_wall_s=round(modeled - gather_max, 2)))

    base = results[0]["modeled_wall_s"]
    base_c = results[0]["compute_wall_s"]
    base_s = results[0]["solo_wall_s"]
    base_sc = results[0]["solo_compute_wall_s"]

    def eff(num, den):   # micro workloads can round a wall to 0.00
        return round(num / max(den, 1e-6), 3)

    for r in results:
        r["modeled_efficiency"] = eff(base, r["procs"] * r["modeled_wall_s"])
        r["compute_efficiency"] = eff(base_c,
                                      r["procs"] * r["compute_wall_s"])
        r["solo_efficiency"] = eff(base_s, r["procs"] * r["solo_wall_s"])
        r["solo_compute_efficiency"] = eff(
            base_sc, r["procs"] * r["solo_compute_wall_s"])
    if own:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    return {"records": n_records, "samples": n_samples,
            "block_length": block_length,
            "single_process_compress_s": round(t_single, 2),
            "byte_identical": True, "curve": results}


def warmup(n_samples: int, block_length: int = 8192,
           mac_threshold: int | None = None,
           fracs: tuple = (1.0, 0.7, 0.45, 0.2)) -> dict:
    """Pre-compile the device executables for a production geometry.

    Each (Lw, H) shape compiles once per cache (utils/jaxcache), so
    running this ahead of time moves those compiles out of the first
    real compress/extract.  Each `frac`
    builds one synthetic block whose WAH-line count lands in a distinct
    WAH-row bucket (encoder_base.prepare: quarter buckets of L_pad when
    H > 16384), encodes it through the production DeviceBlockEncoder
    path and decodes the payload back through DeviceBlockDecoder —
    compiling the same executables a real file of this geometry hits.
    """
    from ..codec.decoder_jax import DeviceBlockDecoder
    from ..codec.encoder_jax import DeviceBlockEncoder
    from ..utils.shapes import bucket

    H = 2 * n_samples
    thr = (max(int(H * 0.001), 1) if mac_threshold is None
           else int(mac_threshold))
    aet = np.uint16 if H <= 0xFFFF else np.uint32
    L_pad = bucket(block_length)

    # Two template records: a balanced common row (mac = H/2 -> WAH) and a
    # single-carrier rare row (-> sparse).  Values don't matter for
    # compilation, shapes do.
    common = np.full(H, 2, np.int32)
    common[0::2] = 4
    rare = np.full(H, 2, np.int32)
    rare[0] = 4

    shapes = []
    for frac in fracs:
        n_wah = max(min(int(block_length * frac), block_length), 1)
        enc = DeviceBlockEncoder(n_samples, block_length, thr,
                                 default_phasing=0, aet_dtype=aet)
        for i in range(block_length):
            enc.encode_record(common if i < n_wah else rare, 2)
        t0 = time.perf_counter()
        prep = enc.prepare()
        payload = enc.serialize_prepared(prep)
        t_enc = time.perf_counter() - t0
        prep_lw = prep["wah_rows_p"].shape[0]

        dec = DeviceBlockDecoder(payload, n_samples, H, aet)
        t0 = time.perf_counter()
        out = dec.decode_all()
        t_dec = time.perf_counter() - t0
        assert out is not None
        shapes.append({"frac": frac, "n_wah": n_wah, "L_pad": L_pad,
                       "Lw_pad": prep_lw,
                       "encode_s": round(t_enc, 2),
                       "decode_s": round(t_dec, 2)})
        print(f"warmup frac={frac}: Lw_pad={prep_lw} "
              f"encode {t_enc:.1f}s decode {t_dec:.1f}s", flush=True)
    return {"n_samples": n_samples, "n_haps": H, "block_length": block_length,
            "mac_threshold": thr, "shapes": shapes}


def _scaling_solo_worker(cfg_json: str) -> None:
    """One worker's COMPUTE slice run alone (no peers, no contention):
    the dedicated-host wall-clock sample for the scaling model."""
    import json
    import os
    import threading

    cfg = json.loads(cfg_json)
    import jax
    jax.config.update("jax_platforms", "cpu")

    from ..codec.compressor import CompressorOptions
    from ..io.unified import GtInput, count_entries_offsets
    from ..parallel.distributed import (
        _encode_block_range,
        _variant_pass,
        plan_block_ranges,
    )

    opts = CompressorOptions(block_length=cfg["block_length"],
                             device="numpy")
    from ..parallel.distributed import _setup
    (s_inp, _samples, n_samples, default_phased, _max_ploidy, aet_dtype,
     mac_threshold, ws) = _setup(cfg["input"], opts)
    s_inp.close()
    perf: dict = {}
    t0 = time.perf_counter()
    n_entries, block_voffs = count_entries_offsets(cfg["input"],
                                                   cfg["block_length"])
    perf["scan_s"] = time.perf_counter() - t0

    n_blocks = -(-n_entries // opts.block_length)
    rng = plan_block_ranges(max(n_blocks, 1), cfg["nproc"])[cfg["procid"]]

    dist_var = (cfg["nproc"] > 1 and block_voffs is not None
                and os.environ.get("XSI_DIST_VARPASS", "1")
                not in ("0", "off", "no"))
    if dist_var:
        # distributed form: THIS worker's var segment (runs on a thread
        # next to encode on a dedicated host; the model takes the max)
        from ..parallel.distributed import _var_segment
        t0 = time.perf_counter()
        seg = _var_segment(cfg["input"], cfg["output"], opts, rng[0],
                           rng[1], block_voffs,
                           write_header=(cfg["procid"] == 0))
        perf["varpass_s"] = time.perf_counter() - t0
        if seg is None and cfg["procid"] == 0:   # ineligible: serial pass
            vin = GtInput(cfg["input"])
            t0 = time.perf_counter()
            _variant_pass(vin, opts, cfg["output"], _max_ploidy)
            perf["varpass_s"] = time.perf_counter() - t0
            vin.close()
    elif cfg["procid"] == 0:
        vin = GtInput(cfg["input"])
        t0 = time.perf_counter()
        _variant_pass(vin, opts, cfg["output"], _max_ploidy)
        perf["varpass_s"] = time.perf_counter() - t0
        vin.close()

    t0 = time.perf_counter()
    payloads = _encode_block_range(
        cfg["input"], rng, n_samples, opts, mac_threshold, default_phased,
        aet_dtype, ws, block_voffs=block_voffs)
    perf["encode_s"] = time.perf_counter() - t0
    perf["payload_bytes"] = sum(len(p) for p in payloads)
    with open(cfg["perf_out"], "w") as f:
        json.dump(perf, f)
