"""Streaming compression driver: VCF/BCF -> .xsi + _var.bcf.

Mirrors the reference pipeline (gt_compressor_new.hpp NewCompressor /
GtCompressorStream + xcf.cpp replace_samples_by_pos_in_binary_matrix) in a
single pass: each input record contributes (1) its site columns + FORMAT/BM
pointer to the variant BCF and (2) its genotype matrix rows to the current
GT block, flushed to the container every `block_length` records.

One deliberate fix over the reference: the sparse/arrangement index width
(A_T) is keyed on N_HAPS everywhere (the reference keys the block encoder on
num_samples but the header on N_HAPS, which disagree for 32769..65535
samples; see SURVEY.md "latent reference bug").
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

from ..format.constants import (
    BM_BLOCK_BITS,
    DEFAULT_BLOCK_LENGTH,
    DEFAULT_MAF,
    DEFAULT_ZSTD_LEVEL,
    PSEUDO_SAMPLE_NAME,
    XSI_BCF_VAR_EXTENSION,
)
from ..format.container import XsiWriter
from ..format.header import XsiHeader
from ..io.bcf import BcfHeader, BcfWriter, patch_shared_sample_counts
from ..io.csi import CsiBuilder
from ..io.sites import encode_bm_indiv
from ..io.unified import (
    GtInput,
    sniff_default_phased,
    sniff_max_ploidy_first_entry,
)
from . import BLOCK_COUNTS
from .gt_block import GtBlockEncoder


@dataclass
class CompressorOptions:
    maf: float = DEFAULT_MAF
    block_length: int = DEFAULT_BLOCK_LENGTH
    zstd: bool = False
    zstd_level: int = DEFAULT_ZSTD_LEVEL
    wah_encode_missing: bool = False  # WS_WAH weirdness strategy
    verbose: bool = False
    device: str = "auto"  # "auto" | "jax" | "numpy"

    def __post_init__(self):
        if self.block_length < 1:
            raise ValueError(
                f"block_length must be >= 1, got {self.block_length}")


def _device_min_cells() -> int:
    """Blocks below this many (lines x haplotypes) cells stay on the host
    NumPy path -- device dispatch latency dominates tiny blocks.  Forcing
    `XSI_DEVICE=jax` keeps the device path unconditionally (tests)."""
    if os.environ.get("XSI_DEVICE") == "jax":
        return 0
    return int(os.environ.get("XSI_DEVICE_MIN_CELLS", 2_000_000))


def use_device_codec(device: str = "auto") -> bool:
    """Whether the device (JAX) block codec runs.  "numpy" never; "jax"
    (option or XSI_DEVICE) always, on whatever backend JAX gives — the
    CPU tests drive the device code that way; "auto" only when JAX's
    default backend is a GPU."""
    if device == "auto":
        device = os.environ.get("XSI_DEVICE", "auto")
    if device == "numpy":
        return False
    if device == "jax":
        return True
    try:
        import jax
    except ImportError:
        return False
    return jax.default_backend() == "gpu"


def _host_encoder_cls():
    """Native C++ block encoder when buildable (XSI_NATIVE_ENCODE=0
    reverts), else the Python oracle — payloads are byte-identical."""
    if os.environ.get("XSI_NATIVE_ENCODE", "1") not in ("0", "off", "no"):
        try:
            from ..interop.native import NativeBlockEncoder
            NativeBlockEncoder  # noqa: B018
            from ..interop.native import build_native
            build_native()
            return NativeBlockEncoder
        except Exception:
            pass
    from .gt_block import GtBlockEncoder
    return GtBlockEncoder


def _device_encoder_cls(device: str):
    if not use_device_codec(device):
        return None
    from .encoder_jax import DeviceBlockEncoder
    return DeviceBlockEncoder


class _SegmentBlock:
    """One block's records as zero-copy slices of parse batches.

    A segment (gt_all, offs, na, lo, hi) references records [lo, hi) of
    one batch whose gt buffer the reader handed over (ownership transfer,
    interop.native.NativeGtBatchReader.iter_batches); a block holds the
    references until its encode completes, then drops them.  No per-record
    Python objects and no copying — the batched GT loop's whole point."""

    __slots__ = ("segs", "n")

    def __init__(self):
        self.segs: list = []
        self.n = 0

    def append(self, gt_all: np.ndarray, offs: np.ndarray, na: np.ndarray,
               lo: int, hi: int) -> None:
        self.segs.append((gt_all, offs, na, lo, hi))
        self.n += hi - lo

    def rows(self):
        """Iterate (gt_view, n_alleles) across the segments."""
        for gt_all, offs, na, lo, hi in self.segs:
            for i in range(lo, hi):
                yield gt_all[offs[i]:offs[i + 1]], int(na[i])


class BlockEncodeDispatcher:
    """Buffers one block of records and picks the device or native/NumPy
    host encoder at flush time (the device path covers uniform AND
    mixed-ploidy blocks; only tiny blocks and ploidy-2+ oddities stay on
    the host).

    With more than one local device, eligible blocks batch through a
    shard_map'd encode over a block-axis Mesh (parallel/shard.py
    MeshBlockEncoder) — single-process multi-chip data parallelism, the
    generalized form of the reference's 2-thread split
    (xsqueezeit.cpp:120-148).  Payload bytes are identical to the
    single-device path; only wall-clock changes."""

    def __init__(self, n_samples, block_length, mac_threshold,
                 default_phasing, aet_dtype, weirdness_strategy, device_cls,
                 force_device: bool = False):
        self._kw = dict(
            n_samples=n_samples, block_bcf_lines=block_length,
            mac_threshold=mac_threshold, default_phasing=default_phasing,
            aet_dtype=aet_dtype, weirdness_strategy=weirdness_strategy)
        self.n_haps = n_samples * 2
        self.block_length = block_length
        self.device_cls = device_cls
        self.force_device = force_device
        self.pending: list[tuple[np.ndarray, int]] = []
        self._buf: _SegmentBlock | None = None  # batch mode current block
        self._executor = None
        self._mesh = None           # lazy: probed on first eligible block
        self._mesh_probed = False
        self._mesh_encoder = None
        self._batch: list = []      # [(DeviceBlockEncoder, Future)]
        self.batch_target = 1
        # Host-path block encodes run on a small worker pool: the native
        # encoder releases the GIL, so independent blocks encode in
        # parallel while the main thread parses (order is preserved by the
        # caller's future deque, not by worker count).  Device paths keep
        # one worker (device dispatch serializes anyway).  Each in-flight
        # block holds its records (~L x H x 4 B), so the pool stays small.
        if device_cls is not None:
            self.encode_workers = 1
        else:
            self.encode_workers = max(1, int(os.environ.get(
                "XSI_ENCODE_THREADS", min(4, os.cpu_count() or 1))))

    @property
    def inflight_target(self) -> int:
        """Blocks allowed in flight before the driver blocks on the head
        future (bounds memory: one block's records is L x H x 4 bytes)."""
        return max(2 * self.batch_target, self.encode_workers + 1)

    @property
    def full(self) -> bool:
        return self.bcf_lines >= self.block_length

    @property
    def bcf_lines(self) -> int:
        if self._buf is not None:
            return self._buf.n
        return len(self.pending)

    @property
    def room(self) -> int:
        return self.block_length - self.bcf_lines

    def encode_record(self, gt: np.ndarray, n_alleles: int) -> None:
        self.pending.append((gt, n_alleles))

    # ------------------------------------------------------------ batch mode
    def encode_records(self, gt_all: np.ndarray, offs: np.ndarray,
                       na: np.ndarray, lo: int, hi: int) -> None:
        """Reference records [lo, hi) of a parse batch in the current
        block (zero-copy).  A run uses either this or encode_record,
        never both (the batched GT loop vs the per-record loops)."""
        assert not self.pending, "mixed per-record and batch dispatch"
        if self._buf is None:
            self._buf = _SegmentBlock()
        self._buf.append(gt_all, offs, na, lo, hi)

    def _take_block(self):
        """Detach the filled block (segments or per-record list)."""
        if self._buf is not None:
            buf, self._buf = self._buf, None
            return buf
        records, self.pending = self.pending, []
        return records

    @staticmethod
    def _row_lengths(records) -> set[int]:
        if isinstance(records, _SegmentBlock):
            out: set[int] = set()
            for _, offs, _, lo, hi in records.segs:
                out.update(np.unique(np.diff(offs[lo:hi + 1])).tolist())
            return out
        return {g.shape[0] for g, _ in records}

    @staticmethod
    def _n_records(records) -> int:
        return (records.n if isinstance(records, _SegmentBlock)
                else len(records))

    def _encode(self, records) -> bytes:
        n_samples = self.n_haps // 2
        lengths = self._row_lengths(records)
        # Uniform blocks take the chunked device pipeline; mixed-ploidy
        # blocks (haploid + diploid interleaved) take the parity-carrying
        # device path (encoder_jax.encode_block_core_mixed).  Anything
        # else (ploidy > 2 guarded upstream) stays on the NumPy encoder.
        uniform = lengths <= {self.n_haps, n_samples} and bool(lengths)
        # Small blocks encode faster on host: device dispatch + transfer
        # latency dwarfs the compute.
        # device="jax" (option or env) forces the device path regardless.
        big_enough = (self.force_device
                      or self._n_records(records) * self.n_haps
                      >= _device_min_cells())
        # Host blocks use the per-record encoder — native C++ when the lib
        # builds (gt_encoder.cpp, byte-identical, ~10x), else the Python
        # oracle.  (A vectorized whole-block host encoder was built and
        # measured 3-7x SLOWER here: stacking + re-streaming hundreds of MB
        # through DRAM loses to cache-resident per-row work, so the block
        # formulation is device-only.)
        on_device = bool(self.device_cls and uniform and big_enough)
        cls = self.device_cls if on_device else _host_encoder_cls()
        BLOCK_COUNTS["encode_device" if on_device else "encode_host"] += 1
        enc = cls(**self._kw)
        if (isinstance(records, _SegmentBlock)
                and hasattr(enc, "encode_records")):
            # one library call per parse-batch segment (native encoder):
            # a handful of ctypes crossings per block instead of one per
            # record, no per-record Python at all
            for gt_all, offs, na, lo, hi in records.segs:
                enc.encode_records(gt_all, offs, na, lo, hi)
        else:
            rows = (records.rows() if isinstance(records, _SegmentBlock)
                    else records)
            for gt, na in rows:
                enc.encode_record(gt, na)
        return enc.serialize()

    def serialize(self) -> bytes:
        return self._encode(self._take_block())

    # ------------------------------------------------------- mesh batching
    def _device_eligible(self, records) -> bool:
        lengths = self._row_lengths(records)
        n_samples = self.n_haps // 2
        uniform = lengths in ({self.n_haps}, {n_samples})
        big_enough = (self.force_device
                      or self._n_records(records) * self.n_haps
                      >= _device_min_cells())
        return self.device_cls is not None and uniform and big_enough

    def _probe_mesh(self):
        """Build the local-device Mesh once, on the first eligible block
        (lazy: small/NumPy-only runs never initialize the jax backend)."""
        if self._mesh_probed:
            return self._mesh
        self._mesh_probed = True
        from ..parallel.shard import local_mesh
        self._mesh = local_mesh()
        if self._mesh is not None:
            self.batch_target = int(self._mesh.devices.size)
        return self._mesh

    def _dispatch_batch(self) -> None:
        batch, self._batch = self._batch, []
        if not batch:
            return

        def run():
            try:
                if self._mesh_encoder is None:
                    from ..parallel.shard import MeshBlockEncoder
                    self._mesh_encoder = MeshBlockEncoder(
                        self._mesh, self._kw["mac_threshold"])
                payloads = self._mesh_encoder.encode_batch(
                    [e for e, _ in batch])
                for (_, fut), p in zip(batch, payloads):
                    fut.set_result(p)
            except BaseException as exc:
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(exc)

        self._executor.submit(run)

    def flush(self) -> None:
        """Dispatch any partially-filled mesh batch (call before draining
        the pending futures, or the tail blocks never resolve)."""
        self._dispatch_batch()

    def submit(self):
        """Encode the buffered block on a worker thread, so the caller can
        keep parsing input while the device works (the 2-stage pipeline the
        reference approximates with its two threads, xsqueezeit.cpp:120-148;
        SURVEY §2 'pipeline parallelism' row).  Returns a Future[bytes];
        the caller's future deque preserves block order at any worker
        count.  On a multi-device host,
        eligible blocks accumulate into mesh batches of `batch_target`."""
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor
            self._executor = ThreadPoolExecutor(
                max_workers=self.encode_workers)
        records = self._take_block()
        if self._device_eligible(records) and self._probe_mesh() is not None:
            from concurrent.futures import Future
            enc = self.device_cls(**self._kw)
            if isinstance(records, _SegmentBlock):
                # batched ingest (encoder_base.encode_records): whole-
                # matrix stats passes instead of per-record numpy calls
                for gt_all, offs, na, lo, hi in records.segs:
                    enc.encode_records(gt_all, offs, na, lo, hi)
            else:
                for gt, na in records:
                    enc.encode_record(gt, na)
            fut = Future()
            BLOCK_COUNTS["encode_device"] += 1
            self._batch.append((enc, fut))
            if len(self._batch) >= self.batch_target:
                self._dispatch_batch()
            return fut
        return self._executor.submit(self._encode, records)

    def shutdown(self) -> None:
        for _, fut in self._batch:
            if not fut.done():
                fut.cancel()
        self._batch = []
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = None


def make_variant_header(src: BcfHeader, xsi_basename: str) -> BcfHeader:
    """Header for the `_var.bcf` variant file: pseudo-sample + BM + ##XSI.

    The clone *shares* the source header's dictionaries so that shared blocks
    encoded against the source keep valid indices (records passed through
    verbatim reference the input header's FILTER/INFO/contig ids).
    """
    src.ensure_string("BM", '##FORMAT=<ID=BM,Number=1,Type=Integer,Description='
                            '"Position in GT Binary Matrix">')
    h = BcfHeader.from_text(src.to_text())
    h.samples = [PSEUDO_SAMPLE_NAME]
    h.lines.append(f"##XSI={xsi_basename}")
    # Share dictionary objects: any string auto-registered while encoding
    # records stays consistent between the two headers.
    h.dict_strings = src.dict_strings
    h.str2idx = src.str2idx
    h.dict_contigs = src.dict_contigs
    h.contig2idx = src.contig2idx
    return h


def _native_var_pass_eligible(inp) -> bool:
    """Gate shared by compress_file and the multihost variant pass: the
    two must agree so single- and multi-process containers stay
    byte-identical within one environment."""
    if inp.format != "bcf":
        return False
    if os.environ.get("XSI_NATIVE", "1") in ("0", "off", "no"):
        return False
    if os.environ.get("XSI_DEVICE") in ("numpy", "jax"):
        # explicit codec selection routes through the Python drivers
        # (tests rely on exercising each path)
        return False
    try:
        from ..interop.native import build_native
        build_native()
        return True
    except Exception:
        return False


def variant_pass_native(inp, opts, output_path: str, sniffed_ploidy: int,
                        assume_eligible: bool = False
                        ) -> tuple[int, int, int] | None:
    """The variant-file pass through native/var_pass.cpp: record walk +
    `_var.bcf` write + BM packing in C++, CSI built here from the
    returned tuples.  Returns (entries, variants, max_ploidy), or None
    when ineligible (the Python loop runs instead).  assume_eligible
    skips re-gating when the caller already decided (the decision must
    be made ONCE — a mid-run disagreement would strand the GT loop)."""
    if not assume_eligible and not _native_var_pass_eligible(inp):
        return None
    from ..interop.native import native_var_pass
    from ..io.csi import CsiBuilder, depth_for_max_len
    from ..io.sites import encode_bm_indiv

    var_path = output_path + XSI_BCF_VAR_EXTENSION
    var_header = make_variant_header(inp.header,
                                     os.path.basename(output_path))
    text = var_header.to_text().encode() + b"\0"
    bm_prefix = encode_bm_indiv(var_header, 0)[:-4]
    gt_key = inp.header.str2idx.get("GT", -1)
    skip = 9 + inp._bcf.header_text_len
    # Exact output sizing: a compressed-size heuristic over-allocates by
    # the compression ratio (tens of GB at biobank scale — the tuple
    # arrays are 32 B/record); the native frame count is a cheap extra
    # walk and bounds memory to what the records actually need.
    from ..io.unified import count_entries_offsets
    n_recs, _ = count_entries_offsets(inp.path, 0)
    rid, pos, rlen, _bm, vbeg, vend, n_variants, max_ploidy = \
        native_var_pass(inp.path, skip, var_path, text, 6, bm_prefix,
                        opts.block_length, gt_key, cap_hint=n_recs + 1)
    csi = CsiBuilder(depth=depth_for_max_len(
        max(var_header.contig_lengths.values(), default=0)))
    rlen1 = np.maximum(rlen, 1)
    csi.add_many(rid, pos, pos.astype(np.int64) + rlen1, vbeg, vend)
    csi.write(var_path + ".csi", n_ref=len(var_header.dict_contigs))
    return rid.shape[0], n_variants, max(sniffed_ploidy, max_ploidy)


def compress_file(input_path: str, output_path: str,
                  opts: CompressorOptions | None = None) -> dict:
    """Compress `input_path` into `output_path` (+ `_var.bcf`).

    Returns summary stats.
    """
    from ..format.constants import WeirdnessStrategy

    opts = opts or CompressorOptions()
    inp = GtInput(input_path)
    samples = inp.samples
    if not samples:
        raise ValueError(f"File {input_path} has no samples")
    n_samples = len(samples)

    default_phased = sniff_default_phased(input_path)
    max_ploidy = sniff_max_ploidy_first_entry(input_path)
    if max_ploidy == 0:
        raise ValueError(f"File {input_path} has no GT entries")

    ploidy_for_haps = 2  # A_T selection always assumes diploid (ref parity)
    n_haps = n_samples * ploidy_for_haps
    aet_dtype = np.uint16 if n_haps <= 0xFFFF else np.uint32
    mac_threshold = int(n_haps * opts.maf)
    ws = (WeirdnessStrategy.WS_WAH if opts.wah_encode_missing
          else WeirdnessStrategy.WS_SPARSE)

    header = XsiHeader(
        version=5,
        ind_bytes=4,
        aet_bytes=np.dtype(aet_dtype).itemsize,
        wah_bytes=2,
        iota_ppa=True,
        no_sort=False,
        default_phased=bool(default_phased),
        ss_rate=opts.block_length,
        rare_threshold=mac_threshold,
    )
    xsi = XsiWriter(output_path, header, samples,
                    zstd_on=opts.zstd, zstd_level=opts.zstd_level)

    var_path = output_path + XSI_BCF_VAR_EXTENSION
    var_header = make_variant_header(inp.header, os.path.basename(output_path))
    native_var = _native_var_pass_eligible(inp)
    if native_var:
        # the native pass owns the variant outputs; it runs on a thread
        # overlapped with the GT loop (_compress_loop_native_var)
        var_writer = csi = None
    else:
        var_writer = BcfWriter(var_path, var_header)
        # reference parity: create_index_file, xcf.cpp:39-57; depth grows
        # with the longest declared contig so >537 Mbp coordinates stay
        # addressable
        from ..io.csi import depth_for_max_len
        csi = CsiBuilder(depth=depth_for_max_len(
            max(var_header.contig_lengths.values(), default=0)))

    force_device = (opts.device == "jax"
                    or os.environ.get("XSI_DEVICE") == "jax")
    block = BlockEncodeDispatcher(
        n_samples, opts.block_length, mac_threshold,
        default_phasing=default_phased, aet_dtype=aet_dtype,
        weirdness_strategy=ws, device_cls=_device_encoder_cls(opts.device),
        force_device=force_device)
    try:
        if native_var:
            return _compress_loop_native_var(inp, opts, xsi, block,
                                             output_path, max_ploidy)
        return _compress_loop(inp, opts, xsi, var_writer, var_header, csi,
                              block, var_path, output_path, max_ploidy)
    except BaseException:
        # A failed compression must not leak the encode worker thread or
        # leave half-written output behind (the zero-ALT ValueError surfaces
        # here through pending_block.result()).
        block.shutdown()
        for f in (getattr(xsi, "f", None),
                  getattr(var_writer, "_f", None) if var_writer else None):
            try:
                if f is not None and not f.closed:
                    f.close()
            except Exception:
                pass
        for path in (output_path, var_path, var_path + ".csi"):
            try:
                os.unlink(path)
            except OSError:
                pass
        raise
    finally:
        block.shutdown()  # successful runs must also release the worker
        inp.close()


def _gt_loop_batched(batches, block, drain_full_block, max_records=None,
                     verbose=False) -> tuple[int, int]:
    """The GT main loop over whole parse batches: validation is vectorized
    and records land in the dispatcher's zero-copy segment blocks (no
    per-record Python, no per-record ctypes crossing).  Same block
    boundaries and payload bytes as the per-record loop.  Shared by the
    single-process loop and the multihost workers (`max_records` bounds a
    worker's record window; validation applies to consumed records only).
    `drain_full_block` is called whenever the dispatcher is full, before
    more records land.  Returns (records consumed, max ploidy seen)."""
    entry_counter = 0
    max_ploidy = 0
    remaining = max_records
    for gt_all, offs, na, pl, n in batches:
        take = n if remaining is None else min(n, remaining)
        if take <= 0:
            break
        pmax = int(pl[:take].max())
        if pmax > 2:
            raise ValueError("Ploidy higher than 2 is not yet supported")
        if int(pl[:take].min()) <= 0:
            raise ValueError("Record without GT data cannot be compressed")
        max_ploidy = max(max_ploidy, pmax)
        lo = 0
        while lo < take:
            if block.full:
                drain_full_block()
            t = min(take - lo, block.room)
            block.encode_records(gt_all, offs, na, lo, lo + t)
            lo += t
        entry_counter += take
        if verbose:
            done = (entry_counter // 1000) * 1000
            if done > entry_counter - take:
                print(f"Handled {done} VCF entries (lines)")
        if remaining is not None:
            remaining -= take
            if remaining == 0:
                break
    return entry_counter, max_ploidy


def _compress_loop_native_var(inp, opts, xsi, block, output_path,
                              max_ploidy) -> dict:
    """GT-only main loop with the variant pass on a native worker thread
    (var_pass.cpp releases the GIL): the two passes read the input
    independently, overlapping on multi-core hosts."""
    import threading
    from collections import deque

    var_state: dict = {}

    def run_var():
        try:
            var_state["result"] = variant_pass_native(
                inp, opts, output_path, max_ploidy, assume_eligible=True)
        except BaseException as exc:
            var_state["error"] = exc

    var_thread = threading.Thread(target=run_var, name="xsi-variant-pass")
    var_thread.start()
    try:
        seen_max_ploidy = max_ploidy
        pending_blocks: deque = deque()

        def drain_after_submit():
            pending_blocks.append(block.submit())
            while pending_blocks and pending_blocks[0].done():
                xsi.write_block(pending_blocks.popleft().result())
            while len(pending_blocks) > block.inflight_target:
                if not pending_blocks[0].done():
                    block.flush()
                xsi.write_block(pending_blocks.popleft().result())

        batches = inp.iter_gt_batches()
        if batches is not None:
            entry_counter, batch_pmax = _gt_loop_batched(
                batches, block, drain_after_submit, verbose=opts.verbose)
            seen_max_ploidy = max(seen_max_ploidy, batch_pmax)
        else:
            entry_counter = 0
            for rec in inp:
                if rec.gt is None:
                    raise ValueError("Record without GT data cannot be "
                                     "compressed")
                if rec.ploidy > 2:
                    raise ValueError(
                        "Ploidy higher than 2 is not yet supported")
                seen_max_ploidy = max(seen_max_ploidy, rec.ploidy)
                if block.full:
                    drain_after_submit()
                block.encode_record(rec.gt, rec.n_alleles)
                entry_counter += 1
                if opts.verbose and entry_counter % 1000 == 0:
                    print(f"Handled {entry_counter} VCF entries (lines)")
        block.flush()
        while pending_blocks:
            xsi.write_block(pending_blocks.popleft().result())
        if block.bcf_lines:
            xsi.write_block(block.serialize())
    finally:
        var_thread.join()
    if "error" in var_state:
        raise var_state["error"]
    var_entries, variant_counter, var_max_ploidy = var_state["result"]
    if var_entries != entry_counter:
        raise RuntimeError(
            f"variant pass saw {var_entries} records but the GT loop saw "
            f"{entry_counter} — inconsistent input read")
    xsi.finalize(num_variants=variant_counter, xcf_entries=entry_counter,
                 max_ploidy=max(seen_max_ploidy, var_max_ploidy))
    if opts.verbose:
        sb = xsi.section_bytes
        print(f"Sections: header {sb['header']} B, blocks {sb['blocks']} B "
              f"({len(xsi.indices)} blocks), indices {sb['indices']} B, "
              f"samples {sb['samples']} B, total {sb['total']} B "
              f"(native variant pass)", file=__import__('sys').stderr)
    var_path = output_path + XSI_BCF_VAR_EXTENSION
    return {
        "entries": entry_counter,
        "variants": variant_counter,
        "n_samples": len(inp.samples),
        "xsi_bytes": os.path.getsize(output_path),
        "variant_bytes": os.path.getsize(var_path),
    }


def _compress_loop(inp, opts, xsi, var_writer, var_header, csi, block,
                   var_path, output_path, max_ploidy) -> dict:
    from collections import deque

    entry_counter = 0
    variant_counter = 0
    bm_block = 0
    bm_offset = 0
    seen_max_ploidy = max_ploidy
    pending_blocks: deque = deque()

    for rec in inp:
        if rec.gt is None:
            raise ValueError("Record without GT data cannot be compressed")
        if rec.ploidy > 2:
            raise ValueError("Ploidy higher than 2 is not yet supported")
        seen_max_ploidy = max(seen_max_ploidy, rec.ploidy)

        # variant file entry (BM = block << 15 | offset)
        if entry_counter and entry_counter % opts.block_length == 0:
            bm_block += 1
            bm_offset = 0
        if bm_offset >> BM_BLOCK_BITS:
            raise ValueError(
                f"BM offset cannot be represented on {BM_BLOCK_BITS} bits")
        bm = (bm_block << BM_BLOCK_BITS) | bm_offset
        shared = patch_shared_sample_counts(rec.shared, n_fmt=1, n_sample=1)
        vbeg, vend = var_writer.write_raw(shared, encode_bm_indiv(var_header, bm))
        rid, pos0, rlen = struct.unpack_from("<iii", shared, 0)
        csi.add(rid, pos0, pos0 + max(rlen, 1), vbeg, vend)

        # genotype block entry (pipelined: earlier blocks encode on a
        # worker thread while this loop parses the next block's records;
        # multi-device hosts keep up to one mesh batch in flight on top)
        if block.full:
            pending_blocks.append(block.submit())
            while pending_blocks and pending_blocks[0].done():
                xsi.write_block(pending_blocks.popleft().result())
            # Bound in-flight memory.  Before a blocking wait, dispatch any
            # partially-filled mesh batch: the head future could otherwise
            # sit in a batch that never fills (e.g. a run of mixed-ploidy
            # blocks that are mesh-ineligible).
            while len(pending_blocks) > block.inflight_target:
                if not pending_blocks[0].done():
                    block.flush()
                xsi.write_block(pending_blocks.popleft().result())
        block.encode_record(rec.gt, rec.n_alleles)

        n_alts = rec.n_alleles - 1
        bm_offset += n_alts
        variant_counter += n_alts
        entry_counter += 1
        if opts.verbose and entry_counter % 1000 == 0:
            print(f"Handled {entry_counter} VCF entries (lines)")

    block.flush()
    while pending_blocks:
        xsi.write_block(pending_blocks.popleft().result())
    if block.bcf_lines:
        xsi.write_block(block.serialize())
    xsi.finalize(num_variants=variant_counter, xcf_entries=entry_counter,
                 max_ploidy=seen_max_ploidy)
    if opts.verbose:
        sb = xsi.section_bytes
        print(f"Sections: header {sb['header']} B, blocks {sb['blocks']} B "
              f"({len(xsi.indices)} blocks), indices {sb['indices']} B, "
              f"samples {sb['samples']} B, total {sb['total']} B",
              file=__import__('sys').stderr)
    var_writer.close()
    csi.write(var_path + ".csi", n_ref=len(var_header.dict_contigs))

    return {
        "entries": entry_counter,
        "variants": variant_counter,
        "n_samples": len(inp.samples),
        "xsi_bytes": os.path.getsize(output_path),
        "variant_bytes": os.path.getsize(var_path),
    }
