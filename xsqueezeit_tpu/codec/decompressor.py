"""Decompression driver: .xsi + _var.bcf -> VCF/BCF.

Mirrors the reference (gt_decompressor_new.hpp NewDecompressor): iterate the
variant BCF, map each record's FORMAT/BM pointer to (block, offset), decode
the genotype matrix rows, and emit the record with its samples restored.
Supports region (-r) and target (-t) filtering and sample subsetting (-s)
with AC/AN recomputation, and re-compression to a fresh XSI (-O x).
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import numpy as np

from ..format.constants import (
    BM_BLOCK_BITS,
    XSI_BCF_VAR_EXTENSION,
)
from ..format.container import XsiReader
from ..io.bcf import BcfHeader, BcfReader, BcfWriter, patch_shared_sample_counts
from ..io.sites import encode_gt_indiv, render_vcf_cols
from ..io.vcf import VcfWriter
from .gt_block_decoder import GtBlockDecoder


@dataclass
class Region:
    chrom: str
    start: int | None = None  # 1-based inclusive
    end: int | None = None

    @classmethod
    def parse(cls, text: str) -> "Region":
        m = re.match(r"^([^:]+)(?::(\d+)(-)?(\d+)?)?$", text)
        if not m:
            raise ValueError(f"Bad region: {text}")
        chrom, start, dash, end = m.groups()
        if start and not dash:
            end = start        # "chr:pos" is that single position (htslib)
        return cls(chrom, int(start) if start else None,
                   int(end) if end else None)

    def overlaps(self, chrom: str, pos: int, rlen: int) -> bool:
        """Region semantics (-r): record overlap including its length."""
        if chrom != self.chrom:
            return False
        if self.start is not None and pos + rlen - 1 < self.start:
            return False
        if self.end is not None and pos > self.end:
            return False
        return True

    def targets(self, chrom: str, pos: int) -> bool:
        """Target semantics (-t): POS-only check."""
        if chrom != self.chrom:
            return False
        if self.start is not None and pos < self.start:
            return False
        if self.end is not None and pos > self.end:
            return False
        return True


def parse_region_list(text: str) -> list[Region]:
    return [Region.parse(t) for t in text.split(",") if t]


@dataclass
class DecompressorOptions:
    regions: str = ""
    targets: str = ""
    samples: str = ""          # comma list, ^-prefixed to exclude
    samples_file: str = ""
    output_type: str = "b"     # b|u|z|v|x
    no_header: bool = False
    verbose: bool = False
    device: str = "auto"       # "auto" | "jax" | "numpy"
    block_range: tuple[int, int] | None = None  # [start, end) block window
    #                 (multi-host partition; parallel/distributed.py)


class Decompressor:
    def __init__(self, xsi_path: str, opts: DecompressorOptions | None = None):
        self.xsi_path = xsi_path
        self.opts = opts or DecompressorOptions()
        self.xsi = XsiReader(xsi_path)
        self.var_path = xsi_path + XSI_BCF_VAR_EXTENSION
        if not os.path.exists(self.var_path):
            raise FileNotFoundError(self.var_path)
        self.n_samples = self.xsi.n_samples
        self.n_haps = self.xsi.header.hap_samples
        # The genotype matrix is sized for diploid samples regardless of the
        # file max ploidy recorded in the header.
        if self.xsi.header.ploidy == 1:
            self.n_haps = self.n_samples * 2

        self._decoders: dict[int, GtBlockDecoder] = {}
        self._select = self._build_sample_selection()

    # ------------------------------------------------------------- samples
    def _build_sample_selection(self) -> np.ndarray | None:
        opt = self.opts
        names: list[str] = []
        invert = False
        if opt.samples_file:
            with open(opt.samples_file) as f:
                names = [l.strip() for l in f if l.strip()]
            if names and names[0].startswith("^"):
                invert = True
                names[0] = names[0][1:]
        elif opt.samples:
            s = opt.samples
            if s.startswith("^"):
                invert = True
                s = s[1:]
            names = [n for n in s.split(",") if n]
        else:
            return None
        index = {n: i for i, n in enumerate(self.xsi.samples)}
        missing = [n for n in names if n not in index]
        if missing:
            raise ValueError(f"Unknown samples: {','.join(missing)}")
        if invert:
            drop = set(names)
            return np.array([i for n, i in
                             ((n, index[n]) for n in self.xsi.samples)
                             if n not in drop], np.int64)
        return np.array([index[n] for n in names], np.int64)

    @property
    def output_samples(self) -> list[str]:
        # cached: emit paths read this per record (it was the TOP cost of
        # a subsetting extract before caching — 24k list rebuilds)
        out = getattr(self, "_output_samples", None)
        if out is None:
            if self._select is None:
                out = self.xsi.samples
            else:
                out = [self.xsi.samples[i] for i in self._select]
            self._output_samples = out
        return out

    # ------------------------------------------------------------- decode
    def _decoder_for(self, block_id: int) -> GtBlockDecoder:
        dec = self._decoders.get(block_id)
        if dec is None:
            self._decoders.clear()  # keep at most one block resident
            dec = GtBlockDecoder(self.xsi.gt_block_payload(block_id),
                                 self.n_samples, self.n_haps,
                                 aet_dtype=self.xsi.aet_dtype)
            self._decoders[block_id] = dec
        return dec

    def _native_accessor(self):
        """BM-keyed native decode (native/xsi_accessor.cpp) for the
        Python-driver paths (-O v/z, -s, regions): ~9x the per-record
        NumPy decode.  False = probed and unavailable."""
        acc = getattr(self, "_nat_acc", None)
        if acc is None:
            acc = False
            # env-only gate: opts.device selects the DEVICE codec, while
            # this is the host decode engine — device="numpy" callers
            # (avoiding a chip) still want it.  Tests pin the pure-Python
            # decoder via the env (conftest XSI_DEVICE=numpy).
            if (os.environ.get("XSI_NATIVE", "1") not in ("0", "off", "no")
                    and os.environ.get("XSI_DEVICE") not in ("numpy", "jax")):
                try:
                    from ..interop.native import NativeAccessor
                    acc = NativeAccessor(self.xsi_path)
                except Exception:
                    acc = False
            self._nat_acc = acc
        return acc

    def close(self) -> None:
        acc = getattr(self, "_nat_acc", None)
        if acc not in (None, False):
            acc.close()
            # None = may probe again; a sticky False (fallback after a
            # decode failure) must stay False or close() would retrigger
            # the probe/fail/log cycle
            self._nat_acc = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def decode_bm(self, bm: int, n_alleles: int) -> np.ndarray:
        acc = self._native_accessor()
        if acc is not False:
            try:
                return acc.fill_genotypes_bm(bm, n_alleles)
            except Exception as exc:
                # unsupported container (e.g. pre-v4 layout) — fall back
                # to the NumPy decoder for good; say so, a silent 9x
                # slowdown is undebuggable
                import sys
                print(f"xsi: native decode fell back to NumPy: {exc}",
                      file=sys.stderr)
                acc.close()
                self._nat_acc = False
        block_id = (bm & 0xFFFFFFFF) >> BM_BLOCK_BITS
        offset = bm & ((1 << BM_BLOCK_BITS) - 1)
        dec = self._decoder_for(block_id)
        dec.seek(offset)
        return dec.fill_genotype_array_advance(n_alleles)

    def allele_counts_bm(self, bm: int, n_alleles: int) -> np.ndarray:
        acc = self._native_accessor()
        if acc is not False:
            try:
                return acc.fill_allele_counts_bm(bm, n_alleles)
            except Exception as exc:
                import sys
                print(f"xsi: native allele counts fell back to NumPy: {exc}",
                      file=sys.stderr)
                acc.close()
                self._nat_acc = False
        block_id = (bm & 0xFFFFFFFF) >> BM_BLOCK_BITS
        offset = bm & ((1 << BM_BLOCK_BITS) - 1)
        dec = self._decoder_for(block_id)
        dec.seek(offset)
        return dec.fill_allele_counts_advance(n_alleles)

    # ---------------------------------------------------------- batch path
    def _use_device(self) -> bool:
        """Device block decode: compressor.use_device_codec, and in auto
        mode only for blocks big enough to amortize dispatch and transfer
        (XSI_DEVICE=jax forces it)."""
        from .compressor import _device_min_cells, use_device_codec

        device = self.opts.device
        if device == "auto":
            device = os.environ.get("XSI_DEVICE", "auto")
        if not use_device_codec(device):
            return False
        if device == "jax":
            return True
        lines = min(self.xsi.header.ss_rate, self.xsi.header.xcf_entries)
        return lines * self.n_haps >= _device_min_cells()

    def iter_decoded_records(self):
        """Yields (variant_rec, gt) in file order, batching whole blocks on
        device when possible.  Multi-device hosts decode batches of
        consecutive blocks through one shard_map'd program
        (decoder_jax.mesh_decode_all) — block-axis data parallelism on the
        read side, matching the compressor's mesh batching."""
        if not self._use_device():
            for rec, bm in self.iter_variant_records():
                yield rec, self.decode_bm(bm, rec.n_allele)
            return

        from concurrent.futures import ThreadPoolExecutor

        from .decoder_jax import (
            DeviceBlockDecoder,
            decode_block_records,
            mesh_decode_all,
        )

        from ..parallel.shard import local_mesh

        mesh = local_mesh()
        batch_target = int(mesh.devices.size) if mesh is not None else 1

        def decode_batch(groups):
            """groups: [(block_id, [(rec, offset), ...]), ...] consecutive.
            Returns [gts_list_per_group]."""
            devs = []
            for block_id, recs in groups:
                payload = self.xsi.gt_block_payload(block_id)
                devs.append((payload, DeviceBlockDecoder(
                    payload, self.n_samples, self.n_haps,
                    self.xsi.aet_dtype)))
            if mesh is not None:
                # mesh-decode the eligible same-width blocks in one program
                h0 = None
                eligible = []
                for _, d in devs:
                    if d.eligible:
                        if h0 is None:
                            h0 = d.n_eff
                        if d.n_eff == h0:
                            eligible.append(d)
                if len(eligible) > 1:
                    mesh_decode_all(eligible, mesh)
            out = []
            for (payload, d), (block_id, recs) in zip(devs, groups):
                out.append(decode_block_records(
                    payload, self.n_samples, self.n_haps, self.xsi.aet_dtype,
                    [r.n_allele for r, _ in recs],
                    [off for _, off in recs], predecoded=d))
            return out

        pending: list = []        # record groups of the current block
        pending_block = -1
        batch: list = []          # [(block_id, recs)] awaiting decode
        in_flight = None          # (groups, Future[list[gts]])

        def seal_block():
            nonlocal pending
            if pending:
                batch.append((pending_block, pending))
                pending = []

        # 2-stage pipeline: batch k decodes on a worker thread while batch
        # k-1's records are being emitted/written (single worker preserves
        # order).
        with ThreadPoolExecutor(max_workers=1) as executor:
            def flush_batch():
                nonlocal in_flight, batch
                groups, batch = batch, []
                prev = in_flight
                in_flight = (groups, executor.submit(decode_batch, groups))
                return prev

            for rec, bm in self.iter_variant_records():
                block_id = (bm & 0xFFFFFFFF) >> BM_BLOCK_BITS
                if block_id != pending_block:
                    seal_block()
                    pending_block = block_id
                    if len(batch) >= batch_target:
                        prev = flush_batch()
                        if prev is not None:
                            for (_, recs), gts in zip(prev[0],
                                                      prev[1].result()):
                                yield from zip((r for r, _ in recs), gts)
                pending.append((rec, bm & ((1 << BM_BLOCK_BITS) - 1)))

            seal_block()
            if batch:
                prev = flush_batch()
                if prev is not None:
                    for (_, recs), gts in zip(prev[0], prev[1].result()):
                        yield from zip((r for r, _ in recs), gts)
            if in_flight is not None:
                for (_, recs), gts in zip(in_flight[0],
                                          in_flight[1].result()):
                    yield from zip((r for r, _ in recs), gts)

    # ------------------------------------------------------------ records
    def _region_chunks(self, reader: BcfReader,
                       regions: list[Region]) -> list[tuple[int, int]] | None:
        """CSI-indexed chunk ranges covering `regions`, or None when no
        index is available (reference parity: region queries seek through
        the variant file's .csi, xcf.cpp initialize_bcf_file_reader_with_region)."""
        idx_path = self.var_path + ".csi"
        if not os.path.exists(idx_path):
            return None
        from ..io.csi import CsiIndex
        idx = CsiIndex.load(idx_path)
        contigs = reader.header.dict_contigs
        chunks: list[tuple[int, int]] = []
        for r in regions:
            if r.chrom not in contigs:
                continue
            rid = contigs.index(r.chrom)
            beg0 = (r.start - 1) if r.start else 0
            end0 = r.end if r.end is not None else (1 << 31) - 1
            chunks.extend(idx.query(rid, beg0, max(end0, beg0 + 1)))
        chunks.sort()
        merged: list[tuple[int, int]] = []
        for cb, ce in chunks:
            if merged and cb <= merged[-1][1]:
                if ce > merged[-1][1]:
                    merged[-1] = (merged[-1][0], ce)
            else:
                merged.append((cb, ce))
        return merged

    def _iter_reader_records(self, reader: BcfReader, regions):
        """Iterate variant records; seek via the CSI index when regions are
        given and an index exists, else stream linearly."""
        chunks = self._region_chunks(reader, regions) if regions else None
        if chunks is None:
            yield from reader
            return
        for cb, ce in chunks:
            reader.seek_virtual(cb)
            while reader.tell_virtual() < ce:
                rec = reader.read_record()
                if rec is None:
                    break
                yield rec

    def iter_variant_records(self):
        """Yields (rec, bm, chrom, keep) over the variant file."""
        reader = BcfReader(self.var_path)
        self.var_header = reader.header
        regions = parse_region_list(self.opts.regions) if self.opts.regions else None
        targets = parse_region_list(self.opts.targets) if self.opts.targets else None
        for rec in self._iter_reader_records(reader, regions):
            bm = None
            for key, t, per, vals in rec.format_fields():
                if reader.header.dict_strings[key] == "BM":
                    bm = int(np.asarray(vals)[0])
                    break
            if bm is None:
                raise ValueError("Variant record without BM field")
            if self.opts.block_range is not None:
                blk = (bm & 0xFFFFFFFF) >> BM_BLOCK_BITS
                if not (self.opts.block_range[0] <= blk
                        < self.opts.block_range[1]):
                    continue
            if regions is not None or targets is not None:
                chrom = (reader.header.dict_contigs[rec.rid]
                         if rec.rid < len(reader.header.dict_contigs) else "")
                pos1 = rec.pos + 1
                if regions is not None and not any(
                        r.overlaps(chrom, pos1, rec.rlen) for r in regions):
                    continue
                if targets is not None and not any(
                        r.targets(chrom, pos1) for r in targets):
                    continue
            yield rec, bm
        reader.close()

    def output_header(self) -> BcfHeader:
        """Output header: the variant header with samples restored and the
        XSI bookkeeping lines removed."""
        reader = BcfReader(self.var_path)
        h = reader.header
        reader.close()
        out = BcfHeader.from_text(h.to_text())
        out.lines = [l for l in out.lines if not l.startswith("##XSI=")]
        out.samples = self.output_samples
        out.dict_strings = h.dict_strings
        out.str2idx = h.str2idx
        out.dict_contigs = h.dict_contigs
        out.contig2idx = h.contig2idx
        # Drop the BM pseudo-format declaration (reference parity: plain
        # extraction removes it, gt_decompressor_new.hpp:506-507; -O x
        # re-adds it via make_variant_header).  Safe only as the TRAILING
        # dictionary entry (make_variant_header appends it last at
        # compress time): popping it shifts no other index, and output
        # records never reference BM (extraction emits GT only).
        if out.dict_strings and out.dict_strings[-1] == "BM":
            out.lines = [l for l in out.lines
                         if not (l.startswith("##FORMAT=")
                                 and re.search(r"[<,]ID=BM[,>]", l))]
            out.dict_strings = out.dict_strings[:-1]
            out.str2idx = {s: i for i, s in enumerate(out.dict_strings)}
            out.format_meta.pop("BM", None)
        return out

    # AC/AN are recomputed on sample subsetting (reference parity:
    # gt_decompressor_new.hpp:324-365, like bcftools); both tags must be
    # declared in the output header BEFORE it is serialized — a late
    # ensure_string would write records carrying INFO keys the on-disk
    # header lacks (the htslib-side invariant the reference gets from
    # bcf_update_info_int32 refusing undeclared tags,
    # gt_decompressor_new.hpp:251-252).
    _ACAN_DECLS = (
        ("AC", '##INFO=<ID=AC,Number=A,Type=Integer,Description='
               '"Allele count in genotypes, for each ALT allele, in the '
               'same order as listed">'),
        ("AN", '##INFO=<ID=AN,Number=1,Type=Integer,Description='
               '"Total number of alleles in called genotypes">'),
    )

    def _declare_subset_tags(self, header: BcfHeader) -> None:
        if self._select is None:
            return
        for ident, line in self._ACAN_DECLS:
            header.ensure_string(ident, line)

    def _subset_gt(self, gt: np.ndarray, ploidy: int) -> np.ndarray:
        if self._select is None:
            return gt
        view = gt.reshape(self.n_samples, ploidy)
        return view[self._select].reshape(-1)

    def _line_ploidy(self, gt_len: int) -> int:
        return gt_len // self.n_samples

    @staticmethod
    def _recompute_ac_an(gt: np.ndarray, n_alleles: int) -> tuple[list[int], int]:
        alleles = (gt >> 1) - 1
        valid = alleles >= 0
        counts = np.bincount(alleles[valid], minlength=n_alleles)
        return [int(c) for c in counts[1:n_alleles]], int(valid.sum())

    # ------------------------------------------------------------- drivers
    def decompress(self, output_path: str) -> dict:
        ot = self.opts.output_type
        if ot == "x":
            return self._decompress_to_xsi(output_path)
        if ot in ("b", "u"):
            # "u": uncompressed BCF (BGZF framing at level 0), the -p fast
            # pipe format for downstream bcftools (README.md:202-218)
            return self._decompress_to_bcf(output_path,
                                           level=0 if ot == "u" else 6)
        return self._decompress_to_vcf(output_path, compress=(ot == "z"))

    def _emit_stats(self, n):
        return {"records": n, "samples": len(self.output_samples)}

    def _decompress_to_vcf(self, output_path: str, compress: bool) -> dict:
        header = self.output_header()
        self._declare_subset_tags(header)
        writer = VcfWriter(output_path, header.lines, self.output_samples,
                           compress=compress, no_header=self.opts.no_header)
        n = 0
        for rec, gt in self.iter_decoded_records():
            ploidy = self._line_ploidy(gt.shape[0])
            gt = self._subset_gt(gt, ploidy)
            cols = render_vcf_cols(self.var_header, rec)
            if self._select is not None:
                cols[7] = self._patch_info_ac_an(cols[7], gt, rec.n_allele)
            writer.write_record(cols, gt, ploidy)
            n += 1
        writer.close()
        return self._emit_stats(n)

    @staticmethod
    def _patch_info_ac_an(info: str, gt: np.ndarray, n_alleles: int) -> str:
        ac, an = Decompressor._recompute_ac_an(gt, n_alleles)
        items = [] if info in (".", "") else info.split(";")
        out = []
        seen_ac = seen_an = False
        for item in items:
            if item.startswith("AC="):
                out.append("AC=" + ",".join(map(str, ac)))
                seen_ac = True
            elif item.startswith("AN="):
                out.append(f"AN={an}")
                seen_an = True
            else:
                out.append(item)
        if not seen_ac and ac:
            out.append("AC=" + ",".join(map(str, ac)))
        if not seen_an:
            out.append(f"AN={an}")
        return ";".join(out) if out else "."

    def _can_extract_native(self, output_path, write_header: bool,
                            write_eof: bool) -> bool:
        """The native extract loop covers full-sample-set BCF output to a
        plain path (header + EOF), unfiltered or region/target-restricted
        (the CSI chunk lookup stays in Python; the C loop seeks the chunk
        voffsets and applies the same overlap rules)."""
        o = self.opts
        if not (isinstance(output_path, str) and output_path != "-"
                and self._select is None
                and o.block_range is None and write_header and write_eof):
            return False
        if o.device != "auto" or os.environ.get("XSI_DEVICE") in (
                "numpy", "jax"):
            # an explicit codec selection (numpy debug path or forced
            # device decode) must route through that path, not the native
            # loop — tests and benches rely on exercising each
            return False
        if self._use_device():
            # auto mode on a GPU: the device decodes the blocks
            return False
        if os.environ.get("XSI_NATIVE", "1") in ("0", "off", "no"):
            return False
        try:
            from ..interop.native import build_native
            build_native()
            return True
        except Exception:
            return False

    def _decompress_to_bcf_native(self, output_path: str, level: int) -> dict:
        from ..interop.native import native_extract, native_extract_ranges

        header = self.output_header()
        gt_key = header.ensure_string(
            "GT",
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
        text = header.to_text().encode() + b"\0"
        o = self.opts
        if not o.regions and not o.targets:
            n = native_extract(self.xsi_path, output_path, text, gt_key,
                               level)
            return self._emit_stats(n)

        # Region/target extract: resolve chrom names + CSI chunks here,
        # hand the C loop pre-computed voffsets and filter triplets.
        reader = BcfReader(self.var_path)
        contigs = reader.header.dict_contigs
        LO, HI = -(1 << 62), 1 << 62

        regions = parse_region_list(o.regions) if o.regions else None
        reg_t = ([(contigs.index(r.chrom) if r.chrom in contigs else -1,
                   r.start if r.start is not None else LO,
                   r.end if r.end is not None else HI)
                  for r in regions] if regions else None)
        tgt_t = None
        if o.targets:
            tgt_t = [(contigs.index(r.chrom) if r.chrom in contigs else -1,
                      r.start if r.start is not None else LO,
                      r.end if r.end is not None else HI)
                     for r in parse_region_list(o.targets)]
        chunks = self._region_chunks(reader, regions) if regions else None
        reader.close()
        if chunks is not None and not chunks:
            chunks = [(0, 0)]   # indexed, nothing overlaps: emit no records
        n = native_extract_ranges(self.xsi_path, output_path, text, gt_key,
                                  level, chunks=chunks, regions=reg_t,
                                  targets=tgt_t)
        return self._emit_stats(n)

    def _decompress_to_bcf(self, output_path, level: int = 6,
                           write_header: bool = True,
                           write_eof: bool = True) -> dict:
        """output_path: path or file object.  write_header/write_eof=False
        emit a records-only BGZF body segment (multi-host partition;
        segments concatenate into one valid BCF)."""
        if self._can_extract_native(output_path, write_header, write_eof):
            return self._decompress_to_bcf_native(output_path, level)
        header = self.output_header()
        self._declare_subset_tags(header)
        header.ensure_string(
            "GT",
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
        n_out = len(self.output_samples)
        # Parallel BGZF deflate: block compression is the reference's own
        # dominant decompress cost (>60% bcf_write1,
        # gt_decompressor_new.hpp:315); the output writer never calls
        # tell_virtual, so the threaded pipeline stays fully async.
        writer = BcfWriter(output_path, header, level=level,
                           threads=min(os.cpu_count() or 1, 8),
                           write_header=write_header)
        n = 0
        for rec, gt in self.iter_decoded_records():
            ploidy = self._line_ploidy(gt.shape[0])
            gt = self._subset_gt(gt, ploidy)
            shared = patch_shared_sample_counts(rec.shared, 1, n_out)
            if self._select is not None:
                shared = self._patch_shared_ac_an(shared, gt, rec.n_allele,
                                                  header)
            indiv = encode_gt_indiv(header, gt, ploidy, n_out)
            writer.write_raw(shared, indiv, want_offsets=False)
            n += 1
        writer._f.finish(write_eof=write_eof)
        writer.close()
        return self._emit_stats(n)

    def _patch_shared_ac_an(self, shared: bytes, gt: np.ndarray,
                            n_alleles: int, out_header: BcfHeader) -> bytes:
        # Re-encode the whole site from text for simplicity on the subset
        # path.  Decode with the variant file's header (the record's dict
        # indices live there); RE-encode against the OUTPUT header, whose
        # dictionary — including the pre-declared AC/AN — is what the
        # on-disk header actually declares.  Both derive from the same
        # variant-file text, so pre-existing indices coincide.
        from ..io.sites import encode_shared_from_vcf_cols
        from ..io.bcf import BcfRecord
        rec = BcfRecord.parse(shared, b"")
        rec._header = self.var_header
        cols = render_vcf_cols(self.var_header, rec)
        cols[7] = self._patch_info_ac_an(cols[7], gt, n_alleles)
        return encode_shared_from_vcf_cols(out_header, cols, 1,
                                           len(self.output_samples))

    def _recompress_options(self):
        """Carry over the source's rare/common split: the header stores
        the MAC threshold (rare_threshold = n_haps * maf); +0.5 keeps
        int(n_haps * maf) == rare_threshold under float rounding when the
        sample set is unchanged."""
        from .compressor import CompressorOptions

        maf = (self.xsi.header.rare_threshold + 0.5) / max(self.n_haps, 1)
        return CompressorOptions(maf=maf, zstd=self.xsi.header.zstd,
                                 block_length=self.xsi.header.ss_rate)

    def _decompress_to_xsi(self, output_path: str) -> dict:
        """Re-compress (possibly subset/filtered) into a fresh XSI with the
        BM rewrite INSIDE the decode loop — no intermediate BCF on disk
        (the reference streams the same way:
        gt_decompressor_new.hpp:241-273, 432-543 re-encode each decoded
        record into a fresh XsiFactory).  Bytes are identical to the
        decode->BCF->compress detour (pinned by tests); XSI_FUSED_RECOMPRESS=0
        reverts to the detour."""
        if os.environ.get("XSI_FUSED_RECOMPRESS", "1") in ("0", "off", "no"):
            return self._decompress_to_xsi_via_bcf(output_path)
        import struct
        from collections import deque
        from itertools import chain

        from ..format.constants import (
            BM_BLOCK_BITS as _BMB,
            WeirdnessStrategy,
            XSI_BCF_VAR_EXTENSION,
        )
        from ..format.container import XsiWriter
        from ..format.header import XsiHeader
        from ..io.csi import CsiBuilder, depth_for_max_len
        from ..io.sites import encode_bm_indiv
        from .compressor import (
            BlockEncodeDispatcher,
            _device_encoder_cls,
            make_variant_header,
        )

        opts = self._recompress_options()
        n_out = len(self.output_samples)
        n_haps_out = n_out * 2    # A_T selection assumes diploid (ref parity)
        mac_threshold = int(n_haps_out * opts.maf)
        aet_dtype = np.uint16 if n_haps_out <= 0xFFFF else np.uint32

        # Buffer the lead records to sniff phasedness / first-entry ploidy
        # exactly as compress_file's sniffers would on the intermediate BCF
        # (io.unified.sniff_default_phased: majority phase bit of the
        # second slot over the first 3 records, 0 on any haploid record).
        stream = self.iter_decoded_records()
        lead: list = []
        for item in stream:
            lead.append(item)
            if len(lead) >= 3:
                break
        if not lead:
            # empty selection: the detour raises exactly as compressing an
            # empty BCF would — keep that behavior
            return self._decompress_to_xsi_via_bcf(output_path)

        def out_ploidy(gt):
            return self._line_ploidy(gt.shape[0])

        counts = [0, 0]
        default_phased = None
        for rec, gt in lead:
            p = out_ploidy(gt)
            if p == 1:
                default_phased = 0
                break
            gt_s = self._subset_gt(gt, p)
            second = gt_s.reshape(-1, p)[:, 1]
            phased = int((second & 1).sum())
            counts[1] += phased
            counts[0] += second.shape[0] - phased
        if default_phased is None:
            default_phased = 1 if counts[1] >= counts[0] else 0
        max_ploidy = out_ploidy(lead[0][1])

        header = XsiHeader(
            version=5, ind_bytes=4,
            aet_bytes=np.dtype(aet_dtype).itemsize, wah_bytes=2,
            iota_ppa=True, no_sort=False,
            default_phased=bool(default_phased),
            ss_rate=opts.block_length, rare_threshold=mac_threshold)
        xsi = XsiWriter(output_path, header, self.output_samples,
                        zstd_on=opts.zstd, zstd_level=opts.zstd_level)
        var_path = output_path + XSI_BCF_VAR_EXTENSION
        out_hdr = self.output_header()
        self._declare_subset_tags(out_hdr)   # before the header hits disk
        var_header = make_variant_header(out_hdr,
                                         os.path.basename(output_path))
        var_writer = BcfWriter(var_path, var_header)
        csi = CsiBuilder(depth=depth_for_max_len(
            max(var_header.contig_lengths.values(), default=0)))
        block = BlockEncodeDispatcher(
            n_out, opts.block_length, mac_threshold,
            default_phasing=default_phased, aet_dtype=aet_dtype,
            weirdness_strategy=WeirdnessStrategy.WS_SPARSE,
            device_cls=_device_encoder_cls(opts.device),
            force_device=(opts.device == "jax"
                          or os.environ.get("XSI_DEVICE") == "jax"))
        entry_counter = variant_counter = 0
        bm_block = bm_offset = 0
        pending: deque = deque()
        try:
            for rec, gt in chain(lead, stream):
                ploidy = out_ploidy(gt)
                max_ploidy = max(max_ploidy, ploidy)
                gt = self._subset_gt(gt, ploidy)
                if entry_counter and entry_counter % opts.block_length == 0:
                    bm_block += 1
                    bm_offset = 0
                if bm_offset >> _BMB:
                    raise ValueError(
                        f"BM offset cannot be represented on {_BMB} bits")
                bm = (bm_block << _BMB) | bm_offset
                shared = patch_shared_sample_counts(rec.shared, 1, n_out)
                if self._select is not None:
                    shared = self._patch_shared_ac_an(shared, gt,
                                                      rec.n_allele,
                                                      var_header)
                shared = patch_shared_sample_counts(shared, 1, 1)
                vbeg, vend = var_writer.write_raw(
                    shared, encode_bm_indiv(var_header, bm))
                rid, pos0, rlen = struct.unpack_from("<iii", shared, 0)
                csi.add(rid, pos0, pos0 + max(rlen, 1), vbeg, vend)

                if block.full:
                    pending.append(block.submit())
                    while pending and pending[0].done():
                        xsi.write_block(pending.popleft().result())
                    while len(pending) > block.inflight_target:
                        if not pending[0].done():
                            block.flush()
                        xsi.write_block(pending.popleft().result())
                block.encode_record(gt, rec.n_allele)

                bm_offset += rec.n_allele - 1
                variant_counter += rec.n_allele - 1
                entry_counter += 1

            block.flush()
            while pending:
                xsi.write_block(pending.popleft().result())
            if block.bcf_lines:
                xsi.write_block(block.serialize())
            xsi.finalize(num_variants=variant_counter,
                         xcf_entries=entry_counter, max_ploidy=max_ploidy)
            var_writer.close()
            csi.write(var_path + ".csi",
                      n_ref=len(var_header.dict_contigs))
        except BaseException:
            block.shutdown()
            for f in (getattr(xsi, "f", None), getattr(var_writer, "_f",
                                                       None)):
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
            block.shutdown()
        return {
            "entries": entry_counter,
            "variants": variant_counter,
            "n_samples": n_out,
            "xsi_bytes": os.path.getsize(output_path),
            "variant_bytes": os.path.getsize(var_path),
        }

    def _decompress_to_xsi_via_bcf(self, output_path: str) -> dict:
        """Legacy detour: decode to an intermediate BCF on disk, then
        compress it (kept as the fused path's equality oracle and for
        XSI_FUSED_RECOMPRESS=0)."""
        from .compressor import compress_file
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            tmp = os.path.join(td, "recompress.bcf")
            self._decompress_to_bcf(tmp)
            return compress_file(tmp, output_path, self._recompress_options())
