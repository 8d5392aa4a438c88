"""Random-access Accessor API.

Python counterpart of the reference's `Accessor` class
(/root/reference/include/accessor.hpp): open a `.xsi` file, then fill
genotype arrays / allele counts for arbitrary records addressed by their
FORMAT/BM value (block << 15 | offset), or expose the raw compressed forms
for compressive computation (dot products over WAH/sparse without decoding).

Typical third-party integration (the SHAPEIT4 pattern):

    acc = Accessor("file.xsi")
    for rec in BcfReader(acc.variant_filename()):
        gt = acc.get_genotypes(rec)          # htslib-style int32 array
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .format.constants import BM_BLOCK_BITS, XSI_BCF_VAR_EXTENSION
from .format.container import XsiReader
from .codec.gt_block_decoder import GtBlockDecoder


@dataclass
class InternalGtAccess:
    """Raw compressed forms of one record (compressive-computation hook).

    Mirrors the reference's InternalGtAccess
    (accessor_internals.hpp:374-397): per binary line either a WAH word
    stream slice or a sparse index slice, plus the arrangement `a` the line
    was encoded under.
    """
    position: int
    n_alleles: int
    default_allele: int
    a: np.ndarray                   # arrangement before the first line
    sparse: list[bool]              # per binary line
    pointers: list[np.ndarray]      # WAH words or sparse stream slice
    wah_bytes: int = 2

    @property
    def a_bytes(self) -> int:
        return self.a.dtype.itemsize


class Accessor:
    def __init__(self, path: str):
        self.path = path
        self.xsi = XsiReader(path)
        self.n_samples = self.xsi.n_samples
        self.n_haps = (self.n_samples * 2 if self.xsi.header.ploidy != 1
                       else self.n_samples * 2)
        self._decoders: dict[int, GtBlockDecoder] = {}
        self._device: bool | None = None     # device codec on (lazy)
        self._dev_block: tuple | None = None  # (block id, decoded block)

    # -------------------------------------------------------------- naming
    def variant_filename(self) -> str:
        return self.path + XSI_BCF_VAR_EXTENSION

    @staticmethod
    def xsi_filename_from_variant(var_path: str) -> str:
        if var_path.endswith(XSI_BCF_VAR_EXTENSION):
            return var_path[: -len(XSI_BCF_VAR_EXTENSION)]
        raise ValueError(f"not a variant file name: {var_path}")

    # ------------------------------------------------------------- samples
    def get_sample_list(self) -> list[str]:
        return self.xsi.samples

    # -------------------------------------------------------------- decode
    def _decoder(self, block_id: int) -> GtBlockDecoder:
        dec = self._decoders.get(block_id)
        if dec is None:
            if len(self._decoders) > 2:
                self._decoders.clear()
            dec = GtBlockDecoder(self.xsi.gt_block_payload(block_id),
                                 self.n_samples, self.n_haps,
                                 aet_dtype=self.xsi.aet_dtype)
            self._decoders[block_id] = dec
        return dec

    @staticmethod
    def split_bm(bm: int) -> tuple[int, int]:
        return ((bm & 0xFFFFFFFF) >> BM_BLOCK_BITS,
                bm & ((1 << BM_BLOCK_BITS) - 1))

    def position_from_bm_entry(self, rec) -> int:
        """Extract FORMAT/BM from a variant-file record (io.bcf.BcfRecord)."""
        for key, t, per, vals in rec.format_fields():
            if rec._header.dict_strings[key] == "BM":
                return int(np.asarray(vals)[0])
        raise ValueError("record has no FORMAT/BM")

    def _device_block(self, block_id: int):
        """The block decoded whole on the device (codec.decoder_jax), or
        None where the host decoder answers: the device codec is off
        (compressor.use_device_codec), or the block has exception tracks
        or mixed ploidy, whose overlays replay sequentially on the host."""
        if self._device is None:
            from .codec.compressor import use_device_codec
            self._device = use_device_codec()
        if not self._device:
            return None
        if self._dev_block is None or self._dev_block[0] != block_id:
            from .codec import BLOCK_COUNTS
            from .codec.decoder_jax import DeviceBlockDecoder
            dev = DeviceBlockDecoder(self.xsi.gt_block_payload(block_id),
                                     self.n_samples, self.n_haps,
                                     self.xsi.aet_dtype)
            if dev.eligible and not dev.meta.has_weirdness:
                dev.decode_all()
                BLOCK_COUNTS["decode_device"] += 1
            else:
                dev = None
            self._dev_block = (block_id, dev)
        return self._dev_block[1]

    def fill_genotype_array(self, bm: int, n_alleles: int) -> np.ndarray:
        block_id, offset = self.split_bm(bm)
        dev = self._device_block(block_id)
        if dev is not None:
            return dev.record_gt(offset, n_alleles)
        dec = self._decoder(block_id)
        dec.seek(offset)
        return dec.fill_genotype_array_advance(n_alleles)

    def _native(self):
        """Native count-only engine (native/xsi_accessor.cpp), lazily
        probed; False = unavailable.  Same env gate as the decompressor's
        native accessor: XSI_NATIVE=0 or a pinned XSI_DEVICE selects the
        pure-Python paths (tests pin XSI_DEVICE=numpy)."""
        import os

        acc = getattr(self, "_nat_acc", None)
        if acc is None:
            acc = False
            if (os.environ.get("XSI_NATIVE", "1") not in ("0", "off", "no")
                    and os.environ.get("XSI_DEVICE") not in ("numpy", "jax")):
                try:
                    from .interop.native import NativeAccessor
                    acc = NativeAccessor(self.path)
                except Exception:
                    acc = False
            self._nat_acc = acc
        return acc

    def close(self) -> None:
        acc = getattr(self, "_nat_acc", None)
        if acc not in (None, False):
            acc.close()
            self._nat_acc = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def fill_allele_counts(self, bm: int, n_alleles: int) -> np.ndarray:
        """AC per allele without materializing genotypes.  Native fast
        path: WAH popcount / sparse lengths straight off the compressed
        forms (xsi_fill_allele_counts_bm; reference count-only path
        accessor_internals_new.hpp:407-438) — the whole point of af_stats.
        Falls back to the NumPy block decoder permanently on error."""
        acc = self._native()
        if acc is not False:
            try:
                return acc.fill_allele_counts_bm(bm, n_alleles)
            except Exception as exc:
                import sys
                print(f"xsi: native allele counts fell back to NumPy: {exc}",
                      file=sys.stderr)
                acc.close()
                self._nat_acc = False
        block_id, offset = self.split_bm(bm)
        dec = self._decoder(block_id)
        dec.seek(offset)
        return dec.fill_allele_counts_advance(n_alleles)

    def fill_allele_counts_range(self, bms, n_alleles) -> "np.ndarray":
        """Batched AC for many records in ONE native crossing
        (xsi_count_alleles_range: sparse heads + WAH run-word popcounts,
        O(stream words) per record, no gt arrays, no PBWT upkeep — the
        af_stats walk; reference accessor_internals_new.hpp:407-438).
        Returns flat int64 counts back-to-back (sum of n_alleles entries);
        falls back to the per-record path permanently on error."""
        acc = self._native()
        if acc is not False:
            try:
                return acc.count_alleles_range(bms, n_alleles)
            except Exception as exc:
                import sys
                print(f"xsi: native batched allele counts fell back: {exc}",
                      file=sys.stderr)
                acc.close()
                self._nat_acc = False
        return np.concatenate(
            [self.fill_allele_counts(int(bm), int(na))
             for bm, na in zip(bms, n_alleles)]) if len(bms) else \
            np.zeros(0, np.int64)

    def get_genotypes(self, rec) -> np.ndarray:
        """htslib bcf_get_genotypes-shaped convenience wrapper."""
        return self.fill_genotype_array(self.position_from_bm_entry(rec),
                                        rec.n_allele)

    def get_allele_counts(self, rec) -> np.ndarray:
        return self.fill_allele_counts(self.position_from_bm_entry(rec),
                                       rec.n_allele)

    # ------------------------------------------- compressive-compute access
    def get_internal_access(self, bm: int, n_alleles: int) -> InternalGtAccess:
        block_id, offset = self.split_bm(bm)
        dec = self._decoder(block_id)
        dec.seek(offset)
        msb = 1 << (dec.aet_dtype.itemsize * 8 - 1)
        sparse_flags: list[bool] = []
        pointers: list[np.ndarray] = []
        default_allele = 0
        a_snapshot = dec.a.copy()
        for i in range(max(n_alleles - 1, 0)):
            pos = offset + i
            dec.seek(pos)
            if dec.line_is_wah[pos]:
                sparse_flags.append(False)
                pointers.append(dec.wah_stream[dec.wah_pos:])
            else:
                sparse_flags.append(True)
                head = int(dec.sparse_stream[dec.sparse_pos])
                if i == 0 and (head & msb):
                    default_allele = 1
                pointers.append(dec.sparse_stream[dec.sparse_pos:])
            if i == 0:
                a_snapshot = dec.a.copy()
        return InternalGtAccess(
            position=offset, n_alleles=n_alleles,
            default_allele=default_allele, a=a_snapshot,
            sparse=sparse_flags, pointers=pointers)
