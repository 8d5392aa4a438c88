"""Block-encoder base: record buffering, line expansion, payload assembly.

Shared, jax-free machinery of the fast block encoders.  The compute core
is supplied by subclasses: DeviceBlockEncoder (codec/encoder_jax, the TPU
pipeline) and NumpyBlockEncoder (codec/encoder_np, the vectorized host
pipeline) produce the same `out` dict and both assemble through here, so
payload bytes are identical across all three encoders (the per-record
GtBlockEncoder is the oracle, pinned by tests/test_encoder_jax.py and the
golden-byte suite).
"""
from __future__ import annotations

import os

import numpy as np

from ..format.constants import (
    GTDict,
    INT32_MISSING,
    INT32_VECTOR_END,
    WeirdnessStrategy,
)
from ..format.dictionary import write_dictionary
from ..ops import wah_np

MISSING_CODE = -1
EOV_CODE = -2

_NAT_INGEST: object = 0   # 0 = unprobed, None = unavailable, else the fn


def _native_ingest_fn():
    """The one-pass C ingest for the batch path, gated like the other
    native-encode surfaces (XSI_NATIVE_ENCODE; an explicit XSI_DEVICE
    selection pins pure Python/device paths for tests)."""
    global _NAT_INGEST
    if _NAT_INGEST == 0:
        fn = None
        if (os.environ.get("XSI_NATIVE_ENCODE", "1") not in ("0", "off", "no")
                and os.environ.get("XSI_DEVICE") not in ("numpy", "jax")):
            try:
                from ..interop.native import build_native, ingest_codes_native
                build_native()
                fn = ingest_codes_native
            except Exception:
                fn = None
        _NAT_INGEST = fn
    return _NAT_INGEST


def alleles_from_gt(gt_block: np.ndarray, n_alleles: int | None = None
                    ) -> np.ndarray:
    """htslib int32 gt rows -> compact allele codes (missing -1, EOV -2).

    Written with in-place masking rather than an np.where chain: on a
    whole block this runs over tens of MB and the chain's five fresh
    temporaries made first-touch page faults the top cost of the host
    encode (see utils/malltune.py for the allocator half of the fix).
    The block encoders call this per record at encode_record time (rows
    are L1/L2-resident right after parse); the block form exists for the
    mesh driver and tests.

    With `n_alleles` <= 127 the codes fit int8 (codes are -3..n_alleles-1),
    halving block-stack memory traffic AND the host->device transfer of
    the block matrix; otherwise int16.  Narrow truncation of the special
    int32 sentinels is harmless — their slots are overwritten by the
    masks computed on the original values."""
    gt = np.asarray(gt_block, np.int32)
    shifted = gt >> 1
    dtype = np.int8 if n_alleles is not None and n_alleles <= 127 else np.int16
    out = shifted.astype(dtype)
    out -= 1
    out[shifted == 0] = MISSING_CODE
    out[gt == np.int32(INT32_MISSING)] = MISSING_CODE
    out[gt == np.int32(INT32_VECTOR_END)] = EOV_CODE
    return out


class BlockEncoderBase:
    """Buffers records, expands them to binary lines and assembles the
    byte-exact GT block payload from a core's outputs."""

    # Subclasses with a device path set this; the host encoder batches its
    # exception tracks with numpy instead.
    use_device_tracks = False

    def __init__(self, n_samples: int, block_bcf_lines: int, mac_threshold: int,
                 default_phasing: int = 0, aet_dtype=np.uint32,
                 weirdness_strategy: int = WeirdnessStrategy.WS_SPARSE):
        self.n_samples = n_samples
        self.n_haps = n_samples * 2
        self.block_bcf_lines = block_bcf_lines
        self.mac_threshold = mac_threshold
        self.default_phasing = int(default_phasing)
        self.aet_dtype = np.dtype(aet_dtype)
        self.weirdness_strategy = weirdness_strategy
        self._allele_rows: list[np.ndarray] = []   # int8/int16 codes per rec
        self._nup_flagged: dict[int, np.ndarray] = {}  # rec -> phase bools
        self._n_alleles: list[int] = []
        self._alt_counts: list[np.ndarray] = []    # carrier count per ALT
        # Exception-track stats taken per record at encode time (the row is
        # cache-resident): serialize() never re-scans the block matrix for
        # flags, and the device track encode gets its static capacity from
        # the maxima.
        self._n_missing: list[int] = []
        self._n_eov: list[int] = []

    @property
    def bcf_lines(self) -> int:
        return len(self._n_alleles)

    @property
    def full(self) -> bool:
        return self.bcf_lines >= self.block_bcf_lines

    def eligible(self, ploidy: int) -> bool:
        return ploidy == 2

    def encode_record(self, gt: np.ndarray, n_alleles: int) -> None:
        assert gt.shape[0] in (self.n_haps, self.n_samples), \
            "block path requires uniformly diploid or uniformly haploid rows"
        gt = np.asarray(gt, np.int32)
        # Convert NOW, while the freshly-parsed row is cache-resident:
        # deferring to serialize() re-streams the whole block (hundreds of
        # MB) through DRAM for work that is a few fused passes per row.
        codes = alleles_from_gt(gt, n_alleles)
        self._allele_rows.append(codes)
        # Exception stats on the resident row: one reduction when clean,
        # two counts when specials are present (rare by construction).
        if int(codes.min(initial=0)) < 0:
            self._n_missing.append(
                int(np.count_nonzero(codes == MISSING_CODE)))
            self._n_eov.append(int(np.count_nonzero(codes == EOV_CODE)))
        else:
            self._n_missing.append(0)
            self._n_eov.append(0)
        # Per-ALT carrier counts, one more pass over the L1-resident row:
        # they make is_wah/negated host-known at serialize time, so the
        # device chain runs only over the WAH rows (prepare() wah_rows).
        # Counts over ALL slots incl. specials' (negative codes never hit
        # an ALT bucket) — mac = min(ac, len - ac) matches GtBlockEncoder.
        if n_alleles == 2:
            self._alt_counts.append(
                np.array([np.count_nonzero(codes == 1)], np.int64))
        elif n_alleles <= 1:
            self._alt_counts.append(np.zeros(0, np.int64))
        else:
            self._alt_counts.append(np.bincount(
                np.maximum(codes, 0), minlength=n_alleles
            )[1:n_alleles].astype(np.int64))
        if gt.shape[0] != self.n_samples or self.n_samples == self.n_haps:
            second = self._second_slot_mask(gt.shape[0])
            # phase applies only to non-first slots; specials included
            # (reference parity).  Haploid records (single-slot samples)
            # carry no phase bit and are never flagged.
            nup = second & ((gt & 1) != self.default_phasing)
            if nup.any():
                self._nup_flagged[len(self._n_alleles)] = nup
        self._n_alleles.append(n_alleles)

    def encode_records(self, gt_all: np.ndarray, offs: np.ndarray,
                       na: np.ndarray, lo: int, hi: int) -> None:
        """Batched encode_record over parse-segment records [lo, hi):
        record i occupies gt_all[offs[i]:offs[i+1]] with na[i] alleles.

        The per-record ingest (allele-code conversion + exception/ALT/
        phase stats) runs as a handful of whole-matrix numpy passes
        instead of ~6 numpy dispatches per record — the host-side cost
        that dominated exception-heavy blocks on the device path.
        Appended state is identical to n encode_record calls (payload
        bytes pinned by tests)."""
        offs = np.asarray(offs, np.int64)
        widths = np.diff(offs[lo:hi + 1])
        start = lo
        while start < hi:
            w = int(widths[start - lo])
            end = start + 1
            while end < hi and widths[end - lo] == w:
                end += 1
            if w in (self.n_haps, self.n_samples):
                self._encode_uniform_batch(gt_all, offs, na, start, end, w)
            else:
                for i in range(start, end):   # scalar path owns the assert
                    self.encode_record(gt_all[offs[i]:offs[i + 1]],
                                       int(na[i]))
            start = end

    def _encode_uniform_batch(self, gt_all, offs, na, lo, hi, W) -> None:
        n = hi - lo
        gt_mat = np.asarray(
            gt_all[offs[lo]:offs[hi]], np.int32).reshape(n, W)
        na_arr = np.asarray(na[lo:hi], np.int64)
        base = len(self._n_alleles)
        check_phase = (W != self.n_samples or self.n_samples == self.n_haps)
        nat = (_native_ingest_fn() if na_arr.max(initial=2) <= 127
               else None)
        if nat is not None:
            # ONE streaming C pass (gt_encoder.cpp xsi_ingest_codes) for
            # codes + all stats, vs ~6 whole-matrix numpy passes below
            # (the numpy branch stays as the oracle; byte-parity pinned).
            codes, miss, eov, alt_flat, alt_offs, nup_flags = nat(
                gt_mat, na_arr, self.default_phasing, check_phase)
            self._allele_rows.extend(codes)
            self._n_missing.extend(int(x) for x in miss)
            self._n_eov.extend(int(x) for x in eov)
            if alt_flat.shape[0] == n and bool(np.all(na_arr == 2)):
                self._alt_counts.extend(alt_flat.reshape(-1, 1))
            else:
                for j in range(n):
                    self._alt_counts.append(
                        alt_flat[alt_offs[j]:alt_offs[j + 1]])
            if check_phase:
                for j in np.flatnonzero(nup_flags):
                    row = gt_mat[j]
                    self._nup_flagged[base + int(j)] = (
                        ((row & 1) != self.default_phasing)
                        & self._second_slot_mask(W))
            self._n_alleles.extend(int(x) for x in na_arr)
            return
        codes = alleles_from_gt(gt_mat, int(na_arr.max(initial=2)))
        self._allele_rows.extend(codes)        # row views, one backing array
        if int(codes.min(initial=0)) < 0:
            miss = (codes == MISSING_CODE).sum(1)
            eov = (codes == EOV_CODE).sum(1)
            self._n_missing.extend(int(x) for x in miss)
            self._n_eov.extend(int(x) for x in eov)
        else:
            self._n_missing.extend([0] * n)
            self._n_eov.extend([0] * n)
        ones = (codes == 1).sum(1, dtype=np.int64)
        if bool(np.all(na_arr == 2)):
            self._alt_counts.extend(ones.reshape(-1, 1))
        else:
            for j in range(n):
                a = int(na_arr[j])
                if a == 2:
                    self._alt_counts.append(ones[j:j + 1])
                elif a <= 1:
                    self._alt_counts.append(np.zeros(0, np.int64))
                else:
                    self._alt_counts.append(np.bincount(
                        np.maximum(codes[j], 0), minlength=a
                    )[1:a].astype(np.int64))
        if check_phase:
            nup_mat = (((gt_mat & 1) != self.default_phasing)
                       & self._second_slot_mask(W))
            for j in np.flatnonzero(nup_mat.any(1)):
                self._nup_flagged[base + int(j)] = nup_mat[j]
        self._n_alleles.extend(int(x) for x in na_arr)

    def _second_slot_mask(self, H: int) -> np.ndarray:
        m = getattr(self, "_second_mask", None)
        if m is None or m.shape[0] != H:
            m = (np.arange(H) & 1).astype(bool)
            self._second_mask = m
        return m

    # ------------------------------------------------------------------
    def prepare(self, pad: bool = True) -> dict:
        """Host prep before the core call: record-to-line expansion +
        bucket padding.  Returns the padded core inputs plus everything
        `assemble` needs; shared by the single-chip serialize() and the
        multi-chip mesh driver (parallel/shard.MeshBlockEncoder).
        pad=False skips the power-of-two line bucket (host cores have no
        XLA executable to share, and the pad is a whole-matrix copy)."""
        n_alleles = np.asarray(self._n_alleles)
        n_alts = np.maximum(n_alleles - 1, 0)
        row_lens = {r.shape[0] for r in self._allele_rows}
        mixed = len(row_lens) > 1
        if mixed:
            # Mixed-ploidy block (haploid + diploid records interleaved,
            # chrX PAR boundary): keep records NATURAL-order in a padded
            # [n_rec, 2N] matrix (haploid rows occupy [:N], REF-padded so
            # the exception-track flags stay honest); the line matrix gets
            # haploid rows slot-DUPLICATED for the unified arrangement
            # chain (encode_block_core_mixed docstring).
            H = self.n_haps
            N = self.n_samples
            rec_hap = np.array([r.shape[0] == N for r in self._allele_rows])
            dt = (np.int16 if any(r.dtype == np.int16
                                  for r in self._allele_rows) else np.int8)
            alleles_rec = np.zeros((len(self._allele_rows), H), dt)
            for i, r in enumerate(self._allele_rows):
                alleles_rec[i, :r.shape[0]] = r
            haploid = False
        else:
            alleles_rec = np.stack(self._allele_rows)   # [n_rec, H] i8/i16
            rec_hap = None
            # Uniformly-haploid blocks (chrX male panels): the diploid 2N
            # arrangement keeps haplotype pairs adjacent when every line's
            # partition key is per-sample, so it collapses to an N-element
            # PBWT over samples -- the SAME kernels run with H = n_samples
            # (reference semantics: haploid_rearrangement_from_diploid,
            # interfaces.hpp:318-333 + pbwt_sort1).
            haploid = alleles_rec.shape[1] == self.n_samples \
                and self.n_samples != self.n_haps
            H = alleles_rec.shape[1]

        # Expand records to binary lines (one per ALT).
        rec_of_line = np.repeat(np.arange(len(n_alts)), n_alts)
        alt_of_line = (np.concatenate([np.arange(1, k + 1) for k in n_alts])
                       if len(n_alts) else np.zeros(0, np.int64))
        L = rec_of_line.shape[0]
        if (not mixed and L == alleles_rec.shape[0]
                and bool((n_alts == 1).all())):
            # all-biallelic uniform block: the line expansion is the
            # identity -- alias instead of copying the whole matrix (the
            # common case; read-only downstream.  The mixed branch writes
            # slot-duplicated haploid rows in place, so it always copies)
            alleles = alleles_rec
        else:
            alleles = alleles_rec[rec_of_line]      # [L, H]
        hap_line = None
        if mixed:
            hap_line = rec_hap[rec_of_line]
            if hap_line.any():
                alleles[hap_line] = np.repeat(
                    alleles[hap_line][:, : self.n_samples], 2, axis=1)

        # Pad the line axis to a power-of-two bucket: one XLA executable
        # serves every block of the file (multi-allelic blocks vary in L).
        from ..utils.shapes import bucket
        # Host-known line classification (from the per-record carrier
        # counts taken at encode_record time): lets the device core gather
        # the WAH rows and run the PBWT chain at the WAH bucket only —
        # sparse-heavy blocks skip most of the chain (symmetric with the
        # decoder's compacted-rows formulation, decoder_jax._decode_block_full).
        ac_line = (np.concatenate(self._alt_counts)
                   if L else np.zeros(0, np.int64))
        len_eff = np.full(L, H, np.int64)
        if mixed:
            len_eff[hap_line] = self.n_samples
        mac = np.minimum(ac_line, len_eff - ac_line)
        is_wah = mac > self.mac_threshold
        negated = ac_line != mac
        wah_rows = np.flatnonzero(is_wah)
        n_wah = wah_rows.shape[0]

        L_pad = bucket(L) if pad else L
        if not pad:
            Lw_pad = max(n_wah, 1)
        elif H > 16384:
            # HRC-and-beyond widths: each (Lw, H) shape is one more cold
            # compile of the block program (18.5 s for the encode at 64,976
            # haplotypes on an H100 SXM, 700 W limit, chip_smoke.py), so
            # the WAH-row axis gets quarter buckets of L_pad (<= 4 variants
            # per block size, and less padding than the next power of two)
            # instead of the fine power-of-two ladder.
            q = max(L_pad // 4, 256)
            Lw_pad = min(-(-max(n_wah, 1) // q) * q, L_pad)
        else:
            Lw_pad = bucket(max(n_wah, 1))
        wah_rows_p = np.zeros(Lw_pad, np.int32)
        wah_rows_p[:n_wah] = wah_rows
        sorts_w = np.zeros(Lw_pad, bool)
        sorts_w[:n_wah] = True

        # Sparse rows compact the same way (the carrier extraction used to
        # scan the WAH rows too, half the traffic on a chr20-like mix).
        sparse_rows = np.flatnonzero(~is_wah)
        n_sparse = sparse_rows.shape[0]
        if not pad:
            Ls_pad = max(n_sparse, 1)
        elif H > 16384:
            q = max(L_pad // 4, 256)
            Ls_pad = min(-(-max(n_sparse, 1) // q) * q, L_pad)
        else:
            Ls_pad = bucket(max(n_sparse, 1))
        sparse_rows_p = np.zeros(Ls_pad, np.int32)
        sparse_rows_p[:n_sparse] = sparse_rows
        # padding rows replicate row 0 harmlessly; negated mask padded False
        negated_s = np.zeros(Ls_pad, bool)
        negated_s[:n_sparse] = negated[sparse_rows]
        alleles_p = alleles
        alts_p = np.asarray(alt_of_line, np.int32)
        hap_line_p = hap_line
        if L_pad != L:
            alleles_p = np.concatenate(
                [alleles, np.full((L_pad - L, H), -3, alleles.dtype)])
            alts_p = np.concatenate(
                [alts_p, np.full(L_pad - L, -100, np.int32)])
            if hap_line is not None:
                hap_line_p = np.concatenate(
                    [hap_line, np.zeros(L_pad - L, bool)])
        is_wah_p = is_wah
        negated_p = negated
        if L_pad != L:
            is_wah_p = np.concatenate([is_wah, np.zeros(L_pad - L, bool)])
            negated_p = np.concatenate([negated, np.zeros(L_pad - L, bool)])

        # Exception-track metadata from the per-record stats captured at
        # encode_record time — serialize() never re-scans the block matrix.
        n_missing = np.asarray(self._n_missing, np.int64)
        n_eov = np.asarray(self._n_eov, np.int64)
        flag_m = np.flatnonzero(n_missing > 0)
        flag_e = np.flatnonzero(n_eov > 0)
        flag_p = np.asarray(sorted(self._nup_flagged), np.int64)
        nup_bits = (np.stack([self._nup_flagged[i] for i in flag_p])
                    if len(flag_p) else np.zeros((0, H), bool))
        first_lines = np.cumsum(np.concatenate([[0], n_alts[:-1]])) \
            if len(n_alts) else np.zeros(0, np.int64)
        return dict(n_alts=n_alts, haploid=haploid, mixed=mixed,
                    H=H, L=L, alleles_rec=alleles_rec,
                    rec_hap=rec_hap,
                    hap_line=hap_line, hap_line_p=hap_line_p,
                    alleles_p=alleles_p, alts_p=alts_p,
                    is_wah=is_wah, negated=negated,
                    is_wah_p=is_wah_p, negated_p=negated_p,
                    wah_rows_p=wah_rows_p, sorts_w=sorts_w, n_wah=n_wah,
                    sparse_rows_p=sparse_rows_p, negated_s=negated_s,
                    n_sparse=n_sparse,
                    n_missing=n_missing, n_eov=n_eov,
                    flag_m=flag_m, flag_e=flag_e, flag_p=flag_p,
                    nup_bits=nup_bits, first_lines=first_lines)

    def assemble(self, out: dict, prep: dict) -> bytes:
        """Payload assembly from the core outputs (sliced to [:L]).

        Byte-identical regardless of which core produced `out` --
        the mesh driver calls this per block with its shard's slice."""
        n_alts = prep["n_alts"]
        haploid = prep["haploid"]
        L = prep["L"]
        hap_line = prep.get("hap_line")
        rec_hap = prep.get("rec_hap")
        # Oracle parity: haploid_found is per RECORD — a clean zero-ALT
        # haploid record owns no binary line but still sets the flag, so
        # the key is emitted with an all-zero flag vector.
        any_hap = haploid or (rec_hap is not None and bool(rec_hap.any()))

        is_wah = out["is_wah"]
        negated = out["negated"] & ~is_wah

        # --- exception tracks (flags captured at encode_record time) -------
        n_rec = len(n_alts)
        rec_has_missing = np.zeros(n_rec, bool)
        rec_has_missing[prep["flag_m"]] = True
        rec_has_eov = np.zeros(n_rec, bool)
        rec_has_eov[prep["flag_e"]] = True
        rec_has_nup = np.zeros(n_rec, bool)
        rec_has_nup[prep["flag_p"]] = True

        zero_alt = n_alts == 0
        if (zero_alt & (rec_has_missing | rec_has_eov | rec_has_nup)).any():
            # see GtBlockEncoder.encode_record: per-binary-line exception
            # tracks cannot carry a record that owns no binary line
            raise ValueError(
                "record with no ALT allele carries missing/end-of-vector/"
                "non-uniform-phasing data, which XSI v5 cannot represent")

        ws = self.weirdness_strategy
        wah_weird = ws in (WeirdnessStrategy.WS_WAH, WeirdnessStrategy.WS_PBWT_WAH)
        if ws == WeirdnessStrategy.WS_PBWT_WAH:
            raise NotImplementedError(
                "block encoders support WS_SPARSE and WS_WAH")

        missing_bytes, eov_bytes, phase_bytes = self._encode_tracks(
            prep, wah_weird, device_out=out.get("trk"))

        # --- assemble payload ---------------------------------------------
        d: dict[int, int] = {
            GTDict.KEY_BCF_LINES: len(n_alts),
            GTDict.KEY_BINARY_LINES: L,
            GTDict.KEY_MAX_LINE_PLOIDY: 1 if haploid else 2,
            GTDict.KEY_DEFAULT_PHASING: self.default_phasing,
            GTDict.KEY_WEIRDNESS_STRATEGY: ws,
            GTDict.KEY_LINE_SORT: GTDict.VAL_UNDEFINED,
            GTDict.KEY_LINE_SELECT: GTDict.VAL_UNDEFINED,
            GTDict.KEY_MATRIX_WAH: GTDict.VAL_UNDEFINED,
            GTDict.KEY_MATRIX_SPARSE: GTDict.VAL_UNDEFINED,
        }
        if any_hap:
            d[GTDict.KEY_LINE_HAPLOID] = GTDict.VAL_UNDEFINED
        if rec_has_missing.any():
            d[GTDict.KEY_LINE_MISSING] = GTDict.VAL_UNDEFINED
            d[GTDict.KEY_MATRIX_MISSING if wah_weird
              else GTDict.KEY_MATRIX_MISSING_SPARSE] = GTDict.VAL_UNDEFINED
        if rec_has_eov.any():
            d[GTDict.KEY_LINE_END_OF_VECTORS] = GTDict.VAL_UNDEFINED
            d[GTDict.KEY_MATRIX_END_OF_VECTORS if wah_weird
              else GTDict.KEY_MATRIX_END_OF_VECTORS_SPARSE] = GTDict.VAL_UNDEFINED
        if rec_has_nup.any():
            d[GTDict.KEY_LINE_NON_UNIFORM_PHASING] = GTDict.VAL_UNDEFINED
            d[GTDict.KEY_MATRIX_NON_UNIFORM_PHASING] = GTDict.VAL_UNDEFINED

        dict_bytes = write_dictionary(d)
        payload = bytearray(dict_bytes)

        def first_line_flags(rec_flags: np.ndarray) -> np.ndarray:
            v = np.zeros(L, np.uint8)
            first_lines = np.cumsum(np.concatenate([[0], n_alts[:-1]]))
            keep = n_alts > 0
            v[first_lines[keep]] = rec_flags[keep]
            return v

        d[GTDict.KEY_LINE_SORT] = len(payload)
        payload.extend(wah_np.wah_encode(is_wah.astype(np.uint8)).tobytes())
        d[GTDict.KEY_LINE_SELECT] = d[GTDict.KEY_LINE_SORT]

        # WAH matrix: concatenate per-line words (front-packed rows)
        d[GTDict.KEY_MATRIX_WAH] = len(payload)
        wah_words, wah_len = out["wah_words"], out["wah_len"]
        if out.get("wah_compact"):
            # Compacted grid (encode_block_core_compact): rows are the WAH
            # lines in line order already — emit directly.
            take = np.arange(wah_words.shape[1])[None, :] < wah_len[:, None]
            payload.extend(wah_words[take].tobytes())
        elif hap_line is not None and "hap_wah_words" in out:
            # Mixed block: haploid WAH lines take their words from the
            # N-width grid (even-slot subsequence), diploid from the full
            # grid — stitch into one per-line-selected matrix.
            hw, hl = out["hap_wah_words"], out["hap_wah_len"]
            Wm = max(wah_words.shape[1], hw.shape[1])
            comb = np.zeros((L, Wm), wah_words.dtype)
            comb[:, : wah_words.shape[1]] = wah_words
            comb[hap_line, :] = 0
            comb[hap_line, : hw.shape[1]] = hw[hap_line]
            wah_words = comb
            wah_len = np.where(hap_line, hl, wah_len)
        if not out.get("wah_compact"):
            W = wah_words.shape[1]
            take = ((np.arange(W)[None, :] < wah_len[:, None])
                    & is_wah[:, None])
            payload.extend(wah_words[take].tobytes())

        # Sparse matrix: [count|neg][indices] per line
        d[GTDict.KEY_MATRIX_SPARSE] = len(payload)
        if "sparse_csr" in out:
            payload.extend(self._assemble_sparse_csr(
                out["sparse_csr"], out["sparse_len"], negated[~is_wah]))
        elif out.get("sparse_compact"):
            # compacted grid: rows are the sparse lines in line order
            payload.extend(self._assemble_sparse(
                out["sparse_idx"], out["sparse_len"], negated[~is_wah],
                np.ones(out["sparse_idx"].shape[0], bool)))
        else:
            sparse_idx = out["sparse_idx"]
            if hap_line is not None and hap_line.any():
                # haploid carriers sit at even slots 2s of the duplicated
                # line; natural (sample) index is s
                sparse_idx = np.where(hap_line[:, None], sparse_idx >> 1,
                                      sparse_idx)
            payload.extend(self._assemble_sparse(
                sparse_idx, out["sparse_len"], negated, ~is_wah))

        if rec_has_missing.any():
            d[GTDict.KEY_LINE_MISSING] = len(payload)
            payload.extend(wah_np.wah_encode(
                first_line_flags(rec_has_missing)).tobytes())
            d[GTDict.KEY_MATRIX_MISSING if wah_weird
              else GTDict.KEY_MATRIX_MISSING_SPARSE] = len(payload)
            payload.extend(missing_bytes)
        if rec_has_eov.any():
            d[GTDict.KEY_LINE_END_OF_VECTORS] = len(payload)
            payload.extend(wah_np.wah_encode(
                first_line_flags(rec_has_eov)).tobytes())
            d[GTDict.KEY_MATRIX_END_OF_VECTORS if wah_weird
              else GTDict.KEY_MATRIX_END_OF_VECTORS_SPARSE] = len(payload)
            payload.extend(eov_bytes)
        if rec_has_nup.any():
            d[GTDict.KEY_LINE_NON_UNIFORM_PHASING] = len(payload)
            payload.extend(wah_np.wah_encode(
                first_line_flags(rec_has_nup)).tobytes())
            d[GTDict.KEY_MATRIX_NON_UNIFORM_PHASING] = len(payload)
            payload.extend(phase_bytes)
        if any_hap:
            d[GTDict.KEY_LINE_HAPLOID] = len(payload)
            flags = (np.ones(L, np.uint8) if haploid
                     else hap_line.astype(np.uint8))
            payload.extend(wah_np.wah_encode(flags).tobytes())

        payload[: len(dict_bytes)] = write_dictionary(d)
        return bytes(payload)

    # ------------------------------------------------------ track encode
    def track_cap(self, prep: dict, wah_weird: bool) -> int:
        """Static sparse capacity for the device track encode (bucketed so
        one executable serves many blocks).  0 = no sparse output needed."""
        from ..utils.shapes import bucket
        if wah_weird or len(prep["flag_m"]) + len(prep["flag_e"]) == 0:
            return 0
        return bucket(max(int(prep["n_missing"].max(initial=0)),
                          int(prep["n_eov"].max(initial=0)), 1), minimum=64)

    def _encode_tracks(self, prep: dict, wah_weird: bool,
                       device_out: dict | None = None
                       ) -> tuple[bytes, bytes, bytes]:
        """Concatenated track bytes (missing, EOV, phase), record order.

        Three producers, all byte-identical (they reduce to
        wah_np.wah_encode / sparse_np.sparse_encode semantics, pinned by
        tests):
          * `device_out` — missing/EOV grids already encoded INSIDE the
            main device dispatch from the block matrix itself (no second
            transfer; encoder_jax._encode_block_device_compact_tracks);
          * the packed-bit device batch (8x smaller transfer than raw
            bool rows) for phase rows and non-fused many-row batches;
          * vectorized numpy for small batches and the mixed-width
            haploid-WAH corner."""
        import os

        flag_m, flag_e, flag_p = prep["flag_m"], prep["flag_e"], prep["flag_p"]
        nm, ne, npp = len(flag_m), len(flag_e), len(flag_p)
        if nm + ne + npp == 0:
            return b"", b"", b""
        alleles_rec = prep["alleles_rec"]
        rec_hap = prep.get("rec_hap")
        min_rows = int(os.environ.get("XSI_TRACKS_DEVICE_MIN", "8"))

        def flag_bits(flags: np.ndarray, code: int) -> np.ndarray:
            if len(flags) == alleles_rec.shape[0]:
                return alleles_rec == code       # all flagged: no gather
            return alleles_rec[flags] == code

        def host_wah(bits: np.ndarray, rows: np.ndarray) -> bytes:
            if rec_hap is not None and len(rows) and rec_hap[rows].any():
                # Haploid records' natural-order tracks have n_samples
                # bits, not n_haps: WAH bytes depend on the row length,
                # so mixed-width batches take the per-row path.
                N = self.n_samples
                segs: list[bytes] = []
                for i, r in enumerate(rows):
                    width = N if rec_hap[r] else bits.shape[1]
                    segs.append(wah_np.wah_encode(
                        bits[i, :width].astype(np.uint8)).tobytes())
                return b"".join(segs)
            stream, _ = wah_np.wah_encode_rows(bits.astype(np.uint8))
            return stream.tobytes()

        def host_sparse(bits: np.ndarray) -> bytes:
            counts = bits.sum(axis=1).astype(np.int64)
            _, cc = np.nonzero(bits)
            return self._assemble_sparse_csr(
                cc, counts, np.zeros(bits.shape[0], bool))

        def wah_bytes(ww: np.ndarray, wl: np.ndarray) -> bytes:
            take = np.arange(ww.shape[1])[None, :] < wl[:, None]
            return ww[take].tobytes()

        def sparse_bytes(si: np.ndarray, sl: np.ndarray) -> bytes:
            return self._assemble_sparse(
                si, sl, np.zeros(sl.shape[0], bool),
                np.ones(sl.shape[0], bool))

        if device_out is not None:
            ww, wl = device_out["wah_words"], device_out["wah_len"]
            si, sl = device_out["sparse_idx"], device_out["sparse_len"]
            if wah_weird:
                mb = wah_bytes(ww[:nm], wl[:nm])
                eb = wah_bytes(ww[nm:nm + ne], wl[nm:nm + ne])
            else:
                mb = sparse_bytes(si[:nm], sl[:nm])
                eb = sparse_bytes(si[nm:nm + ne], sl[nm:nm + ne])
            if npp == 0:
                return mb, eb, b""
            if self.use_device_tracks and npp >= min_rows:
                pw, pl, _, _ = self._device_track_rows(prep["nup_bits"], 0)
                return mb, eb, wah_bytes(pw, pl)
            return mb, eb, host_wah(prep["nup_bits"], flag_p)

        # Haploid flagged rows under WAH weirdness have mixed row widths;
        # the batched device grids assume one width, so stay on host.
        # (WS_SPARSE tracks are [count][indices] — length-agnostic — and
        # phase rows are never haploid, so everything else is unaffected.)
        hap_in_wah_rows = (
            rec_hap is not None and wah_weird
            and bool(rec_hap[np.concatenate([flag_m, flag_e])].any()))
        if self.use_device_tracks and nm + ne + npp >= min_rows \
                and not hap_in_wah_rows:
            bits = np.concatenate([
                flag_bits(flag_m, MISSING_CODE),
                flag_bits(flag_e, EOV_CODE),
                prep["nup_bits"]]).astype(np.uint8)
            cap = self.track_cap(prep, wah_weird)
            ww, wl, si, sl = self._device_track_rows(bits, cap)
            pw, pl = ww[nm + ne:], wl[nm + ne:]
            if wah_weird:
                return (wah_bytes(ww[:nm], wl[:nm]),
                        wah_bytes(ww[nm:nm + ne], wl[nm:nm + ne]),
                        wah_bytes(pw, pl))
            return (sparse_bytes(si[:nm], sl[:nm]),
                    sparse_bytes(si[nm:nm + ne], sl[nm:nm + ne]),
                    wah_bytes(pw, pl))

        if wah_weird:
            mb = host_wah(flag_bits(flag_m, MISSING_CODE), flag_m) \
                if nm else b""
            eb = host_wah(flag_bits(flag_e, EOV_CODE), flag_e) if ne else b""
        else:
            mb = host_sparse(flag_bits(flag_m, MISSING_CODE)) if nm else b""
            eb = host_sparse(flag_bits(flag_e, EOV_CODE)) if ne else b""
        pb = host_wah(prep["nup_bits"], flag_p) if npp else b""
        return mb, eb, pb

    def _device_track_rows(self, bits: np.ndarray, cap: int):
        """Batched device WAH+sparse encode of track bit rows.  The rows
        cross to the device PACKED (np.packbits, 8x less transfer than
        bool rows); the device unpacks and encodes in one dispatch."""
        import jax.numpy as jnp

        from ..utils.shapes import bucket
        from .encoder_jax import _encode_tracks_device_packed

        R, H = bits.shape
        packed = np.packbits(bits.astype(np.uint8), axis=1,
                             bitorder="little")
        R_pad = bucket(R)
        if R_pad != R:
            packed = np.concatenate(
                [packed, np.zeros((R_pad - R, packed.shape[1]), np.uint8)])
        ww, wl, si, sl = (np.asarray(x) for x in _encode_tracks_device_packed(
            jnp.asarray(packed), H, int(cap)))
        return ww[:R], wl[:R], si[:R], sl[:R]

    def _sparse_bytes(self, indices: np.ndarray, negated: bool) -> np.ndarray:
        from ..ops.sparse_np import sparse_encode
        return sparse_encode(indices, negated, self.aet_dtype)

    def _assemble_sparse_csr(self, csr_idx: np.ndarray, counts: np.ndarray,
                             negated: np.ndarray) -> bytes:
        """[head][indices] stream from CSR form (concatenated row-major
        indices + per-row counts) — no padded matrix, so a near-fixed
        negated line costs its own indices, not a whole L x H buffer."""
        dt = self.aet_dtype
        n = counts.shape[0]
        if n == 0:
            return b""
        msb = 1 << (dt.itemsize * 8 - 1)
        heads = counts.astype(np.int64) | np.where(negated, msb, 0)
        total = int(counts.sum()) + n
        outbuf = np.empty(total, dt)
        starts = np.cumsum(np.concatenate([[0], counts[:-1] + 1]))
        outbuf[starts] = heads.astype(dt)
        body = np.ones(total, bool)
        body[starts] = False
        outbuf[body] = csr_idx.astype(dt)
        return outbuf.tobytes()

    def _assemble_sparse(self, sparse_idx: np.ndarray, sparse_len: np.ndarray,
                         negated: np.ndarray, is_sparse: np.ndarray) -> bytes:
        """Vectorised [head][indices] stream assembly for all sparse lines."""
        dt = self.aet_dtype
        msb = 1 << (dt.itemsize * 8 - 1)
        lens = sparse_len[is_sparse]
        if lens.shape[0] == 0:
            return b""
        heads = lens.astype(np.int64) | np.where(negated[is_sparse], msb, 0)
        idx_rows = sparse_idx[is_sparse]
        total = int(lens.sum()) + lens.shape[0]
        outbuf = np.zeros(total, dt)
        starts = np.cumsum(np.concatenate([[0], lens[:-1] + 1]))
        outbuf[starts] = heads.astype(dt)
        take = np.arange(idx_rows.shape[1])[None, :] < lens[:, None]
        flat_dest = (starts[:, None] + 1 + np.arange(idx_rows.shape[1])[None, :])
        outbuf[flat_dest[take]] = idx_rows[take].astype(dt)
        return outbuf.tobytes()
