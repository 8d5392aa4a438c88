"""PBWT arrangement transforms — JAX device kernels (plain XLA).

The PBWT stable partition is sequential along the variant axis but fully
vectorizable along the haplotype axis.  Three formulations coexist:

  * pbwt_{encode,decode}_scan: the simple per-line `lax.scan` (sorts per
    step) — the readable oracle-adjacent baseline used for fallbacks/tests.
  * pbwt_{encode,decode}_chunked: the production path.  Lines group into
    16-line chunks; a per-haplotype 16-bit register carries the chunk's
    bits through the partitions, so per line the only data movement is one
    packed row sort.  Cross-chunk state comes from a radix rank chain
    (encode) or a permutation-composition associative scan (decode).
  * pbwt_encode_keys: cumsum-built packed sort keys (legacy path, still
    used for H > 65535 where the 16-bit register fields don't fit).

Block independence (the arrangement re-seeds to iota every block, header
flag iota_ppa) supplies cross-device parallelism; see parallel/shard.py.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def partition_destinations(y: jnp.ndarray) -> jnp.ndarray:
    """Destination index of each element under a stable partition by y.

    y: bool/int[H] in arrangement order.  Zeros keep order at the front,
    ones are appended in order.
    """
    y = y.astype(jnp.int32)
    zeros_before = jnp.cumsum(1 - y) - (1 - y)
    n_zeros = jnp.sum(1 - y)
    ones_before = jnp.cumsum(y) - y
    return jnp.where(y == 0, zeros_before, n_zeros + ones_before)


def stable_partition(a: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    dest = partition_destinations(y)
    return jnp.zeros_like(a).at[dest].set(a)


@functools.partial(jax.jit, static_argnames=())
def pbwt_encode_scan(alleles: jnp.ndarray, alts: jnp.ndarray,
                     sorts: jnp.ndarray, a0: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Bits-through-arrangement for every line of a block.

    alleles: int8/int16[L, H]  allele index per line per haplotype slot
             (missing -> -1, end-of-vector -> -2)
    alts:    int32[L]          target ALT per binary line
    sorts:   bool[L]           whether the line updates the arrangement (WAH)
    a0:      int32[H]          initial arrangement (iota at block start)

    Returns (y uint8[L, H] bits in arrangement order, a_final int32[H]).

    Formulation: the PBWT arrangement after sorting lines b1..bk is the
    stable lexicographic order of (bk, ..., b1, prior rank) -- a sort by the
    haplotypes' bit-history.  Lines are grouped into chunks of C = 31 -
    ceil(log2 H) lines so that (chunk-local history prefix, chunk-start
    rank, line bit) packs into one uint32; then

      1. per-line packed keys come from one vectorized masked cumsum,
      2. chunk-start ranks come from a lax.scan over chunks (two one-row
         sorts per step: argsort by (chunk total key, rank) + inversion),
      3. ONE batched single-uint32 row sort over all L lines extracts every
         line's arrangement-ordered bits as the payload LSB.
    """
    packed, r_fin = pbwt_encode_keys(alleles, alts, sorts, a0)
    ys = (jax.lax.sort(packed, dimension=1, is_stable=False)
          & jnp.uint32(1)).astype(jnp.uint8)
    iota = jnp.arange(alleles.shape[1], dtype=jnp.int32)
    _, a_final = jax.lax.sort((r_fin, iota), num_keys=1, is_stable=False)
    return ys, a_final


def pbwt_encode_scan_parity(alleles: jnp.ndarray, alts: jnp.ndarray,
                            sorts: jnp.ndarray, a0: jnp.ndarray
                            ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """pbwt_encode_scan that also yields slot parity in arrangement order.

    The mixed-ploidy block encoder needs, per line, both the bit vector in
    arrangement order AND the parity a & 1 of the haplotype at each
    arrangement position (a haploid line emits only the even-slot
    subsequence; codec/encoder_jax.encode_block_core_mixed).  Parity rides
    as a second payload bit in the packed keys — one fewer chunk line
    (C = 30 - b), same single batched extraction sort.

    Oracle: ops/pbwt_np.pbwt_encode_parity.
    """
    packed, r_fin = pbwt_encode_keys(alleles, alts, sorts, a0,
                                     carry_parity=True)
    s = jax.lax.sort(packed, dimension=1, is_stable=False)
    ys = (s & jnp.uint32(1)).astype(jnp.uint8)
    par = ((s >> 1) & jnp.uint32(1)).astype(jnp.uint8)
    iota = jnp.arange(alleles.shape[1], dtype=jnp.int32)
    _, a_final = jax.lax.sort((r_fin, iota), num_keys=1, is_stable=False)
    return ys, par, a_final


def pbwt_encode_keys(alleles: jnp.ndarray, alts: jnp.ndarray,
                     sorts: jnp.ndarray, a0: jnp.ndarray,
                     carry_parity: bool = False
                     ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Packed per-line PBWT sort keys (everything but the final sort).

    Returns (packed uint32[L, H], r_final int32[H]) where sorting row l of
    `packed` ascending yields key (P_l, r_chunk) with the line's bit in the
    LSB -- callers may row-wise substitute other 32-bit keys (e.g. sparse
    index compaction) before ONE fused batched sort.

    carry_parity additionally places the haplotype slot parity (h & 1) one
    bit above the line bit, costing one chunk line of key space.
    """
    L, H = alleles.shape
    b = _hap_bits(H)
    vb = 2 if carry_parity else 1   # payload bits below the rank field
    C = 32 - b - vb
    if C < 2:
        raise ValueError(f"H={H} too large for packed PBWT encode")
    x = (alleles.astype(jnp.int32) == alts[:, None]).astype(jnp.uint32)
    pad = (-L) % C
    if pad:
        x = jnp.pad(x, ((0, pad), (0, 0)))
        sorts = jnp.pad(sorts, (0, pad))
    Lp = L + pad
    n_ch = Lp // C

    iota = jnp.arange(H, dtype=jnp.int32)
    # rank of each haplotype under a0 (inverse permutation, via one sort)
    _, r0 = jax.lax.sort((a0, iota), num_keys=1, is_stable=False)

    # Per-line chunk-local history keys, fully vectorized: within a chunk the
    # j-th sorting line contributes its bit at shift = (#sorting lines before
    # it); P_j = exclusive cumsum of contributions (latest bit highest).
    ss = sorts.reshape(n_ch, C).astype(jnp.uint32)
    xc = x.reshape(n_ch, C, H)
    sh = jnp.cumsum(ss, axis=1) - ss                      # [n_ch, C]
    contrib = jnp.where(ss[:, :, None] != 0,
                        xc << sh[:, :, None], jnp.uint32(0))
    incl = jnp.cumsum(contrib, axis=1)
    P = incl - contrib                                    # exclusive prefix
    T = incl[:, -1, :]                                    # chunk totals [n_ch, H]

    r_fin, r_starts = _rank_chain(T, r0, b, total_bits=C)

    r_b = jnp.broadcast_to(r_starts[:, None, :].astype(jnp.uint32),
                           (n_ch, C, H)).reshape(Lp, H)
    packed = (P.reshape(Lp, H) << (b + vb)) | (r_b << vb) | x.reshape(Lp, H)
    if carry_parity:
        packed = packed | ((jnp.arange(H, dtype=jnp.uint32) & 1) << 1)[None, :]
    return packed[:L], r_fin


def _hap_bits(h: int) -> int:
    return max(int(h - 1).bit_length(), 1)


def _sort_apply(key: jnp.ndarray, val: jnp.ndarray, h: int,
                val_bits: int | None = None) -> jnp.ndarray:
    """Batched permutation apply: out[..., key[i]] = val[..., i].

    key rows are permutations of 0..h-1.  Uses a single packed-u32 sort when
    the fields fit; falls back to a tuple sort for very large h.
    """
    b = _hap_bits(h)
    vb = val_bits if val_bits is not None else b
    if b + vb <= 15:
        packed = ((key.astype(jnp.uint16) << vb)
                  | val.astype(jnp.uint16))
        out = jax.lax.sort(packed, dimension=-1, is_stable=False)
        return (out & ((1 << vb) - 1)).astype(jnp.int32)
    if b + vb <= 31:
        packed = (key.astype(jnp.int32) << vb) | val.astype(jnp.int32)
        out = jax.lax.sort(packed, dimension=-1, is_stable=False)
        return out & ((1 << vb) - 1)
    return jax.lax.sort((key.astype(jnp.int32), val.astype(jnp.int32)),
                        dimension=-1, num_keys=1, is_stable=False)[1]


DECODE_CHUNK = 16


def _rank_chain(T: jnp.ndarray, r0: jnp.ndarray, b: int, s_jump: int = 4,
                total_bits: int | None = None
                ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Chunk-start rank chain: r_{t+1} = rank by (T_t, r_t).

    T: uint32[n_ch, H] per-chunk packed history totals; r0: int32[H].
    Returns (r_final int32[H], r_starts int32[n_ch, H]).

    The radix identity (rank values are unique) lets one multi-key sort jump
    S chunks at a time: r_{t+S} = rank by (T_{t+S-1}, ..., T_t, r_t).
    Phase A chains group starts sequentially; phase B fills within-group
    chunk starts batched across all groups.

    When the caller declares total_bits <= 16 (and H fits 16 bits), phase A
    packs PAIRS of chunk totals per u32 operand and rides (rank, iota) in
    one more — the same radix order with half the compare traffic — and
    doubles the jump to S = 2 * s_jump: half the sequential steps at equal
    per-step bytes (sort cost scales with key operand bytes).
    """
    n_ch, H = T.shape
    S = s_jump
    pack_pairs = (total_bits is not None and total_bits <= 16
                  and H <= 0xFFFF)
    if pack_pairs:
        S = 2 * s_jump
    iota = jnp.arange(H, dtype=jnp.int32)
    padg = (-n_ch) % S
    Tg = jnp.pad(T, ((0, padg), (0, 0)))  # zero keys: identity rank update
    n_g = (n_ch + padg) // S
    Tg = Tg.reshape(n_g, S, H)

    if pack_pairs:
        iota_u = iota.astype(jnp.uint32)

        def step_a(r, ts):
            # priority order T_{S-1} > ... > T_0 > r is preserved by any
            # within-operand packing that keeps higher-priority totals in
            # higher bits; rank is unique so iota (the payload) never
            # influences the order.
            keys = tuple((ts[j + 1] << 16) | ts[j]
                         for j in range(S - 2, -1, -2))
            keys = keys + ((r.astype(jnp.uint32) << 16) | iota_u,)
            a_end = (jax.lax.sort(keys, num_keys=len(keys),
                                  is_stable=False)[-1]
                     & jnp.uint32(0xFFFF)).astype(jnp.int32)
            r_new = _sort_apply(a_end, iota, H)
            return r_new, r
    else:
        def step_a(r, ts):
            k0 = (ts[0] << b) | r.astype(jnp.uint32)
            keys = tuple(ts[j] for j in range(S - 1, 0, -1)) + (k0, iota)
            a_end = jax.lax.sort(keys, num_keys=S, is_stable=False)[-1]
            r_new = _sort_apply(a_end, iota, H)  # inverse via one packed sort
            return r_new, r

    r_fin, r_gstart = jax.lax.scan(step_a, r0, Tg)

    iota_b = jnp.broadcast_to(iota, (n_g, H))

    def step_b(r, t):
        packed = (t << b) | r.astype(jnp.uint32)
        a_end = jax.lax.sort((packed, iota_b), dimension=1, num_keys=1,
                             is_stable=False)[1]
        r_new = _sort_apply(a_end, iota_b, H)
        return r_new, r

    _, r_chunks = jax.lax.scan(step_b, r_gstart, jnp.swapaxes(Tg, 0, 1))
    r_starts = jnp.swapaxes(r_chunks, 0, 1).reshape(n_g * S, H)[:n_ch]
    return r_fin, r_starts


@functools.partial(jax.jit, static_argnames=("chunk",))
def pbwt_encode_chunked(alleles: jnp.ndarray, alts: jnp.ndarray,
                        sorts: jnp.ndarray, chunk: int = 16
                        ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Arrangement-ordered bits for every line — β-register formulation.

    Requires H <= 65535 (16-bit position/payload fields packed in uint32);
    callers fall back to pbwt_encode_scan beyond that.  Block-start
    arrangement is identity (header iota_ppa).

    Formulation: lines are grouped in chunks of `chunk` (<=16) lines.
    A per-haplotype 16-bit register β̂ holds the hap's bits for the chunk's
    lines (bit j = line j), loaded into chunk-start arrangement order by ONE
    batched packed sort per chunk (key = chunk-start rank from the radix
    rank chain).  Within the chunk each line's arrangement-ordered bits are
    an elementwise bit test on β̂ (no data movement!), and the PBWT stable
    partition moves β̂ itself with ONE packed u32 sort per line
    (key = partition destination, payload = β̂).

    Returns (ys uint8[L, H], a_final int32[H]).
    """
    L, H = alleles.shape
    if H > 65535:
        raise ValueError("pbwt_encode_chunked requires H <= 65535")
    C = chunk
    b = _hap_bits(H)
    x = (alleles.astype(jnp.int32) == alts[:, None]).astype(jnp.uint32)
    pad = (-L) % C
    if pad:
        x = jnp.pad(x, ((0, pad), (0, 0)))
        sorts = jnp.pad(sorts, (0, pad))
    Lp = L + pad
    n_ch = Lp // C
    iota = jnp.arange(H, dtype=jnp.int32)

    xc = x.reshape(n_ch, C, H)
    jshift = jnp.arange(C, dtype=jnp.uint32)
    bhat = jnp.sum(xc << jshift[None, :, None], axis=1)        # [n_ch, H]

    # Chunk history totals over sorting lines (latest sorting bit highest).
    ss = sorts.reshape(n_ch, C).astype(jnp.uint32)
    sh = jnp.cumsum(ss, axis=1) - ss
    T = jnp.sum(jnp.where(ss[:, :, None] != 0, xc << sh[:, :, None],
                          jnp.uint32(0)), axis=1)

    r_fin, r_starts = _rank_chain(T, iota, b, total_bits=C)

    # β̂ load: one packed sort per chunk (batched) lands each hap's register
    # at its chunk-start slot.
    q0 = (jax.lax.sort((r_starts.astype(jnp.uint32) << 16) | bhat,
                       dimension=1, is_stable=False) & jnp.uint32(0xFFFF))

    ssw = jnp.swapaxes(ss.astype(jnp.uint32), 0, 1)            # [C, n_ch]

    def step(q, inp):
        j, s_j = inp
        y = (q >> j) & jnp.uint32(1)
        yi = y.astype(jnp.int32)
        cums = jnp.cumsum(yi, axis=1)
        ones_before = cums - yi
        nz = H - cums[:, -1:]
        d = jnp.where(yi == 0, iota[None, :] - ones_before,
                      nz + ones_before)
        d = jnp.where(s_j[:, None] != 0, d, iota[None, :])
        q = jax.lax.sort((d.astype(jnp.uint32) << 16) | q,
                         dimension=1, is_stable=False) & jnp.uint32(0xFFFF)
        return q, y.astype(jnp.uint8)

    _, ys = jax.lax.scan(step, q0, (jshift, ssw))
    ys = jnp.swapaxes(ys, 0, 1).reshape(Lp, H)[:L]
    _, a_final = jax.lax.sort((r_fin, iota), num_keys=1, is_stable=False)
    return ys, a_final


@functools.partial(jax.jit, static_argnames=("chunk",))
def pbwt_decode_chunked(ys: jnp.ndarray, sorts: jnp.ndarray,
                        chunk: int = DECODE_CHUNK
                        ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Blocked PBWT decode, β-register formulation (H <= 65535).

    Each element's uint32 sort payload packs (chunk-start slot k << 16 | β),
    where β accumulates the element's decoded bits for the chunk's lines
    (bit j = line j): the bit at the element's current slot is appended
    BEFORE the line's stable partition, so it travels with the haplotype.
    Per line the only data movement is ONE tuple row sort (u16 destination
    key, u32 payload).  At chunk end, β lands at natural haplotype order via
    ONE batched sort keyed by the next chunk-start arrangement A_{t+1}
    (from the permutation-composition scan of phase 2), replacing the
    2-sorts-per-line extraction of pbwt_decode_blocked.

    ys:    uint8[L, H] bits in arrangement order (block starts at identity).
    sorts: bool[L]; all-zero padding rows may pass True.
    Returns (vals uint8[L, H] natural-order bits, a_final int32[H]).
    """
    L, H = ys.shape
    if H > 65535:
        raise ValueError("pbwt_decode_chunked requires H <= 65535")
    C = chunk
    pad = (-L) % C
    if pad:
        ys = jnp.pad(ys, ((0, pad), (0, 0)))
        sorts = jnp.pad(sorts, (0, pad))
    Lp = L + pad
    n_ch = Lp // C
    y = ys.astype(jnp.int32)
    iota = jnp.arange(H, dtype=jnp.int32)
    jshift = jnp.arange(C, dtype=jnp.uint32)

    # Stable-partition destinations for every line, one vectorized cumsum
    # (identity on non-sorting lines).
    c = jnp.cumsum(y, axis=1)
    ones_before = c - y
    n_zeros = H - c[:, -1:]
    dest = jnp.where(y == 0, iota[None, :] - ones_before,
                     n_zeros + ones_before)
    dest = jnp.where(sorts[:, None], dest, iota[None, :]).astype(jnp.uint16)

    dc = jnp.swapaxes(dest.reshape(n_ch, C, H), 0, 1)          # [C, n_ch, H]
    yc = jnp.swapaxes(y.reshape(n_ch, C, H).astype(jnp.uint32), 0, 1)

    p0 = jnp.broadcast_to(iota.astype(jnp.uint32) << 16, (n_ch, H))

    def step(p, inp):
        d, yrow, j = inp
        p = p | (yrow << j)
        _, p = jax.lax.sort((d, p), dimension=1, num_keys=1, is_stable=False)
        return p, None

    p_fin, _ = jax.lax.scan(step, p0, (dc, yc, jshift))

    o_tot = (p_fin >> 16).astype(jnp.int32)
    beta = (p_fin & jnp.uint32(0xFFFF)).astype(jnp.int32)
    iota_b = jnp.broadcast_to(iota, (n_ch, H))
    oinv_tot = _sort_apply(o_tot, iota_b, H)

    def combine(u, v):
        (p1_, p1i), (p2_, p2i) = u, v
        return (_sort_apply(p2i, p1_, H), _sort_apply(p1_, p2i, H))

    inc, _ = jax.lax.associative_scan(combine, (o_tot, oinv_tot), axis=0)
    # inc[t] = arrangement at the END of chunk t (hap id per end slot), so
    # it keys the flush: X[inc[t][i]] = beta at end-slot i.
    X = _sort_apply(inc, beta, H, val_bits=16)                 # [n_ch, H]

    vals = ((X[:, None, :] >> jshift[None, :, None].astype(jnp.int32)) & 1)
    vals = vals.reshape(Lp, H)[:L].astype(jnp.uint8)
    return vals, inc[-1]


@functools.partial(jax.jit, static_argnames=("chunk",))
def pbwt_decode_blocked(ys: jnp.ndarray, sorts: jnp.ndarray,
                        chunk: int = DECODE_CHUNK
                        ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Blocked PBWT decode: bits back to natural order for every line.

    Replaces the line-sequential `lax.scan` with a 3-phase hierarchy whose
    sequential depth is O(chunk + log(L/chunk)) instead of O(L), all data
    movement expressed as batched packed-u32 row sorts:

      1. per-chunk position-map chains O_j (pos@line -> pos@chunk-start),
         one batched sort per chunk line, chunks independent;
      2. chunk-start arrangements A_t via an associative scan composing the
         per-chunk totals (permutation composition is associative; carries
         (perm, inverse) pairs, two sorts per combine over L/chunk rows);
      3. arrangement chain G seeded with A_t + bit extraction
         X[l][G_l[i]] = y_l[i], two batched sorts per chunk line.

    ys:    uint8[L, H] bits in arrangement order; every row is decoded.
           Assumes the block-start arrangement is identity (header iota_ppa).
    sorts: bool[L] whether the line updates the arrangement (all-zero padding
           rows may pass True: partitioning by an all-zero column is a no-op).
    Returns (vals uint8[L, H] natural-order bits, a_final int32[H]).
    """
    L, H = ys.shape
    C = chunk
    pad = (-L) % C
    if pad:
        ys = jnp.pad(ys, ((0, pad), (0, 0)))
        sorts = jnp.pad(sorts, (0, pad))
    Lp = L + pad
    n_ch = Lp // C
    y = ys.astype(jnp.int32)

    iota = jnp.arange(H, dtype=jnp.int32)
    # Stable-partition destinations for every line (identity on non-sorting
    # lines), all from one vectorized cumsum: zeros_before = i - ones_before.
    c = jnp.cumsum(y, axis=1)
    ones_before = c - y
    n_zeros = H - c[:, -1:]
    dest = jnp.where(y == 0, iota[None, :] - ones_before,
                     n_zeros + ones_before)
    dest = jnp.where(sorts[:, None], dest, iota[None, :])

    dc = jnp.swapaxes(dest.reshape(n_ch, C, H), 0, 1)  # [C, n_ch, H]
    yc = jnp.swapaxes(y.reshape(n_ch, C, H), 0, 1)

    # Phase 1: within-chunk O chains; keep only the chunk totals.
    def p1(o, d):
        return _sort_apply(d, o, H), None

    o0 = jnp.broadcast_to(iota, (n_ch, H))
    o_tot, _ = jax.lax.scan(p1, o0, dc)
    oinv_tot = _sort_apply(o_tot, jnp.broadcast_to(iota, (n_ch, H)), H)

    # Phase 2: chunk-start arrangements A_t = O^(0) o ... o O^(t-1).
    def combine(u, v):
        (p1_, p1i), (p2_, p2i) = u, v
        return (_sort_apply(p2i, p1_, H), _sort_apply(p1_, p2i, H))

    inc, _inc_inv = jax.lax.associative_scan(
        combine, (o_tot, oinv_tot), axis=0)
    a_start = jnp.concatenate([o0[:1], inc[:-1]], axis=0)  # exclusive prefix
    a_final = inc[-1]

    # Phase 3: G chain (global arrangement per line) + extraction.
    def p3(g, inp):
        d, yrow = inp
        x = _sort_apply(g, yrow, H, val_bits=1)
        return _sort_apply(d, g, H), x

    _, xs = jax.lax.scan(p3, a_start, (dc, yc))
    vals = jnp.swapaxes(xs, 0, 1).reshape(Lp, H)[:L].astype(jnp.uint8)
    return vals, a_final


@functools.partial(jax.jit, static_argnames=())
def pbwt_decode_scan(ys: jnp.ndarray, sorts: jnp.ndarray,
                     a0: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Scatter decoded bits back to natural order for every line.

    ys:    uint8[L, H] bits in arrangement order (garbage rows allowed for
           non-WAH lines; pass sorts=False there)
    sorts: bool[L]
    Returns (vals uint8[L, H] bits in natural haplotype order, a_final).

    Both per-line steps are expressed as sorts:
      * vals = sort(key=a, payload=y)        -- a is a permutation, so
        sorting by it inverts the arrangement and lands bits at their
        natural positions (unique keys: stability not required);
      * a'   = stable sort(key=y, payload=a) -- the PBWT stable partition
        is exactly a stable sort by the current bit.
    """

    def step(a, inp):
        y, sort = inp
        _, vals = jax.lax.sort((a, y), num_keys=1, is_stable=False)
        _, a_new = jax.lax.sort((y, a), num_keys=1, is_stable=True)
        a = jnp.where(sort, a_new, a)
        return a, vals

    a_final, vals = jax.lax.scan(step, a0, (ys, sorts))
    return vals, a_final


@functools.partial(jax.jit, static_argnames=())
def pbwt_decode_scan_mixed(ys: jnp.ndarray, sorts: jnp.ndarray,
                           hap_line: jnp.ndarray, a0: jnp.ndarray
                           ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """pbwt_decode_scan for MIXED-ploidy blocks (decode counterpart of
    codec/encoder_jax.encode_block_core_mixed).

    ys rows for diploid lines hold H arrangement-ordered bits; HAPLOID
    lines hold only the N = H/2 even-parity-subsequence bits FRONT-PACKED
    (the on-disk form: the encoder emits the even-slot subsequence of the
    slot-duplicated line, = haploid_rearrangement_from_diploid order,
    interfaces.hpp:318-333).  Each haploid line's full slot-duplicated
    bit vector is reconstructed before the scatter/partition:

        y_full[i] = stored[ rank_even[ inv_a[ a[i] & ~1 ] ] ]

    — position i's sample is a[i] >> 1, its EVEN slot sits at position
    inv_a[a[i] & ~1], whose rank among even-parity positions indexes the
    stored subsequence.  Partitioning by y_full mirrors the encoder's
    parity scan (pbwt_sort1 semantics), so the arrangement chain stays in
    lockstep.  Returns natural-order bits (haploid lines slot-duplicated;
    callers fold even slots) and the final arrangement.
    """
    H = ys.shape[1]
    iota = jnp.arange(H, dtype=jnp.int32)

    def step(a, inp):
        y_st, sort, hap = inp
        par = a & 1
        inv = jnp.zeros_like(a).at[a].set(iota)
        even = 1 - par
        rank_even = jnp.cumsum(even) - even
        pos_partner = inv[a & ~1]
        y_full = y_st[rank_even[pos_partner]]
        y = jnp.where(hap, y_full, y_st)
        _, vals = jax.lax.sort((a, y), num_keys=1, is_stable=False)
        _, a_new = jax.lax.sort((y, a), num_keys=1, is_stable=True)
        a = jnp.where(sort, a_new, a)
        return a, vals

    a_final, vals = jax.lax.scan(step, a0, (ys, sorts, hap_line))
    return vals, a_final
