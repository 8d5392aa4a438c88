"""Device (JAX) kernels vs NumPy oracles."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from xsqueezeit_tpu.ops import pbwt_np, wah_jax, wah_np


def random_block_bits(rng, L, H):
    ps = rng.choice([0.0, 0.001, 0.01, 0.3, 0.5, 0.9, 1.0], size=L)
    return (rng.random((L, H)) < ps[:, None]).astype(np.uint8)


def test_pack_bits_matches_oracle():
    rng = np.random.default_rng(0)
    bits = random_block_bits(rng, 16, 101)
    got = np.asarray(wah_jax.pack_bits(jnp.asarray(bits)))
    want = np.stack([wah_np.pack_words(b) for b in bits])
    np.testing.assert_array_equal(got, want.astype(np.int32))


def test_wah_encode_lines_matches_oracle():
    rng = np.random.default_rng(1)
    for H in (31, 100, 5008):
        bits = random_block_bits(rng, 24, H)
        words, n_out = wah_jax.wah_encode_lines(jnp.asarray(bits))
        words, n_out = np.asarray(words), np.asarray(n_out)
        for i in range(bits.shape[0]):
            want = wah_np.wah_encode(bits[i])
            assert n_out[i] == len(want), f"line {i}"
            np.testing.assert_array_equal(words[i, :n_out[i]], want)


def test_wah_counter_saturation_device():
    n = (16383 + 5) * 15
    bits = np.zeros((2, n), np.uint8)
    bits[1] = 1
    words, n_out = wah_jax.wah_encode_lines(jnp.asarray(bits))
    assert np.asarray(n_out).tolist() == [2, 2]
    assert np.asarray(words)[0, :2].tolist() == [0x8000 | 16383, 0x8000 | 5]
    assert np.asarray(words)[1, :2].tolist() == [0xC000 | 16383, 0xC000 | 5]


def test_wah_decode_lines_roundtrip():
    rng = np.random.default_rng(2)
    H = 1001
    L = 32
    W = wah_jax.n_words_for(H)
    bits = random_block_bits(rng, L, H)
    # build a contiguous stream like the on-disk MATRIX_WAH
    stream = np.concatenate([wah_np.wah_encode(b) for b in bits])
    padded = np.concatenate([stream, np.zeros(W + 1, np.uint16)])
    offsets = wah_jax.wah_line_offsets(jnp.asarray(padded), H, W, n_lines=L)
    # offsets oracle
    pos, want_offsets = 0, []
    for b in bits:
        want_offsets.append(pos)
        pos += wah_np.wah_words_consumed(stream[pos:], H)
    np.testing.assert_array_equal(np.asarray(offsets), want_offsets)

    dec = wah_jax.wah_decode_lines(jnp.asarray(padded), offsets, H, W)
    # decoded padding region beyond H is not produced; compare bits
    np.testing.assert_array_equal(np.asarray(dec), bits)

    pops = wah_jax.wah_popcount_lines(jnp.asarray(padded), offsets, H, W)
    np.testing.assert_array_equal(np.asarray(pops), bits.sum(axis=1))


def test_pbwt_scan_matches_oracle():
    from xsqueezeit_tpu.ops import pbwt_jax
    rng = np.random.default_rng(3)
    L, H = 40, 64
    alleles = rng.integers(0, 2, (L, H)).astype(np.int8)
    alts = np.ones(L, np.int32)
    sorts = rng.random(L) < 0.8
    a0 = np.arange(H, dtype=np.int32)

    ys, a_final = pbwt_jax.pbwt_encode_scan(
        jnp.asarray(alleles), jnp.asarray(alts), jnp.asarray(sorts),
        jnp.asarray(a0))
    ys = np.asarray(ys)

    a = a0.astype(np.int64)
    for l in range(L):
        y_want = (alleles[l][a] == alts[l]).astype(np.uint8)
        np.testing.assert_array_equal(ys[l], y_want, err_msg=f"line {l}")
        if sorts[l]:
            a = pbwt_np.stable_partition(a, y_want.astype(bool))
    np.testing.assert_array_equal(np.asarray(a_final), a)


def test_wah_expand_stream_matches_decode_lines():
    rng = np.random.default_rng(7)
    for H in (31, 1001, 5008):
        L = 24
        W = wah_jax.n_words_for(H)
        bits = random_block_bits(rng, L, H)
        stream = np.concatenate([wah_np.wah_encode(b) for b in bits])
        padded = np.concatenate([stream, np.zeros(5, np.uint16)])
        out15 = wah_jax.wah_expand_stream(jnp.asarray(padded), L, W)
        dec = np.asarray(wah_jax.unpack_bits(out15, H))
        np.testing.assert_array_equal(dec, bits)
        # padded extra lines decode to all-zero rows
        out15p = wah_jax.wah_expand_stream(jnp.asarray(padded), L + 3, W)
        decp = np.asarray(wah_jax.unpack_bits(out15p, H))
        np.testing.assert_array_equal(decp[:L], bits)
        assert decp[L:].sum() == 0


def test_pbwt_decode_blocked_matches_scan():
    from xsqueezeit_tpu.ops import pbwt_jax
    rng = np.random.default_rng(8)
    for L, H, chunk in ((30, 48, 16), (64, 129, 8), (7, 33, 16)):
        ps = rng.choice([0.01, 0.3, 0.5, 0.9], size=L)
        x = (rng.random((L, H)) < ps[:, None]).astype(np.int8)
        sorts = rng.random(L) < 0.7
        a0 = np.arange(H, dtype=np.int32)
        ys, _ = pbwt_jax.pbwt_encode_scan(
            jnp.asarray(x), jnp.asarray(np.ones(L, np.int32)),
            jnp.asarray(sorts), jnp.asarray(a0))
        want, want_a = pbwt_jax.pbwt_decode_scan(
            ys, jnp.asarray(sorts), jnp.asarray(a0))
        got, got_a = pbwt_jax.pbwt_decode_blocked(
            ys, jnp.asarray(sorts), chunk=chunk)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        np.testing.assert_array_equal(np.asarray(got_a), np.asarray(want_a))
        np.testing.assert_array_equal(np.asarray(got), (x == 1))


def test_pbwt_decode_scan_matches_encode():
    from xsqueezeit_tpu.ops import pbwt_jax
    rng = np.random.default_rng(4)
    L, H = 30, 48
    alleles = rng.integers(0, 2, (L, H)).astype(np.int8)
    alts = np.ones(L, np.int32)
    sorts = np.ones(L, bool)
    a0 = np.arange(H, dtype=np.int32)
    ys, _ = pbwt_jax.pbwt_encode_scan(
        jnp.asarray(alleles), jnp.asarray(alts), jnp.asarray(sorts),
        jnp.asarray(a0))
    vals, _ = pbwt_jax.pbwt_decode_scan(ys, jnp.asarray(sorts), jnp.asarray(a0))
    np.testing.assert_array_equal(np.asarray(vals), (alleles == 1))


def test_pbwt_encode_chunked_matches_scan():
    from xsqueezeit_tpu.ops import pbwt_jax
    rng = np.random.default_rng(11)
    for L, H, chunk in ((40, 64, 16), (33, 129, 8), (7, 48, 16), (64, 501, 16)):
        ps = rng.choice([0.01, 0.3, 0.5, 0.9], size=L)
        alleles = (rng.random((L, H)) < ps[:, None]).astype(np.int8)
        alts = np.ones(L, np.int32)
        sorts = rng.random(L) < 0.8
        a0 = np.arange(H, dtype=np.int32)
        want_y, want_a = pbwt_jax.pbwt_encode_scan(
            jnp.asarray(alleles), jnp.asarray(alts), jnp.asarray(sorts),
            jnp.asarray(a0))
        got_y, got_a = pbwt_jax.pbwt_encode_chunked(
            jnp.asarray(alleles), jnp.asarray(alts), jnp.asarray(sorts),
            chunk=chunk)
        np.testing.assert_array_equal(np.asarray(got_y), np.asarray(want_y),
                                      err_msg=f"L={L} H={H}")
        np.testing.assert_array_equal(np.asarray(got_a), np.asarray(want_a))


def test_pbwt_decode_chunked_matches_scan():
    from xsqueezeit_tpu.ops import pbwt_jax
    rng = np.random.default_rng(12)
    for L, H, chunk in ((30, 48, 16), (64, 129, 8), (7, 33, 16), (48, 501, 16)):
        ps = rng.choice([0.01, 0.3, 0.5, 0.9], size=L)
        x = (rng.random((L, H)) < ps[:, None]).astype(np.int8)
        sorts = rng.random(L) < 0.7
        a0 = np.arange(H, dtype=np.int32)
        ys, _ = pbwt_jax.pbwt_encode_scan(
            jnp.asarray(x), jnp.asarray(np.ones(L, np.int32)),
            jnp.asarray(sorts), jnp.asarray(a0))
        want, want_a = pbwt_jax.pbwt_decode_scan(
            ys, jnp.asarray(sorts), jnp.asarray(a0))
        got, got_a = pbwt_jax.pbwt_decode_chunked(
            ys, jnp.asarray(sorts), chunk=chunk)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=f"L={L} H={H}")
        np.testing.assert_array_equal(np.asarray(got_a), np.asarray(want_a))
        np.testing.assert_array_equal(np.asarray(got), (x == 1))


def test_pbwt_chunked_near_u16_boundary():
    """HRC-scale haplotype counts (64976) sit just under the 65535 field
    limit of the chunked kernels' u32 packing; exercise the edge."""
    from xsqueezeit_tpu.ops import pbwt_jax
    rng = np.random.default_rng(13)
    L, H = 24, 65534
    x = (rng.random((L, H)) < 0.3).astype(np.int8)
    sorts = np.ones(L, bool)
    a0 = np.arange(H, dtype=np.int32)
    want_y, want_a = pbwt_jax.pbwt_encode_scan(
        jnp.asarray(x), jnp.asarray(np.ones(L, np.int32)),
        jnp.asarray(sorts), jnp.asarray(a0))
    got_y, got_a = pbwt_jax.pbwt_encode_chunked(
        jnp.asarray(x), jnp.asarray(np.ones(L, np.int32)),
        jnp.asarray(sorts))
    np.testing.assert_array_equal(np.asarray(got_y), np.asarray(want_y))
    np.testing.assert_array_equal(np.asarray(got_a), np.asarray(want_a))
    vals, _ = pbwt_jax.pbwt_decode_chunked(got_y, jnp.asarray(sorts))
    np.testing.assert_array_equal(np.asarray(vals), (x == 1))


def test_rank_chain_packed_pairs_matches_sequential():
    """_rank_chain's packed-pair phase A (total_bits <= 16: doubled jump,
    paired totals per operand) must match the per-chunk sequential rank
    recurrence r_{t+1} = stable-rank by (T_t, r_t) — and the unpacked
    branch (total_bits > 16) likewise."""
    import jax.numpy as jnp

    from xsqueezeit_tpu.ops.pbwt_jax import _hap_bits, _rank_chain

    rng = np.random.default_rng(3)
    for H, tb, n_ch in ((48, 9, 37), (129, 16, 64), (64, 16, 3),
                        (80, 18, 23)):
        b = _hap_bits(H)
        T = rng.integers(0, 1 << tb, (n_ch, H)).astype(np.uint32)
        r0 = rng.permutation(H).astype(np.int32)
        r = r0.copy()
        starts = []
        for t in range(n_ch):
            starts.append(r.copy())
            order = np.lexsort((r, T[t]))   # stable rank by (T_t, r_t)
            inv = np.empty(H, np.int64)
            inv[order] = np.arange(H)
            r = inv.astype(np.int32)
        r_fin, r_starts = _rank_chain(jnp.asarray(T), jnp.asarray(r0), b,
                                      total_bits=tb)
        np.testing.assert_array_equal(np.asarray(r_fin), r,
                                      err_msg=f"H={H} tb={tb}")
        np.testing.assert_array_equal(np.asarray(r_starts), np.array(starts),
                                      err_msg=f"H={H} tb={tb}")


# ---------------------------------------------------------------------------
# The production PBWT chunk chains and WAH expansion (plain XLA) against the
# NumPy oracles, across widths around the 128-lane and 4096 boundaries.
# ---------------------------------------------------------------------------
def _pbwt_oracle(x, sorts):
    """Arrangement-ordered bits per line and the final arrangement."""
    L, H = x.shape
    a = np.arange(H)
    ys = np.zeros((L, H), np.uint8)
    for line in range(L):
        y = x[line][a]
        ys[line] = y
        if sorts[line]:
            a = pbwt_np.pbwt_sort_bool(a, y)
    return ys, a


def _chain_case(H, seed):
    rng = np.random.default_rng(seed)
    L = 45                                  # not a multiple of the chunk
    x = random_block_bits(rng, L, H)
    sorts = rng.random(L) < 0.7             # mixed sorting / non-sorting
    return x, sorts


@pytest.mark.parametrize("H", [1, 7, 128, 129, 1000, 4099])
def test_pbwt_encode_chunked_matches_oracle(H):
    from xsqueezeit_tpu.ops import pbwt_jax

    x, sorts = _chain_case(H, H)
    want_y, want_a = _pbwt_oracle(x, sorts)
    got_y, got_a = pbwt_jax.pbwt_encode_chunked(
        jnp.asarray(x.astype(np.int8)), jnp.ones(x.shape[0], jnp.int32),
        jnp.asarray(sorts))
    np.testing.assert_array_equal(np.asarray(got_y), want_y)
    np.testing.assert_array_equal(np.asarray(got_a), want_a)


@pytest.mark.parametrize("H", [1, 7, 128, 129, 1000, 4099])
def test_pbwt_decode_chunked_matches_oracle(H):
    from xsqueezeit_tpu.ops import pbwt_jax

    x, sorts = _chain_case(H, 100 + H)
    ys, want_a = _pbwt_oracle(x, sorts)
    vals, a_fin = pbwt_jax.pbwt_decode_chunked(jnp.asarray(ys),
                                               jnp.asarray(sorts))
    np.testing.assert_array_equal(np.asarray(vals), x)
    np.testing.assert_array_equal(np.asarray(a_fin), want_a)


def _wah_stream(lines):
    return np.concatenate([wah_np.wah_encode(b) for b in lines])


@pytest.mark.parametrize("case", ["tall_narrow", "wide", "padded_tail",
                                  "saturated"])
def test_wah_expand_stream_matches_oracle(case):
    """Many short lines, w > 1024 groups per line, zero padding past the
    last line (extra rows decode to zeros), and fill counters at the
    16383-group limit."""
    rng = np.random.default_rng(7)
    if case == "tall_narrow":
        lines, extra, pad = random_block_bits(rng, 300, 31), 0, 0
    elif case == "wide":
        lines, extra, pad = random_block_bits(rng, 5, 20000), 0, 0
    elif case == "padded_tail":
        lines, extra, pad = random_block_bits(rng, 20, 1001), 3, 9
    else:
        n = (16383 + 40) * 15
        lines = np.zeros((3, n), np.uint8)
        lines[1] = 1
        lines[2, n // 2:] = 1
        extra, pad = 0, 0
    n_lines, H = lines.shape[0] + extra, lines.shape[1]
    w = wah_jax.n_words_for(H)
    stream = np.concatenate([_wah_stream(lines), np.zeros(pad, np.uint16)])
    got = np.asarray(wah_jax.wah_expand_stream(jnp.asarray(stream),
                                               n_lines, w))
    want = wah_np.wah_expand_block(stream, n_lines, w)
    np.testing.assert_array_equal(got, want)
    bits = wah_np.unpack_words(got[:lines.shape[0]].astype(np.uint16),
                               w * 15)[:, :H]
    np.testing.assert_array_equal(bits, lines)
    assert not got[lines.shape[0]:].any()
