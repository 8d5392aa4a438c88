"""WAH2 codec — JAX/XLA device kernels (batched over block lines).

Data-parallel reformulation of the WAH2 run-length format: instead of the
reference's word-at-a-time C++ loops, whole blocks of lines are processed as
dense [L, W] arrays with cumulative-sum run detection and scatter/gather
compaction, which XLA fuses into a few elementwise and scan kernels.

Encode:  bits[L, H]  ->  (words[L, W], n_words[L])      (fixed-capacity rows)
Decode:  stream words -> per-line word offsets (one cumsum over the stream)
         windowed per-line expansion via vectorised binary search

Capacity invariant: a line of H bits never needs more than W = ceil(H/15)
output words (every emitted word covers >= 15 input bits).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

WAH_BITS = 15
HIGH = 1 << 15
ONE = 1 << 14
MAXC = (1 << 14) - 1
ALL_SET = 0x7FFF


def n_words_for(n_bits: int) -> int:
    return (n_bits + WAH_BITS - 1) // WAH_BITS


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """[..., H] 0/1 -> [..., W] 15-bit LSB-first words (H padded with zeros)."""
    h = bits.shape[-1]
    w = n_words_for(h)
    pad = w * WAH_BITS - h
    if pad:
        bits = jnp.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    groups = bits.reshape(*bits.shape[:-1], w, WAH_BITS).astype(jnp.int32)
    weights = (1 << jnp.arange(WAH_BITS, dtype=jnp.int32))
    return jnp.sum(groups * weights, axis=-1)


def unpack_bits(words: jnp.ndarray, h: int) -> jnp.ndarray:
    """[..., W] words -> [..., h] bits."""
    shifts = jnp.arange(WAH_BITS, dtype=jnp.int32)
    bits = (words[..., :, None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :h].astype(jnp.uint8)


def _cummax(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    return jax.lax.associative_scan(jnp.maximum, x, axis=axis)


@functools.partial(jax.jit, static_argnames=())
def wah_compress_words(words: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """RLE-compress packed 15-bit words, batched.

    words: int32[L, W] (values 0..0x7FFF)
    Returns (out_words uint16[L, W], n_out int32[L]); out rows are
    front-packed, trailing entries zero.
    """
    L, W = words.shape
    if W >= (1 << 15):
        # the front-pack sort key packs the word index into bits 16-30
        raise ValueError(
            f"wah_compress_words supports at most 32767 words per line "
            f"(got {W}; ~491k haplotypes); shard the haplotype axis")
    is_zero = words == 0
    is_ones = words == ALL_SET
    is_fill = is_zero | is_ones
    idx = jnp.arange(W, dtype=jnp.int32)[None, :]

    # Run detection: class changes or literal words break runs.
    cls = jnp.where(is_zero, 0, jnp.where(is_ones, 1, 2 + idx))
    prev_cls = jnp.concatenate([jnp.full((L, 1), -1, cls.dtype), cls[:, :-1]], 1)
    boundary = cls != prev_cls
    # Start index of each word's run via cumulative max of boundary positions.
    run_start = _cummax(jnp.where(boundary, idx, -1), axis=1)
    pos_in_run = idx - run_start
    # Split runs at the 16383-word counter limit.
    sub_boundary = boundary | (is_fill & (pos_in_run > 0)
                               & (pos_in_run % MAXC == 0))
    sub_start = _cummax(jnp.where(sub_boundary, idx, -1), axis=1)
    sub_len = idx - sub_start + 1
    # A word emits output iff it is the last of its sub-run.
    next_sub = jnp.concatenate(
        [sub_boundary[:, 1:], jnp.ones((L, 1), bool)], 1)
    emit = next_sub
    fill_word = HIGH | jnp.where(is_ones, ONE, 0) | sub_len
    out_val = jnp.where(is_fill, fill_word, words)

    n_out = jnp.sum(emit, axis=1).astype(jnp.int32)
    # Front-pack emitted words in order via one packed row sort:
    # key = (!emit, word index), value in the low bits.
    packed = (jnp.where(emit, jnp.uint32(0), jnp.uint32(1) << 31)
              | (idx.astype(jnp.uint32) << 16)
              | out_val.astype(jnp.uint32))
    srt = jax.lax.sort(packed, dimension=1, is_stable=False)
    keep = jnp.arange(W, dtype=jnp.int32)[None, :] < n_out[:, None]
    out = jnp.where(keep, srt & jnp.uint32(0xFFFF), 0)
    return out.astype(jnp.uint16), n_out


def wah_encode_lines(bits: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """bits uint8[L, H] -> (words uint16[L, W], n_words int32[L])."""
    return wah_compress_words(pack_bits(bits))


@functools.partial(jax.jit, static_argnames=("h", "w", "n_lines"))
def wah_line_offsets(stream: jnp.ndarray, h: int, w: int,
                     n_lines: int | None = None) -> jnp.ndarray:
    """Word offset of each line in a uniform-H WAH stream.

    Every line decodes to exactly w*15 bits (h padded up).  One cumsum over
    the stream's per-word bit spans + a searchsorted gives all offsets.
    stream: uint16[N].  Returns int32[L] where L = n_lines or capacity.
    """
    s = stream.astype(jnp.int32)
    is_counter = (s & HIGH) != 0
    span = jnp.where(is_counter, (s & MAXC) * WAH_BITS, WAH_BITS)
    cum = jnp.cumsum(span)
    line_bits = w * WAH_BITS
    n = n_lines if n_lines is not None else (stream.shape[0])
    targets = jnp.arange(n, dtype=jnp.int64) * line_bits
    return jnp.searchsorted(cum, targets, side="right").astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("n_lines", "w"))
def wah_expand_stream(stream: jnp.ndarray, n_lines: int, w: int) -> jnp.ndarray:
    """Expand a concatenated uniform-width WAH stream to packed 15-bit groups.

    stream: uint16[N] -- the WAH words of `n_lines` lines back to back, each
    line spanning exactly `w` 15-bit groups (the codec invariant: lines pad
    to w*15 bits, so fill counters never straddle a line boundary).  Trailing
    padding words are ignored (their slots fall beyond n_lines*w and drop).

    Returns int32[n_lines, w] of 15-bit groups (counters resolved to fills).

    Formulation: no per-line offsets, no windowed gathers -- one global
    cumsum over word spans gives each word's output slot, one scatter plants
    `(pos_in_row+1) << 16 | word` at row starts, and a per-row cumulative max
    forward-fills counter coverage.  Everything else is elementwise.
    """
    if w >= (1 << 15):
        # the forward-fill key packs (pos_in_row + 1) into bits 16-30
        raise ValueError(
            f"wah_expand_stream supports at most 32767 words per line "
            f"(got {w}); shard the haplotype axis")
    s = stream.astype(jnp.int32)
    is_counter = (s & HIGH) != 0
    span = jnp.where(is_counter, s & MAXC, 1)
    start = jnp.cumsum(span) - span          # global 15-bit-group slot
    pos_in_row = start % w
    packed = ((pos_in_row + 1) << 16) | s    # s < 2^16; +1 beats zero-init
    z = jnp.zeros(n_lines * w, jnp.int32).at[start].set(packed, mode="drop")
    z = jax.lax.associative_scan(jnp.maximum, z.reshape(n_lines, w), axis=1)
    word = z & 0xFFFF
    fill = jnp.where((word & ONE) != 0, ALL_SET, 0)
    return jnp.where((word & HIGH) != 0, fill, word)


@functools.partial(jax.jit, static_argnames=("h", "w"))
def wah_decode_lines(stream: jnp.ndarray, offsets: jnp.ndarray,
                     h: int, w: int) -> jnp.ndarray:
    """Decode L lines of h bits each from a WAH stream.

    stream: uint16[N] (padded; reads beyond the final line's words must stay
    in bounds -- pad with >= w zero words), offsets: int32[L].
    Returns bits uint8[L, h].

    Formulation: everything in the WAH stream is 15-bit aligned (counter
    words cover whole 15-bit groups), so expansion runs in *word space*:
    for each of the w output 15-bit slots of a line, find the covering input
    word with an O(w) scatter + cumulative max (no per-bit work), emit
    either the literal word or a fill pattern, then unpack bits elementwise.
    """
    s = stream.astype(jnp.int32)
    L = offsets.shape[0]
    # Windowed gather of each line's words: [L, w]
    win = s[jnp.clip(offsets[:, None] + jnp.arange(w)[None, :], 0,
                     s.shape[0] - 1)]
    is_counter = (win & HIGH) != 0
    span_w = jnp.where(is_counter, win & MAXC, 1)  # span in 15-bit words
    start_w = jnp.cumsum(span_w, axis=1) - span_w   # output slot of word k
    in_line = start_w < w

    # Covering word index per output slot: scatter word ids at their start
    # slots, then cumulative max fills the runs.
    widx = jnp.arange(w, dtype=jnp.int32)
    slot_of_word = jnp.where(in_line, start_w, w)
    marks = jnp.full((L, w + 1), -1, jnp.int32)
    marks = jax.vmap(lambda m, sl: m.at[sl].max(widx, mode="drop"))(
        marks, slot_of_word)
    cover = jax.lax.associative_scan(jnp.maximum, marks[:, :w], axis=1)

    word_at_slot = jnp.take_along_axis(win, cover, axis=1)
    counter_at_slot = (word_at_slot & HIGH) != 0
    fill = jnp.where((word_at_slot & ONE) != 0, ALL_SET, 0)
    out15 = jnp.where(counter_at_slot, fill, word_at_slot)
    return unpack_bits(out15, h)


@functools.partial(jax.jit, static_argnames=("h", "w"))
def wah_popcount_lines(stream: jnp.ndarray, offsets: jnp.ndarray,
                       h: int, w: int) -> jnp.ndarray:
    """Per-line popcount without materializing bits (allele counts)."""
    s = stream.astype(jnp.int32)

    def line(off):
        win = jax.lax.dynamic_slice(s, (off,), (w,))
        is_counter = (win & HIGH) != 0
        span = jnp.where(is_counter, (win & MAXC) * WAH_BITS, WAH_BITS)
        starts = jnp.cumsum(span) - span
        in_line = starts < (w * WAH_BITS)  # mask out the next line's words
        lit_pop = jax.lax.population_count(win & ALL_SET)
        fill_pop = jnp.where((win & ONE) != 0, (win & MAXC) * WAH_BITS, 0)
        pop = jnp.where(is_counter, fill_pop, lit_pop)
        return jnp.sum(jnp.where(in_line, pop, 0))

    return jax.vmap(line)(offsets)


@functools.partial(jax.jit, static_argnames=("n_lines", "w_max"))
def wah_expand_stream_varw(stream: jnp.ndarray, group_off: jnp.ndarray,
                           n_lines: int, w_max: int) -> jnp.ndarray:
    """wah_expand_stream for PER-LINE 15-bit-group widths (mixed-ploidy
    blocks: haploid lines span n_words_for(N) groups, diploid
    n_words_for(2N)).

    group_off: int32[n_lines + 1] cumulative group offsets per line
    (host-known from the line widths).  Output int32[n_lines, w_max] of
    15-bit groups; slots beyond a line's own width are zeroed.  Same
    invariant as the uniform form: fill counters never straddle a line
    boundary (each line pads to its own group count).
    """
    if w_max >= (1 << 15):
        raise ValueError(
            f"wah_expand_stream_varw supports at most 32767 words per "
            f"line (got {w_max})")
    s = stream.astype(jnp.int32)
    is_counter = (s & HIGH) != 0
    span = jnp.where(is_counter, s & MAXC, 1)
    start = jnp.cumsum(span) - span          # global 15-bit-group slot
    line_of = jnp.searchsorted(group_off, start, side="right") - 1
    line_c = jnp.clip(line_of, 0, n_lines - 1)
    pos_in_row = start - group_off[line_c]
    valid = (line_of >= 0) & (line_of < n_lines) & (pos_in_row < w_max)
    packed = ((pos_in_row + 1) << 16) | s    # s < 2^16; +1 beats zero-init
    dest = jnp.where(valid, line_c * w_max + pos_in_row,
                     n_lines * w_max)        # padding words: dropped
    z = jnp.zeros(n_lines * w_max, jnp.int32).at[dest].set(packed,
                                                           mode="drop")
    z = jax.lax.associative_scan(jnp.maximum, z.reshape(n_lines, w_max),
                                 axis=1)
    word = z & 0xFFFF
    fill = jnp.where((word & ONE) != 0, ALL_SET, 0)
    out = jnp.where((word & HIGH) != 0, fill, word)
    widths = group_off[1:] - group_off[:-1]
    return jnp.where(jnp.arange(w_max)[None, :] < widths[:, None], out, 0)
