"""Device block encoder vs NumPy block encoder: byte-identical payloads."""
import numpy as np
import pytest

pytest.importorskip("jax")

from xsqueezeit_tpu.codec.encoder_jax import DeviceBlockEncoder
from xsqueezeit_tpu.codec.gt_block import GtBlockEncoder
from xsqueezeit_tpu.format.constants import WeirdnessStrategy
from tests.gt_synth import make_record


def both_encoders(n_samples, mac_threshold, ws=WeirdnessStrategy.WS_SPARSE,
                  default_phasing=1, aet=np.uint16):
    kw = dict(block_bcf_lines=10_000, mac_threshold=mac_threshold,
              default_phasing=default_phasing, aet_dtype=aet,
              weirdness_strategy=ws)
    return (GtBlockEncoder(n_samples, **kw), DeviceBlockEncoder(n_samples, **kw))


def check_identical(records, n_samples, **kw):
    ref, dev = both_encoders(n_samples, **kw)
    for gt, n_alleles in records:
        ref.encode_record(gt, n_alleles)
        dev.encode_record(gt, n_alleles)
    a, b = ref.serialize(), dev.serialize()
    assert a == b, f"payloads differ: {len(a)} vs {len(b)} bytes"


def test_common_variants():
    rng = np.random.default_rng(0)
    records = [make_record(rng, 60, p_alt=0.4) for _ in range(25)]
    check_identical(records, 60, mac_threshold=2)


def test_rare_and_negated():
    rng = np.random.default_rng(1)
    records = ([make_record(rng, 80, p_alt=0.01) for _ in range(10)]
               + [make_record(rng, 80, p_alt=0.99) for _ in range(10)])
    check_identical(records, 80, mac_threshold=5)


def test_multiallelic():
    rng = np.random.default_rng(2)
    records = [make_record(rng, 50, n_alts=3, p_alt=0.5) for _ in range(12)]
    check_identical(records, 50, mac_threshold=2)


def test_missing_sparse_strategy():
    rng = np.random.default_rng(3)
    records = [make_record(rng, 50, p_alt=0.3, p_missing=0.05)
               for _ in range(15)]
    check_identical(records, 50, mac_threshold=2)


def test_missing_wah_strategy():
    rng = np.random.default_rng(4)
    records = [make_record(rng, 50, p_alt=0.3, p_missing=0.05)
               for _ in range(15)]
    check_identical(records, 50, mac_threshold=2, ws=WeirdnessStrategy.WS_WAH)


def test_eov_and_phase():
    rng = np.random.default_rng(5)
    records = [make_record(rng, 50, p_alt=0.3, p_eov=0.05, p_phase_flip=0.1)
               for _ in range(15)]
    check_identical(records, 50, mac_threshold=2)


def test_kitchen_sink():
    rng = np.random.default_rng(6)
    records = []
    for i in range(40):
        if i % 5 == 0:
            records.append(make_record(rng, 64, n_alts=2, p_alt=0.4,
                                       p_missing=0.03, p_phase_flip=0.05))
        elif i % 3 == 0:
            records.append(make_record(rng, 64, p_alt=0.004))
        else:
            records.append(make_record(rng, 64, p_alt=0.3, p_missing=0.02,
                                       p_eov=0.04))
    check_identical(records, 64, mac_threshold=3)


def test_unphased():
    rng = np.random.default_rng(7)
    records = [make_record(rng, 40, p_alt=0.3, phased=False) for _ in range(10)]
    check_identical(records, 40, mac_threshold=2, default_phasing=0)


def test_sparse_cap_sort_fallback_matches_scan_path():
    """sparse_cap > 32 switches index compaction to the batched partition
    sort; both paths must agree where counts fit both capacities."""
    import jax.numpy as jnp

    from xsqueezeit_tpu.codec.encoder_jax import encode_block_core
    rng = np.random.default_rng(55)
    L, H = 64, 300
    alleles = (rng.random((L, H)) < 0.05).astype(np.int8)
    alts = np.ones(L, np.int32)
    small = encode_block_core(jnp.asarray(alleles), jnp.asarray(alts),
                              jnp.int32(30), 30)
    big = encode_block_core(jnp.asarray(alleles), jnp.asarray(alts),
                            jnp.int32(30), 40)
    np.testing.assert_array_equal(np.asarray(small["is_wah"]),
                                  np.asarray(big["is_wah"]))
    np.testing.assert_array_equal(np.asarray(small["sparse_len"]),
                                  np.asarray(big["sparse_len"]))
    sl = np.asarray(small["sparse_len"])
    iw = np.asarray(small["is_wah"])
    a = np.asarray(small["sparse_idx"])
    b = np.asarray(big["sparse_idx"])[:, :30]
    for l in np.flatnonzero(~iw):
        n = min(int(sl[l]), 30)
        np.testing.assert_array_equal(a[l, :n], b[l, :n], err_msg=f"line {l}")


def test_sparse_idx_packed_reduction_matches_search():
    """The gather-free packed masked reduction (the production
    extraction for H <= 65535) is element-identical to the binary search
    across cap dtypes (i8/i16 cumsum), odd caps, empty rows, and
    positions above 32767 in both 16-bit fields."""
    import jax.numpy as jnp

    from xsqueezeit_tpu.codec.encoder_jax import (
        sparse_idx_by_search,
        sparse_idx_packed_reduction,
    )
    rng = np.random.default_rng(7)
    for R, H, cap, p in [(64, 300, 16, 0.03), (37, 1024, 128, 0.05),
                         (8, 100, 8, 0.0), (5, 64, 64, 0.9),
                         (16, 1000, 127, 0.1), (16, 1000, 129, 0.1),
                         (16, 1000, 200, 0.15), (9, 40000, 33, 0.0006),
                         (4, 65535, 97, 0.001), (6, 50, 1, 0.02),
                         (3, 65535, 4, 0.9)]:
        mask = rng.random((R, H)) < p
        for r in np.flatnonzero(mask.sum(1) > cap):
            mask[r, np.flatnonzero(mask[r])[cap:]] = False
        a = np.asarray(sparse_idx_by_search(jnp.asarray(mask), cap))
        b = np.asarray(sparse_idx_packed_reduction(jnp.asarray(mask), cap))
        np.testing.assert_array_equal(a, b, err_msg=f"{(R, H, cap, p)}")
        c = np.asarray(sparse_idx_packed_reduction(
            jnp.asarray(mask), cap,
            count=jnp.asarray(mask.sum(1), jnp.int32)))
        np.testing.assert_array_equal(a, c, err_msg=f"count= {(R, H, cap)}")


@pytest.mark.parametrize("ws", [WeirdnessStrategy.WS_SPARSE,
                                WeirdnessStrategy.WS_WAH])
@pytest.mark.parametrize("min_rows", ["1", "1000000000"])
def test_tracks_device_batch_vs_host_loop(monkeypatch, ws, min_rows):
    """The batched device track encode and the per-record host loop must
    produce identical payload bytes (XSI_TRACKS_DEVICE_MIN selects the
    path; the sprinkle-missing regime flags every record)."""
    monkeypatch.setenv("XSI_TRACKS_DEVICE_MIN", min_rows)
    rng = np.random.default_rng(8)
    records = [make_record(rng, 70, p_alt=0.3, p_missing=0.02, p_eov=0.01,
                           p_phase_flip=0.03) for _ in range(30)]
    check_identical(records, 70, mac_threshold=3, ws=ws)


def test_wah_encode_rows_matches_loop():
    from xsqueezeit_tpu.ops import wah_np
    rng = np.random.default_rng(9)
    for H in (1, 14, 15, 31, 300, 5008):
        R = 37
        ps = rng.choice([0.0, 0.01, 0.5, 0.99, 1.0], size=R)
        bits = (rng.random((R, H)) < ps[:, None]).astype(np.uint8)
        stream, lens = wah_np.wah_encode_rows(bits)
        want = [wah_np.wah_encode(b) for b in bits]
        assert lens.tolist() == [w.shape[0] for w in want]
        np.testing.assert_array_equal(stream, np.concatenate(want))
    # counter saturation across the 16383-word boundary
    n = (16383 + 5) * 15
    bits = np.zeros((2, n), np.uint8)
    bits[1] = 1
    stream, lens = wah_np.wah_encode_rows(bits)
    np.testing.assert_array_equal(
        stream, np.concatenate([wah_np.wah_encode(b) for b in bits]))


def test_csr_sparse_assembly_matches_padded():
    """The CSR sparse-stream assembler (used by the batched track encode)
    must match the padded-matrix form byte for byte."""
    from xsqueezeit_tpu.codec.encoder_base import BlockEncoderBase

    rng = np.random.default_rng(10)
    enc = BlockEncoderBase(32, block_bcf_lines=100, mac_threshold=3,
                           aet_dtype=np.uint16)
    n, H = 17, 64
    bits = rng.random((n, H)) < rng.uniform(0, 0.3, (n, 1))
    counts = bits.sum(axis=1).astype(np.int64)
    negated = rng.random(n) < 0.3
    _, cc = np.nonzero(bits)
    cap = max(int(counts.max(initial=0)), 1)
    idx = np.zeros((n, cap), np.int64)
    rr, c2 = np.nonzero(bits)
    starts = (np.cumsum(counts) - counts)[rr]
    idx[rr, np.arange(rr.shape[0]) - starts] = c2
    got = enc._assemble_sparse_csr(cc, counts, negated)
    want = enc._assemble_sparse(idx, counts, negated, np.ones(n, bool))
    assert got == want


def test_hrc_width_wah_bucket_quarters():
    """H > 16384 coarsens the WAH-row axis to quarter buckets of L_pad:
    each (Lw, H) shape is one more cold compile of the block program at
    HRC width, so the fine bucket ladder is capped at 4 variants per
    block size (encoder_base.prepare)."""
    H = 20000  # > 16384 trigger
    n_samples = H // 2
    rng = np.random.default_rng(0)
    # L=512 records -> L_pad=512; q = max(512//4, 256) = 256 ->
    # bucket multiples {256, 512}
    for n_common, want in ((1, 256), (100, 256), (300, 512), (500, 512)):
        enc = DeviceBlockEncoder(n_samples, 1024, 2, aet_dtype=np.uint32)
        common = np.full(H, 2, np.int32)
        common[0::2] = 4
        rare = np.full(H, 2, np.int32)
        rare[0] = 4
        for i in range(512):
            enc.encode_record(common if i < n_common else rare, 2)
        prep = enc.prepare()
        assert prep["n_wah"] == n_common
        # L=512 records -> L_pad=512, quarter q=max(512//4,256)=256
        assert prep["wah_rows_p"].shape[0] == want, \
            (n_common, prep["wah_rows_p"].shape[0])


def test_large_threshold_sort_branch():
    """mac_threshold > 32 routes the compact kernel's carrier extraction
    through the batched-sort branch (the HRC regime: threshold = 64) —
    byte-identity + decode round trip on both index widths."""
    from xsqueezeit_tpu.codec.gt_block_decoder import GtBlockDecoder

    rng = np.random.default_rng(21)
    n_samples = 120  # H=240, thr=40 -> plenty of sparse lines below 40
    records = []
    for i in range(40):
        p = [0.01, 0.12, 0.5, 0.99][i % 4]
        records.append(make_record(rng, n_samples, p_alt=p,
                                   p_missing=0.02 if i % 5 == 0 else 0.0))
    for aet in (np.uint16, np.uint32):
        kw = dict(block_bcf_lines=100, mac_threshold=40, default_phasing=1,
                  aet_dtype=aet)
        ref = GtBlockEncoder(n_samples, **kw)
        dev = DeviceBlockEncoder(n_samples, **kw)
        for gt, na in records:
            ref.encode_record(gt, na)
            dev.encode_record(gt, na)
        a, b = ref.serialize(), dev.serialize()
        assert a == b, f"aet={np.dtype(aet).name}: {len(a)} vs {len(b)}"
        dec = GtBlockDecoder(b, n_samples, 2 * n_samples, aet_dtype=aet)
        pos = 0
        for gt, na in records:
            dec.seek(pos)
            np.testing.assert_array_equal(
                dec.fill_genotype_array_advance(na), gt)
            pos += na - 1
