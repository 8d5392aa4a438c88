"""Programmatic VCF fixture generators (equivalents of the reference's
micro_*.vcf test matrix, written from scratch)."""
from __future__ import annotations

import numpy as np

HEADER = """##fileformat=VCFv4.2
##FILTER=<ID=PASS,Description="All filters passed">
##contig=<ID=20,length=63025520>
##contig=<ID=X,length=155270560>
##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">
##INFO=<ID=AC,Number=A,Type=Integer,Description="Allele count">
##INFO=<ID=AN,Number=1,Type=Integer,Description="Allele number">
##INFO=<ID=AF,Number=A,Type=Float,Description="Allele frequency">
"""


# Header WITHOUT any ##INFO declarations: inputs like this exposed the
# round-4 subset-output corruption (AC/AN recomputation must declare its
# tags in the output header rather than inherit declarations of the input).
HEADER_BARE = """##fileformat=VCFv4.2
##FILTER=<ID=PASS,Description="All filters passed">
##contig=<ID=20,length=63025520>
##contig=<ID=X,length=155270560>
##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">
"""


def write_vcf(path, rows, n_samples=10, chrom="20", header=HEADER, info=None):
    samples = [f"S{i:03d}" for i in range(n_samples)]
    with open(path, "w") as f:
        f.write(header)
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(samples) + "\n")
        for i, (alt, gts) in enumerate(rows):
            assert len(gts) == n_samples
            inf = info if info is not None else f"AC=0;AN={2*n_samples}"
            f.write(f"{chrom}\t{60000 + i * 37}\trs{i}\tG\t{alt}\t100\tPASS\t"
                    f"{inf}\tGT\t" + "\t".join(gts) + "\n")
    return path


def gts(*cells):
    return list(cells)


def micro_basic(path, n=10):
    rows = [
        ("A", ["0|0", "1|0", "1|0", "0|0", "0|0", "0|0", "1|0", "0|1", "0|0", "0|0"]),
        ("T", ["0|0"] * 10),
        ("C", ["1|1"] * 10),
        ("G,T", ["0|1", "0|2", "1|2", "2|1", "0|0", "2|2", "1|0", "0|0", "0|0", "1|1"]),
        ("A", ["0|1", "1|1", "0|0", "1|0", "0|1", "1|1", "0|0", "0|0", "1|0", "0|1"]),
    ]
    return write_vcf(path, rows, n_samples=10)


def micro_missing(path):
    rows = [
        ("A", ["0|0", "1|0", "1|0", ".|0", "0|0", "0|0", "1|0", "0|1", "0|0", "0|0"]),
        ("T", ["0|0", "0|0", "0|0", "0|0", "0|0", "0|0", "0|.", "0|0", "0|1", "0|0"]),
        ("C", ["1|0", ".|.", ".|.", ".|.", "0|0", "0|0", "0|0", "0|0", "0|0", "0|0"]),
        ("G", ["0|0", "1|0", "0|0", "0|0", "0|0", "0|0", ".|.", "0|.", "0|0", "0|0"]),
        ("A", ["0|1", "0|0", "0|0", "0|0", "0|0", "0|0", "0|0", "0|0", "0|0", "0|0"]),
    ]
    return write_vcf(path, rows)


def micro_eov(path):
    # one sample haploid ("0") among diploids -> END_OF_VECTOR padding
    rows = [
        ("A", ["0|0", "1|0", "0", "0|0", "0|0", "1|0", "0|0", "0|0", "0|0", "0|0"]),
        ("T", ["0|0", "0|0", "0|0", "0", "0|1", "0|0", "0|0", "0|0", "1|0", "0|0"]),
        ("C", ["1", "0|0", "0|0", "0|0", "0|0", "0|0", "0|0", "0|0", "0|0", "0|0"]),
    ]
    return write_vcf(path, rows)


def micro_haploid(path):
    rows = [
        ("A", ["0", "1", "0", "0", "1", "0", "0", "1", "0", "0"]),
        ("T", ["0", "0", "0", "0", "0", "0", "0", "0", "0", "1"]),
        ("C", ["1", "1", "1", "1", "0", "1", "1", "1", "1", "1"]),
    ]
    return write_vcf(path, rows, chrom="X")


def micro_mixed_ploidy(path):
    # per-line ploidy changes: some lines all-haploid, some diploid
    rows = [
        ("A", ["0|0", "1|0", "0|0", "0|0", "0|0", "1|0", "0|0", "0|0", "0|0", "0|0"]),
        ("T", ["0", "1", "0", "0", "0", "0", "1", "0", "0", "0"]),
        ("C", ["0|1", "0|0", "0|0", "1|0", "0|0", "0|0", "0|0", "0|0", "0|0", "0|0"]),
        ("G", ["1", "0", "0", "0", "0", "0", "0", "0", "0", "0"]),
    ]
    return write_vcf(path, rows, chrom="X")


def micro_non_uniform_phase(path):
    rows = [
        ("A", ["0|0", "1/0", "1|0", "0|0", "0/0", "0|0", "1|0", "0|1", "0|0", "0|0"]),
        ("T", ["0/0", "0/0", "0|0", "0|0", "0|0", "0|0", "0|0", "0|0", "0|0", "0|0"]),
        ("C", ["1|0", "0|0", "0/1", "0|0", "0|0", "0|0", "0|0", "0|0", "0|0", "0|0"]),
    ]
    return write_vcf(path, rows)


def micro_missing_non_uniform_phasing(path):
    rows = [
        ("A", ["0|0", "1/0", ".|0", "0|0", "0/.", "0|0", "1|0", "0|1", "0|0", "0|0"]),
        ("T", ["0/0", ".|.", "0|0", "0|0", "0|0", "0|0", "0|0", "0|0", "0|0", "0|0"]),
    ]
    return write_vcf(path, rows)


def micro_missing_non_uniform_phasing_ploidy(path):
    rows = [
        ("A", ["0|0", "1/0", ".|0", "0", "0/.", "0|0", "1|0", "0|1", "0|0", "0|0"]),
        ("T", ["0", "1", ".", "0", "0", "0", "0", "0", "0", "0"]),
        ("C", ["0/0", ".|.", "0|0", "0", "0|0", "0|0", "1/1", "0|0", "0|0", "0|0"]),
    ]
    return write_vcf(path, rows)


def random_vcf(path, n_samples=127, n_records=300, seed=0, maf_mix=True,
               p_multi=0.1, chrom="20", bare_header=False):
    """A bigger randomized fixture with a rare/common MAF mix."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_records):
        n_alts = 2 if (p_multi and rng.random() < p_multi) else 1
        p_alt = rng.choice([0.001, 0.01, 0.2, 0.5, 0.9]) if maf_mix else 0.3
        cells = []
        for s in range(n_samples):
            a = rng.choice(n_alts + 1, 2, p=[1 - p_alt] + [p_alt / n_alts] * n_alts)
            cells.append(f"{a[0]}|{a[1]}")
        alt = ",".join("ACTG"[j % 4] * (j // 4 + 1) for j in range(1, n_alts + 1))
        rows.append((alt, cells))
    if bare_header:
        return write_vcf(path, rows, n_samples=n_samples, chrom=chrom,
                         header=HEADER_BARE, info=".")
    return write_vcf(path, rows, n_samples=n_samples, chrom=chrom)


def vcf_to_bcf(vcf_path: str, bcf_path: str) -> str:
    """Re-encode a VCF fixture as BCF (the package's own BCF writer)."""
    from xsqueezeit_tpu.io.bcf import BcfWriter, patch_shared_sample_counts
    from xsqueezeit_tpu.io.sites import encode_gt_indiv
    from xsqueezeit_tpu.io.unified import GtInput

    inp = GtInput(vcf_path)
    w = BcfWriter(bcf_path, inp.header)
    n = len(inp.samples)
    for rec in inp:
        shared = patch_shared_sample_counts(rec.shared, 1, n)
        w.write_raw(shared, encode_gt_indiv(inp.header, rec.gt,
                                            rec.ploidy, n))
    w.close()
    inp.close()
    return bcf_path


ALL_MICRO = {
    "micro_basic": micro_basic,
    "micro_missing": micro_missing,
    "micro_eov": micro_eov,
    "micro_haploid": micro_haploid,
    "micro_mixed_ploidy": micro_mixed_ploidy,
    "micro_non_uniform_phase": micro_non_uniform_phase,
    "micro_missing_non_uniform_phasing": micro_missing_non_uniform_phasing,
    "micro_missing_non_uniform_phasing_ploidy": micro_missing_non_uniform_phasing_ploidy,
}
