/*
 * libxsqueezeit_tpu — native XSI accessor C API.
 *
 * A from-scratch C++17 implementation of the XSI random-access surface for
 * third-party C/C++ integrations (the reference exports libxsqueezeit with
 * include/c_api.h; this library provides the equivalent capability for this
 * framework): open a `.xsi` + its `_var.bcf` variant file, iterate records,
 * and fill htslib-style genotype arrays straight out of the compressed
 * representation.
 *
 * Genotype array encoding matches htslib/BCF conventions:
 *   value = (allele_index + 1) << 1 | phased
 *   missing = 0/1, end-of-vector = 0x80000001 (INT32_MIN + 1)
 */
#ifndef XSI_ACCESSOR_H
#define XSI_ACCESSOR_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct xsi_file xsi_file_t;

/* Open `<path>.xsi` (the `_var.bcf` companion is derived).  NULL on error. */
xsi_file_t *xsi_open(const char *xsi_path);
void xsi_close(xsi_file_t *f);

/* Header info */
uint32_t xsi_version(const xsi_file_t *f);
uint64_t xsi_num_samples(const xsi_file_t *f);
uint64_t xsi_num_variants(const xsi_file_t *f);
uint64_t xsi_num_records(const xsi_file_t *f);
uint32_t xsi_ploidy(const xsi_file_t *f);
const char *xsi_sample_name(const xsi_file_t *f, uint64_t i);

/* Variant-file record iteration.  Returns 1 while a record is available,
 * 0 at EOF, negative on error.  After a successful call the record's
 * n_allele, BM pointer, CHROM id and POS are exposed. */
int xsi_next_record(xsi_file_t *f);
int xsi_var_seek(xsi_file_t *f, uint64_t voff);
uint64_t xsi_var_tell(const xsi_file_t *f);
int32_t xsi_record_n_allele(const xsi_file_t *f);
int32_t xsi_record_bm(const xsi_file_t *f);
int32_t xsi_record_rid(const xsi_file_t *f);
int64_t xsi_record_pos(const xsi_file_t *f);  /* 0-based */

/* Raw BCF "shared" bytes of the current variant record (site columns as
 * stored in the `_var.bcf`; the extract path re-emits them with the
 * n_fmt/n_sample word patched).  Valid until the next xsi_next_record. */
const uint8_t *xsi_record_shared(const xsi_file_t *f, uint32_t *len);

/* Fill the current record's genotypes.  `gt_arr` must hold at least
 * xsi_num_samples()*2 int32 entries; returns the number of entries
 * written (n_samples * line_ploidy) or negative on error. */
int64_t xsi_get_genotypes(xsi_file_t *f, int32_t *gt_arr, size_t capacity);

/* Random access by BM pointer (block << 15 | offset). */
int64_t xsi_fill_genotypes_bm(xsi_file_t *f, int32_t bm, int32_t n_allele,
                              int32_t *gt_arr, size_t capacity);

/* Allele counts without materializing genotypes.  `counts` must hold
 * n_allele entries.  Returns 0 on success. */
int xsi_fill_allele_counts_bm(xsi_file_t *f, int32_t bm, int32_t n_allele,
                              int64_t *counts);

/* Batched allele counts for `n_records` records given per-record BM
 * pointers and allele counts; results are written back-to-back into
 * `counts_flat` (sum of n_alleles[i] entries).  One crossing for a whole
 * file walk; sequential BMs walk each block's streams forward without
 * re-seeks.  Returns the number of entries written, negative on error. */
int64_t xsi_count_alleles_range(xsi_file_t *f, const int32_t *bms,
                                const int32_t *n_alleles, int64_t n_records,
                                int64_t *counts_flat);

/* Bulk (BM, n_allele) scan of the variant file in one crossing; starts at
 * the current variant cursor.  Returns records written (<= cap), -1 on a
 * parse error. */
int64_t xsi_scan_records(xsi_file_t *f, int32_t *bm_out, int32_t *na_out,
                         int64_t cap);

const char *xsi_last_error(void);

/* zstd frame codec behind the container's --zstd block layer.  The
 * compress/decompress calls return the output size, or -1 with
 * xsi_last_error() set (always -1 when the library was built without
 * zstd: xsi_have_zstd() == 0). */
int xsi_have_zstd(void);
size_t xsi_zstd_bound(size_t n);
int64_t xsi_zstd_compress(const void *src, size_t n, void *dst, size_t cap,
                          int level);
int64_t xsi_zstd_decompress(const void *src, size_t n, void *dst,
                            size_t cap);

#ifdef __cplusplus
}
#endif

#endif /* XSI_ACCESSOR_H */
