/*
 * Native XSI accessor — C++17, no htslib dependency.
 *
 * Implements, from the format specification (see SURVEY.md and the Python
 * modules under xsqueezeit_tpu/format):
 *   - BGZF block-gzip reader (zlib raw inflate)
 *   - minimal BCF2.2 record walker for the `_var.bcf` variant file
 *   - XSI container: 256-byte header, u64 block index, zstd block layer
 *   - GT block decoder: dictionary, WAH2 16-bit expansion, PBWT arrangement
 *     replay, sparse index lists, missing / end-of-vector / non-uniform
 *     phasing overlays, haploid lines
 */
#include "xsi_accessor.h"

#include "bgzf_reader.h"

#include <zlib.h>
#ifdef XSI_HAVE_ZSTD
#include <zstd.h>
#endif

#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

void set_error(const std::string &msg) { g_error = msg; }

constexpr uint32_t XSI_MAGIC = 0xfeed1767u;
constexpr int32_t INT32_MISSING_V = INT32_MIN;
constexpr int32_t INT32_EOV_V = INT32_MIN + 1;
constexpr int BM_BLOCK_BITS = 15;

/* BGZF reading is shared with the c_xcf shim: bgzf_reader.h. */
using xsi_native::BgzfReader;

/* ------------------------------------------------------- BCF record walk */
struct BcfRecordLite {
  int32_t rid = 0;
  int64_t pos = 0;
  int32_t n_allele = 0;
  int32_t bm = -1;
};

class VariantBcf {
 public:
  explicit VariantBcf(const std::string &path) : r_(path) {
    if (!r_.ok()) { set_error("cannot open " + path); return; }
    char magic[5];
    if (r_.read(magic, 5) != 5 || memcmp(magic, "BCF\2\2", 5) != 0) {
      set_error("not a BCF2.2 file: " + path);
      return;
    }
    uint32_t l_text;
    if (r_.read(&l_text, 4) != 4 || l_text > (1u << 30)) {
      set_error("BCF: malformed header length");
      return;
    }
    std::string text(l_text, '\0');
    if (r_.read(text.data(), l_text) != l_text) {
      set_error("BCF: truncated header");
      return;
    }
    parse_header(text);
    ok_ = true;
  }

  bool ok() const { return ok_; }
  int bm_key() const { return bm_key_; }
  const std::vector<uint8_t> &shared() const { return shared_; }
  bool seek_virtual(uint64_t voff) { return r_.seek_virtual(voff); }
  uint64_t tell_virtual() const { return r_.tell_virtual(); }

  // 1 = record, 0 = EOF, -1 = error
  int next(BcfRecordLite *rec) {
    uint32_t l_shared, l_indiv;
    if (r_.read(&l_shared, 4) != 4) return 0;
    if (r_.read(&l_indiv, 4) != 4) return -1;
    // Fixed site fields span bytes [0,24); cap both lengths so a corrupt
    // frame word cannot drive an absurd allocation.
    if (l_shared < 24 || l_shared > (1u << 30) || l_indiv > (1u << 30)) {
      set_error("BCF: malformed record frame");
      return -1;
    }
    shared_.resize(l_shared);
    indiv_.resize(l_indiv);
    if (r_.read(shared_.data(), l_shared) != l_shared) return -1;
    if (r_.read(indiv_.data(), l_indiv) != l_indiv) return -1;
    memcpy(&rec->rid, shared_.data(), 4);
    int32_t pos32;
    memcpy(&pos32, shared_.data() + 4, 4);
    rec->pos = pos32;
    uint32_t n_allele_info;
    memcpy(&n_allele_info, shared_.data() + 16, 4);
    rec->n_allele = int32_t(n_allele_info >> 16);
    rec->bm = find_bm();
    return 1;
  }

 private:
  void parse_header(const std::string &text) {
    // Build the string dictionary exactly like the Python BcfHeader.
    bool explicit_idx = text.find("IDX=") != std::string::npos;
    std::vector<std::pair<std::string, int>> entries;
    bool has_pass = false;
    size_t start = 0;
    while (start < text.size()) {
      size_t end = text.find('\n', start);
      if (end == std::string::npos) end = text.size();
      std::string line = text.substr(start, end - start);
      start = end + 1;
      if (line.rfind("##", 0) != 0) continue;
      std::string key = line.substr(2, line.find('=') - 2);
      if (key != "FILTER" && key != "INFO" && key != "FORMAT") continue;
      size_t idp = line.find("ID=");
      if (idp == std::string::npos) continue;
      size_t ide = line.find_first_of(",>", idp + 3);
      std::string ident = line.substr(idp + 3, ide - idp - 3);
      int idx = -1;
      if (explicit_idx) {
        size_t xp = line.find("IDX=");
        if (xp != std::string::npos) idx = atoi(line.c_str() + xp + 4);
      }
      if (ident == "PASS") has_pass = true;
      bool seen = false;
      for (auto &e : entries) if (e.first == ident) { seen = true; break; }
      if (!seen) entries.emplace_back(ident, idx);
    }
    if (!has_pass) {
      bool any_explicit = false;
      for (auto &e : entries) any_explicit |= e.second >= 0;
      entries.insert(entries.begin(), {"PASS", any_explicit ? 0 : -1});
    }
    int max_idx = -1;
    for (auto &e : entries) max_idx = std::max(max_idx, e.second);
    std::vector<std::string> table(max_idx + 1);
    std::vector<bool> used(max_idx + 1, false);
    for (auto &e : entries)
      if (e.second >= 0) { table[e.second] = e.first; used[e.second] = true; }
    size_t free_slot = 0;
    for (auto &e : entries) {
      if (e.second >= 0) continue;
      while (free_slot < used.size() && used[free_slot]) free_slot++;
      if (free_slot < table.size()) {
        table[free_slot] = e.first;
        used[free_slot] = true;
      } else {
        table.push_back(e.first);
        used.push_back(true);
      }
    }
    for (size_t i = 0; i < table.size(); ++i)
      if (table[i] == "BM") bm_key_ = int(i);
  }

  // Parse the indiv block for the BM FORMAT value of the pseudo-sample.
  // All typed reads are bounds-checked: the indiv bytes are untrusted.
  int32_t find_bm() {
    const uint8_t *p = indiv_.data();
    const uint8_t *endp = p + indiv_.size();
    while (p < endp) {
      int64_t key, len;
      if (!read_typed_int(&p, endp, &key) || p >= endp) return -1;
      uint8_t d = *p++;
      int type = d & 0x0f;
      len = d >> 4;
      if (len == 15 && !read_typed_int(&p, endp, &len)) return -1;
      if (len < 0) return -1;
      int width = (type == 1 || type == 7) ? 1   // int8, char
                  : type == 2 ? 2                  // int16
                  : 4;                             // int32, float
      size_t span = size_t(width) * size_t(len);  // n_sample == 1
      if (span > size_t(endp - p)) return -1;
      if (key == bm_key_ && (type == 1 || type == 2 || type == 3)) {
        if (size_t(width) > size_t(endp - p)) return -1;
        int64_t v = 0;
        if (type == 1) v = *reinterpret_cast<const int8_t *>(p);
        else if (type == 2) { int16_t t; memcpy(&t, p, 2); v = t; }
        else { int32_t t; memcpy(&t, p, 4); v = t; }
        return int32_t(v);
      }
      p += span;
    }
    return -1;
  }

  static bool read_typed_int(const uint8_t **pp, const uint8_t *endp,
                             int64_t *out) {
    const uint8_t *p = *pp;
    if (p >= endp) return false;
    uint8_t d = *p++;
    int type = d & 0x0f;
    int64_t v = 0;
    if (type == 1) {
      if (p + 1 > endp) return false;
      v = *reinterpret_cast<const int8_t *>(p); p += 1;
    } else if (type == 2) {
      if (p + 2 > endp) return false;
      int16_t t; memcpy(&t, p, 2); v = t; p += 2;
    } else {
      if (p + 4 > endp) return false;
      int32_t t; memcpy(&t, p, 4); v = t; p += 4;
    }
    *pp = p;
    *out = v;
    return true;
  }

  BgzfReader r_;
  bool ok_ = false;
  int bm_key_ = -1;
  std::vector<uint8_t> shared_, indiv_;
};

/* ------------------------------------------------------------ XSI header */
#pragma pack(push, 1)
struct XsiHeader {
  uint32_t endianness, first_magic, version;
  uint8_t ploidy, ind_bytes, aet_bytes, wah_bytes;
  uint8_t special_bitset, specific_bitset;
  uint8_t rsvd_bs[2];
  uint32_t rsvd_1[3];
  uint64_t hap_samples, num_variants;
  uint32_t block_size, number_of_blocks, ss_rate, number_of_ssas;
  uint64_t wahs_offset, indices_offset, samples_offset;
  uint32_t rearrangement_track_offset, sparse_offset, rare_threshold;
  uint64_t xcf_entries;
  uint32_t phase_info_offset;
  uint64_t num_samples;
  uint8_t rsvd_3[104];
  uint32_t rsvd_4[3];
  uint32_t chksum[4];
  uint32_t last_magic;
};
#pragma pack(pop)
static_assert(sizeof(XsiHeader) == 256, "header must be 256 bytes");

/* --------------------------------------------------------- WAH utilities */
constexpr uint16_t WAH_HIGH = 0x8000, WAH_ONE = 0x4000, WAH_MAXC = 0x3fff;
constexpr int WAH_BITS = 15;

// Decode `size` bits; advances *wp, never past `wend` (corrupt streams
// without enough words stop short — untrusted input must not overread).
// Returns popcount over the full span.
size_t wah2_extract(const uint16_t **wp, std::vector<uint8_t> &bits,
                    size_t size, const uint16_t *wend) {
  const uint16_t *p = *wp;
  size_t bpos = 0, ones = 0;
  while (bpos < size && p < wend) {
    uint16_t w = *p++;
    if (w & WAH_HIGH) {
      size_t n = size_t(w & WAH_MAXC) * WAH_BITS;
      uint8_t fill = (w & WAH_ONE) ? 1 : 0;
      size_t stop = std::min(bpos + n, bits.size());
      if (bpos < stop) memset(bits.data() + bpos, fill, stop - bpos);
      if (fill) ones += n;
      bpos += n;
    } else {
      uint16_t v = w;
      for (int j = 0; j < WAH_BITS && bpos + j < bits.size(); ++j) {
        bits[bpos + j] = v & 1;
        ones += v & 1;
        v >>= 1;
      }
      bpos += WAH_BITS;
    }
  }
  *wp = p;
  return ones;
}

void wah2_advance(const uint16_t **wp, size_t size, const uint16_t *wend) {
  const uint16_t *p = *wp;
  size_t bpos = 0;
  while (bpos < size && p < wend) {
    uint16_t w = *p++;
    bpos += (w & WAH_HIGH) ? size_t(w & WAH_MAXC) * WAH_BITS : WAH_BITS;
  }
  *wp = p;
}

// Popcount a WAH2 line WITHOUT expanding bits: run words carry their count
// directly, literal words popcount in one instruction — O(words), not
// O(haplotypes).  Tail-bit semantics match wah2_extract (fill runs count
// their full span; encoder contract keeps pad bits zero).  This is the
// count-only fast path the reference leans on for af_stats
// (accessor_internals_new.hpp:407-438 fill_allele_counts_advance).
size_t wah2_popcount(const uint16_t **wp, size_t size, const uint16_t *wend) {
  const uint16_t *p = *wp;
  size_t bpos = 0, ones = 0;
  while (bpos < size && p < wend) {
    uint16_t w = *p++;
    if (w & WAH_HIGH) {
      size_t n = size_t(w & WAH_MAXC) * WAH_BITS;
      if (w & WAH_ONE) ones += n;
      bpos += n;
    } else {
      ones += size_t(__builtin_popcount(w));
      bpos += WAH_BITS;
    }
  }
  *wp = p;
  return ones;
}

/* ----------------------------------------------------------- GT decoder */
enum GtKeys : uint32_t {
  KEY_BCF_LINES = 0, KEY_BINARY_LINES = 1, KEY_MAX_LINE_PLOIDY = 2,
  KEY_DEFAULT_PHASING = 3, KEY_WEIRDNESS_STRATEGY = 4,
  KEY_LINE_SORT = 0x10, KEY_LINE_SELECT = 0x11, KEY_LINE_HAPLOID = 0x12,
  KEY_LINE_MISSING = 0x16, KEY_LINE_NON_UNIFORM_PHASING = 0x17,
  KEY_LINE_END_OF_VECTORS = 0x18,
  KEY_MATRIX_WAH = 0x20, KEY_MATRIX_SPARSE = 0x21, KEY_MATRIX_MISSING = 0x26,
  KEY_MATRIX_NON_UNIFORM_PHASING = 0x27, KEY_MATRIX_END_OF_VECTORS = 0x28,
  KEY_MATRIX_MISSING_SPARSE = 0x36, KEY_MATRIX_END_OF_VECTORS_SPARSE = 0x38,
};
enum { WS_PBWT_WAH = 0, WS_WAH = 1, WS_SPARSE = 2 };
constexpr uint32_t VAL_UNDEF = 0xffffffffu;

template <typename A_T>
class GtBlockDecoder {
 public:
  // `len` bounds every offset/stream read: the payload is untrusted file
  // bytes, so a corrupt dictionary or counter must surface as !ok(),
  // never as an overread (the Python decoder raises; this mirrors it).
  GtBlockDecoder(const uint8_t *payload, size_t len, size_t n_samples,
                 size_t n_haps)
      : p_(payload), len_(len), n_samples_(n_samples), n_haps_(n_haps) {
    if (len < 8) { fail("block payload too small"); return; }
    const uint32_t *u = reinterpret_cast<const uint32_t *>(payload);
    uint32_t n = u[1];
    if (n > (1u << 20) || 8 + size_t(n) * 8 > len) {
      fail("block dictionary exceeds payload");
      return;
    }
    for (uint32_t i = 0; i < n; ++i) dict_[u[2 + 2 * i]] = u[3 + 2 * i];
    if (!dict_.count(KEY_BCF_LINES) || !dict_.count(KEY_BINARY_LINES)) {
      fail("block dictionary missing line counts");
      return;
    }
    bcf_lines_ = dict_[KEY_BCF_LINES];
    binary_lines_ = dict_[KEY_BINARY_LINES];
    if (bcf_lines_ > (1u << 28) || binary_lines_ > (1u << 28)) {
      fail("absurd block line counts");
      return;
    }
    default_phasing_ = dict_.count(KEY_DEFAULT_PHASING) ?
        int(dict_[KEY_DEFAULT_PHASING]) : 0;
    if (default_phasing_ != 1) default_phasing_ = 0;
    ws_ = dict_.count(KEY_WEIRDNESS_STRATEGY) ?
        int(dict_[KEY_WEIRDNESS_STRATEGY]) : WS_PBWT_WAH;
    // WS_MIXED (=3, gt_block.hpp:70): the reference throws at encode when
    // its sparse heuristic fires (gt_block.hpp:346-348), so on-disk
    // WS_MIXED blocks are WAH-track-only — decode as WS_WAH.
    if (ws_ == 3) ws_ = WS_WAH;
    if (ws_ != WS_PBWT_WAH && ws_ != WS_WAH && ws_ != WS_SPARSE) {
      fail("unknown weirdness strategy");
      return;
    }

    if (!load_bool(KEY_LINE_SELECT, is_wah_)) {
      fail("block missing line-select track");
      return;
    }
    if (!load_bool(KEY_LINE_SORT, is_sorting_)) is_sorting_ = is_wah_;
    has_missing_ = load_bool(KEY_LINE_MISSING, line_missing_);
    has_eov_ = load_bool(KEY_LINE_END_OF_VECTORS, line_eov_);
    has_nup_ = load_bool(KEY_LINE_NON_UNIFORM_PHASING, line_nup_);
    if (!load_bool(KEY_LINE_HAPLOID, haploid_))
      haploid_.assign(binary_lines_, 0);

    wah0_ = ptr<uint16_t>(KEY_MATRIX_WAH);
    sparse0_ = ptr<A_T>(KEY_MATRIX_SPARSE);
    miss_wah0_ = ptr<uint16_t>(KEY_MATRIX_MISSING);
    miss_sp0_ = ptr<A_T>(KEY_MATRIX_MISSING_SPARSE);
    eov_wah0_ = ptr<uint16_t>(KEY_MATRIX_END_OF_VECTORS);
    eov_sp0_ = ptr<A_T>(KEY_MATRIX_END_OF_VECTORS_SPARSE);
    nup_wah0_ = ptr<uint16_t>(KEY_MATRIX_NON_UNIFORM_PHASING);
    wend_ = reinterpret_cast<const uint16_t *>(p_ + (len_ & ~size_t(1)));
    send_ = reinterpret_cast<const A_T *>(
        p_ + (len_ & ~size_t(sizeof(A_T) - 1)));
    reset();
  }

  bool ok() const { return ok_; }

  void reset() {
    pos_ = 0;
    wah_ = wah0_; sparse_ = sparse0_;
    miss_wah_ = miss_wah0_; miss_sp_ = miss_sp0_;
    eov_wah_ = eov_wah0_; eov_sp_ = eov_sp0_;
    nup_wah_ = nup_wah0_;
    weird_pos_ = phase_pos_ = 0;
    a_.resize(n_haps_); b_.resize(n_haps_);
    aw_.resize(n_haps_); bw_.resize(n_haps_);
    for (size_t i = 0; i < n_haps_; ++i) a_[i] = aw_[i] = A_T(i);
    y_.assign(n_haps_ + 16, 0);
    yw_.assign(n_haps_ + 16, 0);
  }

  size_t cur_n_haps(size_t pos) const {
    return (pos < haploid_.size() && haploid_[pos]) ? n_samples_ : n_haps_;
  }

  bool seek(size_t position) {
    if (!ok_) return false;
    if (position > binary_lines_) {
      set_error("seek position beyond block lines (corrupt BM?)");
      return false;
    }
    if (position == pos_) return true;
    if (position < pos_) reset();
    while (pos_ < position && ok_) {
      advance_main(false);
      advance_tracks(1);
      pos_++;
    }
    return ok_;
  }

  // Fill htslib gt array for the record at the cursor; returns entries.
  int64_t fill(int32_t *gt, size_t capacity, int n_allele,
               int64_t *counts /*nullable, size n_allele*/) {
    if (!ok_) { set_error("corrupt block payload"); return -1; }
    if (a_stale_) {
      // a count-only walk skipped the PBWT arrangement updates; rebuild
      // by replaying the block up to the current record
      size_t tgt = pos_;
      reset();
      a_stale_ = false;
      if (!seek(tgt)) return -1;
    }
    if (n_allele > 1 &&
        pos_ + size_t(n_allele - 1) > size_t(binary_lines_)) {
      set_error("record needs more binary lines than the block has");
      return -1;
    }
    if (n_allele <= 1) {
      // zero-ALT (monomorphic) records own no binary line: all-REF with
      // default phasing, nothing consumed (mirrors the Python decoder)
      size_t n = n_haps_;
      if (capacity < n) { set_error("gt array too small"); return -1; }
      for (size_t i = 0; i < n; ++i)
        gt[i] = (1 << 1) | int32_t((i & 1) & unsigned(default_phasing_));
      if (counts) counts[0] = int64_t(n);
      return int64_t(n);
    }
    size_t start = pos_;
    size_t n = cur_n_haps(start);
    bool hap = haploid_[start];
    if (capacity < n) { set_error("gt array too small"); return -1; }
    int dp = default_phasing_;
    int64_t total_alt = 0, n_missing = 0, n_eovs = 0;

    for (int alt = 1; alt < n_allele; ++alt) {
      bool first = alt == 1;
      if (!is_wah_[pos_]) {  // sparse
        if (!sparse_ || sparse_ >= send_) {
          set_error("sparse stream truncated");
          return -1;
        }
        A_T head = *sparse_++;
        bool neg = head & msb();
        size_t cnt = head & ~msb();
        if (cnt > size_t(send_ - sparse_) || cnt > n) {
          set_error("sparse count exceeds stream/haplotypes");
          return -1;
        }
        if (first) {
          int32_t defv = neg ? 4 : 2;   // (1+1)<<1 : (0+1)<<1
          int32_t spv = neg ? 2 : 4;
          for (size_t i = 0; i < n; ++i) gt[i] = defv | (int32_t(i & 1) & dp);
          for (size_t k = 0; k < cnt; ++k) {
            size_t i = sparse_[k];
            if (i >= n) { set_error("sparse index out of range"); return -1; }
            gt[i] = spv | (int32_t(i & 1) & dp);
          }
        } else if (neg) {
          for (size_t i = 0; i < n; ++i)
            if ((gt[i] >> 1) == 1) gt[i] = ((alt + 1) << 1) | (int32_t(i & 1) & dp);
          for (size_t k = 0; k < cnt; ++k) {
            size_t i = sparse_[k];
            if (i >= n) { set_error("sparse index out of range"); return -1; }
            if ((gt[i] >> 1) - 1 == alt) gt[i] = 2 | (int32_t(i & 1) & dp);
          }
        } else {
          for (size_t k = 0; k < cnt; ++k) {
            size_t i = sparse_[k];
            if (i >= n) { set_error("sparse index out of range"); return -1; }
            gt[i] = ((alt + 1) << 1) | (int32_t(i & 1) & dp);
          }
        }
        sparse_ += cnt;
        ones_ = neg ? n - cnt : cnt;
      } else {  // WAH
        if (!wah_) { set_error("WAH stream absent"); return -1; }
        ones_ = wah2_extract(&wah_, y_, n, wend_);
        if (hap) {
          size_t k = 0;
          for (size_t i = 0; i < n_haps_ && k < n; ++i) {
            if ((a_[i] & 1) == 0) {
              size_t tgt = a_[i] / 2;
              if (first) gt[tgt] = (int32_t(y_[k]) + 1) << 1;
              else if (y_[k]) gt[tgt] = (alt + 1) << 1;
              k++;
            }
          }
        } else {
          if (first) {
            for (size_t i = 0; i < n; ++i) {
              A_T t = a_[i];
              gt[t] = ((int32_t(y_[i]) + 1) << 1) | (int32_t(t & 1) & dp);
            }
          } else {
            for (size_t i = 0; i < n; ++i) {
              if (y_[i]) {
                A_T t = a_[i];
                gt[t] = ((alt + 1) << 1) | (int32_t(t & 1) & dp);
              }
            }
          }
        }
      }
      if (counts && alt < n_allele) counts[alt] = ones_;
      total_alt += ones_;
      update_a();
      pos_++;
    }

    /* exception overlays */
    if (has_missing_ && line_missing_[start]) {
      if (ws_ == WS_SPARSE) {
        const A_T *sp = miss_sp_;
        if (!sp || sp >= send_) { set_error("missing track truncated"); return -1; }
        size_t cnt = *sp++ & ~msb();
        if (cnt > size_t(send_ - sp) || cnt > n) {
          set_error("missing track count exceeds stream");
          return -1;
        }
        n_missing = cnt;
        for (size_t k = 0; k < cnt; ++k) {
          size_t i = sp[k];
          if (i >= n) { set_error("missing index out of range"); return -1; }
          gt[i] = int32_t(i & 1) & dp;
        }
      } else {
        const uint16_t *mp = miss_wah_;
        if (!mp) { set_error("missing track absent"); return -1; }
        n_missing = 0;
        (void)wah2_extract(&mp, yw_, n, wend_);
        for (size_t i = 0; i < n; ++i) {
          if (yw_[i]) {
            size_t t = weird_target(i, hap);
            gt[t] = int32_t(t & 1) & dp;
            n_missing++;
          }
        }
      }
    }
    if (has_eov_ && line_eov_[start]) {
      if (ws_ == WS_SPARSE) {
        const A_T *sp = eov_sp_;
        if (!sp || sp >= send_) { set_error("EOV track truncated"); return -1; }
        size_t cnt = *sp++ & ~msb();
        if (cnt > size_t(send_ - sp) || cnt > n) {
          set_error("EOV track count exceeds stream");
          return -1;
        }
        n_eovs = cnt;
        for (size_t k = 0; k < cnt; ++k) {
          size_t i = size_t(sp[k]);
          if (i >= n) { set_error("EOV index out of range"); return -1; }
          gt[i] = INT32_EOV_V;
        }
      } else {
        const uint16_t *ep = eov_wah_;
        if (!ep) { set_error("EOV track absent"); return -1; }
        n_eovs = 0;
        (void)wah2_extract(&ep, yw_, n, wend_);
        for (size_t i = 0; i < n; ++i)
          if (yw_[i]) { gt[weird_target(i, hap)] = INT32_EOV_V; n_eovs++; }
      }
    }
    if (has_nup_ && line_nup_[start]) {
      const uint16_t *pp = nup_wah_;
      if (!pp) { set_error("phase track absent"); return -1; }
      (void)wah2_extract(&pp, yw_, n, wend_);
      for (size_t i = 0; i < n; ++i)
        if (yw_[i] && gt[i] != INT32_EOV_V) gt[i] ^= int32_t(i & 1);
    }
    advance_tracks(n_allele - 1);
    if (counts) counts[0] = int64_t(n) - (total_alt + n_missing + n_eovs);
    return int64_t(n);
  }

  // Count-only record advance: counts[alt>=1] straight from sparse heads /
  // WAH run-word popcounts, counts[0] by subtraction — no genotype
  // materialization and no PBWT arrangement maintenance (a_ goes stale;
  // fill() replays the block before the next positional decode).
  // O(stream words) per record vs fill()'s O(haplotypes) — the count-only
  // walk the reference uses for af_stats
  // (accessor_internals_new.hpp:407-438 fill_allele_counts_advance).
  int fill_counts(int n_allele, int64_t *counts) {
    if (!ok_) { set_error("corrupt block payload"); return -1; }
    if (n_allele > 1 &&
        pos_ + size_t(n_allele - 1) > size_t(binary_lines_)) {
      set_error("record needs more binary lines than the block has");
      return -1;
    }
    size_t start = pos_;
    size_t n = cur_n_haps(start);
    if (n_allele <= 1) {
      counts[0] = int64_t(n_haps_);  // zero-ALT: all-REF, no line consumed
      return 0;
    }
    int64_t total_alt = 0, n_missing = 0, n_eovs = 0;
    for (int alt = 1; alt < n_allele; ++alt) {
      if (is_wah_[pos_]) {
        if (!wah_) { set_error("WAH stream absent"); return -1; }
        ones_ = wah2_popcount(&wah_, n, wend_);
        if (is_sorting_[pos_]) a_stale_ = true;
      } else {
        if (!sparse_ || sparse_ >= send_) {
          set_error("sparse stream truncated");
          return -1;
        }
        A_T head = *sparse_++;
        size_t cnt = head & ~msb();
        if (cnt > size_t(send_ - sparse_) || cnt > n) {
          set_error("sparse count exceeds stream/haplotypes");
          return -1;
        }
        ones_ = (head & msb()) ? n - cnt : cnt;
        sparse_ += cnt;
      }
      counts[alt] = int64_t(ones_);
      total_alt += int64_t(ones_);
      pos_++;
    }
    // exception-track counts for the record's start line (count via local
    // pointer copies; the track streams advance below, same as fill())
    if (has_missing_ && line_missing_[start]) {
      if (ws_ == WS_SPARSE) {
        const A_T *sp = miss_sp_;
        if (!sp || sp >= send_) { set_error("missing track truncated"); return -1; }
        size_t cnt = *sp++ & ~msb();
        if (cnt > size_t(send_ - sp) || cnt > n) {
          set_error("missing track count exceeds stream");
          return -1;
        }
        n_missing = int64_t(cnt);
      } else {
        const uint16_t *mp = miss_wah_;
        if (!mp) { set_error("missing track absent"); return -1; }
        n_missing = int64_t(wah2_popcount(&mp, n, wend_));
      }
    }
    if (has_eov_ && line_eov_[start]) {
      if (ws_ == WS_SPARSE) {
        const A_T *sp = eov_sp_;
        if (!sp || sp >= send_) { set_error("EOV track truncated"); return -1; }
        size_t cnt = *sp++ & ~msb();
        if (cnt > size_t(send_ - sp) || cnt > n) {
          set_error("EOV track count exceeds stream");
          return -1;
        }
        n_eovs = int64_t(cnt);
      } else {
        const uint16_t *ep = eov_wah_;
        if (!ep) { set_error("EOV track absent"); return -1; }
        n_eovs = int64_t(wah2_popcount(&ep, n, wend_));
      }
    }
    advance_tracks(n_allele - 1);
    counts[0] = int64_t(n) - (total_alt + n_missing + n_eovs);
    return 0;
  }

  size_t pos() const { return pos_; }

 private:
  static constexpr A_T msb() { return A_T(1) << (sizeof(A_T) * 8 - 1); }

  size_t weird_target(size_t i, bool hap) const {
    if (!hap) return aw_[i];
    // haploid arrangement derived from the (possibly sorted) diploid aw_
    size_t k = 0;
    for (size_t j = 0; j < n_haps_; ++j) {
      if ((aw_[j] & 1) == 0) {
        if (k == i) return aw_[j] / 2;
        k++;
      }
    }
    return 0;
  }

  void fail(const char *msg) { ok_ = false; set_error(msg); }

  bool load_bool(uint32_t key, std::vector<uint8_t> &v) {
    auto it = dict_.find(key);
    if (it == dict_.end() || it->second == VAL_UNDEF) return false;
    if (it->second % 2 || it->second >= len_) {
      fail("line-track offset out of payload range");
      return false;
    }
    const uint16_t *wp = reinterpret_cast<const uint16_t *>(p_ + it->second);
    const uint16_t *we =
        reinterpret_cast<const uint16_t *>(p_ + (len_ & ~size_t(1)));
    v.assign(binary_lines_ + 16, 0);
    wah2_extract(&wp, v, binary_lines_, we);
    v.resize(binary_lines_);
    return true;
  }

  template <typename T>
  const T *ptr(uint32_t key) const {
    auto it = dict_.find(key);
    if (it == dict_.end() || it->second == VAL_UNDEF) return nullptr;
    if (it->second % alignof(T) || it->second >= len_) return nullptr;
    return reinterpret_cast<const T *>(p_ + it->second);
  }

  void advance_main(bool extract) {
    size_t n = cur_n_haps(pos_);
    if (is_wah_[pos_]) {
      if (!wah_) { fail("WAH stream absent"); return; }
      if (extract || is_sorting_[pos_])
        ones_ = wah2_extract(&wah_, y_, n, wend_);
      else
        wah2_advance(&wah_, n, wend_);
      if (is_sorting_[pos_]) update_a();
    } else {
      if (!sparse_ || sparse_ >= send_) {
        fail("sparse stream truncated");
        return;
      }
      A_T head = *sparse_++;
      size_t cnt = head & ~msb();
      if (cnt > size_t(send_ - sparse_)) {
        fail("sparse count exceeds stream");
        return;
      }
      ones_ = (head & msb()) ? n - cnt : cnt;
      sparse_ += cnt;
    }
  }

  // PBWT update from y_ (already extracted) when the line sorts.
  void update_a() {
    if (!is_sorting_[pos_]) return;
    size_t n = cur_n_haps(pos_);
    if (haploid_[pos_]) {
      // scatter y (in a1 order) to natural sample order, partition a by /2
      std::vector<uint8_t> x(n_samples_, 0);
      size_t k = 0;
      for (size_t j = 0; j < n_haps_ && k < n; ++j)
        if ((a_[j] & 1) == 0) x[a_[j] / 2] = y_[k++];
      size_t u = 0, v = 0;
      for (size_t i = 0; i < n_haps_; ++i) {
        if (!x[a_[i] / 2]) a_[u++] = a_[i];
        else b_[v++] = a_[i];
      }
      if (v) memcpy(a_.data() + u, b_.data(), v * sizeof(A_T));
    } else {
      size_t u = 0, v = 0;
      for (size_t i = 0; i < n_haps_; ++i) {
        if (!y_[i]) a_[u++] = a_[i];
        else b_[v++] = a_[i];
      }
      if (v) memcpy(a_.data() + u, b_.data(), v * sizeof(A_T));
    }
  }

  void advance_tracks(size_t steps) {
    for (size_t s = 0; s < steps && ok_; ++s) {
      size_t p = weird_pos_;
      if (p >= size_t(binary_lines_)) return;   // corrupt overshoot
      size_t n = cur_n_haps(p);
      if (has_missing_ || has_eov_) {
        bool hm = has_missing_ && line_missing_[p];
        bool he = has_eov_ && line_eov_[p];
        if (ws_ == WS_SPARSE) {
          if (hm) {
            if (!miss_sp_ || miss_sp_ >= send_) {
              fail("missing track truncated");
              return;
            }
            A_T h = *miss_sp_;
            size_t adv = 1 + (h & ~msb());
            if (adv > size_t(send_ - miss_sp_)) { fail("missing track truncated"); return; }
            miss_sp_ += adv;
          }
          if (he) {
            if (!eov_sp_ || eov_sp_ >= send_) {
              fail("EOV track truncated");
              return;
            }
            A_T h = *eov_sp_;
            size_t adv = 1 + (h & ~msb());
            if (adv > size_t(send_ - eov_sp_)) { fail("EOV track truncated"); return; }
            eov_sp_ += adv;
          }
        } else {
          std::vector<uint8_t> ym, ye;
          if (hm) {
            if (!miss_wah_) { fail("missing track absent"); return; }
            ym.assign(n + 16, 0);
            wah2_extract(&miss_wah_, ym, n, wend_);
          }
          if (he) {
            if (!eov_wah_) { fail("EOV track absent"); return; }
            ye.assign(n + 16, 0);
            wah2_extract(&eov_wah_, ye, n, wend_);
          }
          if (ws_ == WS_PBWT_WAH && !haploid_[p] && (hm || he)) {
            size_t u = 0, v = 0;
            for (size_t i = 0; i < n_haps_; ++i) {
              bool bit = (hm && ym[i]) || (he && ye[i]);
              if (!bit) aw_[u++] = aw_[i];
              else bw_[v++] = aw_[i];
            }
            if (v) memcpy(aw_.data() + u, bw_.data(), v * sizeof(A_T));
          }
        }
      }
      weird_pos_++;
      if (has_nup_) {
        if (phase_pos_ < line_nup_.size() && line_nup_[phase_pos_]) {
          if (!nup_wah_) { fail("phase track absent"); return; }
          wah2_advance(&nup_wah_, n, wend_);
        }
        phase_pos_++;
      }
    }
  }

  const uint8_t *p_;
  size_t len_ = 0;
  bool ok_ = true;
  const uint16_t *wend_ = nullptr;   // payload end for 16-bit streams
  const A_T *send_ = nullptr;        // payload end for sparse streams
  size_t n_samples_, n_haps_;
  std::map<uint32_t, uint32_t> dict_;
  uint32_t bcf_lines_ = 0, binary_lines_ = 0;
  int default_phasing_ = 0, ws_ = WS_SPARSE;
  std::vector<uint8_t> is_wah_, is_sorting_, line_missing_, line_eov_,
      line_nup_, haploid_;
  bool has_missing_ = false, has_eov_ = false, has_nup_ = false;

  const uint16_t *wah0_ = nullptr, *wah_ = nullptr;
  const A_T *sparse0_ = nullptr, *sparse_ = nullptr;
  const uint16_t *miss_wah0_ = nullptr, *miss_wah_ = nullptr;
  const A_T *miss_sp0_ = nullptr, *miss_sp_ = nullptr;
  const uint16_t *eov_wah0_ = nullptr, *eov_wah_ = nullptr;
  const A_T *eov_sp0_ = nullptr, *eov_sp_ = nullptr;
  const uint16_t *nup_wah0_ = nullptr, *nup_wah_ = nullptr;

  size_t pos_ = 0, weird_pos_ = 0, phase_pos_ = 0;
  bool a_stale_ = false;  // count-only walks skip arrangement updates
  size_t ones_ = 0;
  std::vector<A_T> a_, b_, aw_, bw_;
  std::vector<uint8_t> y_, yw_;
};

/* -------------------------------------------------------------- xsi_file */
struct BlockCursorBase {
  virtual ~BlockCursorBase() = default;
  virtual bool ok() const = 0;
  virtual bool seek(size_t pos) = 0;
  virtual int64_t fill(int32_t *gt, size_t cap, int n_allele, int64_t *c) = 0;
  virtual int fill_counts(int n_allele, int64_t *c) = 0;
};

template <typename A_T>
struct BlockCursor : BlockCursorBase {
  BlockCursor(const uint8_t *payload, size_t len, size_t ns, size_t nh)
      : dec(payload, len, ns, nh) {}
  bool ok() const override { return dec.ok(); }
  bool seek(size_t pos) override { return dec.seek(pos); }
  int64_t fill(int32_t *gt, size_t cap, int n_allele, int64_t *c) override {
    return dec.fill(gt, cap, n_allele, c);
  }
  int fill_counts(int n_allele, int64_t *c) override {
    return dec.fill_counts(n_allele, c);
  }
  GtBlockDecoder<A_T> dec;
};

}  // namespace

struct xsi_file {
  XsiHeader header;
  std::vector<uint8_t> data;       // whole .xsi file
  std::vector<uint64_t> indices;
  std::vector<std::string> samples;
  std::unique_ptr<VariantBcf> var;
  BcfRecordLite cur;
  std::unique_ptr<BlockCursorBase> cursor;
  int64_t cursor_block = -1;
  std::vector<uint8_t> zstd_buf;   // decompressed block when zstd
  size_t n_haps = 0;

  // Returns the GT-entry payload and its length (bytes to the end of the
  // decompressed block).  Every offset/size here is file-controlled and
  // bounds-checked; NULL + error on any violation.
  const uint8_t *block_payload(size_t block_id, size_t *plen) {
    if (block_id >= indices.size()) {
      set_error("block id out of range (bad BM / mismatched variant file)");
      return nullptr;
    }
    size_t off = indices[block_id];
    const uint8_t *bp;
    size_t blen;
    if (header.specific_bitset & 4) {  // zstd flag
      if (off > data.size() || data.size() - off < 16) {
        set_error("block offset beyond file");
        return nullptr;
      }
      uint64_t csize, osize;
      memcpy(&csize, data.data() + off, 8);
      memcpy(&osize, data.data() + off + 8, 8);
      if (csize > data.size() - off - 16) {
        set_error("zstd frame exceeds file");
        return nullptr;
      }
      if (osize > (uint64_t(1) << 31)) {
        set_error("absurd decompressed block size");
        return nullptr;
      }
      zstd_buf.resize(osize);
      if (xsi_zstd_decompress(data.data() + off + 16, csize,
                              zstd_buf.data(), osize) != int64_t(osize)) {
        if (xsi_have_zstd()) set_error("zstd decompress failed");
        return nullptr;
      }
      bp = zstd_buf.data();
      blen = osize;
    } else {
      if (off >= data.size()) {
        set_error("block offset beyond file");
        return nullptr;
      }
      bp = data.data() + off;
      blen = data.size() - off;   // conservative extent for bounds checks
    }
    // top-level dictionary -> GT entry (key 256)
    if (blen < 8) { set_error("block too small"); return nullptr; }
    const uint32_t *u = reinterpret_cast<const uint32_t *>(bp);
    uint32_t n = u[1];
    if (n > (1u << 20) || 8 + size_t(n) * 8 > blen) {
      set_error("block top-level dictionary exceeds block");
      return nullptr;
    }
    for (uint32_t i = 0; i < n; ++i)
      if (u[2 + 2 * i] == 256) {
        uint32_t eoff = u[3 + 2 * i];
        if (eoff % 4 || eoff >= blen) {
          set_error("GT entry offset out of block range");
          return nullptr;
        }
        *plen = blen - eoff;
        return bp + eoff;
      }
    set_error("block has no GT entry");
    return nullptr;
  }

  BlockCursorBase *cursor_for(size_t block_id) {
    if (cursor && cursor_block == int64_t(block_id)) return cursor.get();
    size_t plen = 0;
    const uint8_t *payload = block_payload(block_id, &plen);
    if (!payload) return nullptr;
    if (header.aet_bytes == 2)
      cursor = std::make_unique<BlockCursor<uint16_t>>(
          payload, plen, header.num_samples, n_haps);
    else
      cursor = std::make_unique<BlockCursor<uint32_t>>(
          payload, plen, header.num_samples, n_haps);
    cursor_block = int64_t(block_id);
    if (!cursor->ok()) {
      cursor.reset();
      cursor_block = -1;
      return nullptr;
    }
    return cursor.get();
  }
};

extern "C" {

xsi_file_t *xsi_open(const char *xsi_path) {
  auto f = std::make_unique<xsi_file>();
  FILE *fp = fopen(xsi_path, "rb");
  if (!fp) { set_error(std::string("cannot open ") + xsi_path); return nullptr; }
  fseek(fp, 0, SEEK_END);
  long size = ftell(fp);
  fseek(fp, 0, SEEK_SET);
  f->data.resize(size);
  if (fread(f->data.data(), 1, size, fp) != size_t(size)) {
    fclose(fp);
    set_error("short read");
    return nullptr;
  }
  fclose(fp);
  // Every header offset/count is untrusted: a truncated or corrupt file
  // must fail cleanly here, never drive a read past `data`.
  if (f->data.size() < sizeof(XsiHeader)) {
    set_error("file smaller than the 256-byte header");
    return nullptr;
  }
  memcpy(&f->header, f->data.data(), sizeof(XsiHeader));
  if (f->header.first_magic != XSI_MAGIC || f->header.last_magic != XSI_MAGIC) {
    set_error("bad magic");
    return nullptr;
  }
  if (f->header.version != 4 && f->header.version != 5) {
    set_error("unsupported version");
    return nullptr;
  }
  size_t nb = f->header.number_of_ssas;
  size_t idx_width = f->header.version >= 5 ? 8 : 4;
  if (f->header.indices_offset > f->data.size() ||
      nb > (f->data.size() - f->header.indices_offset) / idx_width) {
    set_error("block index exceeds file");
    return nullptr;
  }
  f->indices.resize(nb);
  if (nb == 0) {
    // no blocks: header-only container (or corrupt count); keep going,
    // every genotype query will fail with "block id out of range"
  } else if (f->header.version >= 5) {
    memcpy(f->indices.data(), f->data.data() + f->header.indices_offset, nb * 8);
  } else {
    for (size_t i = 0; i < nb; ++i) {
      uint32_t v;
      memcpy(&v, f->data.data() + f->header.indices_offset + 4 * i, 4);
      f->indices[i] = v;
    }
  }
  // samples (NUL-terminated names; never run past the file end)
  if (f->header.samples_offset > f->data.size()) {
    set_error("samples offset beyond file");
    return nullptr;
  }
  const char *s = reinterpret_cast<const char *>(f->data.data())
      + f->header.samples_offset;
  const char *end = reinterpret_cast<const char *>(f->data.data()) + size;
  size_t want = f->header.ploidy ? f->header.hap_samples / f->header.ploidy : 0;
  if (want > size_t(size)) {
    set_error("absurd sample count");
    return nullptr;
  }
  while (f->samples.size() < want && s < end) {
    size_t maxn = size_t(end - s);
    size_t len = strnlen(s, maxn);
    if (len == maxn) { set_error("unterminated sample name"); return nullptr; }
    f->samples.emplace_back(s, len);
    s += len + 1;
  }
  if (f->header.num_samples > (uint64_t(1) << 31)) {
    set_error("absurd num_samples");
    return nullptr;
  }
  f->n_haps = size_t(f->header.num_samples) * 2;
  // variant file
  std::string var_path = std::string(xsi_path) + "_var.bcf";
  f->var = std::make_unique<VariantBcf>(var_path);
  if (!f->var->ok()) f->var.reset();  // random-access-only mode
  return f.release();
}

void xsi_close(xsi_file_t *f) { delete f; }

uint32_t xsi_version(const xsi_file_t *f) { return f->header.version; }
uint64_t xsi_num_samples(const xsi_file_t *f) { return f->header.num_samples; }
uint64_t xsi_num_variants(const xsi_file_t *f) { return f->header.num_variants; }
uint64_t xsi_num_records(const xsi_file_t *f) { return f->header.xcf_entries; }
uint32_t xsi_ploidy(const xsi_file_t *f) { return f->header.ploidy; }

const char *xsi_sample_name(const xsi_file_t *f, uint64_t i) {
  return i < f->samples.size() ? f->samples[i].c_str() : nullptr;
}

int xsi_next_record(xsi_file_t *f) {
  if (!f->var) { set_error("no variant file"); return -1; }
  return f->var->next(&f->cur);
}

/* CSI-chunk navigation on the variant file (region extracts: the chunk
 * voffsets come from the caller's index lookup, io/csi.py). */
int xsi_var_seek(xsi_file_t *f, uint64_t voff) {
  if (!f->var) { set_error("no variant file"); return -1; }
  return f->var->seek_virtual(voff) ? 0 : -1;
}

uint64_t xsi_var_tell(const xsi_file_t *f) {
  if (!f->var) return 0;
  return f->var->tell_virtual();
}

int32_t xsi_record_n_allele(const xsi_file_t *f) { return f->cur.n_allele; }
int32_t xsi_record_bm(const xsi_file_t *f) { return f->cur.bm; }
int32_t xsi_record_rid(const xsi_file_t *f) { return f->cur.rid; }
int64_t xsi_record_pos(const xsi_file_t *f) { return f->cur.pos; }

const uint8_t *xsi_record_shared(const xsi_file_t *f, uint32_t *len) {
  if (!f->var) { set_error("no variant file"); return nullptr; }
  const std::vector<uint8_t> &s = f->var->shared();
  if (len) *len = uint32_t(s.size());
  return s.data();
}

int64_t xsi_fill_genotypes_bm(xsi_file_t *f, int32_t bm, int32_t n_allele,
                              int32_t *gt_arr, size_t capacity) {
  if (bm < 0) { set_error("negative BM"); return -1; }
  size_t block_id = uint32_t(bm) >> BM_BLOCK_BITS;
  size_t offset = uint32_t(bm) & ((1u << BM_BLOCK_BITS) - 1);
  auto *c = f->cursor_for(block_id);
  if (!c) return -1;
  if (!c->seek(offset)) return -1;
  return c->fill(gt_arr, capacity, n_allele, nullptr);
}

int64_t xsi_get_genotypes(xsi_file_t *f, int32_t *gt_arr, size_t capacity) {
  if (f->cur.bm < 0) { set_error("no current record / BM"); return -1; }
  return xsi_fill_genotypes_bm(f, f->cur.bm, f->cur.n_allele, gt_arr, capacity);
}

int xsi_fill_allele_counts_bm(xsi_file_t *f, int32_t bm, int32_t n_allele,
                              int64_t *counts) {
  if (bm < 0) { set_error("negative BM"); return -1; }
  size_t block_id = uint32_t(bm) >> BM_BLOCK_BITS;
  size_t offset = uint32_t(bm) & ((1u << BM_BLOCK_BITS) - 1);
  auto *c = f->cursor_for(block_id);
  if (!c) return -1;
  if (!c->seek(offset)) return -1;
  return c->fill_counts(n_allele, counts);
}

int64_t xsi_count_alleles_range(xsi_file_t *f, const int32_t *bms,
                                const int32_t *n_alleles, int64_t n_records,
                                int64_t *counts_flat) {
  int64_t written = 0;
  for (int64_t r = 0; r < n_records; ++r) {
    int32_t bm = bms[r], na = n_alleles[r];
    if (bm < 0) { set_error("negative BM"); return -1; }
    if (na < 1) { set_error("record with n_allele < 1"); return -1; }
    size_t block_id = uint32_t(bm) >> BM_BLOCK_BITS;
    size_t offset = uint32_t(bm) & ((1u << BM_BLOCK_BITS) - 1);
    auto *c = f->cursor_for(block_id);
    if (!c) return -1;
    if (!c->seek(offset)) return -1;
    if (c->fill_counts(na, counts_flat + written) < 0) return -1;
    written += na;
  }
  return written;
}

/* Bulk (BM, n_allele) scan of the variant file in ONE crossing — the
 * af_stats front walk (a per-record Python BCF parse costs ~100x this).
 * Starts at the current variant cursor (fresh xsi_open = file start);
 * returns the number of records written (<= cap), -1 on a parse error. */
int64_t xsi_scan_records(xsi_file_t *f, int32_t *bm_out, int32_t *na_out,
                         int64_t cap) {
  if (!f->var) { set_error("no variant file"); return -1; }
  if (!bm_out || !na_out || cap < 0) { set_error("bad scan args"); return -1; }
  int64_t n = 0;
  while (n < cap) {
    int rc = f->var->next(&f->cur);
    if (rc == 0) break;
    if (rc < 0) return -1;
    bm_out[n] = f->cur.bm;
    na_out[n] = f->cur.n_allele;
    n++;
  }
  return n;
}

const char *xsi_last_error(void) { return g_error.c_str(); }

int xsi_have_zstd(void) {
#ifdef XSI_HAVE_ZSTD
  return 1;
#else
  return 0;
#endif
}

size_t xsi_zstd_bound(size_t n) {
#ifdef XSI_HAVE_ZSTD
  return ZSTD_compressBound(n);
#else
  return n;
#endif
}

int64_t xsi_zstd_compress(const void *src, size_t n, void *dst, size_t cap,
                          int level) {
#ifdef XSI_HAVE_ZSTD
  size_t rc = ZSTD_compress(dst, cap, src, n, level);
  if (ZSTD_isError(rc)) {
    set_error(std::string("zstd compress failed: ") + ZSTD_getErrorName(rc));
    return -1;
  }
  return int64_t(rc);
#else
  (void)src; (void)n; (void)dst; (void)cap; (void)level;
  set_error("native library built without zstd (zstd.h not found)");
  return -1;
#endif
}

int64_t xsi_zstd_decompress(const void *src, size_t n, void *dst,
                            size_t cap) {
#ifdef XSI_HAVE_ZSTD
  size_t rc = ZSTD_decompress(dst, cap, src, n);
  if (ZSTD_isError(rc)) {
    set_error(std::string("zstd decompress failed: ") +
              ZSTD_getErrorName(rc));
    return -1;
  }
  return int64_t(rc);
#else
  (void)src; (void)n; (void)dst; (void)cap;
  set_error("native library built without zstd (zstd.h not found)");
  return -1;
#endif
}

}  // extern "C"
