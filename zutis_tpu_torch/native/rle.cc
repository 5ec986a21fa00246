// COCO compressed-RLE codec, C++ implementation: the port's copy of
// zutis_tpu/native/rle.cc, whose C interface it keeps unchanged. It is
// independent of the numpy codec in ops/rle.py; the two cross-validate
// (tests/test_torch_rle_native.py).
//
// Format (the published COCO "counts" string): the mask is scanned in
// column-major order into alternating run lengths starting with a zero-run;
// each count is delta-coded against count[i-2] for i > 2 and emitted as
// little-endian 5-bit groups with bit 5 as the continuation flag, each group
// offset by ASCII 48.
//
// Built with g++ on first use by zutis_tpu_torch/ops/_build.py and bound with
// ctypes in zutis_tpu_torch/native/__init__.py; the server's RLE, the eval's
// COCO strings and the COCO scorer's IoUs and string parsing run on it.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// mask: row-major [h, w] uint8 (as numpy hands it over); internally scanned
// column-major per the COCO format. Returns the number of chars written to
// `out`, or -1 if out_cap is too small.
int rle_encode(const uint8_t* mask, int h, int w, char* out, int out_cap) {
  std::vector<int64_t> counts;
  counts.reserve(64);
  uint8_t prev = 0;
  int64_t run = 0;
  for (int j = 0; j < w; ++j) {
    for (int i = 0; i < h; ++i) {
      uint8_t v = mask[(int64_t)i * w + j] ? 1 : 0;
      if (v == prev) {
        ++run;
      } else {
        counts.push_back(run);
        prev = v;
        run = 1;
      }
    }
  }
  counts.push_back(run);
  // counts[0] is the leading zero-run (possibly 0 when mask[0,0] == 1)

  int pos = 0;
  for (size_t idx = 0; idx < counts.size(); ++idx) {
    int64_t x = counts[idx];
    if (idx > 2) x -= counts[idx - 2];
    bool more = true;
    while (more) {
      int chunk = (int)(x & 0x1F);
      x >>= 5;
      more = (chunk & 0x10) ? (x != -1) : (x != 0);
      if (more) chunk |= 0x20;
      if (pos >= out_cap) return -1;
      out[pos++] = (char)(chunk + 48);
    }
  }
  return pos;
}

// Decodes `s` (slen chars) into a row-major [h, w] uint8 mask. Returns 0 on
// success, -1 on malformed input or size mismatch.
int rle_decode(const char* s, int slen, int h, int w, uint8_t* out) {
  std::vector<int64_t> counts;
  counts.reserve(64);
  int p = 0;
  while (p < slen) {
    int64_t x = 0;
    int k = 0;
    bool more = true;
    while (more) {
      if (p >= slen) return -1;
      int c = s[p++] - 48;
      x |= (int64_t)(c & 0x1F) << (5 * k);
      more = (c & 0x20) != 0;
      if (!more && (c & 0x10)) x |= -((int64_t)1 << (5 * k + 5));
      ++k;
    }
    if (counts.size() > 2) x += counts[counts.size() - 2];
    counts.push_back(x);
  }

  std::memset(out, 0, (size_t)h * w);
  int64_t total = (int64_t)h * w;
  int64_t pos = 0;
  uint8_t val = 0;
  for (int64_t c : counts) {
    if (c < 0 || pos + c > total) return -1;
    if (val) {
      for (int64_t t = pos; t < pos + c; ++t) {
        // column-major position t -> row-major index
        int64_t col = t / h, row = t % h;
        out[row * w + col] = 1;
      }
    }
    pos += c;
    val = 1 - val;
  }
  return pos == total ? 0 : -1;
}

// Batch encode: n masks of [h, w]; offsets[i] receives the start of mask i's
// counts string in `out`; returns total chars or -1 on overflow.
int rle_encode_batch(const uint8_t* masks, int n, int h, int w, char* out,
                     int out_cap, int* offsets) {
  int pos = 0;
  for (int i = 0; i < n; ++i) {
    offsets[i] = pos;
    int wrote = rle_encode(masks + (int64_t)i * h * w, h, w, out + pos,
                           out_cap - pos);
    if (wrote < 0) return -1;
    pos += wrote;
  }
  return pos;
}

// ---------------------------------------------------------------------------
// Packed-bits batch encode: the eval fast path. The device packs each mask's
// Fortran-order flatten to bits (np.packbits bitorder='big' layout: bit j of
// a column lives in byte j/8, position 7 - j%8) with rows padded to
// `col_stride_bits` (multiple of 8) so every column starts byte-aligned; only
// the packed bits cross the host boundary (~32x less PCIe traffic than byte
// masks). Each selected mask is scanned word-at-a-time over its native
// (h, w) window: transitions come from v ^ ((v >> 1) | carry) with MSB-first
// row order, and set bits are walked with count-leading-zeros, so runtime is
// O(words + transitions) not O(pixels).
//
// Arguments:
//   packed:        base of the packed mask array
//   mask_stride:   bytes between consecutive masks
//   sel:           indices of the masks to encode (n_sel entries)
//   col_stride_bits: padded rows per column (multiple of 8)
//   hs, ws:        native window per SELECTED mask (n_sel entries)
//   out/out_cap:   counts-string arena; offsets[i] = start of string i
//   bboxes:        n_sel * 4 ints, xyxy tight box (zeros when empty)
//   areas:         n_sel foreground-pixel counts
// Returns total chars written, or -1 on overflow.

static int emit_counts(const std::vector<int64_t>& counts, char* out,
                       int out_cap, int pos) {
  for (size_t idx = 0; idx < counts.size(); ++idx) {
    int64_t x = counts[idx];
    if (idx > 2) x -= counts[idx - 2];
    bool more = true;
    while (more) {
      int chunk = (int)(x & 0x1F);
      x >>= 5;
      more = (chunk & 0x10) ? (x != -1) : (x != 0);
      if (more) chunk |= 0x20;
      if (pos >= out_cap) return -1;
      out[pos++] = (char)(chunk + 48);
    }
  }
  return pos;
}

static inline uint64_t load_be64(const uint8_t* p) {
  // byte 0 holds rows 0-7 (MSB-first) -> place it at the top of the word so
  // bit 63 is row 0 and row r+1 sits one position below row r
  return ((uint64_t)p[0] << 56) | ((uint64_t)p[1] << 48) |
         ((uint64_t)p[2] << 40) | ((uint64_t)p[3] << 32) |
         ((uint64_t)p[4] << 24) | ((uint64_t)p[5] << 16) |
         ((uint64_t)p[6] << 8) | (uint64_t)p[7];
}

// Compress device-computed run-length sequences (ops/rle_device.py) to COCO
// counts strings: counts[i*stride .. i*stride+n_counts[i]) per mask.
// Returns total chars or -1 on overflow.
int rle_counts_to_string_batch(const int64_t* counts, const int* n_counts,
                               int n_masks, int stride, char* out,
                               int out_cap, int* offsets) {
  int pos = 0;
  std::vector<int64_t> tmp;
  for (int i = 0; i < n_masks; ++i) {
    offsets[i] = pos;
    tmp.assign(counts + (int64_t)i * stride,
               counts + (int64_t)i * stride + n_counts[i]);
    pos = emit_counts(tmp, out, out_cap, pos);
    if (pos < 0) return -1;
  }
  return pos;
}

int rle_encode_packed_batch(const uint8_t* packed, int64_t mask_stride,
                            const int* sel, int n_sel, int col_stride_bits,
                            const int* hs, const int* ws, char* out,
                            int out_cap, int* offsets, int* bboxes,
                            int64_t* areas) {
  const int col_bytes = col_stride_bits / 8;
  int pos = 0;
  std::vector<int64_t> counts;
  std::vector<uint64_t> rowocc;  // OR of all columns, for ymin/ymax
  for (int s = 0; s < n_sel; ++s) {
    const uint8_t* base = packed + (int64_t)sel[s] * mask_stride;
    const int h = hs[s], w = ws[s];
    const int n_words = (h + 63) / 64;
    counts.clear();
    rowocc.assign((size_t)n_words, 0);
    int xmin = w, xmax = -1;
    int64_t area = 0;
    int64_t last_t = 0;   // flat column-major position of the last transition
    uint64_t prev_bit = 0;  // value of the preceding pixel (MSB position)
    for (int j = 0; j < w; ++j) {
      const uint8_t* col = base + (int64_t)j * col_bytes;
      const int64_t col_base = (int64_t)j * h;
      bool col_any = false;
      for (int wd = 0; wd < n_words; ++wd) {
        int row0 = wd * 64;
        int nbits = h - row0 < 64 ? h - row0 : 64;
        uint64_t v;
        if (nbits == 64) {
          v = load_be64(col + wd * 8);
        } else {
          v = 0;
          int nbytes = (nbits + 7) / 8;
          for (int b = 0; b < nbytes; ++b)
            v |= (uint64_t)col[wd * 8 + b] << (56 - 8 * b);
          v &= ~0ull << (64 - nbits);  // drop padded rows
        }
        if (v) {
          col_any = true;
          area += __builtin_popcountll(v);
          rowocc[wd] |= v;
        }
        // pred of row r is row r-1 = one bit position above (towards MSB)
        uint64_t pred = (v >> 1) | (prev_bit << 63);
        uint64_t trans = (v ^ pred);
        if (nbits < 64) trans &= ~0ull << (64 - nbits);
        while (trans) {
          int k = __builtin_clzll(trans);        // row offset within word
          int64_t t = col_base + row0 + k;       // global F-order position
          counts.push_back(t - last_t);
          last_t = t;
          trans &= ~(1ull << (63 - k));
        }
        prev_bit = nbits == 64 ? (v & 1) : (v >> (64 - nbits)) & 1;
      }
      if (col_any) {
        if (j < xmin) xmin = j;
        xmax = j;
      }
    }
    const int64_t total = (int64_t)h * w;
    counts.push_back(total - last_t);
    // counts currently hold transition deltas: [t0 - 0, t1 - t0, ..., N - tk]
    // which IS the run-length sequence (first entry the leading zero-run,
    // possibly 0 when pixel (0,0) is set)
    offsets[s] = pos;
    pos = emit_counts(counts, out, out_cap, pos);
    if (pos < 0) return -1;
    areas[s] = area;
    int ymin = h, ymax = -1;
    for (int wd = 0; wd < n_words; ++wd) {
      if (!rowocc[wd]) continue;
      int first = wd * 64 + __builtin_clzll(rowocc[wd]);
      int last = wd * 64 + 63 - __builtin_ctzll(rowocc[wd]);
      if (first < ymin) ymin = first;
      if (last > ymax) ymax = last;
    }
    if (xmax < 0) {
      bboxes[4 * s] = bboxes[4 * s + 1] = bboxes[4 * s + 2] =
          bboxes[4 * s + 3] = 0;
    } else {
      bboxes[4 * s] = xmin;
      bboxes[4 * s + 1] = ymin;
      bboxes[4 * s + 2] = xmax;
      bboxes[4 * s + 3] = ymax;
    }
  }
  return pos;
}

// Parse a COCO counts string into its run-length sequence (the inverse of
// emit_counts). Returns the number of counts, or -1 on malformed input /
// out_cap overflow. Every count consumes >= 1 char, so out_cap = slen always
// suffices.
int rle_string_to_counts(const char* s, int slen, int64_t* out, int out_cap) {
  int n = 0;
  int p = 0;
  while (p < slen) {
    int64_t x = 0;
    int k = 0;
    bool more = true;
    while (more) {
      if (p >= slen) return -1;
      int c = s[p++] - 48;
      x |= (int64_t)(c & 0x1F) << (5 * k);
      more = (c & 0x20) != 0;
      if (!more && (c & 0x10)) x |= -((int64_t)1 << (5 * k + 5));
      ++k;
    }
    if (n > 2) x += out[n - 2];
    if (n >= out_cap) return -1;
    out[n++] = x;
  }
  return n;
}

// ---------------------------------------------------------------------------
// RLE-space pairwise mask IoU (the pycocotools maskApi.c approach): walk the
// two alternating run-length sequences with a two-pointer merge, summing the
// overlap of simultaneous 1-runs — never densifying either mask. Exact
// integer arithmetic, so results are bit-identical to dense IoU.
//
//   dt/gt counts: padded [n, stride] int64 run sequences (zeros first),
//   n_dt/n_gt valid prefix lengths per row; crowd[g] nonzero makes the
//   denominator the dt area (COCO crowd convention).
// Writes out[d * n_gt + g] doubles.

static void rle_inter_area(const int64_t* a, int na, const int64_t* b, int nb,
                           int64_t* inter_out) {
  int64_t inter = 0;
  int ia = 0, ib = 0;
  int64_t ca = na > 0 ? a[0] : 0, cb = nb > 0 ? b[0] : 0;
  bool va = false, vb = false;
  while (ia < na && ib < nb) {
    int64_t c = ca < cb ? ca : cb;
    if (va && vb) inter += c;
    ca -= c;
    cb -= c;
    if (ca == 0) {
      ++ia;
      va = !va;
      if (ia < na) ca = a[ia];
    }
    if (cb == 0) {
      ++ib;
      vb = !vb;
      if (ib < nb) cb = b[ib];
    }
  }
  *inter_out = inter;
}

void rle_iou_batch(const int64_t* dt, const int* n_dt, int nd, int stride_d,
                   const int64_t* gt, const int* n_gt, int ng, int stride_g,
                   const uint8_t* crowd, double* out) {
  std::vector<int64_t> d_area((size_t)nd), g_area((size_t)ng);
  for (int i = 0; i < nd; ++i) {
    int64_t area = 0;
    const int64_t* row = dt + (int64_t)i * stride_d;
    for (int j = 1; j < n_dt[i]; j += 2) area += row[j];
    d_area[i] = area;
  }
  for (int i = 0; i < ng; ++i) {
    int64_t area = 0;
    const int64_t* row = gt + (int64_t)i * stride_g;
    for (int j = 1; j < n_gt[i]; j += 2) area += row[j];
    g_area[i] = area;
  }
  for (int d = 0; d < nd; ++d) {
    for (int g = 0; g < ng; ++g) {
      int64_t inter;
      rle_inter_area(dt + (int64_t)d * stride_d, n_dt[d],
                     gt + (int64_t)g * stride_g, n_gt[g], &inter);
      int64_t uni = crowd[g] ? d_area[d] : d_area[d] + g_area[g] - inter;
      out[(int64_t)d * ng + g] = uni > 0 ? (double)inter / (double)uni : 0.0;
    }
  }
}

}  // extern "C"
