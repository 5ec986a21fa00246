// Binary hole filling and 4-connected component labelling on the host, in
// C++ behind a plain C interface (bound with ctypes in
// zutis_tpu_torch/native/labels.py, built with g++ by ops/_build.py).
//
// The bilateral solver's last step (ops/bilateral.py) thresholds the soft
// mask, fills its holes and keeps the second-largest component. The JAX
// package does that with scipy.ndimage, which the card's machine lacks, so
// this file gives scipy's results bit for bit at its defaults in 2-D:
//
//   * fill_holes: ndimage.binary_fill_holes with the cross structure. Holes
//     are the background pixels that no 4-connected path of background
//     pixels joins to the image border (scipy dilates the inverted border
//     through the background and inverts the result).
//   * label4: ndimage.label with the cross structure: foreground pixels
//     4-connected share a label; labels 1..n are numbered in raster order
//     of each component's first pixel, 0 is the background.
//
// Both are breadth-first floods over one queue; every pixel enters it once.

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

// Push every unvisited 4-neighbour of p in `open` (nonzero = passable).
inline void flood(std::vector<int64_t>& queue, const uint8_t* open,
                  int32_t* mark, int32_t value, int h, int w) {
  for (std::size_t head = 0; head < queue.size(); ++head) {
    int64_t p = queue[head];
    int64_t y = p / w, x = p % w;
    int64_t nb[4] = {y > 0 ? p - w : -1, y + 1 < h ? p + w : -1,
                     x > 0 ? p - 1 : -1, x + 1 < w ? p + 1 : -1};
    for (int64_t q : nb) {
      if (q >= 0 && open[q] && mark[q] == 0) {
        mark[q] = value;
        queue.push_back(q);
      }
    }
  }
}

}  // namespace

extern "C" {

// mask [h, w] (nonzero = foreground) -> out [h, w] in {0, 1}.
int fill_holes(const uint8_t* mask, uint8_t* out, int h, int w) {
  if (h < 0 || w < 0) return -1;
  int64_t n = int64_t(h) * w;
  std::vector<uint8_t> background(n);
  std::vector<int32_t> reached(n, 0);
  std::vector<int64_t> queue;
  for (int64_t p = 0; p < n; ++p) background[p] = mask[p] == 0;
  for (int64_t p = 0; p < n; ++p) {
    int64_t y = p / w, x = p % w;
    bool border = y == 0 || y == h - 1 || x == 0 || x == w - 1;
    if (border && background[p]) {
      reached[p] = 1;
      queue.push_back(p);
    }
  }
  flood(queue, background.data(), reached.data(), 1, h, w);
  for (int64_t p = 0; p < n; ++p) out[p] = reached[p] ? 0 : 1;
  return 0;
}

// mask [h, w] (nonzero = foreground) -> labels [h, w] int32; returns the
// number of components, or -1 on a bad shape.
int label4(const uint8_t* mask, int32_t* labels, int h, int w) {
  if (h < 0 || w < 0) return -1;
  int64_t n = int64_t(h) * w;
  std::vector<uint8_t> fg(n);
  for (int64_t p = 0; p < n; ++p) {
    fg[p] = mask[p] != 0;
    labels[p] = 0;
  }
  int32_t count = 0;
  std::vector<int64_t> queue;
  for (int64_t p = 0; p < n; ++p) {
    if (!fg[p] || labels[p] != 0) continue;
    labels[p] = ++count;
    queue.assign(1, p);
    flood(queue, fg.data(), labels, count, h, w);
  }
  return count;
}

}  // extern "C"
