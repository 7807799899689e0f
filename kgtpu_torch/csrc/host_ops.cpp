// Host ops of the port's data and evaluation paths, with kgtpu's semantics
// (its kgtpu/native/host_ops.cpp): one O(H * W) pass over a label map where
// the NumPy versions in data/transforms.py and evaluate.py scan it once per
// instance id or expand masks.
//
//   boxes_from_label_map  area-ranked boxes (desc, ties by ascending id) of
//                         the instances of at least min_pixels pixels
//   renumber_label_map    slot s's instance -> id s + 1, the rest 0
//   label_map_iou         the f32 IoU matrix of two label maps,
//                         (float)inter / (float)union, 0 where union is 0
//
// Ids of 0 or below are background.  Built with g++ -O3 -shared -fPIC into
// kgtpu_torch/_build/ at first use (kgtpu_torch/native.py, through
// ops/_cuda.py's builder) and called through ctypes; without a compiler the
// NumPy versions, which give the same results bit for bit, are taken.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// label: [h*w] int32 instance ids (0 = background), ids < max_id.
// Writes boxes[max_inst*4] (x0,y0,x1,y1), valid[max_inst], remap[max_inst]
// (original id per slot, 0 = padding).  Slots are area-ranked (desc), ties
// by id asc; instances with < min_pixels pixels are dropped.
// Returns the number of valid slots.
int boxes_from_label_map(const int32_t* label, int h, int w, int max_inst,
                         int min_pixels, float* boxes, float* valid,
                         int32_t* remap) {
  int32_t max_id = 0;
  const int n = h * w;
  for (int i = 0; i < n; ++i) max_id = std::max(max_id, label[i]);

  if (max_id <= 0) {
    std::memset(boxes, 0, sizeof(float) * max_inst * 4);
    std::memset(valid, 0, sizeof(float) * max_inst);
    std::memset(remap, 0, sizeof(int32_t) * max_inst);
    return 0;
  }

  std::vector<int64_t> count(max_id + 1, 0);
  std::vector<int32_t> x0(max_id + 1, INT32_MAX), y0(max_id + 1, INT32_MAX);
  std::vector<int32_t> x1(max_id + 1, -1), y1(max_id + 1, -1);

  for (int y = 0; y < h; ++y) {
    const int32_t* row = label + (int64_t)y * w;
    for (int x = 0; x < w; ++x) {
      const int32_t id = row[x];
      if (id <= 0) continue;
      ++count[id];
      x0[id] = std::min(x0[id], x);
      x1[id] = std::max(x1[id], x);
      y0[id] = std::min(y0[id], y);
      y1[id] = std::max(y1[id], y);
    }
  }

  // area-rank (desc), id asc on ties — matches the NumPy oracle's sort
  std::vector<int32_t> ids;
  ids.reserve(max_id);
  for (int32_t id = 1; id <= max_id; ++id)
    if (count[id] >= min_pixels) ids.push_back(id);
  std::stable_sort(ids.begin(), ids.end(), [&](int32_t a, int32_t b) {
    if (count[a] != count[b]) return count[a] > count[b];
    return a < b;
  });

  const int kept = std::min<int>(ids.size(), max_inst);
  std::memset(boxes, 0, sizeof(float) * max_inst * 4);
  std::memset(valid, 0, sizeof(float) * max_inst);
  std::memset(remap, 0, sizeof(int32_t) * max_inst);
  for (int s = 0; s < kept; ++s) {
    const int32_t id = ids[s];
    boxes[s * 4 + 0] = (float)x0[id];
    boxes[s * 4 + 1] = (float)y0[id];
    boxes[s * 4 + 2] = (float)(x1[id] + 1);
    boxes[s * 4 + 3] = (float)(y1[id] + 1);
    valid[s] = 1.0f;
    remap[s] = id;
  }
  return kept;
}

// out[i] = slot+1 where remap[slot] == label[i], else 0.
void renumber_label_map(const int32_t* label, int h, int w,
                        const int32_t* remap, int n_slots, int32_t* out) {
  int32_t max_id = 0;
  const int n = h * w;
  for (int i = 0; i < n; ++i) max_id = std::max(max_id, label[i]);
  std::vector<int32_t> lut(max_id + 1, 0);
  for (int s = 0; s < n_slots; ++s) {
    const int32_t id = remap[s];
    if (id > 0 && id <= max_id) lut[id] = s + 1;
  }
  for (int i = 0; i < n; ++i) {
    const int32_t id = label[i];
    out[i] = (id > 0) ? lut[id] : 0;
  }
}

// Per-instance binary-mask IoU matrix between two label maps.
// preds ids 1..np_, gts ids 1..ng (dense); iou is [np_ * ng], row-major.
void label_map_iou(const int32_t* pred, const int32_t* gt, int h, int w,
                   int np_, int ng, float* iou) {
  std::vector<int64_t> inter((int64_t)np_ * ng, 0);
  std::vector<int64_t> parea(np_, 0), garea(ng, 0);
  const int n = h * w;
  for (int i = 0; i < n; ++i) {
    const int32_t p = pred[i], g = gt[i];
    if (p > 0 && p <= np_) ++parea[p - 1];
    if (g > 0 && g <= ng) ++garea[g - 1];
    if (p > 0 && p <= np_ && g > 0 && g <= ng)
      ++inter[(int64_t)(p - 1) * ng + (g - 1)];
  }
  for (int p = 0; p < np_; ++p)
    for (int g = 0; g < ng; ++g) {
      const int64_t iv = inter[(int64_t)p * ng + g];
      const int64_t uv = parea[p] + garea[g] - iv;
      iou[(int64_t)p * ng + g] = uv > 0 ? (float)iv / (float)uv : 0.0f;
    }
}

}  // extern "C"
