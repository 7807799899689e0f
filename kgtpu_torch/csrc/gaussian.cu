// CornerNet Gaussian target heatmaps for a batch, for Hopper (sm_90a).
//
// Replaces kgtpu/ops/pallas/gaussian.py::render_heatmaps_pallas (the Pallas
// TPU kernel, body `_kernel`), which the JAX train step vmaps over the batch;
// its plain version is kgtpu_torch/ops/targets.py::render_heatmaps_batch.
//
// What it computes, per image b, pixel (y, x) and keypoint class c of C = 5:
//   out[b, y, x, c] = max over valid instances i of
//                     expf(-((x - kx)^2 + (y - ky)^2) * coef[b, i])
// with (kx, ky) = floor(kpts[b, i, c]), coef = 1 / (2 sigma^2 + 1e-12),
// sigma = (2 floor(r) + 1) / 6 and r = gaussian_radius(sizes[b, i]); 0 where
// no valid instance is within reach.  Floored keypoints make every squared
// distance an exact integer, so a keypoint pixel gets expf(-0) = 1.0 exactly:
// the focal loss counts positives as t >= 1.0.  Hence expf, not __expf, and
// no --use_fast_math.
//
// The kernel takes the wrapper's inputs as they are (kpts [B, N, 5, 2],
// sizes [B, N, 2], valid [B, N], f32) and does the prep itself: each block
// computes every instance's floored keypoints and coef once, one instance a
// thread.  floor(r) picks sigma, so the prep is bit-identical to the plain
// version as torch computes it on the card, operation by operation with
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn), which nvcc never contracts into an FMA.  Where the plain
// version divides by a Python number, torch on CUDA multiplies by that
// number's reciprocal cast to f32 (ATen's div_true_kernel_cuda), and so does this
// kernel; those constants are made on the host from min_overlap exactly as
// torch makes them (Consts below).
//
// Design.  Grid (column tiles, row tiles, images): one block per 8 x 32 tile
// of one image, one pixel a thread, so one launch renders the whole batch.
// After the prep, the block keeps, for each class c separately, the valid
// instances whose class-c keypoint is within reach of the tile: the distance
// d from the tile's rectangle to the keypoint (in both dimensions) gives
// d^2 * coef < 14 (exp(-14) ~ 8.3e-7, below the targets' 1e-6 tolerance),
// and compacts their (kx, ky, coef) into a per-class list in shared memory.
// A pixel then evaluates expf only for the discs that reach its tile, keeps
// the 5 class maxima in registers and writes them side by side: the
// [B, H, W, 5] layout the focal loss reads, one write of each float.  Tiles
// on the ragged edges mask their pixels, for any H and W.  The lists' order
// depends on shared-memory atomics, but a max does not depend on the order,
// so the output is deterministic.
//
// Bound.  Bytes: the f32 output dominates (2.62 MB at [8, 128, 128, 5],
// 0.78 us at 3.35 TB/s); the inputs are 52 bytes an instance.  Operations:
// an expf and about 8 other f32 operations per (pixel, class, instance) in
// reach; the discs need a few pixels to a few hundred per instance (23,925
// expf on chip_smoke.py's timed scene), so at the train step's size the
// bytes bound it.  A tile's reach test is conservative (rectangle, not
// disc), so the kernel evaluates somewhat more expf than that count.
//
// Interface: a plain C function, loaded with ctypes.  It returns
// cudaGetLastError() after the launch (0 when it was accepted).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kClasses = 5;
constexpr int kTileH = 8;    // ops/gaussian.py TILE_H
constexpr int kTileW = 32;   // ops/gaussian.py TILE_W
constexpr int kThreads = kTileH * kTileW;
constexpr float kCutoff = 14.0f;

// The f32 constants of targets.py::gaussian_radius and splat_coef, made from
// the Python numbers the way torch makes them: a double cast to f32, and for
// a division by a Python number its reciprocal, taken in double and cast.
struct Consts {
  float one_minus;    // 1.0 - min_overlap
  float inv_one_plus; // 1 / (1.0 + min_overlap)
  float b3;           // -2.0 * min_overlap
  float c3;           // min_overlap - 1.0
  float four_a3;      // 4.0 * (4.0 * min_overlap)
  float inv_two_a3;   // 1 / (2.0 * (4.0 * min_overlap))
  float inv_six;      // 1 / 6.0
  float tiny;         // 1e-12
};

__device__ __forceinline__ float clamp0(float v) { return v < 0.f ? 0.f : v; }

// targets.py::gaussian_radius then splat_coef's 1 / (2 sigma^2 + 1e-12), each
// torch operation one rounding, in the plain version's order.
__device__ float splat_coef(float h, float w, const Consts& k) {
  const float hw_sum = __fadd_rn(h, w);
  const float b1 = hw_sum;
  const float c1 = __fmul_rn(__fmul_rn(__fmul_rn(w, h), k.one_minus), k.inv_one_plus);
  const float d1 = clamp0(__fsub_rn(__fmul_rn(b1, b1), __fmul_rn(4.0f, c1)));
  const float r1 = __fmul_rn(__fsub_rn(b1, __fsqrt_rn(d1)), 0.5f);
  const float b2 = __fmul_rn(2.0f, hw_sum);
  const float c2 = __fmul_rn(__fmul_rn(k.one_minus, w), h);
  const float d2 = clamp0(__fsub_rn(__fmul_rn(b2, b2), __fmul_rn(16.0f, c2)));
  const float r2 = __fmul_rn(__fsub_rn(b2, __fsqrt_rn(d2)), 0.125f);
  const float b3 = __fmul_rn(k.b3, hw_sum);
  const float c3 = __fmul_rn(__fmul_rn(k.c3, w), h);
  const float d3 = clamp0(__fsub_rn(__fmul_rn(b3, b3), __fmul_rn(k.four_a3, c3)));
  const float r3 = __fmul_rn(__fadd_rn(b3, __fsqrt_rn(d3)), k.inv_two_a3);
  const float r = clamp0(fminf(fminf(r1, r2), r3));
  const float sigma = __fmul_rn(__fadd_rn(__fmul_rn(2.0f, floorf(r)), 1.0f), k.inv_six);
  return __fdiv_rn(1.0f, __fadd_rn(__fmul_rn(__fmul_rn(2.0f, sigma), sigma), k.tiny));
}

// kpts: [B, N, 5, 2] (x, y); sizes: [B, N, 2] (h, w); valid: [B, N];
// out: [B, H, W, 5].  Shared memory: per class, lists of kx, ky and coef of
// N floats each, then 5 counts.
__global__ void __launch_bounds__(kThreads)
render_kernel(const float* __restrict__ kpts, const float* __restrict__ sizes,
              const float* __restrict__ valid, float* __restrict__ out, int n,
              int height, int width, const Consts k) {
  extern __shared__ float smem[];
  float* s_kx = smem;                      // [5][n]
  float* s_ky = s_kx + kClasses * n;       // [5][n]
  float* s_cf = s_ky + kClasses * n;       // [5][n]
  int* s_count = reinterpret_cast<int*>(s_cf + kClasses * n);

  const int64_t b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const float fx0 = (float)x0, fy0 = (float)y0;
  const float fx1 = (float)(min(x0 + kTileW, width) - 1);
  const float fy1 = (float)(min(y0 + kTileH, height) - 1);
  if (threadIdx.x < kClasses) s_count[threadIdx.x] = 0;
  __syncthreads();

  // prep and per-class compaction, one instance a thread
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int64_t bi = b * n + i;
    // all of the instance's inputs in one round trip to memory
    const float v = valid[bi], h = sizes[2 * bi], w = sizes[2 * bi + 1];
    float kp[2 * kClasses];
#pragma unroll
    for (int e = 0; e < 2 * kClasses; ++e) kp[e] = kpts[bi * 2 * kClasses + e];
    if (!(v > 0.f)) continue;
    const float cf = splat_coef(h, w, k);
#pragma unroll
    for (int c = 0; c < kClasses; ++c) {
      const float kx = floorf(kp[2 * c]), ky = floorf(kp[2 * c + 1]);
      const float dx = fmaxf(fmaxf(fx0 - kx, kx - fx1), 0.f);
      const float dy = fmaxf(fmaxf(fy0 - ky, ky - fy1), 0.f);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      if (__fmul_rn(d2, cf) < kCutoff) {
        const int j = atomicAdd(&s_count[c], 1);
        s_kx[c * n + j] = kx;
        s_ky[c * n + j] = ky;
        s_cf[c * n + j] = cf;
      }
    }
  }
  __syncthreads();

  const int y = y0 + threadIdx.x / kTileW, x = x0 + threadIdx.x % kTileW;
  if (y >= height || x >= width) return;
  const float fy = (float)y, fx = (float)x;
  float* o = out + ((b * height + y) * width + x) * kClasses;
#pragma unroll
  for (int c = 0; c < kClasses; ++c) {
    const int cnt = s_count[c];
    const float* lx = s_kx + c * n;
    const float* ly = s_ky + c * n;
    const float* lc = s_cf + c * n;
    float m = 0.f;
    for (int j = 0; j < cnt; ++j) {
      const float dx = fx - lx[j], dy = fy - ly[j];
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      m = fmaxf(m, expf(__fmul_rn(-d2, lc[j])));
    }
    o[c] = m;
  }
}

}  // namespace

extern "C" {

// kpts: [batch, n, 5, 2], sizes: [batch, n, 2] (h, w), valid: [batch, n],
// all f32 contiguous; out: [batch, height, width, 5] f32.  Returns a
// cudaError_t value.
int kgtpu_render_heatmaps(const void* kpts, const void* sizes, const void* valid, void* out,
                          int batch, int n, int height, int width, double min_overlap,
                          void* stream) {
  Consts k;
  k.one_minus = (float)(1.0 - min_overlap);
  k.inv_one_plus = (float)(1.0 / (1.0 + min_overlap));
  k.b3 = (float)(-2.0 * min_overlap);
  k.c3 = (float)(min_overlap - 1.0);
  k.four_a3 = (float)(4.0 * (4.0 * min_overlap));
  k.inv_two_a3 = (float)(1.0 / (2.0 * (4.0 * min_overlap)));
  k.inv_six = (float)(1.0 / 6.0);
  k.tiny = (float)1e-12;
  const size_t smem = (size_t)3 * kClasses * n * sizeof(float) + kClasses * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        render_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((width + kTileW - 1) / kTileW),
                  (unsigned)((height + kTileH - 1) / kTileH), (unsigned)batch);
  render_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(kpts), static_cast<const float*>(sizes),
      static_cast<const float*>(valid), static_cast<float*>(out), n, height, width, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
