// CornerNet Gaussian target heatmaps for a batch, for Hopper (sm_90a).
//
// Replaces kgtpu/ops/pallas/gaussian.py::render_heatmaps_pallas (the Pallas
// TPU kernel), which the JAX train step vmaps over the batch; its plain
// version is kgtpu_torch/ops/targets.py::render_heatmaps_batch.
//
// What it computes, per image b, pixel (y, x) and keypoint class c of C = 5:
//   out[b, y, x, c] = max over instances i with coef[b, i] > 0 of
//                     expf(-((x - kx[b,c,i])^2 + (y - ky[b,c,i])^2) * coef[b,i])
// and 0 where no instance is within reach.  The wrapper (ops/gaussian.py)
// floors the keypoints and sets coef = 1 / (2 sigma^2) for valid instances
// and 0 for padding, so every squared distance is an exact integer and a
// keypoint pixel gets expf(-0) = 1.0 exactly: the focal loss counts positives
// as t >= 1.0.  Hence expf, not __expf, and no --use_fast_math.
//
// Design.  Grid (row bands, images): one block per band of `band_h` rows and
// all W columns of one image, so one launch renders the whole batch.  The
// block stages its image's per-instance scalars (kx, ky for 5 classes and
// coef: 11 floats an instance, 5.6 KB at N = 128) in shared memory, then
// keeps the instances within reach of its band: those whose row distance d
// from the band to the instance's keypoint rows gives d^2 * coef < 14
// (exp(-14) ~ 8e-7, below the targets' f32 resolution), the Pallas kernel's
// skip test.  The test is the same for every thread of the block, so it costs
// no divergence.  Each thread then walks its pixels of the band, keeps the 5
// class maxima in registers over the kept instances, and writes the 5 floats
// of a pixel side by side: the [B, H, W, 5] layout the focal loss reads, so
// no transpose follows.  The last band is masked when H % band_h != 0.
//
// Bound.  Bytes: the f32 output dominates (2.62 MB at [8, 128, 128, 5],
// 0.78 us at 3.35 TB/s); the inputs are 5.6 KB an image.  Operations: the
// function needs one expf and about 8 other f32 operations per (pixel,
// class, instance) inside the disc d^2 * coef < 14 around that class's
// keypoint, a few pixels to a few hundred per instance, so at the train
// step's size the bytes bound it; expf goes through the SM's
// special-function units (16 results per clock per SM).  This design
// computes every column of a band for each instance within row reach, more
// expf than the discs need (bounding the columns as the rows are is the
// next step); the single launch per batch keeps the launch count at one
// per step.
//
// Interface: a plain C function, loaded with ctypes.  It returns
// cudaGetLastError() after the launch (0 when it was accepted).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kClasses = 5;
constexpr float kCutoff = 14.0f;
constexpr int kThreads = 256;

// kx, ky: [B, 5, N]; coef: [B, N]; out: [B, H, W, 5].
// Shared memory: (2 * 5 + 1) * N floats, N ints and one int.
__global__ void __launch_bounds__(kThreads)
render_kernel(const float* __restrict__ kx, const float* __restrict__ ky,
              const float* __restrict__ coef, float* __restrict__ out, int n,
              int height, int width, int band_h) {
  extern __shared__ float smem[];
  float* s_kx = smem;
  float* s_ky = s_kx + kClasses * n;
  float* s_coef = s_ky + kClasses * n;
  int* s_idx = reinterpret_cast<int*>(s_coef + n);
  int* s_count = s_idx + n;

  const int b = blockIdx.y;
  const int y0 = blockIdx.x * band_h;
  const int y_last = min(y0 + band_h, height) - 1;
  const float* kxb = kx + (int64_t)b * kClasses * n;
  const float* kyb = ky + (int64_t)b * kClasses * n;
  const float* cb = coef + (int64_t)b * n;
  for (int i = threadIdx.x; i < kClasses * n; i += blockDim.x) {
    s_kx[i] = kxb[i];
    s_ky[i] = kyb[i];
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_coef[i] = cb[i];
  if (threadIdx.x == 0) *s_count = 0;
  __syncthreads();

  // Keep the instances within reach of this band.  The order of s_idx
  // depends on the atomics, but a max does not depend on the order.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float cf = s_coef[i];
    float lo = s_ky[i], hi = lo;
#pragma unroll
    for (int c = 1; c < kClasses; ++c) {
      lo = fminf(lo, s_ky[c * n + i]);
      hi = fmaxf(hi, s_ky[c * n + i]);
    }
    const float d = fmaxf(fmaxf((float)y0 - hi, lo - (float)y_last), 0.0f);
    if (cf > 0.0f && d * d * cf < kCutoff) s_idx[atomicAdd(s_count, 1)] = i;
  }
  __syncthreads();

  const int kept = *s_count;
  const int npix = (y_last - y0 + 1) * width;
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int y = y0 + p / width;
    const int x = p - (p / width) * width;
    const float fy = (float)y, fx = (float)x;
    float m[kClasses];
#pragma unroll
    for (int c = 0; c < kClasses; ++c) m[c] = 0.0f;
    for (int j = 0; j < kept; ++j) {
      const int i = s_idx[j];
      const float cf = s_coef[i];
#pragma unroll
      for (int c = 0; c < kClasses; ++c) {
        const float dx = fx - s_kx[c * n + i];
        const float dy = fy - s_ky[c * n + i];
        m[c] = fmaxf(m[c], expf(-(dx * dx + dy * dy) * cf));
      }
    }
    float* o = out + (((int64_t)b * height + y) * width + x) * kClasses;
#pragma unroll
    for (int c = 0; c < kClasses; ++c) o[c] = m[c];
  }
}

}  // namespace

// kx, ky: [batch, 5, n] f32 floored keypoints; coef: [batch, n] f32 (0 for
// invalid slots); out: [batch, height, width, 5] f32.  Returns a cudaError_t
// value.
extern "C" int kgtpu_render_heatmaps(const void* kx, const void* ky, const void* coef,
                                     void* out, int batch, int n, int height, int width,
                                     int band_h, void* stream) {
  const dim3 grid((unsigned)((height + band_h - 1) / band_h), (unsigned)batch);
  const size_t smem = (size_t)(2 * kClasses + 1) * n * sizeof(float) + (size_t)(n + 1) * sizeof(int);
  render_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(kx), static_cast<const float*>(ky),
      static_cast<const float*>(coef), static_cast<float*>(out), n, height, width, band_h);
  return (int)cudaGetLastError();
}
