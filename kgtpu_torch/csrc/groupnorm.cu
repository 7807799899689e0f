// GroupNorm(+ReLU) over channels-last activations, for Hopper (sm_90a).
//
// Replaces kgtpu/ops/pallas/groupnorm.py::fused_group_norm (the Pallas TPU
// kernel) and, in the port, every flax nn.GroupNorm of the hourglass
// backbone and the mask head (kgtpu/models/blocks.py::Norm).
//
// What it computes, per sample b and group g of G (C % G == 0, cg = C / G):
//   mean = E[x], var = max(0, E[x^2] - mean^2)  over (H, W, cg), in f32
//   a[c] = scale[c] * rsqrt(var + eps),  b[c] = bias[c] - mean * a[c]
//   y = x * a + b, then max(y, 0) when relu, stored in the input dtype.
// The clamp of var at 0 follows flax's _compute_stats (flax 0.12.3), which is
// what the default JAX path runs; the Pallas kernel does not clamp.
//
// Bound: memory.  The least traffic is one read of x and one write of y
// (2 * numel * itemsize bytes); the arithmetic is a few operations per
// element.  This first version is right and simple, not tuned: three
// launches and THREE passes over x (stats read, normalize read + write),
// against the one read and one write that bound it.
//   1. stats:     grid (chunks, B).  Each block sums a chunk of rows per
//                 channel in f32 (16-byte vector loads along the contiguous
//                 C) and writes partial sums to a [B, chunks, 2, C] scratch.
//                 No atomics, so the result is deterministic.
//   2. finalize:  grid B.  Reduces the partials over chunks, then over the
//                 cg channels of each group, into a[B, C] and b[B, C].
//   3. normalize: grid-stride over 16-byte vectors: y = x * a + b (+ReLU).
// A whole sample does not fit one SM (a [128*128, 128] bf16 sample is 4 MB)
// and Hopper blocks run in no order, so the TPU kernel's single-block design
// becomes the split reduction above.
//
// Interface: a plain C function, loaded with ctypes.  It returns the first
// non-zero cudaGetLastError() of its launches (0 when all were accepted).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* o) { *o = __float2bfloat16(v); }

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// x viewed as [B, HW, C].  blockDim.x = nvec * rpb, nvec = C / VEC: thread t
// owns channel vector t % nvec and walks rows t / nvec, + rpb, ...
// Shared memory: 2 * rpb * C floats.
template <typename T, int VEC>
__global__ void stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                             int64_t hw, int c, int chunk_rows) {
  extern __shared__ float smem[];
  const int nvec = c / VEC;
  const int rpb = blockDim.x / nvec;
  const int cv = threadIdx.x % nvec;
  const int r0 = threadIdx.x / nvec;
  const int chunk = blockIdx.x;
  const int nchunks = gridDim.x;
  const int64_t b = blockIdx.y;
  const int64_t row_begin = (int64_t)chunk * chunk_rows;
  int64_t row_end = row_begin + chunk_rows;
  if (row_end > hw) row_end = hw;

  float s[VEC], ss[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) { s[k] = 0.f; ss[k] = 0.f; }
  const T* xb = x + b * hw * c;
  for (int64_t row = row_begin + r0; row < row_end; row += rpb) {
    Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xb + row * c + cv * VEC);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float v = to_f(p.v[k]);
      s[k] += v;
      ss[k] += v * v;
    }
  }
  float* s_sum = smem;
  float* s_sq = smem + rpb * c;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    s_sum[r0 * c + cv * VEC + k] = s[k];
    s_sq[r0 * c + cv * VEC + k] = ss[k];
  }
  __syncthreads();
  float* out = partial + (b * nchunks + chunk) * 2 * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int r = 0; r < rpb; ++r) {
      a += s_sum[r * c + ch];
      q += s_sq[r * c + ch];
    }
    out[ch] = a;
    out[c + ch] = q;
  }
}

// grid B; shared memory: 2 * C floats.  ab: [B, 2, C] (a, then b).
__global__ void finalize_kernel(const float* __restrict__ partial,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias,
                                float* __restrict__ ab, int nchunks, int c,
                                int groups, int64_t hw, float eps) {
  extern __shared__ float smem[];
  float* c_sum = smem;
  float* c_sq = smem + c;
  const int64_t b = blockIdx.x;
  const float* pb = partial + b * nchunks * 2 * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int k = 0; k < nchunks; ++k) {
      a += pb[k * 2 * c + ch];
      q += pb[k * 2 * c + c + ch];
    }
    c_sum[ch] = a;
    c_sq[ch] = q;
  }
  __syncthreads();
  const int cg = c / groups;
  const float n = (float)(hw * cg);
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const int g0 = (ch / cg) * cg;
    float a = 0.f, q = 0.f;
    for (int k = 0; k < cg; ++k) {
      a += c_sum[g0 + k];
      q += c_sq[g0 + k];
    }
    const float mean = a / n;
    const float var = fmaxf(q / n - mean * mean, 0.f);
    const float mul = scale[ch] * rsqrtf(var + eps);
    ab[b * 2 * c + ch] = mul;
    ab[b * 2 * c + c + ch] = bias[ch] - mean * mul;
  }
}

template <typename T, int VEC>
__global__ void normalize_kernel(const T* __restrict__ x, const float* __restrict__ ab,
                                 T* __restrict__ y, int64_t hw, int c, int relu,
                                 int64_t nvec_total) {
  const int nvec = c / VEC;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec_total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int cv = (int)(i % nvec);
    const int64_t b = i / ((int64_t)nvec * hw);
    const float* ab_b = ab + b * 2 * c;
    Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(x + i * VEC);
    Pack<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int ch = cv * VEC + k;
      float v = to_f(p.v[k]) * ab_b[ch] + ab_b[c + ch];
      if (relu) v = fmaxf(v, 0.f);
      from_f(v, &o.v[k]);
    }
    *reinterpret_cast<Pack<T, VEC>*>(y + i * VEC) = o;
  }
}

template <typename T, int VEC>
int launch(const void* x, const float* scale, const float* bias, void* y, float* partial,
           float* ab, int64_t batch, int64_t hw, int c, int groups, int chunk_rows,
           int nchunks, int relu, float eps, cudaStream_t stream) {
  const int nvec = c / VEC;
  const int rpb = nvec >= 256 ? 1 : 256 / nvec;
  const int threads = nvec * rpb;
  dim3 sgrid(nchunks, (unsigned)batch);
  stats_kernel<T, VEC><<<sgrid, threads, 2 * rpb * c * sizeof(float), stream>>>(
      static_cast<const T*>(x), partial, hw, c, chunk_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int fthreads = c < 1024 ? c : 1024;
  finalize_kernel<<<(unsigned)batch, fthreads, 2 * c * sizeof(float), stream>>>(
      partial, scale, bias, ab, nchunks, c, groups, hw, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int64_t nvec_total = batch * hw * nvec;
  int64_t blocks = (nvec_total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  normalize_kernel<T, VEC><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const T*>(x), ab, static_cast<T*>(y), hw, c, relu, nvec_total);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: elements per load (4 or 1 for
// float32, 8 or 1 for bfloat16).  partial: [batch, nchunks, 2, c] f32
// scratch; ab: [batch, 2, c] f32 scratch.  Returns a cudaError_t value, or
// -1 for a (dtype, vec) pair it was not built for.
extern "C" int kgtpu_group_norm_relu(const void* x, const void* scale, const void* bias,
                                     void* y, void* partial, void* ab, int64_t batch,
                                     int64_t hw, int c, int groups, int chunk_rows,
                                     int nchunks, int relu, float eps, int dtype, int vec,
                                     void* stream) {
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* pa = static_cast<float*>(partial);
  float* abp = static_cast<float*>(ab);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return launch<float, 4>(x, sc, bi, y, pa, abp, batch, hw, c, groups, chunk_rows, nchunks,
                            relu, eps, s);
  if (dtype == 0 && vec == 1)
    return launch<float, 1>(x, sc, bi, y, pa, abp, batch, hw, c, groups, chunk_rows, nchunks,
                            relu, eps, s);
  if (dtype == 1 && vec == 8)
    return launch<__nv_bfloat16, 8>(x, sc, bi, y, pa, abp, batch, hw, c, groups, chunk_rows,
                                    nchunks, relu, eps, s);
  if (dtype == 1 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, sc, bi, y, pa, abp, batch, hw, c, groups, chunk_rows,
                                    nchunks, relu, eps, s);
  return -1;
}
