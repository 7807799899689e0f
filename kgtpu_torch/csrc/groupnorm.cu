// GroupNorm(+ReLU) over channels-last activations, for Hopper (sm_90a).
//
// Replaces kgtpu/ops/pallas/groupnorm.py::fused_group_norm (the Pallas TPU
// kernel, body `_kernel`) and, in the port, every flax nn.GroupNorm of the
// hourglass backbone and the mask head in eval mode (kgtpu/models/blocks.py::
// Norm).
//
// What it computes, per sample b and group g of G (C % G == 0, cg = C / G):
//   mean = E[x], var = max(0, E[x^2] - mean^2)  over (H, W, cg), in f32
//   a[c] = scale[c] * rsqrt(var + eps),  b[c] = bias[c] - mean * a[c]
//   y = x * a + b, then max(y, 0) when relu, stored in the input dtype.
// The clamp of var at 0 follows flax's _compute_stats (flax 0.12.3), which is
// what the default JAX path runs; the Pallas kernel does not clamp.
//
// Bound: memory.  The least traffic is one read of x and one write of y,
// 2 * numel * itemsize bytes (268 MB, 80 us at 3.35 TB/s, for
// [32, 128, 128, 128] bf16); the arithmetic is a few operations per element.
//
// Design: one launch that reads x once and writes y once.  The Pallas kernel
// holds a whole sample in VMEM; a Hopper SM has 227 KB of shared memory, and
// a sample of the 128^2 x 128 level is 4 MB.  So a sample is cut into `parts`
// row ranges of its [H*W, C] channels-last matrix, each a contiguous run of
// whole rows, and a work item (sample, part) is held in shared memory by one
// block from its load to its store:
//   1. load the item's rows into a shared-memory slot (cp.async, 16 bytes a
//      thread), sum x and x^2 per channel from there and fold the channels
//      into per-group sums;
//   2. publish them to a global workspace partial[B, parts, 2G] and arrive
//      at the sample's counter (a release add, no reply awaited);
//   3. once every part has arrived (an acquiring spin on the counter), add
//      all parts' sums in part order (the same order in every block, so the
//      result is the same from call to call), normalise the item from its
//      slot and write y.
// Each block has three slots and pipelines its items: while item t is
// summed and published, item t + 1 is loading, and then item t - 1, whose
// parts have had a step to arrive, is normalised and its slot takes item
// t + 2.  The wait for the other parts of a sample so overlaps loads and
// stores.  Slots are sized so that two blocks fit an SM (113 KB each).
// Samples that fit one part skip the exchange.
//
// Step 3 is safe only if all parts of a sample are resident at once: a block
// spinning on a counter that a never-scheduled block would bump hangs the
// card.  Hence a cooperative launch (cudaLaunchCooperativeKernel refuses a
// grid larger than what fits the card at once) of a persistent grid
// P = floor(capacity / parts) * parts that walks the items in sample-major
// order: P is a multiple of parts, so a sample never straddles two rounds of
// the walk, and every block reaches a sample at the same step.  The barrier
// is hand-written (a release add per arrival, an acquiring spin), so no
// relocatable device code is needed.  The counters come in two banks, used
// by turns (the wrapper keeps the turn with the counters): a call counts in
// its bank, which the previous call zeroed, and zeroes the other bank for
// the next call.  So the counters need no memset between calls,
// and a call is one launch with nothing else on the stream.  Calls whose
// samples fit one part need no exchange and launch as a plain grid.
//
// A sample larger than one slot of every resident block together (about
// 8.5 MB; the largest of the 512^2 main path, the stem's bf16 sample, is
// 8 MB) has items longer than a slot: a block streams
// such an item through its slot in `chunks` slabs, summing each as it
// arrives and keeping the last, and reads the others again from x for
// step 3.  Only then does the kernel read x more than once.
//
// vec: elements per 16-byte access (8 for bf16, 4 for f32), or 1 where C is
// not a multiple of that or x is not 16-byte aligned (plain element copies
// instead of cp.async; the same kernel otherwise).
//
// Interface: plain C functions, loaded with ctypes.  They return a
// cudaError_t value (0 on success), or -1 for a (dtype, vec) pair the
// library was not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 3;

// The launch plan (ops/groupnorm.py::launch_plan); the same field order as
// the wrapper's ctypes Structure.
struct Params {
  int64_t batch;
  int64_t hw;
  int c;
  int groups;
  int rows_per_block;  // rows of one (sample, part) work item
  int slab_rows;       // rows a slot holds
  int parts;           // items per sample
  int grid;            // persistent grid, a multiple of parts
  int smem;            // dynamic shared memory per block, bytes
  int slab_bytes;      // one slot (16-byte aligned)
  int relu;
  float eps;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* o) { *o = __float2bfloat16(v); }

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

// The exchange's synchronisation at device scope: an arrival that orders
// this block's earlier writes (made visible to thread 0 by __syncthreads)
// before the count, and the acquiring load that waits for the count.
__device__ __forceinline__ void arrive(int* count) {
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(count) : "memory");
}
__device__ __forceinline__ int acquire(const int* count) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(count) : "memory");
  return v;
}

// Spin until *count reaches n.  A wait of more than two seconds means the
// protocol broke (a counter not zeroed, a part never scheduled): trap, so
// that the launch fails with an error rather than hanging the card.
__device__ __forceinline__ void wait_for(const int* count, int n) {
  unsigned long long start, now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(start));
  while (acquire(count) < n) {
    __nanosleep(32);
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (now - start > 2000000000ull) __trap();
  }
}

// A group's mean and rstd from its sums over n values.
__device__ __forceinline__ void finish_stats(float sum, float sq, float n, float eps,
                                             float* mean, float* rstd) {
  const float m = sum / n;
  const float var = fmaxf(sq / n - m * m, 0.f);
  *mean = m;
  *rstd = rsqrtf(var + eps);
}

// Start copying n elements (n % VEC == 0) from global to shared memory:
// cp.async, 16 bytes a thread, committed as one group (a plain copy where
// VEC elements are not 16 bytes).
template <typename T, int VEC>
__device__ __forceinline__ void issue_slab(T* dst, const T* src, int n) {
  if constexpr (sizeof(T) * VEC == 16) {
    for (int i = threadIdx.x; i < n / VEC; i += kThreads) {
      const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + i * VEC));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src + i * VEC));
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  }
}

// Wait until at most `pending` of this thread's copy groups are in flight,
// then make the landed ones visible to the block.
template <int pending>
__device__ __forceinline__ void wait_slabs() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
  __syncthreads();
}

// y = x * a + b (+ReLU) over `rows` rows, a[k], b[k] for the thread's VEC
// channels.
template <typename T, int VEC>
__device__ __forceinline__ void normalize_rows(const T* src, T* dst, int rows, int c, int cv,
                                               int r0, int rpp, const float* ma,
                                               const float* mb, bool relu) {
  for (int r = r0; r < rows; r += rpp) {
    const Pack<T, VEC> v = *reinterpret_cast<const Pack<T, VEC>*>(src + r * c + cv * VEC);
    Pack<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float f = to_f(v.v[k]) * ma[k] + mb[k];
      if (relu) f = fmaxf(f, 0.f);
      from_f(f, &o.v[k]);
    }
    *reinterpret_cast<Pack<T, VEC>*>(dst + r * c + cv * VEC) = o;
  }
}

// Shared memory: kSlots slots (slab_bytes each), then f32 scratch: per-thread
// channel sums [2][rpp][C] (later the exchange's lanes), each slot's group
// sums and then mean and rstd [kSlots][2G], scale and bias [2][C], and a
// and b [2][C].  Thread t owns channel vector cv = t % nvec
// (nvec = C / VEC) and rows t / nvec, + rpp, ... of a slot (rpp = kThreads /
// nvec); threads past rpp * nvec only help with loads, folds and the
// exchange.  The workspace is partial[B][parts][stride] (stride: 2G rounded
// up to a multiple of 4).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
group_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y,
                  float* __restrict__ partial, int* __restrict__ sync, const int sync_len,
                  const Params p, const int bank) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = p.c, groups = p.groups, cg = c / groups, cols = 2 * groups;
  const int stride = (cols + 3) / 4 * 4;  // a part's row of the workspace, whole float4s
  const int nvec = c / VEC, rpp = kThreads / nvec;
  const int cv = threadIdx.x % nvec, r0 = threadIdx.x / nvec;
  const bool owner = r0 < rpp;
  float* red = reinterpret_cast<float*>(smem + kSlots * p.slab_bytes);  // [2][rpp][c]
  float* stat = red + 2 * rpp * c;                                        // [kSlots][cols]
  float* coef = stat + kSlots * cols;                                     // [2][c]
  float* ab = coef + 2 * c;                                               // [2][c]
  const float n = (float)(p.hw * cg);
  const int64_t items = p.batch * p.parts;
  const int64_t grid = gridDim.x;
  // arrival counters: this call counts in `bank`, which the previous call
  // left at zero, and zeroes the other bank for the next call
  int* count = sync + bank * sync_len;
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < sync_len; i += kThreads) sync[(bank ^ 1) * sync_len + i] = 0;
  if (blockIdx.x >= items) return;
  const int steps = (int)((items - blockIdx.x + grid - 1) / grid);
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    coef[ch] = scale[ch];
    coef[c + ch] = bias[ch];
  }

  // step t of this block: item blockIdx.x + t * grid, rows [row0, row_end)
  // of sample b, held in slot t % kSlots
  struct Item {
    int64_t b, row0, row_end;
    int part;
  };
  auto item_at = [&](int t) {
    Item it;
    const int64_t i = blockIdx.x + (int64_t)t * grid;
    it.b = i / p.parts;
    it.part = (int)(i - it.b * p.parts);
    it.row0 = (int64_t)it.part * p.rows_per_block;
    it.row_end = min64(it.row0 + p.rows_per_block, p.hw);
    return it;
  };
  auto slot = [&](int t) { return reinterpret_cast<T*>(smem + (t % kSlots) * p.slab_bytes); };
  auto issue_first = [&](int t) {
    const Item it = item_at(t);
    issue_slab<T, VEC>(slot(t), x + (it.b * p.hw + it.row0) * c,
                       (int)min64(p.slab_rows, it.row_end - it.row0) * c);
  };

  // 1-2. sum the item in slot t % kSlots (its first slab has landed), then
  // publish and arrive; the last to arrive finishes the sample's stats
  auto sum_and_publish = [&](int t) {
    const Item it = item_at(t);
    const T* sl = slot(t);
    float s[VEC], q[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) { s[k] = 0.f; q[k] = 0.f; }
    for (int64_t cr = it.row0; cr < it.row_end; cr += p.slab_rows) {
      const int rows = (int)min64(p.slab_rows, it.row_end - cr);
      if (cr != it.row0) {  // chunks > 1: stream the next slab through the slot
        __syncthreads();
        issue_slab<T, VEC>(slot(t), x + (it.b * p.hw + cr) * c, rows * c);
        wait_slabs<0>();
      }
      if (owner) {
        for (int r = r0; r < rows; r += rpp) {
          const Pack<T, VEC> v = *reinterpret_cast<const Pack<T, VEC>*>(sl + r * c + cv * VEC);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float f = to_f(v.v[k]);
            s[k] += f;
            q[k] += f * f;
          }
        }
      }
    }
    if (owner) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        red[r0 * c + cv * VEC + k] = s[k];
        red[(rpp + r0) * c + cv * VEC + k] = q[k];
      }
    }
    __syncthreads();
    // fold the row lanes per channel (into row 0), then the channels per
    // group, each in a fixed order
    for (int ch = threadIdx.x; ch < c; ch += kThreads) {
      float a = 0.f, aq = 0.f;
      for (int r = 0; r < rpp; ++r) {
        a += red[r * c + ch];
        aq += red[(rpp + r) * c + ch];
      }
      red[ch] = a;
      red[rpp * c + ch] = aq;
    }
    __syncthreads();
    // a sample of one part has its stats now; others publish their sums
    float* st = stat + (t % kSlots) * cols;
    float* pb = partial + (it.b * p.parts + it.part) * stride;
    for (int g = threadIdx.x; g < groups; g += kThreads) {
      float a = 0.f, aq = 0.f;
      for (int k = 0; k < cg; ++k) {
        a += red[g * cg + k];
        aq += red[rpp * c + g * cg + k];
      }
      if (p.parts == 1) {
        finish_stats(a, aq, n, p.eps, st + g, st + groups + g);
      } else {
        pb[g] = a;
        pb[groups + g] = aq;
      }
    }
    __syncthreads();
    if (p.parts > 1 && threadIdx.x == 0) arrive(count + it.b);
  };

  // 3. wait for the sample's stats, then normalise the item: its resident
  // slab from the slot, any earlier slab (chunks > 1) read again from x
  auto normalize = [&](int t) {
    const Item it = item_at(t);
    float* st = stat + (t % kSlots) * cols;
    if (p.parts > 1) {
      if (threadIdx.x == 0) wait_for(count + it.b, p.parts);
      __syncthreads();
      // add the parts in part order, the same in every block: lane l of a
      // column quad takes parts l, l + lanes, ... (16-byte loads, eight in
      // flight), then the lanes are added in order
      const float* pb = partial + it.b * p.parts * stride;
      const int quads = stride / 4;
      const int lanes = max(1, min(kThreads / quads, 2 * rpp * c / stride));
      for (int idx = threadIdx.x; idx < lanes * quads; idx += kThreads) {
        const int qd = idx % quads, l = idx / quads;
        const float4* col = reinterpret_cast<const float4*>(pb) + qd;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        int k = l;
        for (; k + 7 * lanes < p.parts; k += 8 * lanes) {
          float4 v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = __ldcg(col + (k + u * lanes) * quads);
#pragma unroll
          for (int u = 0; u < 8; ++u) add4(a, v[u]);
        }
        for (; k < p.parts; k += lanes) add4(a, __ldcg(col + k * quads));
        reinterpret_cast<float4*>(red + l * stride)[qd] = a;
      }
      __syncthreads();
      for (int g = threadIdx.x; g < groups; g += kThreads) {
        float a = 0.f, aq = 0.f;
        for (int l = 0; l < lanes; ++l) {
          a += red[l * stride + g];
          aq += red[l * stride + groups + g];
        }
        finish_stats(a, aq, n, p.eps, st + g, st + groups + g);
      }
      __syncthreads();
    }
    for (int ch = threadIdx.x; ch < c; ch += kThreads) {
      const int g = ch / cg;
      const float a = coef[ch] * st[groups + g];
      ab[ch] = a;
      ab[c + ch] = coef[c + ch] - st[g] * a;
    }
    __syncthreads();
    if (owner) {
      float ma[VEC], mb[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        ma[k] = ab[cv * VEC + k];
        mb[k] = ab[c + cv * VEC + k];
      }
      const T* xb = x + it.b * p.hw * c;
      T* yb = y + it.b * p.hw * c;
      int64_t cr = it.row0;
      for (; cr + p.slab_rows < it.row_end; cr += p.slab_rows)
        normalize_rows<T, VEC>(xb + cr * c, yb + cr * c, p.slab_rows, c, cv, r0, rpp, ma, mb,
                               p.relu);
      normalize_rows<T, VEC>(slot(t), yb + cr * c, (int)(it.row_end - cr), c, cv, r0, rpp, ma,
                             mb, p.relu);
    }
    __syncthreads();  // the slot is free for the next load
  };

  issue_first(0);
  if (steps > 1) issue_first(1);
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) wait_slabs<1>(); else wait_slabs<0>();
    sum_and_publish(t);
    if (t > 0) normalize(t - 1);
    if (t + 2 < steps) issue_first(t + 2);
  }
  normalize(steps - 1);
}

template <typename T, int VEC>
int capacity(int smem, int* out) {
  const void* fn = reinterpret_cast<const void*>(group_norm_kernel<T, VEC>);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, group_norm_kernel<T, VEC>,
                                                        kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  *out = coop ? per_sm * sms : 0;
  return 0;
}

template <typename T, int VEC>
int launch(const void* x, const float* scale, const float* bias, void* y, float* partial,
           int* sync, int sync_len, const void* params, int bank, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  Params pv = *static_cast<const Params*>(params);
  if (pv.parts == 1) {  // no exchange between blocks: any schedule will do
    group_norm_kernel<T, VEC><<<pv.grid, kThreads, pv.smem, stream>>>(
        xt, scale, bias, yt, partial, sync, sync_len, pv, bank);
    return (int)cudaGetLastError();
  }
  void* args[] = {&xt, &scale, &bias, &yt, &partial, &sync, &sync_len, &pv, &bank};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(group_norm_kernel<T, VEC>),
                                          dim3(pv.grid), dim3(kThreads), args,
                                          (size_t)pv.smem, stream);
}

}  // namespace

extern "C" {

// Sets the kernel's shared-memory limit to `smem` bytes on the current
// device and writes the number of its blocks that fit the card at once (0
// without cooperative launch).
int kgtpu_group_norm_capacity(int dtype, int vec, int smem, int* out) {
  if (dtype == 0 && vec == 4) return capacity<float, 4>(smem, out);
  if (dtype == 0 && vec == 1) return capacity<float, 1>(smem, out);
  if (dtype == 1 && vec == 8) return capacity<__nv_bfloat16, 8>(smem, out);
  if (dtype == 1 && vec == 1) return capacity<__nv_bfloat16, 1>(smem, out);
  return -1;
}

// dtype: 0 = float32, 1 = bfloat16.  vec: elements per access (4 or 1 for
// float32, 8 or 1 for bfloat16).  params: a Params (void here: a type of the
// unnamed namespace in the signature would hide the symbol).  partial:
// [batch, parts, stride] f32.  sync: [2, sync_len] int32 arrival counters,
// sync_len >= batch, all zero before the first call on them; bank: 0 or 1,
// the other one than the previous call's on the same counters.
int kgtpu_group_norm_relu(const void* x, const void* scale, const void* bias, void* y,
                          void* partial, void* sync, int sync_len, const void* p, int bank,
                          int dtype, int vec, void* stream) {
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* pa = static_cast<float*>(partial);
  int* sy = static_cast<int*>(sync);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) return launch<float, 4>(x, sc, bi, y, pa, sy, sync_len, p, bank, s);
  if (dtype == 0 && vec == 1) return launch<float, 1>(x, sc, bi, y, pa, sy, sync_len, p, bank, s);
  if (dtype == 1 && vec == 8)
    return launch<__nv_bfloat16, 8>(x, sc, bi, y, pa, sy, sync_len, p, bank, s);
  if (dtype == 1 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, sc, bi, y, pa, sy, sync_len, p, bank, s);
  return -1;
}

}  // extern "C"
