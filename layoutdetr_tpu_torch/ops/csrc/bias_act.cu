// Fused bias + activation + gain + clamp, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel layoutdetr_tpu/ops/bias_act.py:_bias_act_pallas
// (pl.pallas_call, body _bias_act_kernel):
//     y = clamp(act(x + b[c]) * gain, -clamp, clamp)
// computed in fp32, stored in x's dtype (fp32 or bf16), for the 9
// activations of activation_funcs. b is read in fp32 or bf16 and widened
// here. The wrapper, its per-shape plans, the autograd Function and the
// plain PyTorch versions are in layoutdetr_tpu_torch/ops/bias_act.py.
//
// Layout. x is read as [outer, C, inner]: `outer` rows of `inner`
// contiguous elements per channel. Two forms, each in a vector variant
// (16-byte loads and stores: float4, or 8 bf16) where the shape and the
// pointers allow it, and a scalar variant for the rest (an odd `inner` or
// C, a tensor that does not start on 16 bytes), which then covers the
// whole call; no call of the train step takes it.
//  - FC (inner == 1, x [B, C]): a thread owns V adjacent channels. Forward,
//    a block takes a row (rows with a stride past 65535). Backward, a block
//    is 32 channel lanes x 8 row slots: slot s sums rows s, s + 8, ... in
//    order, then slot 0 adds the 8 slots in order and writes db. dx and db
//    in one launch, no scratch, a fixed order.
//  - map (inner > 1, NCHW): grid (k, C). The k blocks of channel c walk its
//    outer * inner positions with a fixed stride, so the channel and b[c]
//    are known per block; the row of a vector is a shift (a 32-bit
//    division where inner / V is not a power of two), its offset one wide
//    multiply-add. The backward's k blocks form one thread-block cluster:
//    each reduces its positions in a fixed order (its loop, warp
//    shuffles, the warps in order), then rank 0 adds the ranks' sums in
//    rank order through distributed shared memory and writes db[c]. One
//    launch, no atomics, no scratch: two runs give bit-equal db.
// The plan (V, k, threads per block) is chosen per shape by the wrapper:
// the forward aims at 8 blocks of 256 threads an SM; the backward's k is at
// most 16 (sizes above 8 are non-portable and set
// cudaFuncAttributeNonPortableClusterSizeAllowed once per device), and
// where C * 16 blocks cannot fill the card (ToRGB, C = 3) its blocks grow
// to 1024 threads to keep enough loads in flight. linear and lrelu, the
// step's two activations, have kernels of their own; the others share one
// that switches on the activation per element. Run on the lrelu calls, that
// generic kernel took 5-8% longer on the largest fp32 call and 35-37%
// longer in bf16 (8 elements a load: the instructions count there), which
// pays for 48 instantiations (2 dtypes x 2 widths x 3 activations x 4
// kernels) and a build of ~11 s.
//
// Backward. The TPU kernel has no VJP (JAX differentiates its XLA path).
// It recomputes z = x + b from x and b rather than saving y (y cannot give
// act'(z) for every activation):
//     dz = dy * gain * act'(z), 0 where |act(z) * gain| > clamp,
//     dx = dz (in x's dtype),   db[c] = sum of dz over all positions of c.
// A linear call without a clamp never reads x; with gain 1 as well the
// wrapper passes dx = nullptr and returns dy itself as dx, so the launch
// only reduces db.
//
// Bound on this card (H100 SXM, 3.35 TB/s): every form moves bytes and
// does a few operations per element. The large NCHW calls of the train
// step are bound by bytes: [16, 32, 256, 256] lrelu, 33.5 M elements,
// needs 0.0801 ms forward and 0.1202 ms backward in fp32. Reached on an
// H100 80GB HBM3 at 700 W, two runs of `chip_smoke.py --bias-act-only`:
// fp32 0.0981-0.0984 ms forward and 0.1447-0.1451 ms backward (81-82% and
// 83% of the bound), bf16 0.0517-0.0528 and 0.0865-0.0866 ms (76-77% and
// 69%). The previous design, with scalar loads, a 64-bit division per
// element and a second pass for db, took 0.131 and 0.181 ms in fp32. The
// small calls ([16, C] FCs, 4x4-32x32 maps: 38 of the 48 a step) move under
// 2 us of bytes and are bound by the host: 9-15 us a call at [16, 512],
// beside 7-9 us for torch.add on the same host (PERF.md). Left for later:
// fusing the bias/act into the convolution's epilogue, which needs a
// hand-written conv.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kFcLanes = 32;    // backward FC block: 32 channel lanes x 8 row slots
constexpr int kFcSlots = 8;
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;

enum Act { kLinear, kRelu, kLrelu, kTanh, kSigmoid, kElu, kSelu, kSoftplus, kSwish };
constexpr int kAnyAct = -1;  // kernels specialised on kLinear and kLrelu, the rest read p.act
enum Form { kFc, kMap };

constexpr float kSeluScale = 1.0507009873554804934193349852946f;
constexpr float kSeluAlpha = 1.6732632423543772848170429916717f;

}  // namespace

// One plan per call signature, built once by the wrapper (ctypes Structure
// _Params in ops/bias_act.py, same field order) and passed by pointer.
struct Params {
  int form;          // kFc or kMap
  int vec;           // elements per load: 1, or 16 bytes' worth (4 fp32, 8 bf16)
  int dtype;         // x, y, dy, dx: 0 fp32, 1 bf16
  int b_bf16;        // b: 0 fp32, 1 bf16
  int act;
  float alpha;
  float gain;
  float clamp;       // < 0: no clamp
  int need_x;        // the backward reads x (act' or the clamp depend on z)
  int channels;
  long long outer;
  long long inner;
  unsigned vecs_per_channel;  // map: outer * inner / vec
  unsigned inner_vecs;        // map: inner / vec
  int inner_shift;            // log2(inner_vecs), or -1 if not a power of two
  unsigned fwd_grid_x;        // FC: channel blocks; map: k, blocks per channel
  unsigned fwd_grid_y;        // FC: row blocks (each walks rows with stride fwd_grid_y)
  unsigned bwd_grid_x;        // FC: blocks of kFcLanes lanes; map: cluster size k
  int threads;                // forward threads per block, a multiple of 32
  int bwd_threads;            // map backward threads per block (FC: kFcLanes x kFcSlots)
};

namespace {

__device__ __forceinline__ float sigmoidf(float z) { return 1.f / (1.f + expf(-z)); }

__device__ __forceinline__ float act_fwd(float z, int act, float alpha) {
  switch (act) {
    case kRelu: return fmaxf(z, 0.f);
    case kLrelu: return z >= 0.f ? z : z * alpha;
    case kTanh: return tanhf(z);
    case kSigmoid: return sigmoidf(z);
    case kElu: return z >= 0.f ? z : expm1f(z);
    case kSelu: return kSeluScale * (z >= 0.f ? z : kSeluAlpha * expm1f(z));
    case kSoftplus: return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
    case kSwish: return z * sigmoidf(z);
    default: return z;
  }
}

__device__ __forceinline__ float act_grad(float z, int act, float alpha) {
  switch (act) {
    case kRelu: return z > 0.f ? 1.f : 0.f;
    case kLrelu: return z >= 0.f ? 1.f : alpha;
    case kTanh: {
      const float t = tanhf(z);
      return 1.f - t * t;
    }
    case kSigmoid: {
      const float s = sigmoidf(z);
      return s * (1.f - s);
    }
    case kElu: return z >= 0.f ? 1.f : expf(z);
    case kSelu: return kSeluScale * (z >= 0.f ? 1.f : kSeluAlpha * expf(z));
    case kSoftplus: return sigmoidf(z);
    case kSwish: {
      const float s = sigmoidf(z);
      return s + z * s * (1.f - s);
    }
    default: return 1.f;
  }
}

// the activation: A where the kernel is specialised on it, else the plan's
template <int A>
__device__ __forceinline__ int act_of(const Params& p) {
  return A == kAnyAct ? p.act : A;
}

template <int A>
__device__ __forceinline__ float fwd_op(float xv, float bc, const Params& p) {
  float v = act_fwd(xv + bc, act_of<A>(p), p.alpha) * p.gain;
  // fmaxf/fminf return the number for a NaN operand: keep NaN, as torch.clamp does
  if (p.clamp >= 0.f && !isnan(v)) v = fminf(fmaxf(v, -p.clamp), p.clamp);
  return v;
}

template <int A>
__device__ __forceinline__ float bwd_op(float dyv, float xv, float bc, const Params& p) {
  const float z = xv + bc;
  float g = dyv * p.gain * act_grad(z, act_of<A>(p), p.alpha);
  if (p.clamp >= 0.f && fabsf(act_fwd(z, act_of<A>(p), p.alpha) * p.gain) > p.clamp) g = 0.f;
  return g;
}

__device__ __forceinline__ float load_bias(const void* b, long long c, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(b)[c])
              : static_cast<const float*>(b)[c];
}

// V elements at p (16-byte aligned when V > 1), widened to fp32
template <int V>
__device__ __forceinline__ void ld(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}
template <int V>
__device__ __forceinline__ void ld(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  }
}
template <int V>
__device__ __forceinline__ void st(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}
template <int V>
__device__ __forceinline__ void st(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = t;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// element offset of vector v (of channel c's outer * inner / V) in x
template <int V>
__device__ __forceinline__ long long map_offset(unsigned v, int c, const Params& p) {
  const unsigned o = p.inner_shift >= 0 ? v >> p.inner_shift : v / p.inner_vecs;
  const unsigned w = v - o * p.inner_vecs;
  return ((long long)o * p.channels + c) * p.inner + (long long)w * V;
}

// ---- FC form: x [outer, C], a thread owns channels [c0, c0 + V) ----

// block (i, j) takes rows j, j + gridDim.y, ... of its channel lanes
template <typename T, int V, int A>
__global__ void __launch_bounds__(kMaxThreads) fwd_fc(const T* __restrict__ x,
                                                      const void* __restrict__ b,
                                                      T* __restrict__ y, const Params p) {
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (c0 >= p.channels) return;
  float bc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) bc[i] = load_bias(b, c0 + i, p.b_bf16);
  for (long long o = blockIdx.y; o < p.outer; o += gridDim.y) {
    const long long i = o * p.channels + c0;
    float v[V];
    ld<V>(x + i, v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = fwd_op<A>(v[j], bc[j], p);
    st<V>(y + i, v);
  }
}

// block (kFcLanes, kFcSlots): slot s takes rows s, s + kFcSlots, ... in
// order, then slot 0 adds the slots' sums in slot order: a fixed order
template <typename T, int V, int A>
__global__ void __launch_bounds__(kFcLanes * kFcSlots) bwd_fc(const T* __restrict__ dy,
                                                             const T* __restrict__ x,
                                                             const void* __restrict__ b,
                                                             T* __restrict__ dx,
                                                             float* __restrict__ db,
                                                             const Params p) {
  __shared__ float part[kFcSlots][kFcLanes][V];
  const int c0 = (blockIdx.x * kFcLanes + threadIdx.x) * V;
  const bool live = c0 < p.channels;
  float bc[V], sum[V];
#pragma unroll
  for (int i = 0; i < V; ++i) bc[i] = live ? load_bias(b, c0 + i, p.b_bf16) : 0.f, sum[i] = 0.f;
  for (long long o = threadIdx.y; live && o < p.outer; o += kFcSlots) {
    const long long i = o * p.channels + c0;
    float g[V], xv[V];
    ld<V>(dy + i, g);
    if (p.need_x) {
      ld<V>(x + i, xv);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) xv[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      g[j] = bwd_op<A>(g[j], xv[j], bc[j], p);
      sum[j] += g[j];
    }
    if (dx != nullptr) st<V>(dx + i, g);
  }
#pragma unroll
  for (int j = 0; j < V; ++j) part[threadIdx.y][threadIdx.x][j] = sum[j];
  __syncthreads();
  if (threadIdx.y == 0 && live) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < kFcSlots; ++t) s += part[t][threadIdx.x][j];
      db[c0 + j] = s;
    }
  }
}

// ---- map form: grid (k, C), block (r, c) takes vectors r*T + t + j*k*T ----

constexpr int kItems = 2;  // vectors in flight per thread and loop pass

template <typename T, int V, int A>
__global__ void __launch_bounds__(kMaxThreads) fwd_map(const T* __restrict__ x,
                                                       const void* __restrict__ b,
                                                       T* __restrict__ y, const Params p) {
  const int c = blockIdx.y;
  const float bc = load_bias(b, c, p.b_bf16);
  const unsigned n = p.vecs_per_channel;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned v0 = blockIdx.x * blockDim.x + threadIdx.x; v0 < n; v0 += kItems * stride) {
    float v[kItems][V];
    long long off[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const unsigned vk = v0 + k * stride;
      if (vk < n) {
        off[k] = map_offset<V>(vk, c, p);
        ld<V>(x + off[k], v[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (v0 + k * stride < n) {
#pragma unroll
        for (int j = 0; j < V; ++j) v[k][j] = fwd_op<A>(v[k][j], bc, p);
        st<V>(y + off[k], v[k]);
      }
    }
  }
}

template <typename T, int V, int A>
__global__ void __launch_bounds__(kMaxThreads) bwd_map(const T* __restrict__ dy,
                                                       const T* __restrict__ x,
                                                       const void* __restrict__ b,
                                                       T* __restrict__ dx, float* __restrict__ db,
                                                       const Params p) {
  __shared__ float warp_sums[kMaxThreads / 32];
  __shared__ float block_sum;
  const int c = blockIdx.y;
  const float bc = load_bias(b, c, p.b_bf16);
  const unsigned n = p.vecs_per_channel;
  const unsigned stride = gridDim.x * blockDim.x;
  float sum = 0.f;
  for (unsigned v0 = blockIdx.x * blockDim.x + threadIdx.x; v0 < n; v0 += kItems * stride) {
    float g[kItems][V], xv[kItems][V];
    long long off[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const unsigned vk = v0 + k * stride;
      if (vk < n) {
        off[k] = map_offset<V>(vk, c, p);
        ld<V>(dy + off[k], g[k]);
        if (p.need_x) {
          ld<V>(x + off[k], xv[k]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) xv[k][j] = 0.f;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (v0 + k * stride < n) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          g[k][j] = bwd_op<A>(g[k][j], xv[k][j], bc, p);
          sum += g[k][j];
        }
        if (dx != nullptr) st<V>(dx + off[k], g[k]);
      }
    }
  }
  // the block's sum in a fixed order: butterfly within each warp, then the
  // warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += warp_sums[w];
    block_sum = s;
    if (gridDim.x == 1) db[c] = s;
  }
  if (gridDim.x == 1) return;  // no cluster: the block is the channel
  // the cluster's k blocks are the channel's: rank 0 adds their sums in rank
  // order; the second sync keeps every rank's shared memory alive until then
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    float s = 0.f;
    for (unsigned r = 0; r < cluster.num_blocks(); ++r) s += *cluster.map_shared_rank(&block_sum, r);
    db[c] = s;
  }
  cluster.sync();
}

// ---- host side ----

// Sets the current device to dev for the launch, back to the caller's after.
class DeviceGuard {
 public:
  explicit DeviceGuard(int dev) {
    int cur = -1;
    err_ = cudaGetDevice(&cur);
    if (err_ == cudaSuccess && cur != dev) {
      err_ = cudaSetDevice(dev);
      prev_ = cur;
    }
  }
  ~DeviceGuard() {
    if (prev_ >= 0) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  cudaError_t err_ = cudaSuccess;
};

bool threads_ok(int t) { return t > 0 && t <= kMaxThreads && t % 32 == 0; }

bool valid(const Params* p, int dev) {
  if (p == nullptr || dev < 0 || dev >= kMaxDevices) return false;
  if (p->dtype != 0 && p->dtype != 1) return false;
  const int wide = p->dtype == 0 ? 4 : 8;
  if ((p->vec != 1 && p->vec != wide) || p->act < kLinear || p->act > kSwish) return false;
  if (!threads_ok(p->threads) || p->channels <= 0 || p->outer <= 0 || p->inner <= 0 ||
      p->fwd_grid_x == 0 || p->bwd_grid_x == 0)
    return false;
  if (p->form == kFc)
    return p->inner == 1 && p->channels % p->vec == 0 && p->fwd_grid_y > 0 &&
           p->fwd_grid_y <= 65535;
  return p->form == kMap && threads_ok(p->bwd_threads) && p->channels <= 65535 &&
         p->bwd_grid_x <= kMaxCluster && p->inner % p->vec == 0 &&
         (unsigned long long)p->outer * p->inner / p->vec == p->vecs_per_channel;
}

template <typename T, int V, int A>
cudaError_t forward(const Params& p, const void* x, const void* b, void* y, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (p.form == kFc)
    fwd_fc<T, V, A><<<dim3(p.fwd_grid_x, p.fwd_grid_y), p.threads, 0, s>>>(xt, b, yt, p);
  else
    fwd_map<T, V, A><<<dim3(p.fwd_grid_x, p.channels), p.threads, 0, s>>>(xt, b, yt, p);
  return cudaGetLastError();
}

template <typename T, int V, int A>
cudaError_t backward(const Params& p, const void* dy, const void* x, const void* b, void* dx,
                     float* db, int dev, cudaStream_t s) {
  const T* dyt = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  T* dxt = static_cast<T*>(dx);
  if (p.form == kFc) {
    bwd_fc<T, V, A><<<p.bwd_grid_x, dim3(kFcLanes, kFcSlots), 0, s>>>(dyt, xt, b, dxt, db, p);
    return cudaGetLastError();
  }
  const unsigned k = p.bwd_grid_x;
  if (k > 8) {  // non-portable cluster size: allowed once per device
    static bool allowed[kMaxDevices] = {};
    if (!allowed[dev]) {
      const cudaError_t err = cudaFuncSetAttribute(
          bwd_map<T, V, A>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      allowed[dev] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(k, p.channels);
  cfg.blockDim = dim3(p.bwd_threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 0;
  if (k > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.numAttrs = 1;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, bwd_map<T, V, A>, dyt, xt, b, dxt, db, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the kernels specialised on the call's activation where there is one
template <typename T, int V>
cudaError_t forward_any(const Params& p, const void* x, const void* b, void* y, cudaStream_t s) {
  if (p.act == kLinear) return forward<T, V, kLinear>(p, x, b, y, s);
  if (p.act == kLrelu) return forward<T, V, kLrelu>(p, x, b, y, s);
  return forward<T, V, kAnyAct>(p, x, b, y, s);
}

template <typename T, int V>
cudaError_t backward_any(const Params& p, const void* dy, const void* x, const void* b, void* dx,
                         float* db, int dev, cudaStream_t s) {
  if (p.act == kLinear) return backward<T, V, kLinear>(p, dy, x, b, dx, db, dev, s);
  if (p.act == kLrelu) return backward<T, V, kLrelu>(p, dy, x, b, dx, db, dev, s);
  return backward<T, V, kAnyAct>(p, dy, x, b, dx, db, dev, s);
}

}  // namespace

// x, y: [outer, channels, inner] contiguous in p->dtype, 16-byte aligned
// when p->vec > 1; b: [channels] in fp32 or bf16 (p->b_bf16). Launches on
// `stream` on device `dev`. Returns the launch's cudaError_t, or
// cudaErrorInvalidValue for a plan the kernels do not take.
extern "C" int layoutdetr_bias_act_forward(const Params* p, const void* x, const void* b, void* y,
                                           int dev, void* stream) {
  if (!valid(p, dev)) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(dev);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->dtype == 0)
    return (int)(p->vec == 1 ? forward_any<float, 1>(*p, x, b, y, s)
                             : forward_any<float, 4>(*p, x, b, y, s));
  return (int)(p->vec == 1 ? forward_any<__nv_bfloat16, 1>(*p, x, b, y, s)
                           : forward_any<__nv_bfloat16, 8>(*p, x, b, y, s));
}

// dy, x, dx: as x above (x is not read unless p->need_x); dx may be null,
// and then only db is computed; db: [channels] fp32. One launch.
extern "C" int layoutdetr_bias_act_backward(const Params* p, const void* dy, const void* x,
                                            const void* b, void* dx, float* db, int dev,
                                            void* stream) {
  if (!valid(p, dev)) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(dev);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->dtype == 0)
    return (int)(p->vec == 1 ? backward_any<float, 1>(*p, dy, x, b, dx, db, dev, s)
                             : backward_any<float, 4>(*p, dy, x, b, dx, db, dev, s));
  return (int)(p->vec == 1 ? backward_any<__nv_bfloat16, 1>(*p, dy, x, b, dx, db, dev, s)
                           : backward_any<__nv_bfloat16, 8>(*p, dy, x, b, dx, db, dev, s));
}

// sizeof(Params): the wrapper checks its ctypes Structure against it.
extern "C" int layoutdetr_bias_act_params_size() { return (int)sizeof(Params); }
