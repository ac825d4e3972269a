// Fused bias + activation + gain + clamp, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel layoutdetr_tpu/ops/bias_act.py:_bias_act_pallas
// (pl.pallas_call, body _bias_act_kernel):
//     y = clamp(act(x + b[c]) * gain, -clamp, clamp)
// computed in fp32, stored in x's dtype (fp32 or bf16), for the 9
// activations of activation_funcs. The wrapper, the autograd Function and
// the plain PyTorch versions are in layoutdetr_tpu_torch/ops/bias_act.py.
//
// Layout. x is read as [outer, C, inner] with the channel of flat element
// i at (i / inner) % C, so one kernel serves the FC layers ([B, C], inner
// = 1) and NCHW convolutions ([B, C, H*W]) without the moveaxis copy the
// TPU kernel makes to put channels on the lanes. Both passes run a grid of
// (chunk, channel): block (j, c) takes positions [j*kChunk, (j+1)*kChunk)
// of the outer*inner positions of channel c, so b[c] is read once per
// block and, for NCHW, the chunk is contiguous runs of inner elements.
//
// Backward. The TPU kernel has no VJP (JAX differentiates its XLA path);
// the port runs the kernel in D's training forward, so it needs one. It
// recomputes z = x + b from x and b rather than saving y (y cannot give
// act'(z) for every activation, and x is kept for the backward anyway):
//     dz = dy * gain * act'(z), 0 where |act(z) * gain| > clamp,
//     dx = dz (in x's dtype),   db[c] = sum of dz over all positions of c.
// db is deterministic: each block writes one fp32 partial sum per
// (channel, chunk), reduced in a fixed order (warp shuffles, then the
// warps in order), and a second small kernel adds the partials of each
// channel in chunk order. No atomics, so db is the same from run to run.
//
// Bound on this card (H100 SXM, 3.35 TB/s): both passes move bytes and do
// a few operations per element. On the train step's path (batch 16, D's
// bg_decoder) the 13 synthesis layers hold about 131 M elements: the
// forward reads x and writes y (1.05 GB in fp32, ~0.31 ms; half in bf16),
// the backward reads dy and x and writes dx (~0.47 ms in fp32). The kernels
// keep 4 independent elements in flight per thread and 256 threads per
// block so that enough loads are outstanding to approach that rate; they
// use scalar loads (no vector width assumed of inner), which is a later
// speed item, as is fusing the bias_act into the convolution's epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                     // positions per thread and block pass
constexpr long long kChunk = kThreads * kItems;  // positions per block

enum Act { kLinear, kRelu, kLrelu, kTanh, kSigmoid, kElu, kSelu, kSoftplus, kSwish };

constexpr float kSeluScale = 1.0507009873554804934193349852946f;
constexpr float kSeluAlpha = 1.6732632423543772848170429916717f;

struct Params {
  long long outer;
  long long inner;
  int channels;
  int act;
  float alpha;
  float gain;
  float clamp;  // < 0: no clamp
  long long nchunks;
};

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

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// flat index of position pos (of outer * inner) of channel c
__device__ __forceinline__ long long flat_index(long long pos, int c, const Params& p) {
  const long long o = pos / p.inner;
  return (o * p.channels + c) * p.inner + (pos - o * p.inner);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bias_act_fwd_kernel(const T* __restrict__ x,
                                                                const float* __restrict__ b,
                                                                T* __restrict__ y, Params p) {
  const int c = blockIdx.y;
  const float bc = b[c];
  const long long positions = p.outer * p.inner;
  const long long base = blockIdx.x * kChunk + threadIdx.x;
#pragma unroll 4
  for (int k = 0; k < kItems; ++k) {
    const long long pos = base + (long long)k * kThreads;
    if (pos >= positions) break;
    const long long i = flat_index(pos, c, p);
    float v = act_fwd(load(x, i) + bc, p.act, p.alpha) * p.gain;
    // fmaxf/fminf return the number for a NaN operand: keep NaN, as torch.clamp does
    if (p.clamp >= 0.f && !isnan(v)) v = fminf(fmaxf(v, -p.clamp), p.clamp);
    store(y, i, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bias_act_bwd_kernel(
    const T* __restrict__ dy, const T* __restrict__ x, const float* __restrict__ b,
    T* __restrict__ dx, float* __restrict__ partial, Params p) {
  __shared__ float warp_sums[kThreads / 32];
  const int c = blockIdx.y;
  const float bc = b[c];
  const long long positions = p.outer * p.inner;
  const long long base = blockIdx.x * kChunk + threadIdx.x;
  float sum = 0.f;
#pragma unroll 4
  for (int k = 0; k < kItems; ++k) {
    const long long pos = base + (long long)k * kThreads;
    if (pos >= positions) break;
    const long long i = flat_index(pos, c, p);
    const float z = load(x, i) + bc;
    float g = load(dy, i) * p.gain * act_grad(z, p.act, p.alpha);
    if (p.clamp >= 0.f && fabsf(act_fwd(z, p.act, p.alpha) * p.gain) > p.clamp) g = 0.f;
    store(dx, i, g);
    sum += g;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    partial[(long long)c * p.nchunks + blockIdx.x] = s;
  }
}

// db[c] = sum over chunks of partial[c, :], in chunk order
__global__ void bias_act_db_kernel(const float* __restrict__ partial, float* __restrict__ db,
                                   int channels, long long nchunks) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  float s = 0.f;
  for (long long j = 0; j < nchunks; ++j) s += partial[(long long)c * nchunks + j];
  db[c] = s;
}

bool make_params(Params& p, long long outer, int channels, long long inner, int act, float alpha,
                 float gain, float clamp) {
  if (outer <= 0 || inner <= 0 || channels <= 0 || channels > 65535 || act < kLinear ||
      act > kSwish)
    return false;
  p.outer = outer;
  p.inner = inner;
  p.channels = channels;
  p.act = act;
  p.alpha = alpha;
  p.gain = gain;
  p.clamp = clamp;
  p.nchunks = (outer * inner + kChunk - 1) / kChunk;
  return p.nchunks <= 0x7fffffffLL;
}

}  // namespace

// Positions per block: the wrapper sizes the partial-sum scratch of the
// backward as channels * ceil(outer * inner / chunk) floats.
extern "C" long long layoutdetr_bias_act_chunk() { return kChunk; }

// x, y: [outer, channels, inner] contiguous, dtype 0 = fp32, 1 = bf16;
// b: [channels] fp32. clamp < 0 means no clamp. Returns cudaGetLastError()
// after the launch, or an error code for arguments the kernel does not take.
extern "C" int layoutdetr_bias_act_forward(const void* x, const float* b, void* y,
                                           long long outer, int channels, long long inner,
                                           int act, float alpha, float gain, float clamp,
                                           int dtype, void* stream) {
  Params p;
  if (!make_params(p, outer, channels, inner, act, alpha, gain, clamp) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)p.nchunks, channels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    bias_act_fwd_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), b,
                                                          static_cast<float*>(y), p);
  else
    bias_act_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), b, static_cast<__nv_bfloat16*>(y), p);
  return (int)cudaGetLastError();
}

// dy, x, dx: [outer, channels, inner] contiguous in one dtype; b: [channels]
// fp32; partial: scratch of channels * nchunks fp32; db: [channels] fp32.
// Launches the dx pass and the db pass on the stream.
extern "C" int layoutdetr_bias_act_backward(const void* dy, const void* x, const float* b,
                                            void* dx, float* partial, float* db,
                                            long long outer, int channels, long long inner,
                                            int act, float alpha, float gain, float clamp,
                                            int dtype, long long nchunks, void* stream) {
  Params p;
  if (!make_params(p, outer, channels, inner, act, alpha, gain, clamp) || (dtype != 0 && dtype != 1) ||
      nchunks != p.nchunks)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)p.nchunks, channels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    bias_act_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(dy), static_cast<const float*>(x), b, static_cast<float*>(dx),
        partial, p);
  else
    bias_act_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(x), b,
        static_cast<__nv_bfloat16*>(dx), partial, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bias_act_db_kernel<<<(channels + 127) / 128, 128, 0, s>>>(partial, db, channels, p.nchunks);
  return (int)cudaGetLastError();
}
