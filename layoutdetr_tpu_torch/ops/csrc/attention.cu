// Fused multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel layoutdetr_tpu/ops/attention.py:_attn_kernel
// (pl.pallas_call in fused_attention). Per (sequence, head) it computes
//     o = softmax(q k^T * scale + bias[key]) v
// with logits and softmax in fp32 and the output in q's dtype, forward
// only and without dropout. The wrapper and the plain PyTorch version are
// in layoutdetr_tpu_torch/ops/attention.py.
//
// Design. The Pallas kernel holds a whole S x S cell of one (batch, head)
// in VMEM. At S=256 in fp32 that cell alone is 256 KB, more than the
// 227 KB of shared memory an H100 block may use, and one block per
// (batch, head) would give too few blocks to fill 132 SMs. So each block
// takes one (sequence, head, 64-query tile), streams the keys in chunks
// of 64 and keeps a running max and sum per query row (online softmax,
// fp32). Logits and probabilities live in registers and shared memory
// only: device memory sees one read of q, k, v and the bias and one
// write of o. Tiles reach shared memory by 16-byte cp.async copies (rows
// past T are zero-filled), so every row of q, k, v and o must start
// 16-byte aligned; the wrapper checks it. The head dim (192 on the main
// path) is not a power of two; tiles are sized from it as a template
// parameter, and the ragged sequence edge (T=64 and T=256 occur, any T
// is taken) is masked: keys past T get a logit of -inf and rows past T
// are not stored.
//
// Two bodies share that plan, one per dtype:
// - fp32: FMAs on the CUDA cores (TF32 would miss the plain version's
//   1e-5). 256 threads form a 16 x 16 grid; thread (tx, ty) owns query
//   rows ty + 16 i (i < 4), keys tx + 16 j (j < 4) of a chunk, and output
//   columns 4 tx + 64 c (c < D / 64). Shared rows are padded by 4 floats,
//   which keeps the float4 reads free of bank conflicts. ~164 KB of
//   shared memory: 1 block/SM.
// - bf16: the tensor cores through mma.sync m16n8k16 (bf16 in, fp32
//   accumulate). 128 threads = 4 warps; each warp owns 16 query rows,
//   holds its q fragments in registers for the whole key loop, and keeps
//   its 16 x D output and row statistics in registers. Fragments come out
//   of shared memory with ldmatrix (V transposed); rows are padded by 16
//   bytes, so the 8 row addresses of an ldmatrix hit 8 bank groups.
//   Probabilities go from the S accumulators straight into bf16 A
//   fragments of P V, rounded to bf16 as the plain version rounds p to
//   v's dtype. ~77 KB of shared memory: 2 blocks/SM.
//
// Bound on this card (H100 SXM): at B*9 = 144 sequences, 4 heads, T=256,
// D=192 one launch is 144 * 4 * 2 * (2 * 256^2 * 192) ~ 29 GFLOP and
// moves ~450 MB in fp32 (q, k, v read once, o written once). fp32 on the
// CUDA cores peaks at 67 TFLOP/s, so fp32 is bound by operations
// (~0.43 ms) and not by bytes (~0.14 ms at 3.35 TB/s). In bf16 the bytes
// halve and the tensor cores would do the operations in ~0.03 ms, so
// bf16 is bound by bytes (~0.07 ms). Neither body overlaps the next
// chunk's copy with compute, and mma.sync reaches only part of the tensor
// cores' rate; wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kHeadDim = 192;  // the only head dim instantiated
constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per streamed chunk

struct Strides {
  long long b, h, s;  // in elements; the head dim is contiguous
};

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // [batch, seq] fp32, contiguous
  void* o;
  Strides qs, ks, vs, os;
  int heads;
  int seq;
  float scale;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// rows [row0, row0 + 64) of one (sequence, head) into dst[64][D + kPadElems]
// by 16-byte cp.async, spread over kNThreads threads; rows past seq are
// zero-filled (src-size 0).
template <typename T, int D, int kPadElems, int kNThreads>
__device__ __forceinline__ void load_rows_async(T* dst, const T* src, long long row_stride,
                                                int row0, int seq) {
  constexpr int ld = D + kPadElems;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  constexpr int kIters = kBK * kChunks / kNThreads;
  static_assert(kBK * kChunks % kNThreads == 0, "tile must split evenly over the threads");
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int idx = threadIdx.x + i * kNThreads;
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const bool valid = row0 + r < seq;
    const T* g = valid ? src + (row0 + r) * row_stride + c * kVec : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst + r * ld + c * kVec)),
                 "l"(g), "r"(valid ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;  // 16 x 16
constexpr int kF32Pad = 4;        // floats per shared row

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) attention_fwd_f32_kernel(AttnArgs a) {
  static_assert(D % 64 == 0, "head dim must be a multiple of 64");
  constexpr int ld = D + kF32Pad;
  constexpr int ldp = kBK + kF32Pad;
  constexpr int kCols = D / 64;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][ld]
  float* Ks = Qs + kBQ * ld;                     // [kBK][ld]
  float* Vs = Ks + kBK * ld;                     // [kBK][ld]
  float* Ps = Vs + kBK * ld;                     // [kBQ][ldp]
  float* Bs = Ps + kBQ * ldp;                    // [kBK]

  const int b = blockIdx.x / a.heads;
  const int h = blockIdx.x - b * a.heads;
  const int q0 = blockIdx.y * kBQ;
  const int seq = a.seq;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const float* q = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* k = static_cast<const float*>(a.k) + b * a.ks.b + h * a.ks.h;
  const float* v = static_cast<const float*>(a.v) + b * a.vs.b + h * a.vs.h;
  float* o = static_cast<float*>(a.o) + b * a.os.b + h * a.os.h;
  const float* bias = a.bias + static_cast<long long>(b) * seq;

  load_rows_async<float, D, kF32Pad, kF32Threads>(Qs, q, a.qs.s, q0, seq);

  float acc[4][kCols][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += kBK) {
    __syncthreads();  // the previous chunk's readers are done
    load_rows_async<float, D, kF32Pad, kF32Threads>(Ks, k, a.ks.s, k0, seq);
    load_rows_async<float, D, kF32Pad, kF32Threads>(Vs, v, a.vs.s, k0, seq);
    if (threadIdx.x < kBK) {
      const int key = k0 + threadIdx.x;
      Bs[threadIdx.x] = key < seq ? bias[key] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    // s = q k^T over the chunk
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }

    // logits, then the online softmax update of each owned row
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool valid = k0 + tx + 16 * j < seq;
      const float bj = Bs[tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][j] = valid ? s[i][j] * a.scale + bj : -CUDART_INF_F;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);  // finite: every chunk has a key < seq
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * ldp + tx + 16 * j] = p;
        sum += p;
      }
      sum = half_warp_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();

    // acc += p v over the chunk
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * ldp + kk);
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + (kk + kq) * ld + 4 * tx + 64 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = kq == 0 ? pv[i].x : kq == 1 ? pv[i].y : kq == 2 ? pv[i].z : pv[i].w;
            acc[i][c][0] = fmaf(p, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p, vv.w, acc[i][c][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq) continue;
    const float inv = 1.f / l[i];
    float* orow = o + row * a.os.s;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      *reinterpret_cast<float4*>(orow + 4 * tx + 64 * c) =
          make_float4(acc[i][c][0] * inv, acc[i][c][1] * inv, acc[i][c][2] * inv,
                      acc[i][c][3] * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kBf16Threads = 128;  // 4 warps x 16 query rows
constexpr int kBf16Pad = 8;        // bf16 per shared row (16 bytes)

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] b[16x8]
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kBf16Threads, 2) attention_fwd_bf16_kernel(AttnArgs a) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int ld = D + kBf16Pad;
  constexpr int kKSteps = D / 16;  // k-steps of q k^T
  constexpr int kDTiles = D / 8;   // n-tiles of p v

  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [kBQ][ld]
  __nv_bfloat16* Ks = Qs + kBQ * ld;                             // [kBK][ld]
  __nv_bfloat16* Vs = Ks + kBK * ld;                             // [kBK][ld]

  const int b = blockIdx.x / a.heads;
  const int h = blockIdx.x - b * a.heads;
  const int q0 = blockIdx.y * kBQ;
  const int seq = a.seq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair

  const auto* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const auto* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const auto* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.vs.b + h * a.vs.h;
  auto* o = static_cast<__nv_bfloat16*>(a.o) + b * a.os.b + h * a.os.h;
  const float* bias = a.bias + static_cast<long long>(b) * seq;

  load_rows_async<__nv_bfloat16, D, kBf16Pad, kBf16Threads>(Qs, q, a.qs.s, q0, seq);
  cp_async_wait_all();
  __syncthreads();
  unsigned qf[kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks)
    ldmatrix_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * ld + ks * 16 + (lane >> 4) * 8);

  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows g and g + 8
  float l[2] = {0.f, 0.f};                      // this thread's share of the row sums

  for (int k0 = 0; k0 < seq; k0 += kBK) {
    __syncthreads();  // the previous chunk's readers are done
    load_rows_async<__nv_bfloat16, D, kBf16Pad, kBf16Threads>(Ks, k, a.ks.s, k0, seq);
    load_rows_async<__nv_bfloat16, D, kBf16Pad, kBf16Threads>(Vs, v, a.vs.s, k0, seq);
    cp_async_wait_all();
    __syncthreads();

    // s = q k^T: 16 rows x 64 keys per warp, 8 n-tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned kb[4];
        ldmatrix_x4(kb, Ks + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * ld + ks * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // logits and the online softmax update of rows g and g + 8
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        const bool valid = key < seq;
        const float bk = valid ? bias[key] : 0.f;
        s[j][e] = valid ? s[j][e] * a.scale + bk : -CUDART_INF_F;
        s[j][e + 2] = valid ? s[j][e + 2] * a.scale + bk : -CUDART_INF_F;
        mx[0] = fmaxf(mx[0], s[j][e]);
        mx[1] = fmaxf(mx[1], s[j][e + 2]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: every chunk has a key < seq
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // acc += p v: 4 k-steps of 16 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        unsigned vb[4];
        ldmatrix_x4_trans(vb, Vs + (16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld +
                                  16 * dp + ((lane >> 4) << 3));
        mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= seq) continue;
    __nv_bfloat16* orow = o + row * a.os.s + 2 * t;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, const AttnArgs& a, int batch, int threads, size_t smem,
           cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * a.heads, (a.seq + kBQ - 1) / kBQ);
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool rows_aligned(const AttnArgs& a, long long vec) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.o};
  const Strides st[4] = {a.qs, a.ks, a.vs, a.os};
  for (int i = 0; i < 4; ++i) {
    if (reinterpret_cast<unsigned long long>(ptrs[i]) % 16 != 0) return false;
    if (st[i].b % vec != 0 || st[i].h % vec != 0 || st[i].s % vec != 0) return false;
  }
  return true;
}

}  // namespace

// strides: 12 int64 in elements, (batch, head, seq) for q, k, v, o.
// dtype: 0 = fp32, 1 = bf16. Returns cudaGetLastError() after the launch,
// or an error code for arguments the kernels do not take.
extern "C" int layoutdetr_attention_forward(const void* q, const void* k, const void* v,
                                            const float* bias, void* o, const long long* strides,
                                            int batch, int heads, int seq, int head_dim,
                                            float scale, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0 || head_dim != kHeadDim || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.o = o;
  a.qs = {strides[0], strides[1], strides[2]};
  a.ks = {strides[3], strides[4], strides[5]};
  a.vs = {strides[6], strides[7], strides[8]};
  a.os = {strides[9], strides[10], strides[11]};
  a.heads = heads;
  a.seq = seq;
  a.scale = scale;
  if (!rows_aligned(a, dtype == 0 ? 4 : 8)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    constexpr int ld = kHeadDim + kF32Pad;
    constexpr size_t smem = sizeof(float) * (3 * kBQ * ld + kBQ * (kBK + kF32Pad) + kBK);
    return launch(attention_fwd_f32_kernel<kHeadDim>, a, batch, kF32Threads, smem, s);
  }
  constexpr size_t smem = sizeof(__nv_bfloat16) * 3 * kBQ * (kHeadDim + kBf16Pad);
  return launch(attention_fwd_bf16_kernel<kHeadDim>, a, batch, kBf16Threads, smem, s);
}
