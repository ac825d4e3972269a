// Fused multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel layoutdetr_tpu/ops/attention.py:_attn_kernel
// (pl.pallas_call in fused_attention). Per (sequence, head) it computes
//     o = softmax(q k^T * scale + bias[key]) v
// with logits and softmax in fp32, p rounded to v's dtype before p v (as
// _attn_kernel does), the output in q's dtype, forward only, and
// optionally with dropout on the probabilities (the training form of the
// hoisted text pass). The wrapper, its plan and the plain PyTorch version
// are in layoutdetr_tpu_torch/ops/attention.py.
//
// The Pallas kernel holds a whole S x S cell of one (batch, head) in VMEM.
// At S=256 that cell alone (256 KB in fp32) is more than the 227 KB of
// shared memory an H100 block may use, so both bodies here stream the keys
// in chunks and keep a running max and sum per query row (online softmax,
// fp32). Logits and probabilities never reach device memory: it sees one
// read of q, k, v and the bias and one write of o. The head dim is 192
// (768 wide, 4 heads), the only one instantiated; any T is taken: keys past
// T get a logit of -inf and rows past T are not stored.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 67 TFLOP/s fp32 on the CUDA
// cores, 989 TFLOP/s bf16 on the tensor cores): at B*9 = 144 sequences,
// 4 heads, T=256, D=192 a launch is 4 * 576 * 256^2 * 192 ~ 29 GFLOP and
// moves 4 * 576 * 256 * 192 elements. fp32 is bound by operations
// (~0.43 ms, bytes ~0.14 ms); bf16 by bytes (~0.068 ms, the tensor cores
// would need ~0.03 ms). At T=64 both are bound by bytes.
//
// bf16 body: tensor cores, wgmma fed by TMA, warp-specialised, persistent.
// - A block is 3 warpgroups: warp 0 of the first is the producer, the other
//   two are consumers that own 64 query rows each of a 128-query tile.
//   Blocks (one per SM, 198 KB of shared memory) walk the tiles
//   (sequence, head, 128 queries) with a stride of the grid, so the ring
//   below runs on from one tile into the next.
// - Loads: the producer keeps TMA loads (cp.async.bulk.tensor, 4-d maps
//   over the strided [B, T, H, D] view BERT hands over, byte strides of the
//   view, encoded per call on the host with cuTensorMapEncodeTiled taken
//   from cudaGetDriverEntryPointByVersion, so nothing links libcuda) in
//   flight into a 2-stage ring of 64-key K and V chunks, with one full
//   mbarrier each for K and V and one empty mbarrier per stage, and Q into
//   two buffers (the next tile's Q lands while this one runs). Each load is
//   3 boxes of 64 columns (128 bytes, the 128-byte swizzle span) by the
//   tile's rows; TMA zero-fills rows past T. The producer also writes the
//   chunk's bias (times log2 e, -inf past T) into shared memory.
// - Query tile and K/V reuse: choice (a) of the design, 128 queries a block
//   in two consumer warpgroups. At T=256 the K/V of one (sequence, head)
//   leave L2 twice, not 4 times as with 64-query blocks, and the two tiles
//   of one head are neighbours in the tile order, so they run at the same
//   time and the second read mostly hits L2. A cluster with TMA multicast
//   (choice b) would read them once but ties ceil(T/128) blocks together
//   and buys at most the other half of the K/V reads from L2.
// - Products: S = Q K^T by wgmma.mma_async m64n64k16 (bf16 in, fp32
//   accumulate), Q and K K-major in swizzled shared memory; O += P V by
//   m64n192k16 with P from registers (the register-source A operand) and V
//   MN-major in shared memory. O is 64 x 192 fp32, 96 registers a thread;
//   setmaxnreg gives the consumers 232 registers and the producer 40.
// - Softmax in fp32 on the accumulators: a thread holds rows g and g + 8
//   (g = lane / 4) of its warp's 16 and columns 8j + 2(lane % 4) + {0, 1},
//   the layout of an mma m16n8 fragment, so the row max and sum take two
//   shuffles and the probabilities become the A fragments of P V in place,
//   rounded to bf16.
// - Epilogue: O / l is rounded to bf16 into the consumer's half of its Q
//   buffer (swizzled, as TMA reads it) and written by TMA stores, which
//   clip rows past T; the buffer goes back to the producer once the store
//   has read it.
// - A consumer whose 64 rows all lie past T (T <= 64) only keeps the
//   barriers' counts.
//
// fp32 body: CUDA cores in full fp32 (the port's fp32 contract is 1e-5 of
// the plain version; TF32 would miss it). What bounds it on this card is
// the shared-memory pipe that feeds the FMAs: a warp's 16-byte shared load
// costs about as much as 16 of its FMAs, so the tiles are chosen for FMAs
// per shared load. A block takes 64 queries and streams keys in chunks of
// 32; 128 threads: for q k^T thread (sx, sy) owns rows sy + 16 i (i < 4)
// and keys sx + 8 j (j < 4), 16 FMAs for every 2 float4 reads; for p v
// rows py + 8 i (i < 8) and columns 4 px + 64 c (c < 3), 96 accumulators,
// 384 FMAs for every 20 float4 reads. The row statistics live with the
// q k^T owners; alpha and, at the end, the row sum reach the p v owners
// through shared memory. Shared rows are padded by 4 floats, which keeps
// the float4 reads free of bank conflicts. 107 KB of shared memory, so 2
// blocks share an SM and one block's loads and barriers hide behind the
// other's FMAs. Copies overlap compute within a block too: 16-byte
// cp.async groups are staggered so that V_j lands while s_j = q k_j^T and
// its softmax run, and K_{j+1} lands while p_j v_j runs; two barriers a
// chunk (one more with dropout).
//
// Dropout. The TPU kernel draws its keep mask from the TPU's own PRNG,
// seeded seed + b*H + h; those bits cannot be had here. This kernel keeps
// probability p[b, h, q, k] when the Philox4x32-10 word for it is >= the
// threshold rate * 2^32 (as the TPU kernel compares its bits), with
//     key     = (seed, b*H + h)   (H the whole layer's heads; see below)
//     counter = (k / 4, q, 0, 0), word k % 4,
// so one 128-bit draw covers 4 consecutive keys and the bits depend on
// neither the tiling nor the dtype. ops/attention.py computes the same
// bits in plain PyTorch (philox4x32), so the card and its plain version
// drop the same entries. The row sum of the online softmax takes every
// key, dropped ones included; only the numerator of p v is masked and
// scaled by 1 / (1 - rate), as the TPU kernel masks p after normalizing.
// fp32: after a chunk's probabilities are in shared memory, each thread
// masks 2 groups of 4 keys there. bf16: the two threads of a quad that
// hold one group's keys (rows g and g + 8) each draw one of the two rows'
// words and swap the halves the other needs with one shuffle.
// Under tensor parallelism a launch holds only a rank's heads of each
// sequence: Params carries the layer's head count (total_heads, the H of
// the key) and the rank's first head (head_offset), and local head h keys
// as head head_offset + h, so the rank drops exactly what a launch over
// all heads drops for those heads. One launch over all heads has
// head_offset 0 and total_heads = heads.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// The plan's structs have external linkage: the C entry points take them.
// Tensor-map geometry of one of q, k, v, o (bf16 body): dims[0] is the
// head dim, dims[1..3] the head, sequence and batch dims in order of
// increasing stride; strides[i] is the byte stride of dims[i + 1];
// pos_h, pos_t, pos_b are the map dims (1-3) of head, sequence and batch.
struct MapGeom {
  cuuint64_t dims[4];
  cuuint64_t strides[3];
  int pos_h, pos_t, pos_b;
  int pad_;
};

// Everything about a call that its signature fixes (the wrapper's plan).
struct Params {
  int dtype;  // 0 fp32, 1 bf16
  int batch;
  int heads;
  int seq;
  int head_dim;
  float scale;
  int dropout;         // 0: deterministic
  unsigned threshold;  // keep when bits >= threshold (rate * 2^32)
  float inv_keep;      // 1 / (1 - rate)
  int head_offset;     // the Philox key's heads: local head h is head_offset + h
  int total_heads;     // of total_heads (>= head_offset + heads) in each sequence
  int pad_;
  long long strides[4][3];  // elements: (batch, head, seq) of q, k, v, o
  MapGeom maps[4];          // q, k, v, o
};

namespace {

constexpr int kHeadDim = 192;  // the only head dim instantiated
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

// What a kernel reads.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // [batch, seq] fp32, contiguous
  void* o;
  long long qs[3], ks[3], vs[3], os[3];  // fp32 body: (batch, head, seq) in elements
  int heads;
  int seq;
  float scale;  // fp32: scale; bf16: scale * log2 e
  int dropout;
  unsigned seed;  // Philox key word 0
  int head_offset, total_heads;  // key word 1 = b * total_heads + head_offset + h
  unsigned threshold;
  float inv_keep;
  int q_tiles;  // bf16: 128-query tiles of one (sequence, head)
  int tiles;    // bf16: batch * heads * q_tiles
  int pos[4];   // bf16: pos_h | pos_t << 2 | pos_b << 4 of the q, k, v, o maps
};

// Philox4x32 with 10 rounds (Salmon et al., Random123).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float keep_or_drop(unsigned bits, float p, const Args& a) {
  return bits >= a.threshold ? p * a.inv_keep : 0.f;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Q = 64;         // queries per block
constexpr int kF32K = 32;         // keys per chunk
constexpr int kF32Threads = 128;
constexpr int kF32Pad = 4;        // floats per shared row
constexpr int kF32Smem =
    4 * ((kF32Q + 2 * kF32K) * (kHeadDim + kF32Pad) + kF32Q * (kF32K + kF32Pad) + kF32Q);

// rows [row0, row0 + kRows) of one (sequence, head) into dst[kRows][D + 4]
// by 16-byte cp.async over the block; rows past seq are zero-filled.
template <int D, int kRows>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, long long row_stride,
                                              int row0, int seq) {
  constexpr int ld = D + kF32Pad;
  constexpr int kChunks = D / 4;
  constexpr int kIters = kRows * kChunks / kF32Threads;
  static_assert(kRows * kChunks % kF32Threads == 0, "tile must split evenly over the threads");
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int idx = threadIdx.x + i * kF32Threads;
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const bool valid = row0 + r < seq;
    const float* g = valid ? src + (row0 + r) * row_stride + c * 4 : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst + r * ld + c * 4)),
                 "l"(g), "r"(valid ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// over the 8 lanes that share a row of q k^T
__device__ __forceinline__ float octet_max(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float octet_sum(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 2) attention_fwd_f32_kernel(const Args a) {
  static_assert(D % 64 == 0, "head dim must be a multiple of 64");
  constexpr int ld = D + kF32Pad;
  constexpr int ldp = kF32K + kF32Pad;
  constexpr int kCols = D / 64;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kF32Q][ld]
  float* Ks = Qs + kF32Q * ld;                   // [kF32K][ld]
  float* Vs = Ks + kF32K * ld;                   // [kF32K][ld]
  float* Ps = Vs + kF32K * ld;                   // [kF32Q][ldp]
  float* Rs = Ps + kF32Q * ldp;                  // [kF32Q]: a row's alpha, at the end its sum

  const int b = blockIdx.x / a.heads;
  const int h = blockIdx.x - b * a.heads;
  const unsigned key_head = b * a.total_heads + a.head_offset + h;
  const int q0 = blockIdx.y * kF32Q;
  const int seq = a.seq;
  // q k^T: thread (sx, sy) owns rows sy + 16 i (i < 4), keys sx + 8 j (j < 4)
  const int sx = threadIdx.x & 7;
  const int sy = threadIdx.x >> 3;
  // p v: thread (px, py) owns rows py + 8 i (i < 8), columns 4 px + 64 c (c < 3)
  const int px = threadIdx.x & 15;
  const int py = threadIdx.x >> 4;

  const float* q = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const float* k = static_cast<const float*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const float* v = static_cast<const float*>(a.v) + b * a.vs[0] + h * a.vs[1];
  float* o = static_cast<float*>(a.o) + b * a.os[0] + h * a.os[1];
  const float* bias = a.bias + static_cast<long long>(b) * seq;

  // groups in flight: (q, k_0), then v_0
  load_rows_f32<D, kF32Q>(Qs, q, a.qs[2], q0, seq);
  load_rows_f32<D, kF32K>(Ks, k, a.ks[2], 0, seq);
  cp_async_commit();
  load_rows_f32<D, kF32K>(Vs, v, a.vs[2], 0, seq);
  cp_async_commit();

  float acc[8][kCols][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -CUDART_INF_F, l[i] = 0.f;

  for (int k0 = 0; k0 < seq; k0 += kF32K) {
    // k_j has landed; every thread is done with v_{j-1}, p_{j-1} and alpha
    if (k0 == 0)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (k0 > 0) {  // v_j lands while s_j runs
      load_rows_f32<D, kF32K>(Vs, v, a.vs[2], k0, seq);
      cp_async_commit();
    }
    float bk[4];
    bool valid[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + sx + 8 * j;
      valid[j] = key < seq;
      bk[j] = valid[j] ? bias[key] : 0.f;
    }

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
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (sy + 16 * i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(Ks + (sx + 8 * j) * ld + d);
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

    // logits, then the online softmax update of each owned row; its alpha
    // goes to the threads that own the row in p v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = valid[j] ? s[i][j] * a.scale + bk[j] : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = octet_max(mx);
      const float m_new = fmaxf(m[i], mx);  // finite: every chunk has a key < seq
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(sy + 16 * i) * ldp + sx + 8 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + octet_sum(sum);
      m[i] = m_new;
      if (sx == 0) Rs[sy + 16 * i] = alpha;
    }

    // v_j has landed and p_j is complete; every thread is done with k_j
    cp_async_wait<0>();
    __syncthreads();
    if (k0 + kF32K < seq) {  // k_{j+1} lands while p_j v_j runs
      load_rows_f32<D, kF32K>(Ks, k, a.ks[2], k0 + kF32K, seq);
      cp_async_commit();
    }

    if (a.dropout) {  // mask the chunk's probabilities, 4 keys per draw
      constexpr int kGroups = kF32K / 4;
#pragma unroll
      for (int i = 0; i < kF32Q * kGroups / kF32Threads; ++i) {
        const int gi = threadIdx.x + i * kF32Threads;
        const int r = gi / kGroups;
        const int cg = gi - r * kGroups;
        const uint4 bits = philox4x32_10(make_uint4((k0 >> 2) + cg, q0 + r, 0u, 0u),
                                         make_uint2(a.seed, key_head));
        float4* pr = reinterpret_cast<float4*>(Ps + r * ldp + 4 * cg);
        float4 p = *pr;
        p.x = keep_or_drop(bits.x, p.x, a);
        p.y = keep_or_drop(bits.y, p.y, a);
        p.z = keep_or_drop(bits.z, p.z, a);
        p.w = keep_or_drop(bits.w, p.w, a);
        *pr = p;
      }
      __syncthreads();
    }

    // acc = acc * alpha + p v over the chunk
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float alpha = Rs[py + 8 * i];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
#pragma unroll 2
    for (int kk = 0; kk < kF32K; kk += 4) {
      float4 pv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = *reinterpret_cast<const float4*>(Ps + (py + 8 * i) * ldp + kk);
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + (kk + kq) * ld + 4 * px + 64 * c);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
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

  __syncthreads();  // every alpha is read
  if (sx == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) Rs[sy + 16 * i] = l[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + py + 8 * i;
    if (row >= seq) continue;
    const float inv = 1.f / Rs[py + 8 * i];
    float* orow = o + row * a.os[2];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      *reinterpret_cast<float4*>(orow + 4 * px + 64 * c) =
          make_float4(acc[i][c][0] * inv, acc[i][c][1] * inv, acc[i][c][2] * inv,
                      acc[i][c][3] * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kBf16Threads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kQRows = 128;        // queries per tile
constexpr int kChunk = 64;         // keys per ring stage
constexpr int kDSub = kHeadDim / 64;  // 128-byte (64-column) swizzled sub-tiles
constexpr int kSubQ = kQRows * 128;   // bytes of one Q sub-tile
constexpr int kSubKV = kChunk * 128;  // bytes of one K or V sub-tile
constexpr int kQBuf = kDSub * kSubQ;
constexpr int kKVStage = kDSub * kSubKV;
constexpr int kOffQ = 0;  // 2 Q buffers
constexpr int kOffK = kOffQ + 2 * kQBuf;
constexpr int kOffV = kOffK + 2 * kKVStage;
constexpr int kOffBias = kOffV + 2 * kKVStage;  // [2][kChunk] fp32
constexpr int kOffBar = kOffBias + 2 * kChunk * 4;
constexpr int kNumBars = 10;
constexpr int kBf16Smem = kOffBar + 8 * kNumBars + 1024;  // + alignment to 1024
// barriers: q_full[2], q_empty[2], k_full[2], v_full[2], kv_empty[2]
constexpr int kQFull = 0, kQEmpty = 2, kKFull = 4, kVFull = 6, kKVEmpty = 8;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// coordinates of (head h, row t, batch b) in a map whose dims 1-3 are
// ordered as `pos` says
__device__ __forceinline__ void map_coords(int pos, int h, int t, int b, int& c1, int& c2,
                                           int& c3) {
  const int ph = pos & 3, pt = (pos >> 2) & 3;
  c1 = ph == 1 ? h : pt == 1 ? t : b;
  c2 = ph == 2 ? h : pt == 2 ? t : b;
  c3 = ph == 3 ? h : pt == 3 ? t : b;
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle; lbo and sbo in
// 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of r across the wgmma fences
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S[64 x 64] (+)= Q[64 x 16] K[64 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t desc_q, uint64_t desc_k,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_q), "l"(desc_k), "r"(accumulate));
}

// O[64 x 192] += P[64 x 16] V[16 x 192]: P in registers (the A fragments),
// V MN-major in shared memory (transposed B).
__device__ __forceinline__ void wgmma_pv(float (&d)[96], const uint32_t (&a)[4], uint64_t desc_v) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
}

__device__ __forceinline__ void bf16_producer(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                              const CUtensorMap* tm_v, const Args& a,
                                              uint32_t base, float* bias_s) {
  const int lane = threadIdx.x;
  const uint32_t bars = base + kOffBar;
  const int seq = a.seq;
  int n = 0;  // ring chunks so far
  for (int it = 0, tile = blockIdx.x; tile < a.tiles; ++it, tile += gridDim.x) {
    const int bh = tile / a.q_tiles;
    const int q0 = (tile - bh * a.q_tiles) * kQRows;
    const int b = bh / a.heads, h = bh - b * a.heads;
    const int qb = it & 1;
    int c1, c2, c3;
    if (lane == 0) {
      mbar_wait(bars + 8 * (kQEmpty + qb), ((it >> 1) & 1) ^ 1);
      mbar_expect_tx(bars + 8 * (kQFull + qb), kQBuf);
      map_coords(a.pos[0], h, q0, b, c1, c2, c3);
#pragma unroll
      for (int c = 0; c < kDSub; ++c)
        tma_load(base + kOffQ + qb * kQBuf + c * kSubQ, tm_q, bars + 8 * (kQFull + qb), 64 * c,
                 c1, c2, c3);
    }
    const float* brow = a.bias + static_cast<long long>(b) * seq;
    for (int k0 = 0; k0 < seq; k0 += kChunk, ++n) {
      const int st = n & 1;
      mbar_wait(bars + 8 * (kKVEmpty + st), ((n >> 1) & 1) ^ 1);
#pragma unroll
      for (int i = lane; i < kChunk; i += 32) {
        const int key = k0 + i;
        bias_s[st * kChunk + i] = key < seq ? brow[key] * kLog2e : -CUDART_INF_F;
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) {
        const uint32_t kf = bars + 8 * (kKFull + st), vf = bars + 8 * (kVFull + st);
        mbar_expect_tx(kf, kKVStage);
        map_coords(a.pos[1], h, k0, b, c1, c2, c3);
#pragma unroll
        for (int c = 0; c < kDSub; ++c)
          tma_load(base + kOffK + st * kKVStage + c * kSubKV, tm_k, kf, 64 * c, c1, c2, c3);
        mbar_expect_tx(vf, kKVStage);
        map_coords(a.pos[2], h, k0, b, c1, c2, c3);
#pragma unroll
        for (int c = 0; c < kDSub; ++c)
          tma_load(base + kOffV + st * kKVStage + c * kSubKV, tm_v, vf, 64 * c, c1, c2, c3);
      }
      __syncwarp();
    }
  }
}

__device__ __forceinline__ void bf16_consumer(const CUtensorMap* tm_o, const Args& a,
                                              uint32_t base, uint8_t* gbase,
                                              const float* bias_s) {
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: rows 64 cw .. 64 cw + 63
  const int wtid = threadIdx.x & 127;
  const int warp = wtid >> 5, lane = wtid & 31;
  const int g = lane >> 2;  // accumulator rows g and g + 8 of the warp's 16
  const int t = lane & 3;   // accumulator column pair
  const uint32_t bars = base + kOffBar;
  const int seq = a.seq;
  int n = 0;
  for (int it = 0, tile = blockIdx.x; tile < a.tiles; ++it, tile += gridDim.x) {
    const int bh = tile / a.q_tiles;
    const int q0w = (tile - bh * a.q_tiles) * kQRows + 64 * cw;
    const int b = bh / a.heads, h = bh - b * a.heads;
    const unsigned key_head = b * a.total_heads + a.head_offset + h;
    const int qb = it & 1;
    const bool active = q0w < seq;  // uniform over the warpgroup
    const uint32_t qbase = base + kOffQ + qb * kQBuf + cw * (kSubQ / 2);
    const int row0 = q0w + warp * 16 + g;
    mbar_wait(bars + 8 * (kQFull + qb), (it >> 1) & 1);

    float o[96];
#pragma unroll
    for (int i = 0; i < 96; ++i) o[i] = 0.f;
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

    for (int k0 = 0; k0 < seq; k0 += kChunk, ++n) {
      const int st = n & 1;
      const uint32_t ph = (n >> 1) & 1;
      float s[32];
      float al0 = 1.f, al1 = 1.f;
      mbar_wait(bars + 8 * (kKFull + st), ph);
      if (active) {
        const uint32_t kbase = base + kOffK + st * kKVStage;
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        fence_operands(s);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kHeadDim / 16; ++ks)
          wgmma_qk(s, smem_desc(qbase + (ks >> 2) * kSubQ + (ks & 3) * 32, 1, 64),
                   smem_desc(kbase + (ks >> 2) * kSubKV + (ks & 3) * 32, 1, 64), ks > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(s);

        // logits (log2 domain) and the online softmax of rows g and g + 8
        const float* bs = bias_s + st * kChunk;
        float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 bv = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t);
          s[4 * j] = fmaf(s[4 * j], a.scale, bv.x);
          s[4 * j + 1] = fmaf(s[4 * j + 1], a.scale, bv.y);
          s[4 * j + 2] = fmaf(s[4 * j + 2], a.scale, bv.x);
          s[4 * j + 3] = fmaf(s[4 * j + 3], a.scale, bv.y);
          mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: a key < seq
        al0 = ex2(m0 - mn0);
        al1 = ex2(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        l0 *= al0;
        l1 *= al1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[4 * j] = ex2(s[4 * j] - mn0);
          s[4 * j + 1] = ex2(s[4 * j + 1] - mn0);
          s[4 * j + 2] = ex2(s[4 * j + 2] - mn1);
          s[4 * j + 3] = ex2(s[4 * j + 3] - mn1);
          l0 += s[4 * j] + s[4 * j + 1];
          l1 += s[4 * j + 2] + s[4 * j + 3];
        }

        if (a.dropout) {
          // Keys 8j + 2t + {0, 1} of rows g and g + 8 lie in key group
          // 2j + t/2 at words 2(t&1), 2(t&1)+1. The even thread of a pair
          // draws row g, the odd one row g + 8; each passes the pair the
          // other needs.
          const bool odd = t & 1;
          const int row = row0 + (odd ? 8 : 0);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint4 bits = philox4x32_10(make_uint4((k0 >> 2) + 2 * j + (t >> 1), row, 0u, 0u),
                                             make_uint2(a.seed, key_head));
            const unsigned send0 = odd ? bits.x : bits.z, send1 = odd ? bits.y : bits.w;
            const unsigned recv0 = __shfl_xor_sync(0xffffffffu, send0, 1);
            const unsigned recv1 = __shfl_xor_sync(0xffffffffu, send1, 1);
            const unsigned own0 = odd ? bits.z : bits.x, own1 = odd ? bits.w : bits.y;
            s[4 * j] = keep_or_drop(odd ? recv0 : own0, s[4 * j], a);
            s[4 * j + 1] = keep_or_drop(odd ? recv1 : own1, s[4 * j + 1], a);
            s[4 * j + 2] = keep_or_drop(odd ? own0 : recv0, s[4 * j + 2], a);
            s[4 * j + 3] = keep_or_drop(odd ? own1 : recv1, s[4 * j + 3], a);
          }
        }
      }
      mbar_wait(bars + 8 * (kVFull + st), ph);
      if (active) {
        // p as the bf16 A fragments of p v, 16 keys a k-step
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
#pragma unroll
        for (int i = 0; i < 24; ++i) {
          o[4 * i] *= al0;
          o[4 * i + 1] *= al0;
          o[4 * i + 2] *= al1;
          o[4 * i + 3] *= al1;
        }
        const uint32_t vbase = base + kOffV + st * kKVStage;
        fence_operands(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_pv(o, pa[kk], smem_desc(vbase + kk * 2048, 512, 64));
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (kKVEmpty + st));
    }

    if (active) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      // this warpgroup's Q rows are read: o / l goes there, swizzled as
      // TMA reads it (16-byte column group i of row r at i ^ (r % 8))
      named_barrier(1 + cw, 128);
      uint8_t* obuf = gbase + kOffQ + qb * kQBuf + cw * (kSubQ / 2);
      const int r0 = warp * 16 + g, r1 = r0 + 8;
#pragma unroll
      for (int i = 0; i < 24; ++i) {
        uint8_t* sub = obuf + (i >> 3) * kSubQ + 4 * t;
        *reinterpret_cast<__nv_bfloat162*>(sub + r0 * 128 + (((i & 7) ^ (r0 & 7)) << 4)) =
            __floats2bfloat162_rn(o[4 * i] * inv0, o[4 * i + 1] * inv0);
        *reinterpret_cast<__nv_bfloat162*>(sub + r1 * 128 + (((i & 7) ^ (r1 & 7)) << 4)) =
            __floats2bfloat162_rn(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_barrier(1 + cw, 128);
      if (wtid == 0) {
        int c1, c2, c3;
        map_coords(a.pos[3], h, q0w, b, c1, c2, c3);
#pragma unroll
        for (int c = 0; c < kDSub; ++c) tma_store(tm_o, smem_u32(obuf + c * kSubQ), 64 * c, c1, c2, c3);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    }
    if (wtid == 0) mbar_arrive(bars + 8 * (kQEmpty + qb));
  }
  if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kBf16Threads, 1)
    attention_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_o, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the 128-byte swizzle repeats every 1024
  uint8_t* gbase = smem_raw + (base - raw);
  float* bias_s = reinterpret_cast<float*>(gbase + kOffBias);
  if (threadIdx.x == 0) {
    const uint32_t bars = base + kOffBar;
    for (int i = 0; i < 2; ++i) {
      mbar_init(bars + 8 * (kQFull + i), 1);
      mbar_init(bars + 8 * (kQEmpty + i), 2);  // one arrival per consumer warpgroup
      mbar_init(bars + 8 * (kKFull + i), 1);
      mbar_init(bars + 8 * (kVFull + i), 1);
      mbar_init(bars + 8 * (kKVEmpty + i), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x < 32) bf16_producer(&tm_q, &tm_k, &tm_v, a, base, bias_s);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    bf16_consumer(&tm_o, a, base, gbase, bias_s);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// a bf16 map of g over ptr with boxes of 64 columns by `rows` rows
bool encode_map(CUtensorMap* map, const MapGeom& g, const void* ptr, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint32_t box[4] = {64, 1, 1, 1};
  box[g.pos_t] = static_cast<cuuint32_t>(rows);
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), g.dims, g.strides,
            box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int pos_code(const MapGeom& g) { return g.pos_h | g.pos_t << 2 | g.pos_b << 4; }

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

bool geom_ok(const MapGeom& g) {
  const int p[3] = {g.pos_h, g.pos_t, g.pos_b};
  int seen = 0;
  for (int i = 0; i < 3; ++i) {
    if (p[i] < 1 || p[i] > 3) return false;
    seen |= 1 << p[i];
  }
  return seen == 0xE && g.dims[0] == kHeadDim;
}

bool valid(const Params* p, int dev) {
  if (p == nullptr || dev < 0 || dev >= kMaxDevices) return false;
  if ((p->dtype != 0 && p->dtype != 1) || p->batch <= 0 || p->heads <= 0 || p->seq <= 0 ||
      p->head_dim != kHeadDim || !(p->inv_keep >= 1.f) || p->head_offset < 0 ||
      p->total_heads < p->head_offset + p->heads)
    return false;
  if (p->dtype == 1)
    for (int i = 0; i < 4; ++i)
      if (!geom_ok(p->maps[i])) return false;
  return true;
}

bool aligned(const void* q, const void* k, const void* v, const void* o) {
  return ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15) == 0;
}

Args make_args(const Params& p, const void* q, const void* k, const void* v, const float* bias,
               void* o, unsigned seed) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.o = o;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = p.strides[0][i];
    a.ks[i] = p.strides[1][i];
    a.vs[i] = p.strides[2][i];
    a.os[i] = p.strides[3][i];
  }
  a.heads = p.heads;
  a.seq = p.seq;
  a.scale = p.dtype == 1 ? p.scale * kLog2e : p.scale;
  a.dropout = p.dropout;
  a.seed = seed;
  a.head_offset = p.head_offset;
  a.total_heads = p.total_heads;
  a.threshold = p.threshold;
  a.inv_keep = p.inv_keep;
  a.q_tiles = (p.seq + kQRows - 1) / kQRows;
  a.tiles = p.batch * p.heads * a.q_tiles;
  for (int i = 0; i < 4; ++i) a.pos[i] = pos_code(p.maps[i]);
  return a;
}

// encodes the q, k, v, o maps of one call
cudaError_t encode_maps(const Params& p, const void* q, const void* k, const void* v, void* o,
                        CUtensorMap (&maps)[4]) {
  const void* ptrs[4] = {q, k, v, o};
  const int rows[4] = {kQRows, kChunk, kChunk, 64};
  for (int i = 0; i < 4; ++i)
    if (!encode_map(&maps[i], p.maps[i], ptrs[i], rows[i])) return cudaErrorInvalidValue;
  return cudaSuccess;
}

cudaError_t launch_bf16(const Params& p, const Args& a, const void* q, const void* k,
                        const void* v, void* o, int dev, cudaStream_t s) {
  static int sms[kMaxDevices] = {};
  if (sms[dev] == 0) {
    cudaError_t err = cudaFuncSetAttribute(attention_fwd_bf16_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kBf16Smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  CUtensorMap maps[4];
  const cudaError_t err = encode_maps(p, q, k, v, o, maps);
  if (err != cudaSuccess) return err;
  const int grid = a.tiles < sms[dev] ? a.tiles : sms[dev];
  attention_fwd_bf16_kernel<<<grid, kBf16Threads, kBf16Smem, s>>>(maps[0], maps[1], maps[2],
                                                                  maps[3], a);
  return cudaGetLastError();
}

cudaError_t launch_f32(const Params& p, const Args& a, int dev, cudaStream_t s) {
  static bool ready[kMaxDevices] = {};
  if (!ready[dev]) {
    cudaError_t err = cudaFuncSetAttribute(attention_fwd_f32_kernel<kHeadDim>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attention_fwd_f32_kernel<kHeadDim>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const dim3 grid(p.batch * p.heads, (p.seq + kF32Q - 1) / kF32Q);
  attention_fwd_f32_kernel<kHeadDim><<<grid, kF32Threads, kF32Smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [batch, heads, seq, 192] in p->dtype with the strides of
// p->strides (and, bf16, the maps of p->maps), every row 16-byte aligned;
// bias: [batch, seq] fp32 contiguous. seed keys the Philox draws of the
// dropout form. Launches on `stream` on device `dev`. Returns the launch's
// cudaError_t, cudaErrorInvalidValue for a plan the kernels do not take
// (or a tensor map cuTensorMapEncodeTiled refuses), cudaErrorMisalignedAddress for a
// pointer that is not 16-byte aligned.
extern "C" int layoutdetr_attention_forward(const Params* p, const void* q, const void* k,
                                            const void* v, const float* bias, void* o,
                                            unsigned seed, int dev, void* stream) {
  if (!valid(p, dev)) return (int)cudaErrorInvalidValue;
  if (!aligned(q, k, v, o)) return (int)cudaErrorMisalignedAddress;
  DeviceGuard guard(dev);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a = make_args(*p, q, k, v, bias, o, seed);
  return (int)(p->dtype == 0 ? launch_f32(*p, a, dev, s) : launch_bf16(*p, a, q, k, v, o, dev, s));
}

// Encodes the four tensor maps of a bf16 call `reps` times and launches
// nothing: the host cost of the per-call encoding, for measurement.
extern "C" int layoutdetr_attention_encode_maps(const Params* p, const void* q, const void* k,
                                                const void* v, void* o, int reps) {
  if (!valid(p, 0) || p->dtype != 1) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  for (int r = 0; r < reps; ++r) {
    const cudaError_t err = encode_maps(*p, q, k, v, o, maps);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// sizeof(Params): the wrapper checks its ctypes Structure against it.
extern "C" int layoutdetr_attention_params_size() { return (int)sizeof(Params); }
