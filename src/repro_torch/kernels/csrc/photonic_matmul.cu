// Photonic weight-bank product on Hopper: C = A·Bᵀ (+ bank read noise),
// and with a mask epilogue the fused DFA gradient δ = (A·Bᵀ + η) ⊙ mask.
//
// Replaces two TPU kernels, one template flag apart:
//   kMask = false: src/repro/kernels/photonic_matmul.py
//                  (photonic_matmul_pallas, body _kernel, noise _gaussian_tile);
//   kMask = true : src/repro/kernels/dfa_gradient.py
//                  (dfa_gradient_pallas, body _kernel): the paper's TIA-gain
//                  stage (Fig. 4b) multiplies the noisy product by g'(a)
//                  before it leaves the kernel, so δ never round-trips device
//                  memory between the product and the mask.
//
// A (T, K) holds the amplitude-encoded inputs and B (M, K) the inscribed
// weight panel, both normalised to [-1, 1] by the wrapper, both row-major
// and contiguous, in f32 or bf16.  C (T, M) is f32, and so is the mask
// (T, M).  Products accumulate in f32.  Noise modes, as on the TPU:
//   0 none  : the exact product;
//   1 input : a (T, M) f32 total-noise operand added in the epilogue;
//   2 prng  : sigma_step * N(0, 1) for every BK-wide K tile kt, drawn from a
//             counter-based threefry2x32 keyed by (seed, kt) with counter
//             (row, col), so the sum over the nk tiles has std
//             sigma_step * sqrt(nk).  Every variant draws the same numbers
//             in its epilogue; the plain version
//             (photonic_matmul.py::photonic_matmul_plain) draws them too.
// The mask multiplies after the noise, as the TPU kernel applies it at its
// last K step.  No atomics anywhere: the same seed gives the same bits.
//
// Batch axis: A (E, T, K) and B (E, M, K) give C (E, T, M) in one launch,
// the counterpart of the reference's jax.vmap over stacked experts (its
// pallas_call batching rule adds a grid axis).  Index e reads A[e] and B[e]
// and writes C[e] (and the mask's [e]); the noise is one (T, M) operand
// read at every index (batch stride 0) and prng mode draws with the same
// seed at every index, as the reference's unbatched key does.  Each variant
// takes e from one grid axis, so index e of a batched launch computes what
// a 2-D launch of A[e], B[e] computes under the same plan, bit for bit.
//
// Three variants; the wrapper's planner (photonic_matmul.py::_plan) picks
// one per call from (T, M, K, dtype, operand addresses) and passes it in.
//
// 1. skinny (T <= the planner's seam; decode runs T = 4).  Work is
//    2·T·M·K operations on M·K elements of B: a GEMV, bound by reading B
//    (the 311 MB bf16 qwen head takes >= 93 us at 3.35 TB/s).  One warp per
//    B row, its lanes striding K in 16-byte loads with 4 or 12 of them in
//    flight per lane, so B streams through once at full width; A (at most
//    16 × K) is staged once per block in shared memory in its own dtype and
//    read back as 16-byte vectors; T f32 accumulators per lane, a shuffle
//    reduction, then the epilogue on lane t.  The grid is the card's
//    resident capacity (or one warp per row, if less) walking the rows, so
//    every SM pulls B and A is staged once per block, not once per row.
//    Operands that are not 16-byte aligned (K·itemsize % 16 != 0, or a view
//    at an odd offset) take the same loop with coalesced scalar loads.
// 2. mma (bf16, T above the seam: prefill T = 64, the head at T = 64).
//    Still bytes-bound (64 operations per byte of B at T = 64, below the
//    ~295 where the tensor cores would bind), but 2·T·M·K on the CUDA cores
//    alone would take 3x the bytes bound at the head.  Tensor cores through
//    mma.sync m16n8k16 (bf16 in, f32 accumulate; products of bf16 are exact
//    in f32, so only the order of the sums differs from the plain version),
//    a 64 × 64 output tile per block of 4 warps, operands staged 64 K wide
//    (128-byte row segments of B) by a MT_STAGES-deep cp.async ring into
//    padded shared memory (144-byte rows: ldmatrix conflict-free).  Narrow
//    layers give too few tiles to fill 132 SMs (M = 1024 at T = 64 is 16
//    tiles), so the planner splits K over a thread-block cluster of up to 8
//    blocks; the partial tiles meet in distributed shared memory and each
//    block of the cluster sums one slice of rows in rank order: one launch,
//    deterministic.  Unaligned operands (K = 257, K = 10, odd views) fill
//    the same ring with scalar loads.
// 3. ffma (f32, T above the seam: training at (64, 10, 800), the f32
//    parity runs).  CUDA-core FFMA, no TF32 (it would break the 2e-5 f32
//    bound).  32 × 32 output tiles so that (64, 800) launches 50 blocks,
//    and each K tile loops only over its valid columns, so K = 10 is one
//    pass of 10 steps.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "threefry.cuh"

namespace cg = cooperative_groups;

namespace {

using repro_torch::threefry2x32;

constexpr int BK = 32;  // the prng K tile (photonic_matmul.py::BLOCK_K)
constexpr int kSmemMax = 232448;  // an sm_90 block's opt-in shared memory

enum NoiseMode { kNone = 0, kInput = 1, kPrng = 2 };
// photonic_matmul.py::VARIANTS, in order
enum Variant { kSkinny = 0, kSkinnyScalar = 1, kMma = 2, kMmaScalar = 3, kFfma = 4 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Box-Muller from 24 high bits of each word, as the TPU kernel's
// _gaussian_tile: u1 = 0 gives z = 0.
__device__ __forceinline__ float counter_gaussian(uint32_t seed, uint32_t ktile,
                                                  uint32_t row, uint32_t col) {
  uint32_t x0 = row, x1 = col;
  threefry2x32(seed, ktile, x0, x1);
  const float u1 = static_cast<float>(x0 >> 8) * (1.0f / 16777216.0f);
  const float u2 = static_cast<float>(x1 >> 8) * (1.0f / 16777216.0f);
  return sqrtf(-2.0f * log1pf(-u1)) * cosf(6.283185307179586f * u2);
}

// The sum of one output's nk draws, tile by tile (the tiled epilogues).
__device__ __forceinline__ float prng_sum(uint32_t seed, int nk, int row, int col) {
  float s = 0.0f;
  for (int kt = 0; kt < nk; ++kt) s += counter_gaussian(seed, kt, row, col);
  return s;
}

// The epilogue every variant shares: the noise, then the mask.
template <bool kMask>
__device__ __forceinline__ float epilogue(float v, float noise_v, float draws, float mask_v,
                                          int mode, float sigma_step) {
  if (mode == kInput) v += noise_v;
  if (mode == kPrng) v += sigma_step * draws;
  if constexpr (kMask) v *= mask_v;
  return v;
}

template <bool kMask>
__device__ __forceinline__ void store_out(float v, float draws, size_t o, int mode,
                                          const float* __restrict__ noise,
                                          const float* __restrict__ mask,
                                          float* __restrict__ c, float sigma_step) {
  c[o] = epilogue<kMask>(v, mode == kInput ? noise[o] : 0.0f, draws, kMask ? mask[o] : 1.0f,
                         mode, sigma_step);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16 bytes -> 4 f32 or 8 bf16 widened to f32 (bf16 2i in the low half).
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

// ---------------------------------------------------------------------------
// 1. skinny: one warp per B row
// ---------------------------------------------------------------------------

constexpr int SK_WARPS = 8;
constexpr int SK_THREADS = SK_WARPS * 32;
// loads in flight per lane (U): 4 covers a 2 KB row (K = 1024 bf16) with
// the fewest registers, 12 a 6 KB row (K = 2816 bf16) in one round trip;
// the scalar-load twin keeps 8
constexpr int SK_SHORT = 4;
constexpr int SK_LONG = 12;
constexpr int SK_SCALAR = 8;

// TT: T rounded up to a power of two (accumulators per lane); A rows
// n_t..TT-1 are staged as zeros.  Loads are issued ahead of their use: a
// warp's first batch of B (and its row's noise and mask) before A is
// staged, and the next row's first batch before this row's reduction and
// epilogue, so no DRAM round trip waits on another.
template <typename T, int TT, int U, bool kMask, bool kVec>
__global__ void __launch_bounds__(SK_THREADS)
skinny_kernel(const T* __restrict__ a, const T* __restrict__ b,
              const float* __restrict__ mask, const float* __restrict__ noise,
              float* __restrict__ c, int n_t, int n_m, int n_k, int mode, uint32_t seed,
              float sigma_step) {
  extern __shared__ uint4 smem[];  // A: [TT][n_k] in T
  {  // this block's batch index
    const size_t e = blockIdx.y;
    a += e * n_t * n_k;
    b += e * n_m * n_k;
    c += e * n_t * n_m;
    if constexpr (kMask) mask += e * n_t * n_m;
  }
  constexpr int E = kVec ? 16 / sizeof(T) : 1;  // elements per load
  using Load = typename std::conditional<kVec, uint4, T>::type;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int stride = gridDim.x * SK_WARPS;
  const int n_ld = n_k / E;  // loads per row of A or B
  const Load* a_ld = reinterpret_cast<const Load*>(a);
  const Load* b_ld = reinterpret_cast<const Load*>(b);
  Load* a_s = reinterpret_cast<Load*>(smem);

  Load v[U];
  float noise_v = 0.0f, mask_v = 1.0f;
  auto issue = [&](int row, int c0) {  // one batch of B's row, lanes striding K
    const Load* brow = b_ld + static_cast<size_t>(row) * n_ld;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ch = c0 + 32 * u;
      if (ch < n_ld) v[u] = __ldg(brow + ch);
    }
  };
  auto issue_epilogue = [&](int row) {  // lane t: output (t, row)'s noise and mask
    if (lane < n_t) {
      const size_t o = static_cast<size_t>(lane) * n_m + row;
      if (mode == kInput) noise_v = __ldg(noise + o);
      if constexpr (kMask) mask_v = __ldg(mask + o);
    }
  };

  int row = blockIdx.x * SK_WARPS + warp;
  bool issued = row < n_m;
  if (issued) {
    issue(row, lane);
    issue_epilogue(row);
  }
  // stage A: every load of a batch in flight before the first store
  for (int i0 = tid; i0 < TT * n_ld; i0 += 4 * SK_THREADS) {
    Load r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j * SK_THREADS;
      if (i < n_t * n_ld) r[j] = __ldg(a_ld + i);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j * SK_THREADS;
      if (i < TT * n_ld) a_s[i] = i < n_t * n_ld ? r[j] : Load{};
    }
  }
  __syncthreads();

  const int nk_tiles = (n_k + BK - 1) / BK;
  for (; row < n_m; row += stride) {
    float acc[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[t] = 0.0f;
    for (int c0 = lane; c0 < n_ld; c0 += 32 * U) {
      if (!issued) issue(row, c0);
      issued = false;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int ch = c0 + 32 * u;
        if (ch < n_ld) {
          if constexpr (kVec) {
            float bf[E];
            unpack(v[u], bf);
#pragma unroll
            for (int t = 0; t < TT; ++t) {
              float af[E];
              unpack(a_s[t * n_ld + ch], af);
#pragma unroll
              for (int e = 0; e < E; ++e) acc[t] = fmaf(af[e], bf[e], acc[t]);
            }
          } else {
            const float bv = to_f32(v[u]);
#pragma unroll
            for (int t = 0; t < TT; ++t) acc[t] = fmaf(to_f32(a_s[t * n_ld + ch]), bv, acc[t]);
          }
        }
      }
    }
    const float row_noise = noise_v;
    const float row_mask = mask_v;
    if (row + stride < n_m) {
      issue(row + stride, lane);
      issue_epilogue(row + stride);
      issued = true;
    }

    // lane t ends with output (t, row)
    float mine = 0.0f;
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const float s = warp_sum(acc[t]);
      if (lane == t) mine = s;
    }
    float draws = 0.0f;
    if (mode == kPrng) {
      // the lanes split each output's nk draws, then a shuffle sums them
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        if (t >= n_t) break;
        float p = 0.0f;
        for (int kt = lane; kt < nk_tiles; kt += 32) p += counter_gaussian(seed, kt, t, row);
        p = warp_sum(p);
        if (lane == t) draws = p;
      }
    }
    if (lane < n_t)
      c[static_cast<size_t>(lane) * n_m + row] =
          epilogue<kMask>(mine, row_noise, draws, row_mask, mode, sigma_step);
  }
}

template <typename T, int TT, int U, bool kMask, bool kVec>
cudaError_t launch_skinny_tt(const T* a, const T* b, const float* mask, const float* noise,
                             float* c, int n_e, int n_t, int n_m, int n_k, int mode,
                             uint32_t seed, float sigma_step, cudaStream_t s) {
  const auto kernel = skinny_kernel<T, TT, U, kMask, kVec>;
  const int smem = TT * n_k * static_cast<int>(sizeof(T));
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  // once per instantiation: the opt-in above 48 KB, and the occupancy of
  // the last shared-memory size (benign if two threads race)
  static bool opted_in = false;
  static int occ_smem = -1, occ_blocks = 1;
  if (!opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  if (smem != occ_smem) {
    int blocks = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, SK_THREADS, smem);
    if (err != cudaSuccess) return err;
    occ_blocks = blocks > 0 ? blocks : 1;
    occ_smem = smem;
  }
  // the card's resident blocks shared over the batch: each index walks its
  // rows with ⌈resident / E⌉ blocks (or one warp per row, if fewer)
  if (n_e > 65535) return cudaErrorInvalidValue;
  const int rows_grid = (n_m + SK_WARPS - 1) / SK_WARPS;
  const int resident = (num_sms() * occ_blocks + n_e - 1) / n_e;
  const int grid_x = rows_grid < resident ? rows_grid : resident;
  kernel<<<dim3(grid_x, n_e), SK_THREADS, smem, s>>>(a, b, mask, noise, c, n_t, n_m, n_k,
                                                     mode, seed, sigma_step);
  return cudaGetLastError();
}

template <typename T, int U, bool kMask, bool kVec>
cudaError_t launch_skinny_u(const T* a, const T* b, const float* mask, const float* noise,
                            float* c, int n_e, int n_t, int n_m, int n_k, int mode,
                            uint32_t seed, float sigma_step, cudaStream_t s) {
  if (n_t <= 2)
    return launch_skinny_tt<T, 2, U, kMask, kVec>(a, b, mask, noise, c, n_e, n_t, n_m, n_k,
                                                    mode, seed, sigma_step, s);
  if (n_t <= 4)
    return launch_skinny_tt<T, 4, U, kMask, kVec>(a, b, mask, noise, c, n_e, n_t, n_m, n_k,
                                                    mode, seed, sigma_step, s);
  if (n_t <= 8)
    return launch_skinny_tt<T, 8, U, kMask, kVec>(a, b, mask, noise, c, n_e, n_t, n_m, n_k,
                                                    mode, seed, sigma_step, s);
  if (n_t <= 16)
    return launch_skinny_tt<T, 16, U, kMask, kVec>(a, b, mask, noise, c, n_e, n_t, n_m, n_k,
                                                     mode, seed, sigma_step, s);
  return cudaErrorInvalidValue;
}

template <typename T, bool kMask, bool kVec>
cudaError_t launch_skinny(const T* a, const T* b, const float* mask, const float* noise,
                          float* c, int n_e, int n_t, int n_m, int n_k, int mode, uint32_t seed,
                          float sigma_step, cudaStream_t s) {
  if constexpr (!kVec) {
    return launch_skinny_u<T, SK_SCALAR, kMask, false>(a, b, mask, noise, c, n_e, n_t, n_m,
                                                       n_k, mode, seed, sigma_step, s);
  } else {
    const int loads_per_lane = (n_k * static_cast<int>(sizeof(T)) / 16 + 31) / 32;
    if (loads_per_lane <= SK_SHORT)
      return launch_skinny_u<T, SK_SHORT, kMask, true>(a, b, mask, noise, c, n_e, n_t, n_m,
                                                       n_k, mode, seed, sigma_step, s);
    return launch_skinny_u<T, SK_LONG, kMask, true>(a, b, mask, noise, c, n_e, n_t, n_m, n_k,
                                                    mode, seed, sigma_step, s);
  }
}

// ---------------------------------------------------------------------------
// 2. mma: bf16 tensor-core tiles, K split over a cluster
// ---------------------------------------------------------------------------

constexpr int MT_BT = 64;  // output rows (A rows) per block
constexpr int MT_BM = 64;  // output cols (B rows) per block
constexpr int MT_BK = 64;  // K per stage: 128-byte row segments of B
constexpr int MT_THREADS = 128;  // 4 warps, each 16 rows x 64 cols
constexpr int MT_STAGES = 3;
constexpr int MT_LD = MT_BK + 8;  // padded smem row, bf16 elements (144 bytes)
constexpr int MT_PLD = MT_BM + 4;  // partial-tile row, floats
constexpr int MT_SMEM = 2 * MT_STAGES * MT_BT * MT_LD * 2;  // A and B rings, bytes
static_assert(MT_BT == MT_BM, "A and B tiles share one layout");
static_assert(MT_STAGES * MT_BT * MT_LD * 2 >= MT_BT * MT_PLD * 4, "partial tile reuses A's ring");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled past src_bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Rank `rank` of an S-block cluster sums its MT_BT/S rows of the partial
// tiles over the ranks in rank order (every distributed-shared-memory
// load in flight first, 16 bytes each) and writes them through the
// epilogue.
template <int S, bool kMask>
__device__ __forceinline__ void reduce_cluster(float* part, int rank, int row0, int col0,
                                               int n_t, int n_m, int nk_tiles, int mode,
                                               uint32_t seed, const float* __restrict__ noise,
                                               const float* __restrict__ mask,
                                               float* __restrict__ c, float sigma_step) {
  constexpr int ROWS = MT_BT / S;
  constexpr int VPR = MT_BM / 4;  // float4 per tile row
  constexpr int ITEMS = ROWS * VPR / MT_THREADS;
  static_assert(ITEMS * MT_THREADS == ROWS * VPR, "the slice splits evenly over the block");
  cg::cluster_group cluster = cg::this_cluster();
  float4 v[ITEMS][S];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int idx = threadIdx.x + it * MT_THREADS;
    const int off = (rank * ROWS + idx / VPR) * MT_PLD + (idx % VPR) * 4;
#pragma unroll
    for (int q = 0; q < S; ++q)
      v[it][q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) + off);
  }
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int idx = threadIdx.x + it * MT_THREADS;
    const int r = row0 + rank * ROWS + idx / VPR;
    float sum[4] = {v[it][0].x, v[it][0].y, v[it][0].z, v[it][0].w};
#pragma unroll
    for (int q = 1; q < S; ++q) {
      sum[0] += v[it][q].x;
      sum[1] += v[it][q].y;
      sum[2] += v[it][q].z;
      sum[3] += v[it][q].w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = col0 + (idx % VPR) * 4 + e;
      if (r < n_t && col < n_m) {
        const float draws = mode == kPrng ? prng_sum(seed, nk_tiles, r, col) : 0.0f;
        store_out<kMask>(sum[e], draws, static_cast<size_t>(r) * n_m + col, mode, noise, mask, c,
                         sigma_step);
      }
    }
  }
}

// grid (split, ⌈T/64⌉, E·⌈M/64⌉), cluster (split, 1, 1): cluster rank r
// multiplies the MT_BK-wide K tiles [r·n/split, (r+1)·n/split); z holds
// the batch index e and the column tile, e major.
template <bool kMask, bool kVec>
__global__ void __launch_bounds__(MT_THREADS)
mma_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
           const float* __restrict__ mask, const float* __restrict__ noise,
           float* __restrict__ c, int n_t, int n_m, int n_k, int mode, uint32_t seed,
           float sigma_step) {
  using Tile = __nv_bfloat16[MT_BT][MT_LD];
  extern __shared__ __align__(128) unsigned char mt_smem[];
  Tile* sa = reinterpret_cast<Tile*>(mt_smem);  // [MT_STAGES] A tiles, then B's
  Tile* sb = sa + MT_STAGES;

  const int split = gridDim.x;
  const int rank = blockIdx.x;
  const int row0 = blockIdx.y * MT_BT;
  const int m_tiles = (n_m + MT_BM - 1) / MT_BM;
  const int col0 = (blockIdx.z % m_tiles) * MT_BM;
  {  // this block's batch index
    const size_t e = blockIdx.z / m_tiles;
    a += e * n_t * n_k;
    b += e * n_m * n_k;
    c += e * n_t * n_m;
    if constexpr (kMask) mask += e * n_t * n_m;
  }
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nk_tiles = (n_k + BK - 1) / BK;  // prng tiles
  const int n_tiles = (n_k + MT_BK - 1) / MT_BK;
  const int kt_begin = static_cast<int>(static_cast<long long>(rank) * n_tiles / split);
  const int kt_end = static_cast<int>(static_cast<long long>(rank + 1) * n_tiles / split);
  const int n_iter = kt_end - kt_begin;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * MT_BK;
    if constexpr (kVec) {
      // 64 rows x 8 chunks of 8 for each operand; K % 8 == 0, so a chunk
      // is wholly inside or wholly past the edge
      constexpr int CH = MT_BK / 8;
#pragma unroll
      for (int i = tid; i < MT_BT * CH; i += MT_THREADS) {
        const int r = i / CH;
        const int kk = (i % CH) * 8;
        const int k = k0 + kk;
        const int ra = row0 + r;
        const bool in_a = ra < n_t && k < n_k;
        cp_async16(smem_addr(&sa[stage][r][kk]),
                   in_a ? a + static_cast<size_t>(ra) * n_k + k : a, in_a ? 16 : 0);
        const int rb = col0 + r;
        const bool in_b = rb < n_m && k < n_k;
        cp_async16(smem_addr(&sb[stage][r][kk]),
                   in_b ? b + static_cast<size_t>(rb) * n_k + k : b, in_b ? 16 : 0);
      }
    } else {
      // element by element, 8 loads of each operand in flight per thread
      constexpr int PER = MT_BT * MT_BK / MT_THREADS;
      constexpr int BATCH = 8;
#pragma unroll
      for (int j0 = 0; j0 < PER; j0 += BATCH) {
        __nv_bfloat16 va[BATCH], vb[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          const int i = tid + (j0 + j) * MT_THREADS;
          const int r = i / MT_BK;
          const int k = k0 + i % MT_BK;
          va[j] = row0 + r < n_t && k < n_k ? a[static_cast<size_t>(row0 + r) * n_k + k]
                                            : __float2bfloat16(0.0f);
          vb[j] = col0 + r < n_m && k < n_k ? b[static_cast<size_t>(col0 + r) * n_k + k]
                                            : __float2bfloat16(0.0f);
        }
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          const int i = tid + (j0 + j) * MT_THREADS;
          sa[stage][i / MT_BK][i % MT_BK] = va[j];
          sb[stage][i / MT_BK][i % MT_BK] = vb[j];
        }
      }
    }
  };

  // the noise and mask rows this block will write, into L2 while K runs
  if (mode == kInput || kMask) {
    const int rows = MT_BT / split;
    for (int i = tid; i < rows * 2; i += MT_THREADS) {
      const int r = row0 + (split == 1 ? 0 : rank * rows) + i / 2;
      const int col = col0 + (i % 2) * 32;
      if (r < n_t && col < n_m) {
        const size_t o = static_cast<size_t>(r) * n_m + col;
        if (mode == kInput) prefetch_l2(noise + o);
        if constexpr (kMask) prefetch_l2(mask + o);
      }
    }
  }

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const bool active = row0 + warp * 16 < n_t;  // this warp's 16 rows hold data

#pragma unroll
  for (int st = 0; st < MT_STAGES - 1; ++st) {
    if (st < n_iter) load_stage(st, kt_begin + st);
    cp_async_commit();
  }
  for (int i = 0; i < n_iter; ++i) {
    cp_async_wait<MT_STAGES - 2>();
    __syncthreads();  // stage i landed; stage i-1 is free for the refill
    const int next = i + MT_STAGES - 1;
    if (next < n_iter) load_stage(next % MT_STAGES, kt_begin + next);
    cp_async_commit();
    const int st = i % MT_STAGES;
    if (active) {
#pragma unroll
      for (int ks = 0; ks < MT_BK / 16; ++ks) {
        uint32_t af[4];
        ldmatrix_x4(af, smem_addr(&sa[st][warp * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bfr[4];
          const int n = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(bfr, smem_addr(&sb[st][n][ks * 16 + ((lane >> 3) & 1) * 8]));
          mma_bf16(acc[2 * np], af, bfr[0], bfr[1]);
          mma_bf16(acc[2 * np + 1], af, bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // fragment (j, e): row warp·16 + lane/4 + 8·(e/2), col 8j + 2·(lane%4) + e%2
  const int g = lane >> 2;
  const int q2 = (lane & 3) * 2;
  if (split == 1) {
    if (!active) return;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + warp * 16 + g + 8 * (e >> 1);
        const int col = col0 + j * 8 + q2 + (e & 1);
        if (r < n_t && col < n_m) {
          const float draws = mode == kPrng ? prng_sum(seed, nk_tiles, r, col) : 0.0f;
          store_out<kMask>(acc[j][e], draws, static_cast<size_t>(r) * n_m + col, mode, noise,
                           mask, c, sigma_step);
        }
      }
    return;
  }

  // split K: each block's partial tile into its own shared memory, then
  // block r of the cluster sums rows [r·64/split, (r+1)·64/split) over the
  // ranks in order and writes them
  float* part = reinterpret_cast<float*>(&sa[0][0][0]);
  if (active) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(warp * 16 + g + 8 * (e >> 1)) * MT_PLD + j * 8 + q2 + (e & 1)] = acc[j][e];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (split == 2)
    reduce_cluster<2, kMask>(part, rank, row0, col0, n_t, n_m, nk_tiles, mode, seed, noise, mask,
                             c, sigma_step);
  else if (split == 4)
    reduce_cluster<4, kMask>(part, rank, row0, col0, n_t, n_m, nk_tiles, mode, seed, noise, mask,
                             c, sigma_step);
  else
    reduce_cluster<8, kMask>(part, rank, row0, col0, n_t, n_m, nk_tiles, mode, seed, noise, mask,
                             c, sigma_step);
  cluster.sync();  // no block leaves while another reads its tile
}

template <bool kMask, bool kVec>
cudaError_t launch_mma(const __nv_bfloat16* a, const __nv_bfloat16* b, const float* mask,
                       const float* noise, float* c, int n_e, int n_t, int n_m, int n_k,
                       int mode, uint32_t seed, float sigma_step, int split, cudaStream_t s) {
  if (split != 1 && split != 2 && split != 4 && split != 8) return cudaErrorInvalidValue;
  const long long z = static_cast<long long>(n_e) * ((n_m + MT_BM - 1) / MT_BM);
  if (z > 65535) return cudaErrorInvalidValue;  // grid z's limit
  const auto kernel = mma_kernel<kMask, kVec>;
  static bool opted_in = false;  // once per instantiation: above 48 KB
  if (!opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MT_SMEM);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (n_t + MT_BT - 1) / MT_BT, static_cast<unsigned>(z));
  cfg.blockDim = dim3(MT_THREADS);
  cfg.dynamicSmemBytes = MT_SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, b, mask, noise, c, n_t, n_m, n_k,
                                             mode, seed, sigma_step);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 3. ffma: f32 tiles on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int FF_BT = 32;
constexpr int FF_BM = 32;
constexpr int FF_THREADS = 256;  // 16 x 16 threads, 2 x 2 outputs each

template <bool kMask>
__global__ void __launch_bounds__(FF_THREADS)
ffma_kernel(const float* __restrict__ a, const float* __restrict__ b,
            const float* __restrict__ mask, const float* __restrict__ noise,
            float* __restrict__ c, int n_t, int n_m, int n_k, int mode, uint32_t seed,
            float sigma_step) {
  // [row][k], one word of padding: a column of b_tile is conflict-free
  __shared__ float a_tile[FF_BT][BK + 1];
  __shared__ float b_tile[FF_BM][BK + 1];
  {  // this block's batch index
    const size_t e = blockIdx.z;
    a += e * n_t * n_k;
    b += e * n_m * n_k;
    c += e * n_t * n_m;
    if constexpr (kMask) mask += e * n_t * n_m;
  }
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * FF_BT;
  const int col0 = blockIdx.x * FF_BM;

  // this thread's outputs' noise and mask, in flight with the first tiles
  float noise_v[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  float mask_v[2][2] = {{1.0f, 1.0f}, {1.0f, 1.0f}};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = row0 + ty + 16 * i;
      const int col = col0 + tx + 16 * j;
      if (r < n_t && col < n_m) {
        const size_t o = static_cast<size_t>(r) * n_m + col;
        if (mode == kInput) noise_v[i][j] = __ldg(noise + o);
        if constexpr (kMask) mask_v[i][j] = __ldg(mask + o);
      }
    }

  constexpr int PER = FF_BT * BK / FF_THREADS;  // elements per thread and operand
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  for (int k0 = 0; k0 < n_k; k0 += BK) {
    const int width = n_k - k0 < BK ? n_k - k0 : BK;  // only the valid columns
    float ra[PER], rb[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {  // every load in flight before the first store
      const int e = tid + j * FF_THREADS;
      const int r = e / width;
      const int kk = e % width;
      if (e < FF_BT * width) {
        ra[j] = row0 + r < n_t ? __ldg(a + static_cast<size_t>(row0 + r) * n_k + k0 + kk) : 0.0f;
        rb[j] = col0 + r < n_m ? __ldg(b + static_cast<size_t>(col0 + r) * n_k + k0 + kk) : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = tid + j * FF_THREADS;
      if (e < FF_BT * width) {
        a_tile[e / width][e % width] = ra[j];
        b_tile[e / width][e % width] = rb[j];
      }
    }
    __syncthreads();
    for (int kk = 0; kk < width; ++kk) {
      const float a0 = a_tile[ty][kk];
      const float a1 = a_tile[ty + 16][kk];
      const float b0 = b_tile[tx][kk];
      const float b1 = b_tile[tx + 16][kk];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }

  const int nk_tiles = (n_k + BK - 1) / BK;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n_t) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col >= n_m) continue;
      const float draws = mode == kPrng ? prng_sum(seed, nk_tiles, r, col) : 0.0f;
      c[static_cast<size_t>(r) * n_m + col] =
          epilogue<kMask>(acc[i][j], noise_v[i][j], draws, mask_v[i][j], mode, sigma_step);
    }
  }
}

template <bool kMask>
cudaError_t launch_ffma(const float* a, const float* b, const float* mask, const float* noise,
                        float* c, int n_e, int n_t, int n_m, int n_k, int mode, uint32_t seed,
                        float sigma_step, cudaStream_t s) {
  if (n_e > 65535) return cudaErrorInvalidValue;  // grid z's limit
  const dim3 grid((n_m + FF_BM - 1) / FF_BM, (n_t + FF_BT - 1) / FF_BT, n_e);
  ffma_kernel<kMask><<<grid, FF_THREADS, 0, s>>>(a, b, mask, noise, c, n_t, n_m, n_k, mode,
                                                 seed, sigma_step);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------

template <bool kMask>
int launch(const void* a, const void* b, const float* mask, const float* noise, float* c,
           int n_e, int n_t, int n_m, int n_k, int dtype, int mode, unsigned int seed,
           float sigma_step, void* stream, int variant, int split) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* af = static_cast<const float*>(a);
  const auto* bf = static_cast<const float*>(b);
  const auto* ah = static_cast<const __nv_bfloat16*>(a);
  const auto* bh = static_cast<const __nv_bfloat16*>(b);
  cudaError_t err = cudaErrorInvalidValue;
  if ((dtype != 0 && dtype != 1) || n_e < 1) return static_cast<int>(err);
  switch (variant) {
    case kSkinny:
      err = dtype == 0 ? launch_skinny<float, kMask, true>(af, bf, mask, noise, c, n_e, n_t, n_m,
                                                           n_k, mode, seed, sigma_step, s)
                       : launch_skinny<__nv_bfloat16, kMask, true>(
                             ah, bh, mask, noise, c, n_e, n_t, n_m, n_k, mode, seed, sigma_step,
                             s);
      break;
    case kSkinnyScalar:
      err = dtype == 0 ? launch_skinny<float, kMask, false>(af, bf, mask, noise, c, n_e, n_t,
                                                            n_m, n_k, mode, seed, sigma_step, s)
                       : launch_skinny<__nv_bfloat16, kMask, false>(
                             ah, bh, mask, noise, c, n_e, n_t, n_m, n_k, mode, seed, sigma_step,
                             s);
      break;
    case kMma:
      if (dtype == 1)
        err = launch_mma<kMask, true>(ah, bh, mask, noise, c, n_e, n_t, n_m, n_k, mode, seed,
                                      sigma_step, split, s);
      break;
    case kMmaScalar:
      if (dtype == 1)
        err = launch_mma<kMask, false>(ah, bh, mask, noise, c, n_e, n_t, n_m, n_k, mode, seed,
                                       sigma_step, split, s);
      break;
    case kFfma:
      if (dtype == 0)
        err = launch_ffma<kMask>(af, bf, mask, noise, c, n_e, n_t, n_m, n_k, mode, seed,
                                 sigma_step, s);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}

}  // namespace

// A file that includes this one for its device functions alone (the draw
// probes of chip_smoke.py) defines REPRO_DEVICE_FUNCTIONS_ONLY: the entry
// points below are left out, so no kernel template is instantiated.
#ifndef REPRO_DEVICE_FUNCTIONS_ONLY

extern "C" int photonic_matmul_block_k() { return BK; }

// n_e: the batch count (1 for a 2-D product); dtype: 0 = f32, 1 = bf16;
// variant and split from photonic_matmul.py::_plan.  Returns the launch's
// CUDA error (0 on success).
extern "C" int photonic_matmul_launch(const void* a, const void* b, const float* noise,
                                      float* c, int n_e, int n_t, int n_m, int n_k, int dtype,
                                      int mode, unsigned int seed, float sigma_step,
                                      void* stream, int variant, int split) {
  return launch<false>(a, b, nullptr, noise, c, n_e, n_t, n_m, n_k, dtype, mode, seed,
                       sigma_step, stream, variant, split);
}

// The fused DFA gradient: as photonic_matmul_launch, then out *= mask with
// mask a contiguous (E, T, M) f32 operand.
extern "C" int dfa_gradient_launch(const void* a, const void* b, const float* mask,
                                   const float* noise, float* c, int n_e, int n_t, int n_m,
                                   int n_k, int dtype, int mode, unsigned int seed,
                                   float sigma_step, void* stream, int variant, int split) {
  return launch<true>(a, b, mask, noise, c, n_e, n_t, n_m, n_k, dtype, mode, seed, sigma_step,
                      stream, variant, split);
}

#endif  // REPRO_DEVICE_FUNCTIONS_ONLY
