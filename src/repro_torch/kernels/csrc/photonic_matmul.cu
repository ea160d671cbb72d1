// Photonic weight-bank product on Hopper: C = A·Bᵀ (+ bank read noise),
// and with a mask epilogue the fused DFA gradient δ = (A·Bᵀ + η) ⊙ mask.
//
// Replaces two TPU kernels, one template flag apart:
//   kMask = false: src/repro/kernels/photonic_matmul.py
//                  (photonic_matmul_pallas, body _kernel, noise _gaussian_tile);
//   kMask = true : src/repro/kernels/dfa_gradient.py
//                  (dfa_gradient_pallas, body _kernel): the paper's TIA-gain
//                  stage (Fig. 4b) multiplies the noisy product by g'(a)
//                  before it leaves the block, so δ never round-trips device
//                  memory between the product and the mask.
//
// A (T, K) holds the amplitude-encoded inputs and B (M, K) the inscribed
// weight panel, both normalised to [-1, 1] by the wrapper, both row-major
// and contiguous, in f32 or bf16.  C (T, M) is f32, and so is the mask
// (T, M).  Each block owns a BT x BM output tile and walks K in BK-wide
// tiles with an f32 accumulator in registers: the in-block loop takes the
// place of the TPU grid's sequential ("arbitrary") K axis.  Loads are
// predicated, so a ragged K (the DFA projection has K = 10 < BK) reads
// zeros past the edge.  Noise modes, as on the TPU:
//   0 none  : the exact product;
//   1 input : a (T, M) f32 total-noise operand added in the epilogue;
//   2 prng  : sigma_step * N(0, 1) added after every K tile, drawn from a
//             counter-based threefry2x32 keyed by (seed, k tile) with
//             counter (row, col), so sum over the nk tiles has std
//             sigma_step * sqrt(nk).  The plain version
//             (photonic_matmul.py::photonic_matmul_plain) draws the same
//             numbers.
// The mask is read once per output element, in the epilogue after the
// noise, as the TPU kernel applies it at its last K step.
//
// What bounds it on an H100: at the decode shapes (T = 4 slots) the work
// is 2·T·M·K operations on 2·M·K bytes of B (bf16), so the kernel is bound
// by reading B: the 311 MB bf16 unembedding (151936 x 1024) takes at least
// 93 us at 3.35 TB/s.  At prefill (T = 64) it is still bytes-bound (64
// operations per byte of B, far below the ~295 at which the tensor cores
// become the limit).  The DFA projection of the paper's MLP (T = 64,
// K = 10, M = 800) moves about 0.44 MB (mostly the f32 mask and output):
// its bound is a fraction of a microsecond, far below a launch, and the
// grid has only 13 blocks.  The design reads every element of B exactly
// once when T <= BT (one block row), coalesced along K.  It is the simple,
// right first version: FMA in f32 on the CUDA cores, no cp.async/TMA
// pipeline, no split-K for the narrow (1024-row) decode GEMVs — those are
// later work, measured in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

using repro_torch::threefry2x32;

constexpr int BT = 64;        // output rows (A rows) per block
constexpr int BM = 64;        // output cols (B rows) per block
constexpr int BK = 32;        // contraction tile
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int TPR = 16;       // threads along one tile edge

enum NoiseMode { kNone = 0, kInput = 1, kPrng = 2 };

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

template <typename T, bool kMask>
__global__ void __launch_bounds__(THREADS)
photonic_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       const float* __restrict__ mask, const float* __restrict__ noise,
                       float* __restrict__ c,
                       int n_t, int n_m, int n_k, int mode, uint32_t seed,
                       float sigma_step) {
  // [row][k] with one word of padding: the inner loop reads a column of
  // each tile without bank conflicts.
  __shared__ float a_tile[BT][BK + 1];
  __shared__ float b_tile[BM][BK + 1];

  const int tid = threadIdx.x;
  const int tx = tid % TPR;
  const int ty = tid / TPR;
  const int row0 = blockIdx.y * BT;
  const int col0 = blockIdx.x * BM;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int n_tiles = (n_k + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    // A warp loads 32 consecutive k of one row: coalesced along K.
#pragma unroll
    for (int e = tid; e < BT * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      const int gr = row0 + r, gk = k0 + kk;
      a_tile[r][kk] = (gr < n_t && gk < n_k) ? to_f32(a[(size_t)gr * n_k + gk]) : 0.0f;
    }
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      const int gr = col0 + r, gk = k0 + kk;
      b_tile[r][kk] = (gr < n_m && gk < n_k) ? to_f32(b[(size_t)gr * n_k + gk]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_tile[ty + TPR * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_tile[tx + TPR * j][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    if (mode == kPrng) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] += sigma_step * counter_gaussian(seed, kt, row0 + ty + TPR * i,
                                                     col0 + tx + TPR * j);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + TPR * i;
    if (r >= n_t) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + TPR * j;
      if (col >= n_m) continue;
      float v = acc[i][j];
      const size_t o = (size_t)r * n_m + col;
      if (mode == kInput) v += noise[o];
      if constexpr (kMask) v *= mask[o];  // the TIA gain epilogue, after the noise
      c[o] = v;
    }
  }
}

template <bool kMask>
int launch(const void* a, const void* b, const float* mask, const float* noise, float* c,
           int n_t, int n_m, int n_k, int dtype, int mode, unsigned int seed,
           float sigma_step, void* stream) {
  const dim3 grid((n_m + BM - 1) / BM, (n_t + BT - 1) / BT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    photonic_matmul_kernel<float, kMask><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), mask, noise, c, n_t,
        n_m, n_k, mode, seed, sigma_step);
  } else if (dtype == 1) {
    photonic_matmul_kernel<__nv_bfloat16, kMask><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), mask,
        noise, c, n_t, n_m, n_k, mode, seed, sigma_step);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int photonic_matmul_block_k() { return BK; }

// dtype: 0 = f32, 1 = bf16.  Returns cudaGetLastError() after the launch.
extern "C" int photonic_matmul_launch(const void* a, const void* b, const float* noise,
                                      float* c, int n_t, int n_m, int n_k, int dtype,
                                      int mode, unsigned int seed, float sigma_step,
                                      void* stream) {
  return launch<false>(a, b, nullptr, noise, c, n_t, n_m, n_k, dtype, mode, seed,
                       sigma_step, stream);
}

// The fused DFA gradient: as photonic_matmul_launch, then out *= mask with
// mask a contiguous (T, M) f32 operand.
extern "C" int dfa_gradient_launch(const void* a, const void* b, const float* mask,
                                   const float* noise, float* c, int n_t, int n_m, int n_k,
                                   int dtype, int mode, unsigned int seed, float sigma_step,
                                   void* stream) {
  return launch<true>(a, b, mask, noise, c, n_t, n_m, n_k, dtype, mode, seed, sigma_step,
                      stream);
}
