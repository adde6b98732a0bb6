// Tiled RBF cross-Gram K[a, b] = exp(-gamma max(s1_a + s2_b - 2 x1_a.x2_b,
// 0)) with the distance and exp epilogue fused before the one store.
//
// Replaces: src/repro/kernels/gram_block.py, gram_pallas (_kernel).
//
// What bounds it on an H100: operations.  An (m, n) output over d
// features costs 2 m n d multiply-adds' worth of operations against
// m n values written; at the predict shapes (d = 128) that is far above
// the card's operations per byte.  This first version runs them on the
// ordinary FMA units in the input precision: TF32 tensor cores would break
// float32 parity with the reference, and DMMA / wgmma tiles are later work.
//
// Design: one 256-thread block per 64 x 64 output tile, each thread a
// 4 x 4 micro-tile strided by 16 (so a warp's stores and shared-memory
// reads touch neighbouring columns).  Both inputs stream through shared
// memory in slices of 16 features; every value staged there is used 64
// times.  The squared norms s1, s2 come from the caller.
#include "common.cuh"

namespace repro {

constexpr int kTile = 64;
constexpr int kSlice = 16;
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const T* __restrict__ X1, const T* __restrict__ X2,
            const T* __restrict__ s1, const T* __restrict__ s2, T gamma,
            T* __restrict__ out, int m, int n, int d) {
  __shared__ T As[kSlice][kTile];
  __shared__ T Bs[kSlice][kTile];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;

  T acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = T(0);

  for (int k0 = 0; k0 < d; k0 += kSlice) {
    for (int e = threadIdx.x; e < kTile * kSlice; e += kThreads) {
      const int r = e / kSlice, kk = e % kSlice;
      const int gk = k0 + kk;
      const int gi = i0 + r, gj = j0 + r;
      As[kk][r] = (gi < m && gk < d) ? X1[(size_t)gi * d + gk] : T(0);
      Bs[kk][r] = (gj < n && gk < d) ? X2[(size_t)gj * d + gk] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlice; ++kk) {
      T av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = As[kk][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = Bs[kk][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fma(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int gi = i0 + ty + 16 * a;
    if (gi >= m) continue;
    const T si = s1[gi];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int gj = j0 + tx + 16 * b;
      if (gj < n)
        out[(size_t)gi * n + gj] = rbf_entry(si, s2[gj], acc[a][b], gamma);
    }
  }
}

template <typename T>
int gram(const T* X1, const T* X2, const T* s1, const T* s2, T* out,
         double gamma, int m, int n, int d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  gram_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      X1, X2, s1, s2, static_cast<T>(gamma), out, m, n, d);
  return (int)cudaGetLastError();
}

}  // namespace repro

extern "C" {

int gram_block_f32(const float* X1, const float* X2, const float* s1,
                   const float* s2, float* out, double gamma, int m, int n,
                   int d, int device, void* stream) {
  return repro::gram<float>(X1, X2, s1, s2, out, gamma, m, n, d, device,
                            stream);
}

int gram_block_f64(const double* X1, const double* X2, const double* s1,
                   const double* s2, double* out, double gamma, int m, int n,
                   int d, int device, void* stream) {
  return repro::gram<double>(X1, X2, s1, s2, out, gamma, m, n, d, device,
                             stream);
}

}  // extern "C"
