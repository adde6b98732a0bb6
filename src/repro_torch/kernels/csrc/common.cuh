// Shared pieces of the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel here is templated on float/double and exposed through a
// plain extern "C" function that launches on the caller's stream and
// returns the cudaError_t of the launch (0 on success); the Python
// wrappers in repro_torch/kernels/ raise on anything else.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace repro {

// Columns of the example axis l in one block of the rbf pass A / pass B
// kernels' per-block outputs (and in one thread block: one column per
// thread in the single-lane kernels, a micro-tiled block in the batched
// rbf kernels, rbf_tile.cuh).  The bank passes size their own blocks
// (bank_pass.cuh) and return lane results.  The Python side reads it back
// through repro_block_l() and refuses a library that disagrees.
constexpr int kBlockL = 128;
constexpr int kWarps = kBlockL / 32;
// Feature slice of the query row the single-lane kernels stage in shared
// memory per step.
constexpr int kChunkD = 32;
// LIBSVM's guard for vanishing curvature (repro_torch.core.qp.TAU).
constexpr double kTau = 1e-12;

template <typename T> __device__ __forceinline__ T pos_inf();
template <> __device__ __forceinline__ float pos_inf<float>() {
  return CUDART_INF_F;
}
template <> __device__ __forceinline__ double pos_inf<double>() {
  return CUDART_INF;
}

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

// RBF entry from the expanded squared distance, in the plain version's
// order: d2 = (sqq + sqn) - 2 prod, k = exp(-gamma * max(d2, 0)).
template <typename T>
__device__ __forceinline__ T rbf_entry(T sqq, T sqn, T prod, T gamma) {
  const T d2 = (sqq + sqn) - T(2) * prod;
  return exp_t(-gamma * fmax(d2, T(0)));
}

// Keep the larger value; on equal values (-inf included) keep the lower
// index.  That is jax.lax.argmax's first-maximum rule, and it is a total
// order, so the reduction order below does not change the result.
template <typename T>
__device__ __forceinline__ void take_first_max(T& v, int& i, T ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <typename T>
__device__ __forceinline__ void warp_first_max(T& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    take_first_max(v, i, ov, oi);
  }
}

template <typename T>
__device__ __forceinline__ void warp_min(T& v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmin(v, __shfl_down_sync(0xffffffffu, v, off));
  }
}

inline int n_blocks(int l) { return (l + kBlockL - 1) / kBlockL; }

}  // namespace repro

extern "C" int repro_block_l();
extern "C" const char* repro_error_string(int err);
