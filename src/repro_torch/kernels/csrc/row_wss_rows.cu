// Pass A of the fused PA-SMO iteration over the Gram bank, lane-batched:
// the WSS2 second-order choice of j from the bank row of each lane's
// working-set point i, reduced to a per-block (max, first argmax).
//
// Replaces: src/repro/kernels/rbf_row_wss.py, row_wss_batched_rows_pallas
// (_kernel_batched_rows + _select_from_k), in the variant the grid runs:
// one state half (H = 1), no active-set mask.
//
// What bounds it on an H100: bytes.  Per launch it reads B bank rows and
// four (B, l) state rows, 5 B l values, and does about 20 operations per
// value read: far below the card's operations per byte.
//
// Design: the Pallas kernel takes the rows pre-gathered into a (B, l)
// block; here each lane reads its row gram[gram_idx[b], i_idx[b], :] in
// place, which saves the gather launch and 2 B l values of traffic per
// iteration.  Lanes go along gridDim.y, one thread owns one column, and
// neighbouring threads read neighbouring columns of every row (coalesced).
// The gain, the mask and the block's first-max reduction stay in
// registers and shared memory; only (B, nb) pairs reach device memory.
// The bank offset is computed in size_t: (n_stack, l, l) passes 2^31
// values at l = 16384 with 8 entries.  The cross-block first-max stays
// in PyTorch (repro_torch/kernels/ops.py).
#include "common.cuh"

namespace repro {

template <typename T>
__global__ void __launch_bounds__(kBlockL)
row_wss_rows_kernel(const T* __restrict__ gram,
                    const long long* __restrict__ gram_idx,
                    const T* __restrict__ G, const T* __restrict__ alpha,
                    const T* __restrict__ L, const T* __restrict__ U,
                    const T* __restrict__ a_i, const T* __restrict__ L_i,
                    const T* __restrict__ U_i, const T* __restrict__ g_i,
                    const int* __restrict__ i_idx,
                    const bool* __restrict__ use_exact,
                    T* __restrict__ bmax, int* __restrict__ barg, int l) {
  __shared__ T red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int tid = threadIdx.x;
  const int j = blockIdx.x * kBlockL + tid;
  const int lane = blockIdx.y;

  T v = -pos_inf<T>();
  int vi = j;  // out-of-range columns lose every tie to real ones
  if (j < l) {
    const int i = i_idx[lane];
    const size_t row = ((size_t)gram_idx[lane] * l + i) * l;
    const T k = gram[row + j];
    const size_t o = (size_t)lane * l + j;
    const T al = alpha[o], lo_b = L[o], up_b = U[o];
    const T lv = g_i[lane] - G[o];
    const T q = fmax(T(2) - T(2) * k, T(kTau));  // RBF diag == 1
    T gain;
    if (use_exact[lane]) {
      const T lo = fmax(L_i[lane] - a_i[lane], al - up_b);
      const T hi = fmin(U_i[lane] - a_i[lane], al - lo_b);
      const T mu = fmin(fmax(lv / q, lo), hi);
      gain = lv * mu - T(0.5) * q * mu * mu;
    } else {
      gain = T(0.5) * lv * lv / q;
    }
    if (al > lo_b && lv > T(0) && j != i) v = gain;
  }
  warp_first_max(v, vi);
  if ((tid & 31) == 0) {
    red_v[tid >> 5] = v;
    red_i[tid >> 5] = vi;
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      take_first_max(v, vi, red_v[w], red_i[w]);
    const size_t out = (size_t)lane * gridDim.x + blockIdx.x;
    bmax[out] = v;
    barg[out] = vi;
  }
}

template <typename T>
int row_wss_rows(const T* gram, const long long* gram_idx, const T* G,
                 const T* alpha, const T* L, const T* U, const T* a_i,
                 const T* L_i, const T* U_i, const T* g_i, const int* i_idx,
                 const bool* use_exact, T* bmax, int* barg, int B, int l,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_blocks(l), B);
  row_wss_rows_kernel<T><<<grid, kBlockL, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i, g_i, i_idx, use_exact,
      bmax, barg, l);
  return (int)cudaGetLastError();
}

}  // namespace repro

extern "C" {

int row_wss_batched_rows_f32(const float* gram, const long long* gram_idx,
                             const float* G, const float* alpha,
                             const float* L, const float* U,
                             const float* a_i, const float* L_i,
                             const float* U_i, const float* g_i,
                             const int* i_idx, const bool* use_exact,
                             float* bmax, int* barg, int B, int l,
                             int device, void* stream) {
  return repro::row_wss_rows<float>(gram, gram_idx, G, alpha, L, U, a_i,
                                    L_i, U_i, g_i, i_idx, use_exact, bmax,
                                    barg, B, l, device, stream);
}

int row_wss_batched_rows_f64(const double* gram, const long long* gram_idx,
                             const double* G, const double* alpha,
                             const double* L, const double* U,
                             const double* a_i, const double* L_i,
                             const double* U_i, const double* g_i,
                             const int* i_idx, const bool* use_exact,
                             double* bmax, int* barg, int B, int l,
                             int device, void* stream) {
  return repro::row_wss_rows<double>(gram, gram_idx, G, alpha, L, U, a_i,
                                     L_i, U_i, g_i, i_idx, use_exact, bmax,
                                     barg, B, l, device, stream);
}

}  // extern "C"
