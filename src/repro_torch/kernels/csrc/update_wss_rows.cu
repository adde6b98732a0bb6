// Pass B of the fused PA-SMO iteration over the Gram bank, lane-batched:
// read both bank rows k_i and k_j of the chosen working sets, update the
// gradient G_new = G - mu (k_i - k_j), and reduce the next-i first-max over
// alpha < U and the gap's other end, min G over alpha > L, per block.
//
// Replaces: src/repro/kernels/rbf_update_wss.py,
// update_wss_batched_rows_pallas (_kernel_batched_rows +
// _update_from_rows), in the variant the grid runs: one state half
// (H = 1), no active-set mask, no conjugate direction.
//
// What bounds it on an H100: bytes.  Per launch it reads two bank rows
// and four (B, l) state rows and writes one, 7 B l values, with a handful
// of operations per value.
//
// Design: as bank pass A (row_wss_rows.cu).  The Pallas kernel takes KRi
// and KRj pre-gathered; here each lane reads rows i and j of its bank
// entry in place, which saves the gather launch and 4 B l values of
// traffic per iteration.  Lanes go along gridDim.y, one thread owns one
// column.  G is written out of place; a lane with mu == 0 writes its G
// back bitwise unchanged (G - 0 * r == G), which is how the solver
// freezes converged lanes.  Offsets into the bank are size_t.  The
// cross-block reductions stay in PyTorch (repro_torch/kernels/ops.py).
#include "common.cuh"

namespace repro {

template <typename T>
__global__ void __launch_bounds__(kBlockL)
update_wss_rows_kernel(const T* __restrict__ gram,
                       const long long* __restrict__ gram_idx,
                       const int* __restrict__ i_idx,
                       const int* __restrict__ j_idx,
                       const T* __restrict__ G, const T* __restrict__ alpha,
                       const T* __restrict__ L, const T* __restrict__ U,
                       const T* __restrict__ mu, T* __restrict__ G_out,
                       T* __restrict__ bmax, int* __restrict__ barg,
                       T* __restrict__ bmin, int l) {
  __shared__ T red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ T red_m[kWarps];

  const int tid = threadIdx.x;
  const int j = blockIdx.x * kBlockL + tid;
  const int lane = blockIdx.y;

  T v = -pos_inf<T>();
  int vi = j;  // out-of-range columns lose every tie to real ones
  T m = pos_inf<T>();
  if (j < l) {
    const size_t entry = (size_t)gram_idx[lane] * l;
    const T ki = gram[(entry + i_idx[lane]) * l + j];
    const T kj = gram[(entry + j_idx[lane]) * l + j];
    const size_t o = (size_t)lane * l + j;
    const T g = G[o] - mu[lane] * (ki - kj);
    G_out[o] = g;
    const T al = alpha[o];
    if (al < U[o]) v = g;
    if (al > L[o]) m = g;
  }
  warp_first_max(v, vi);
  warp_min(m);
  if ((tid & 31) == 0) {
    red_v[tid >> 5] = v;
    red_i[tid >> 5] = vi;
    red_m[tid >> 5] = m;
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      take_first_max(v, vi, red_v[w], red_i[w]);
      m = fmin(m, red_m[w]);
    }
    const size_t out = (size_t)lane * gridDim.x + blockIdx.x;
    bmax[out] = v;
    barg[out] = vi;
    bmin[out] = m;
  }
}

template <typename T>
int update_wss_rows(const T* gram, const long long* gram_idx,
                    const int* i_idx, const int* j_idx, const T* G,
                    const T* alpha, const T* L, const T* U, const T* mu,
                    T* G_out, T* bmax, int* barg, T* bmin, int B, int l,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_blocks(l), B);
  update_wss_rows_kernel<T><<<grid, kBlockL, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      gram, gram_idx, i_idx, j_idx, G, alpha, L, U, mu, G_out, bmax, barg,
      bmin, l);
  return (int)cudaGetLastError();
}

}  // namespace repro

extern "C" {

int update_wss_batched_rows_f32(const float* gram, const long long* gram_idx,
                                const int* i_idx, const int* j_idx,
                                const float* G, const float* alpha,
                                const float* L, const float* U,
                                const float* mu, float* G_out, float* bmax,
                                int* barg, float* bmin, int B, int l,
                                int device, void* stream) {
  return repro::update_wss_rows<float>(gram, gram_idx, i_idx, j_idx, G,
                                       alpha, L, U, mu, G_out, bmax, barg,
                                       bmin, B, l, device, stream);
}

int update_wss_batched_rows_f64(const double* gram,
                                const long long* gram_idx, const int* i_idx,
                                const int* j_idx, const double* G,
                                const double* alpha, const double* L,
                                const double* U, const double* mu,
                                double* G_out, double* bmax, int* barg,
                                double* bmin, int B, int l, int device,
                                void* stream) {
  return repro::update_wss_rows<double>(gram, gram_idx, i_idx, j_idx, G,
                                        alpha, L, U, mu, G_out, bmax, barg,
                                        bmin, B, l, device, stream);
}

}  // extern "C"
