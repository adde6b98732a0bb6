// Kernel 6, single-lane pass A of the fused PA-SMO iteration: the RBF
// kernel row of the working-set point i, stored to device memory for pass
// B and the O(1) step algebra, fused with the WSS2 second-order choice of
// j, reduced to a per-block (max, argmax).  An optional device flag `run`
// turns a launch into a no-op that leaves the stored row as it was (Alg.
// 3's relaunch for the B^(t-2) candidate, decided on the card without a
// host sync).
//
// Replaces: src/repro/kernels/rbf_row_wss.py, rbf_row_wss_pallas
// (_kernel).
//
// What bounds it on an H100: bytes.  It moves l d + 6 l values (X once,
// four state vectors, the stored row) and is launch-bound at the repo's
// sizes.
//
// Design: one thread a column, instantiated for one lane with the row
// stored (STORE).  X is read transposed, XT (d, l), so
// the 128 threads of a block read 128 neighbouring columns of each feature
// row; the query row is staged in shared memory in slices of kChunkD
// features; the distance, the kernel value, the gain and the first-max
// reduction stay in registers and shared memory.  Global indices are j;
// first-max is a total order on (value, index).

#include "common.cuh"

namespace repro {

template <typename T, int LG, int H, bool STORE, bool ACT>
__global__ void __launch_bounds__(kBlockL)
row_wss_kernel(const T* __restrict__ XT, const T* __restrict__ sqn,
               const T* __restrict__ G, const T* __restrict__ alpha,
               const T* __restrict__ L, const T* __restrict__ U,
               const T* __restrict__ XQ, const T* __restrict__ sqq,
               const T* __restrict__ a_i, const T* __restrict__ L_i,
               const T* __restrict__ U_i, const T* __restrict__ g_i,
               const int* __restrict__ i_idx,
               const bool* __restrict__ use_exact,
               const T* __restrict__ gammas, const bool* __restrict__ act,
               const bool* __restrict__ run, T* __restrict__ k_out, T* __restrict__ bmax,
               int* __restrict__ barg, int B, int l, int d) {
  // a relaunch whose flag is false does nothing (uniform over the block,
  // before any barrier): the stored row stays as it was
  if (STORE && run != nullptr && !*run) return;

  __shared__ T sq[LG][kChunkD];
  __shared__ T red_v[LG][kWarps];
  __shared__ int red_i[LG][kWarps];

  const int tid = threadIdx.x;
  const int j = blockIdx.x * kBlockL + tid;
  const int b0 = blockIdx.y * LG;
  const int nl = min(LG, B - b0);
  const bool in = j < l;

  T acc[LG];
#pragma unroll
  for (int b = 0; b < LG; ++b) acc[b] = T(0);

  for (int k0 = 0; k0 < d; k0 += kChunkD) {
    const int kn = min(kChunkD, d - k0);
    for (int e = tid; e < LG * kChunkD; e += kBlockL) {
      const int b = e / kChunkD, kk = e % kChunkD;
      sq[b][kk] = (b < nl && kk < kn)
                      ? XQ[(size_t)(b0 + b) * d + k0 + kk] : T(0);
    }
    __syncthreads();
    if (in) {
      const T* xcol = XT + (size_t)k0 * l + j;
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const T x = xcol[(size_t)kk * l];
#pragma unroll
        for (int b = 0; b < LG; ++b) acc[b] = fma(sq[b][kk], x, acc[b]);
      }
    }
    __syncthreads();
  }

  const T sn = in ? sqn[j] : T(0);
  const T tau = T(kTau);
#pragma unroll
  for (int b = 0; b < LG; ++b) {
    T v = -pos_inf<T>();
    int vi = j;  // out-of-range columns lose every tie to real ones
    if (b < nl && in) {
      const int lane = b0 + b;
      const T k = rbf_entry(sqq[lane], sn, acc[b], gammas[lane]);
      if (STORE) k_out[(size_t)lane * l + j] = k;
      const T q = fmax(T(2) - T(2) * k, tau);  // RBF diag == 1
      const T ai = a_i[lane], gi = g_i[lane];
      const bool exact = use_exact[lane];
      const int ii = i_idx[lane];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const size_t o = ((size_t)lane * H + h) * l + j;
        const int gj = h * l + j;
        const T al = alpha[o], lo_b = L[o], up_b = U[o];
        const T lv = gi - G[o];
        T gain;
        if (exact) {
          const T lo = fmax(L_i[lane] - ai, al - up_b);
          const T hi = fmin(U_i[lane] - ai, al - lo_b);
          const T mu = fmin(fmax(lv / q, lo), hi);
          gain = lv * mu - T(0.5) * q * mu * mu;
        } else {
          gain = T(0.5) * lv * lv / q;
        }
        const bool ok = al > lo_b && lv > T(0) && gj != ii &&
                        (!ACT || act[o]);
        const T vh = ok ? gain : -pos_inf<T>();
        if (h == 0) {
          v = vh;
          vi = gj;
        } else {
          take_first_max(v, vi, vh, gj);
        }
      }
    }
    warp_first_max(v, vi);
    if ((tid & 31) == 0) {
      red_v[b][tid >> 5] = v;
      red_i[b][tid >> 5] = vi;
    }
  }
  __syncthreads();
  if (tid < nl) {
    T v = red_v[tid][0];
    int vi = red_i[tid][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      take_first_max(v, vi, red_v[tid][w], red_i[tid][w]);
    const size_t out = (size_t)(b0 + tid) * gridDim.x + blockIdx.x;
    bmax[out] = v;
    barg[out] = vi;
  }
}

template <typename T, int LG, int H, bool STORE, bool ACT>
void launch_row_wss(const T* XT, const T* sqn, const T* G, const T* alpha,
                    const T* L, const T* U, const T* XQ, const T* sqq,
                    const T* a_i, const T* L_i, const T* U_i, const T* g_i,
                    const int* i_idx, const bool* use_exact,
                    const T* gammas, const bool* act, const bool* run,
                    T* k_out, T* bmax, int* barg, int B, int l, int d,
                    cudaStream_t stream) {
  const dim3 grid(n_blocks(l), (B + LG - 1) / LG);
  row_wss_kernel<T, LG, H, STORE, ACT><<<grid, kBlockL, 0, stream>>>(
      XT, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i, g_i, i_idx,
      use_exact, gammas, act, run, k_out, bmax, barg, B, l, d);
}

template <typename T>
int row_wss_single(const T* XT, const T* sqn, const T* G, const T* alpha,
                   const T* L, const T* U, const T* xq, const T* sqq,
                   const T* a_i, const T* L_i, const T* U_i, const T* g_i,
                   const int* i_idx, const bool* use_exact, const T* gamma,
                   const bool* run, T* k_out, T* bmax, int* barg, int l,
                   int d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  launch_row_wss<T, 1, 1, true, false>(XT, sqn, G, alpha, L, U, xq, sqq,
                                       a_i, L_i, U_i, g_i, i_idx, use_exact,
                                       gamma, nullptr, run, k_out, bmax,
                                       barg, 1, l, d,
                                       static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

}  // namespace repro

extern "C" {

int rbf_row_wss_f32(const float* XT, const float* sqn, const float* G,
                    const float* alpha, const float* L, const float* U,
                    const float* xq, const float* sqq, const float* a_i,
                    const float* L_i, const float* U_i, const float* g_i,
                    const int* i_idx, const bool* use_exact,
                    const float* gamma, const bool* run, float* k_out,
                    float* bmax, int* barg, int l, int d, int device,
                    void* stream) {
  return repro::row_wss_single<float>(XT, sqn, G, alpha, L, U, xq, sqq, a_i,
                                      L_i, U_i, g_i, i_idx, use_exact, gamma,
                                      run, k_out, bmax, barg, l, d, device,
                                      stream);
}

int rbf_row_wss_f64(const double* XT, const double* sqn, const double* G,
                    const double* alpha, const double* L, const double* U,
                    const double* xq, const double* sqq, const double* a_i,
                    const double* L_i, const double* U_i, const double* g_i,
                    const int* i_idx, const bool* use_exact,
                    const double* gamma, const bool* run, double* k_out,
                    double* bmax, int* barg, int l, int d, int device,
                    void* stream) {
  return repro::row_wss_single<double>(XT, sqn, G, alpha, L, U, xq, sqq,
                                       a_i, L_i, U_i, g_i, i_idx, use_exact,
                                       gamma, run, k_out, bmax, barg, l, d,
                                       device, stream);
}

}  // extern "C"
