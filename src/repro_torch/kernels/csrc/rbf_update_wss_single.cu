// Kernel 7, single-lane pass B of the fused PA-SMO iteration: k_i read
// from the row kernel 6 stored, k_j recomputed from X, the gradient update
// G_new = G - mu (k_i - k_j), and per block the next-i first-max over
// alpha < U and the gap's other end, min G over alpha > L.
//
// Replaces: src/repro/kernels/rbf_update_wss.py, rbf_update_wss_pallas
// (_kernel).
//
// What bounds it on an H100: bytes.  It moves l d + 7 l values and is
// launch-bound at the repo's sizes.
//
// Design: one thread a column, instantiated for one lane with the stored
// row (STORED): X is read transposed, the query row staged in slices of
// kChunkD features, G written out of place (mu == 0 writes it back
// bitwise unchanged).  The cross-block reductions stay in
// PyTorch (repro_torch/kernels/ops.py).

#include "common.cuh"

namespace repro {

template <typename T, int LG, int H, bool STORED, bool ACT, bool CONJ>
__global__ void __launch_bounds__(kBlockL)
update_wss_kernel(const T* __restrict__ XT, const T* __restrict__ sqn,
                  const T* __restrict__ G, const T* __restrict__ alpha,
                  const T* __restrict__ L, const T* __restrict__ U,
                  const T* __restrict__ XQi, const T* __restrict__ sqqi,
                  const T* __restrict__ KI, const T* __restrict__ XQj,
                  const T* __restrict__ sqqj, const T* __restrict__ mu,
                  const T* __restrict__ gammas,
                  const bool* __restrict__ act,
                  const T* __restrict__ dirv, const T* __restrict__ mu2,
                  T* __restrict__ G_out, T* __restrict__ bmax,
                  int* __restrict__ barg, T* __restrict__ bmin,
                  T* __restrict__ r_out, int B, int l, int d) {
  __shared__ T sqi[STORED ? 1 : LG][kChunkD];
  __shared__ T sqj[LG][kChunkD];
  __shared__ T red_v[LG][kWarps];
  __shared__ int red_i[LG][kWarps];
  __shared__ T red_m[LG][kWarps];

  const int tid = threadIdx.x;
  const int j = blockIdx.x * kBlockL + tid;
  const int b0 = blockIdx.y * LG;
  const int nl = min(LG, B - b0);
  const bool in = j < l;

  T acc_i[LG], acc_j[LG];
#pragma unroll
  for (int b = 0; b < LG; ++b) {
    acc_i[b] = T(0);
    acc_j[b] = T(0);
  }

  for (int k0 = 0; k0 < d; k0 += kChunkD) {
    const int kn = min(kChunkD, d - k0);
    for (int e = tid; e < LG * kChunkD; e += kBlockL) {
      const int b = e / kChunkD, kk = e % kChunkD;
      const bool ok = b < nl && kk < kn;
      const size_t src = (size_t)(b0 + b) * d + k0 + kk;
      if (!STORED) sqi[b][kk] = ok ? XQi[src] : T(0);
      sqj[b][kk] = ok ? XQj[src] : T(0);
    }
    __syncthreads();
    if (in) {
      const T* xcol = XT + (size_t)k0 * l + j;
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const T x = xcol[(size_t)kk * l];
#pragma unroll
        for (int b = 0; b < LG; ++b) {
          if (!STORED) acc_i[b] = fma(sqi[STORED ? 0 : b][kk], x, acc_i[b]);
          acc_j[b] = fma(sqj[b][kk], x, acc_j[b]);
        }
      }
    }
    __syncthreads();
  }

  const T sn = in ? sqn[j] : T(0);
#pragma unroll
  for (int b = 0; b < LG; ++b) {
    T v = -pos_inf<T>();
    int vi = j;  // out-of-range columns lose every tie to real ones
    T m = pos_inf<T>();
    if (b < nl && in) {
      const int lane = b0 + b;
      const T gam = gammas[lane];
      const T ki = STORED ? KI[(size_t)lane * l + j]
                          : rbf_entry(sqqi[lane], sn, acc_i[b], gam);
      const T kj = rbf_entry(sqqj[lane], sn, acc_j[b], gam);
      const T r = ki - kj;
      const T mul = mu[lane];
      T dv = T(0), m2 = T(0);
      if (CONJ) {
        dv = dirv[(size_t)lane * l + j];
        m2 = mu2[lane];
        r_out[(size_t)lane * l + j] = r;
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const size_t o = ((size_t)lane * H + h) * l + j;
        T g = G[o] - mul * r;
        if (CONJ) g = g - m2 * dv;
        G_out[o] = g;
        const T al = alpha[o];
        const bool in_set = !ACT || act[o];
        if (in_set && al < U[o]) take_first_max(v, vi, g, h * l + j);
        if (in_set && al > L[o]) m = fmin(m, g);
      }
    }
    warp_first_max(v, vi);
    warp_min(m);
    if ((tid & 31) == 0) {
      red_v[b][tid >> 5] = v;
      red_i[b][tid >> 5] = vi;
      red_m[b][tid >> 5] = m;
    }
  }
  __syncthreads();
  if (tid < nl) {
    T v = red_v[tid][0];
    int vi = red_i[tid][0];
    T m = red_m[tid][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      take_first_max(v, vi, red_v[tid][w], red_i[tid][w]);
      m = fmin(m, red_m[tid][w]);
    }
    const size_t out = (size_t)(b0 + tid) * gridDim.x + blockIdx.x;
    bmax[out] = v;
    barg[out] = vi;
    bmin[out] = m;
  }
}

template <typename T, int LG, int H, bool STORED, bool ACT, bool CONJ>
void launch_update_wss(const T* XT, const T* sqn, const T* G,
                       const T* alpha, const T* L, const T* U, const T* XQi,
                       const T* sqqi, const T* KI, const T* XQj,
                       const T* sqqj, const T* mu, const T* gammas,
                       const bool* act, const T* dirv, const T* mu2,
                       T* G_out, T* bmax, int* barg, T* bmin, T* r_out,
                       int B, int l, int d, cudaStream_t stream) {
  const dim3 grid(n_blocks(l), (B + LG - 1) / LG);
  update_wss_kernel<T, LG, H, STORED, ACT, CONJ>
      <<<grid, kBlockL, 0, stream>>>(XT, sqn, G, alpha, L, U, XQi, sqqi, KI,
                                     XQj, sqqj, mu, gammas, act, dirv, mu2,
                                     G_out, bmax, barg, bmin, r_out, B, l, d);
}

template <typename T>
int update_wss_single(const T* XT, const T* sqn, const T* G, const T* k_i,
                      const T* alpha, const T* L, const T* U, const T* xqj,
                      const T* sqqj, const T* mu, const T* gamma, T* G_out,
                      T* bmax, int* barg, T* bmin, int l, int d, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  launch_update_wss<T, 1, 1, true, false, false>(
      XT, sqn, G, alpha, L, U, nullptr, nullptr, k_i, xqj, sqqj, mu, gamma,
      nullptr, nullptr, nullptr, G_out, bmax, barg, bmin, nullptr, 1, l, d,
      static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

}  // namespace repro

extern "C" {

int rbf_update_wss_f32(const float* XT, const float* sqn, const float* G,
                       const float* k_i, const float* alpha, const float* L,
                       const float* U, const float* xqj, const float* sqqj,
                       const float* mu, const float* gamma, float* G_out,
                       float* bmax, int* barg, float* bmin, int l, int d,
                       int device, void* stream) {
  return repro::update_wss_single<float>(XT, sqn, G, k_i, alpha, L, U, xqj,
                                         sqqj, mu, gamma, G_out, bmax, barg,
                                         bmin, l, d, device, stream);
}

int rbf_update_wss_f64(const double* XT, const double* sqn, const double* G,
                       const double* k_i, const double* alpha,
                       const double* L, const double* U, const double* xqj,
                       const double* sqqj, const double* mu,
                       const double* gamma, double* G_out, double* bmax,
                       int* barg, double* bmin, int l, int d, int device,
                       void* stream) {
  return repro::update_wss_single<double>(XT, sqn, G, k_i, alpha, L, U, xqj,
                                          sqqj, mu, gamma, G_out, bmax, barg,
                                          bmin, l, d, device, stream);
}

}  // extern "C"
