// Pass B of the fused PA-SMO iteration: the rows k_i and k_j of the chosen
// working sets, the gradient update G_new = G - mu (k_i - k_j), and the
// next-i first-max over alpha < U and the gap's other end, min G over
// alpha > L, per block.  One kernel, these variants:
//
//  * lane-batched, one state half (H = 1): both rows recomputed from X;
//  * lane-batched, two state halves (H = 2): the doubled e-SVR operator,
//    the base columns of both rows computed once and applied to half 0,
//    then half 1;
//  * either of those with an active-set mask (ACT, soft shrinking): a
//    (B, H l) bool mask, read per coordinate, restricts the next-i scan
//    and the min to the active coordinates.  The update of G is never
//    masked: G stays exact on every coordinate, so a coordinate that
//    comes back into the set needs no repair;
//  * any of those four with the Conjugate-SMO direction (CONJ): a (B, l)
//    base-width row dirv, the previous direction's Q-product, and a
//    per-lane mu2 add the axpy G_new -= mu2 dirv after the mu update, and
//    the base row difference r = k_i - k_j, the next direction, is
//    written as a (B, l) output.  With H = 2 the operator is
//    Q = [[K, K], [K, K]], so the direction row is the base row tiled and
//    one base value of dirv serves both halves;
//  * single lane (STORED): k_i is read from the row pass A stored, and
//    only k_j is computed in the tile.
//
// Replaces: src/repro/kernels/rbf_update_wss.py,
// rbf_update_wss_batched_pallas (_kernel_batched + _update_from_rows; H = 1
// and H = 2, with and without the active-set mask, with and without the
// conjugate direction dirv/mu2/r) and rbf_update_wss_pallas (_kernel).
//
// What bounds it on an H100: bytes.  It reads X once (l * d values) for
// both query sets, reads four (B, H l) state rows and writes one; the
// 4 B l d operations of the two distance products sit far below the card's
// operations per byte at B <= 16.  The mask adds B H l bytes read; the
// conjugate direction adds B l values read (dirv) and B l written (r).
// The single-lane variant moves l d + 7 l values and is launch-bound at
// the repo's sizes.
//
// Design: the tiling of pass A (rbf_row_wss.cu) with two staged query sets
// and two accumulators per lane (one in the single-lane variant), so X is
// read once for both rows.  No recomputed row reaches device memory except
// r in the conjugate variants, written once per base column.  G is
// written out of place; a lane with mu == 0 (and mu2 == 0) writes its G
// back bitwise unchanged (G - 0 * r - 0 * dirv == G for finite dirv),
// which is how the solvers freeze converged lanes.  Global indices are
// h l + j, first-max a total order on (value, index).  The cross-block
// reductions stay in PyTorch (repro_torch/kernels/ops.py).
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

template <typename T, int H, bool ACT, bool CONJ>
void update_wss_batched(const T* XT, const T* sqn, const T* G,
                        const T* alpha, const T* L, const T* U, const T* XQi,
                        const T* sqqi, const T* XQj, const T* sqqj,
                        const T* mu, const T* gammas, const bool* act,
                        const T* dirv, const T* mu2, T* G_out, T* bmax,
                        int* barg, T* bmin, T* r_out, int B, int l, int d,
                        cudaStream_t s) {
#define REPRO_LAUNCH(LG)                                                    \
  launch_update_wss<T, LG, H, false, ACT, CONJ>(                            \
      XT, sqn, G, alpha, L, U, XQi, sqqi, nullptr, XQj, sqqj, mu, gammas,  \
      act, dirv, mu2, G_out, bmax, barg, bmin, r_out, B, l, d, s)
  switch (lane_group(B)) {
    case 1: REPRO_LAUNCH(1); break;
    case 2: REPRO_LAUNCH(2); break;
    case 4: REPRO_LAUNCH(4); break;
    case 8: REPRO_LAUNCH(8); break;
    default: REPRO_LAUNCH(16); break;
  }
#undef REPRO_LAUNCH
}

// act == nullptr selects the variants without the mask, dirv == nullptr
// those without the conjugate direction (mu2 and r_out are then unused).
template <typename T>
int update_wss(const T* XT, const T* sqn, const T* G, const T* alpha,
               const T* L, const T* U, const T* XQi, const T* sqqi,
               const T* XQj, const T* sqqj, const T* mu, const T* gammas,
               const bool* act, const T* dirv, const T* mu2, T* G_out,
               T* bmax, int* barg, T* bmin, T* r_out, int B, int H, int l,
               int d, int device, void* stream) {
  if (H != 1 && H != 2) return (int)cudaErrorInvalidValue;
  if (dirv != nullptr && (mu2 == nullptr || r_out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_BATCHED(HH, A, C)                                             \
  update_wss_batched<T, HH, A, C>(XT, sqn, G, alpha, L, U, XQi, sqqi, XQj, \
                                  sqqj, mu, gammas, act, dirv, mu2, G_out, \
                                  bmax, barg, bmin, r_out, B, l, d, s)
#define REPRO_MASKED(HH, C)                                                 \
  if (act == nullptr) REPRO_BATCHED(HH, false, C);                          \
  else REPRO_BATCHED(HH, true, C)
  const bool conj = dirv != nullptr;
  if (H == 1 && !conj) { REPRO_MASKED(1, false); }
  else if (H == 1) { REPRO_MASKED(1, true); }
  else if (!conj) { REPRO_MASKED(2, false); }
  else { REPRO_MASKED(2, true); }
#undef REPRO_MASKED
#undef REPRO_BATCHED
  return (int)cudaGetLastError();
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

int rbf_update_wss_batched_f32(const float* XT, const float* sqn,
                               const float* G, const float* alpha,
                               const float* L, const float* U,
                               const float* XQi, const float* sqqi,
                               const float* XQj, const float* sqqj,
                               const float* mu, const float* gammas,
                               const bool* act, const float* dirv,
                               const float* mu2, float* G_out, float* bmax,
                               int* barg, float* bmin, float* r_out, int B,
                               int H, int l, int d, int device,
                               void* stream) {
  return repro::update_wss<float>(XT, sqn, G, alpha, L, U, XQi, sqqi, XQj,
                                  sqqj, mu, gammas, act, dirv, mu2, G_out,
                                  bmax, barg, bmin, r_out, B, H, l, d, device,
                                  stream);
}

int rbf_update_wss_batched_f64(const double* XT, const double* sqn,
                               const double* G, const double* alpha,
                               const double* L, const double* U,
                               const double* XQi, const double* sqqi,
                               const double* XQj, const double* sqqj,
                               const double* mu, const double* gammas,
                               const bool* act, const double* dirv,
                               const double* mu2, double* G_out,
                               double* bmax, int* barg, double* bmin,
                               double* r_out, int B, int H, int l, int d,
                               int device, void* stream) {
  return repro::update_wss<double>(XT, sqn, G, alpha, L, U, XQi, sqqi, XQj,
                                   sqqj, mu, gammas, act, dirv, mu2, G_out,
                                   bmax, barg, bmin, r_out, B, H, l, d, device,
                                   stream);
}

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
