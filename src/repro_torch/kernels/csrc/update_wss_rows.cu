// Pass B of the fused PA-SMO iteration over the Gram bank, lane-batched:
// read both bank rows k_i and k_j of the chosen working sets, update the
// gradient G_new = G - mu (k_i - k_j), and reduce the next-i first-max over
// alpha < U and the gap's other end, min G over alpha > L, per block.  One
// kernel, these variants:
//
//  * one state half (H = 1): the (C, gamma) and one-class grids;
//  * two state halves (H = 2): the doubled e-SVR operator.  Lane b reads
//    the base rows i mod l and j mod l of its bank entry; each thread
//    computes k_i - k_j for its base column j once and applies it to half
//    0 (coordinate j), then half 1 (coordinate l + j), since
//    Q = [[K, K], [K, K]];
//  * either of those with an active-set mask (ACT, soft shrinking): a
//    (B, H l) bool mask, read per coordinate, restricts the next-i scan
//    and the min to the active coordinates.  The update of G is never
//    masked, so G stays exact on every coordinate;
//  * any of those four with the Conjugate-SMO direction (CONJ): a (B, l)
//    base-width row dirv, the previous direction's Q-product, and a
//    per-lane mu2 add G_new -= mu2 dirv after the mu update, and the base
//    row difference r = k_i - k_j, the next direction, is written as a
//    (B, l) output.  With H = 2 the direction row is the base row tiled,
//    so one base value of dirv serves both halves.
//
// Replaces: src/repro/kernels/rbf_update_wss.py,
// update_wss_batched_rows_pallas (_kernel_batched_rows +
// _update_from_rows): H = 1 and H = 2, with and without the active-set
// mask, with and without the conjugate direction (dirv/mu2/r).
//
// What bounds it on an H100: bytes.  Per launch it reads two bank rows (l
// values each, whatever H) and four (B, H l) state rows and writes one,
// plus B H l mask bytes with ACT, and B l values read (dirv) and B l
// written (r) with CONJ, with a handful of operations per value.
//
// Design: as bank pass A (row_wss_rows.cu).  The Pallas kernel takes KRi
// and KRj pre-gathered; here each lane reads rows i and j of its bank
// entry in place, which saves the gather launch and 4 B l values of
// traffic per iteration.  Row i of lane b starts at gram_i + e bank_stride
// + i row_stride, e = gram_idx[b], row j at gram_j the same way: the bank
// passes gram_i == gram_j with strides l l and l.  Pre-gathered KRi and
// KRj (B, l), the reference's form, pass as gram_i and gram_j with a null
// gram_idx (e = b), null i_idx and j_idx, bank stride l and row stride 0.
// Lanes go along gridDim.y, one thread owns one base column.  G is
// written out of place; a lane with mu == 0 (and mu2 == 0) writes its G
// back bitwise unchanged (G - 0 * r - 0 * dirv == G for finite dirv),
// which is how the solver freezes converged lanes.
// Global indices are h l + j, first-max a total order on (value, index);
// after hard compaction l is the bucketed row count.  Offsets into the
// bank are size_t.  The cross-block reductions stay in PyTorch
// (repro_torch/kernels/ops.py).
#include "common.cuh"

namespace repro {

template <typename T, int H, bool ACT, bool CONJ>
__global__ void __launch_bounds__(kBlockL)
update_wss_rows_kernel(const T* __restrict__ gram_i,
                       const T* __restrict__ gram_j,
                       const long long* __restrict__ gram_idx,
                       const int* __restrict__ i_idx,
                       const int* __restrict__ j_idx,
                       const T* __restrict__ G, const T* __restrict__ alpha,
                       const T* __restrict__ L, const T* __restrict__ U,
                       const T* __restrict__ mu,
                       const bool* __restrict__ act,
                       const T* __restrict__ dirv,
                       const T* __restrict__ mu2, T* __restrict__ G_out,
                       T* __restrict__ bmax, int* __restrict__ barg,
                       T* __restrict__ bmin, T* __restrict__ r_out, int l,
                       long long bank_stride, long long row_stride) {
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
    int ri = i_idx != nullptr ? i_idx[lane] : 0;
    int rj = j_idx != nullptr ? j_idx[lane] : 0;
    if (H == 2) {
      if (ri >= l) ri -= l;
      if (rj >= l) rj -= l;
    }
    const long long e = gram_idx != nullptr ? gram_idx[lane] : lane;
    const size_t entry = (size_t)e * bank_stride;
    const T ki = gram_i[entry + (size_t)ri * row_stride + j];
    const T kj = gram_j[entry + (size_t)rj * row_stride + j];
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

// act == nullptr selects the variants without the mask, dirv == nullptr
// those without the conjugate direction (mu2 and r_out are then unused);
// gram_idx == nullptr reads lane b's rows from entry b (pre-gathered rows).
template <typename T>
int update_wss_rows(const T* gram_i, const T* gram_j,
                    const long long* gram_idx,
                    const int* i_idx, const int* j_idx, const T* G,
                    const T* alpha, const T* L, const T* U, const T* mu,
                    const bool* act, const T* dirv, const T* mu2, T* G_out,
                    T* bmax, int* barg, T* bmin, T* r_out, int B, int H,
                    int l, long long bank_stride, long long row_stride,
                    int device, void* stream) {
  if (H != 1 && H != 2) return (int)cudaErrorInvalidValue;
  if (dirv != nullptr && (mu2 == nullptr || r_out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_blocks(l), B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(HH, A, C)                                             \
  update_wss_rows_kernel<T, HH, A, C><<<grid, kBlockL, 0, s>>>(            \
      gram_i, gram_j, gram_idx, i_idx, j_idx, G, alpha, L, U, mu, act,     \
      dirv, mu2, G_out, bmax, barg, bmin, r_out, l, bank_stride, row_stride)
#define REPRO_MASKED(HH, C)                                                \
  if (act == nullptr) REPRO_LAUNCH(HH, false, C);                          \
  else REPRO_LAUNCH(HH, true, C)
  const bool conj = dirv != nullptr;
  if (H == 1 && !conj) { REPRO_MASKED(1, false); }
  else if (H == 1) { REPRO_MASKED(1, true); }
  else if (!conj) { REPRO_MASKED(2, false); }
  else { REPRO_MASKED(2, true); }
#undef REPRO_MASKED
#undef REPRO_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace repro

extern "C" {

int update_wss_batched_rows_f32(const float* gram_i, const float* gram_j,
                                const long long* gram_idx,
                                const int* i_idx, const int* j_idx,
                                const float* G, const float* alpha,
                                const float* L, const float* U,
                                const float* mu, const bool* act,
                                const float* dirv, const float* mu2,
                                float* G_out, float* bmax, int* barg,
                                float* bmin, float* r_out, int B, int H,
                                int l, long long bank_stride,
                                long long row_stride, int device,
                                void* stream) {
  return repro::update_wss_rows<float>(gram_i, gram_j, gram_idx, i_idx,
                                       j_idx, G, alpha, L, U, mu, act, dirv,
                                       mu2, G_out, bmax, barg, bmin, r_out,
                                       B, H, l, bank_stride, row_stride,
                                       device, stream);
}

int update_wss_batched_rows_f64(const double* gram_i,
                                const double* gram_j,
                                const long long* gram_idx, const int* i_idx,
                                const int* j_idx, const double* G,
                                const double* alpha, const double* L,
                                const double* U, const double* mu,
                                const bool* act, const double* dirv,
                                const double* mu2, double* G_out,
                                double* bmax, int* barg, double* bmin,
                                double* r_out, int B, int H, int l,
                                long long bank_stride, long long row_stride,
                                int device, void* stream) {
  return repro::update_wss_rows<double>(gram_i, gram_j, gram_idx, i_idx,
                                        j_idx, G, alpha, L, U, mu, act, dirv,
                                        mu2, G_out, bmax, barg, bmin, r_out,
                                        B, H, l, bank_stride, row_stride,
                                        device, stream);
}

}  // extern "C"
