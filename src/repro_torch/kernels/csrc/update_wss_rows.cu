// Pass B of the fused PA-SMO iteration over the Gram bank, lane-batched:
// read both bank rows k_i and k_j of the chosen working sets, update the
// gradient G_new = G - mu (k_i - k_j), and return each lane's next i (the
// first max of G_new over alpha < U) and the gap's other end (min G_new
// over alpha > L).  One kernel, these variants:
//
//  * one state half (H = 1): the (C, gamma) and one-class grids;
//  * two state halves (H = 2): the doubled e-SVR operator.  Lane b reads
//    the base rows i mod l and j mod l of its bank entry and applies
//    k_i - k_j of each base column j to half 0 (coordinate j) and half 1
//    (coordinate l + j), since Q = [[K, K], [K, K]];
//  * either of those with an active-set mask (ACT, soft shrinking): a
//    (B, H l) bool mask restricts the next-i scan and the min to the
//    active coordinates.  The update of G is never masked, so G stays
//    exact on every coordinate;
//  * any of those four with the Conjugate-SMO direction (CONJ): a (B, l)
//    base-width row dirv, the previous direction's Q-product, and a
//    per-lane mu2 add G_new -= mu2 dirv after the mu update, and the base
//    row difference r = k_i - k_j, the next direction, is written as a
//    (B, l) output.  With H = 2 the direction row is the base row tiled,
//    so one base value of dirv serves both halves.
//
// Replaces: src/repro/kernels/rbf_update_wss.py,
// update_wss_batched_rows_pallas (_kernel_batched_rows +
// _update_from_rows) and the cross-block argmax and min after it: H = 1
// and H = 2, with and without the active-set mask, with and without the
// conjugate direction (dirv/mu2/r).
//
// What bounds it on an H100: bytes.  Per launch it reads two bank rows (l
// values each, whatever H) and four (B, H l) state rows and writes one,
// plus B H l mask bytes with ACT, and B l values read (dirv) and B l
// written (r) with CONJ, and writes 3 B results, with a handful of
// operations per value.  A B = 1 launch moves under 2 MB: the launch
// itself, not the bandwidth, sets its time.
//
// Design: as bank pass A (row_wss_rows.cu, bank_pass.cuh).  Each lane
// reads rows i and j of its bank entry in place: row i of lane b starts at
// gram_i + e bank_stride + i row_stride, e = gram_idx[b], row j at gram_j
// the same way; the bank passes gram_i == gram_j with strides l l and l,
// and pre-gathered KRi and KRj (B, l), the reference's form, pass as
// gram_i and gram_j with a null gram_idx (e = b), null i_idx and j_idx,
// bank stride l and row stride 0.  A thread owns a 16-byte group of
// columns a step; its first group's state loads (G, alpha, L, U, the mask
// as packed bytes, dirv) go out before the rows' addresses are known, its
// G (and r) go back as 16-byte stores.  Per element the arithmetic is the
// reference's _update_from_rows in its order (G - mu r, then - mu2 dirv),
// so G is bitwise that of the kernel this one replaced.  G is written out
// of place; a lane with mu == 0 (and mu2 == 0) writes its G back bitwise
// unchanged (G - 0 * r - 0 * dirv == G for finite dirv), which is how the
// solver freezes converged lanes.  Global indices are h l + j, first max a
// total order on (value, index); a lane with no next-i candidate returns
// index 0 at -inf; the lane's pick and min are folded into the launch
// (lane_pick).  After hard compaction l is the bucketed row count.
// Offsets into the bank are size_t.
#include "bank_pass.cuh"

namespace repro {

template <typename T, int H, bool ACT, bool CONJ, bool VEC>
__global__ void __launch_bounds__(kBankMaxThreads)
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
                       T* __restrict__ part_v, int* __restrict__ part_i,
                       T* __restrict__ part_m,
                       unsigned* __restrict__ tickets,
                       int* __restrict__ i_out, T* __restrict__ gi_out,
                       T* __restrict__ gdn_out, T* __restrict__ r_out, int l,
                       long long bank_stride, long long row_stride) {
  constexpr int V = bank_cols<T>();
  const int lane = blockIdx.y;
  const int step = gridDim.x * blockDim.x * V;
  int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;

  T v = -pos_inf<T>();
  int vi = INT_MAX;  // columns past l lose every tie to real ones
  T m = pos_inf<T>();
  if (j0 < l) {
    vi = j0;  // a lane with no candidate picks index 0 at -inf
    int ri = i_idx != nullptr ? i_idx[lane] : 0;
    int rj = j_idx != nullptr ? j_idx[lane] : 0;
    const long long e = gram_idx != nullptr ? gram_idx[lane] : lane;
    const T mul = mu[lane];
    const T m2 = CONJ ? mu2[lane] : T(0);
    const size_t o = (size_t)lane * H * l;
    T g[H][V], al[H][V], lo_b[H][V], up_b[H][V], dv[V];
    bool in[H][V];
    // the first group's state goes out before the rows' addresses are known
    auto load_state = [&](int c) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        load_cols<T, VEC>(g[h], G + o + (size_t)h * l, c, l);
        load_cols<T, VEC>(al[h], alpha + o + (size_t)h * l, c, l);
        load_cols<T, VEC>(lo_b[h], L + o + (size_t)h * l, c, l);
        load_cols<T, VEC>(up_b[h], U + o + (size_t)h * l, c, l);
        if (ACT) load_mask<V, VEC>(in[h], act + o + (size_t)h * l, c, l);
      }
      if (CONJ) load_cols<T, VEC>(dv, dirv + (size_t)lane * l, c, l);
    };
    load_state(j0);
    if (H == 2) {
      if (ri >= l) ri -= l;
      if (rj >= l) rj -= l;
    }
    const size_t entry = (size_t)e * bank_stride;
    const T* row_i = gram_i + entry + (size_t)ri * row_stride;
    const T* row_j = gram_j + entry + (size_t)rj * row_stride;
#pragma unroll 1
    while (true) {
      T ki[V], kj[V], r[V];
      load_cols<T, VEC>(ki, row_i, j0, l);
      load_cols<T, VEC>(kj, row_j, j0, l);
#pragma unroll
      for (int u = 0; u < V; ++u) r[u] = ki[u] - kj[u];
      if (CONJ) store_cols<T, VEC>(r_out + (size_t)lane * l, r, j0, l);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        T gn[V];
#pragma unroll
        for (int u = 0; u < V; ++u) {
          T x = g[h][u] - mul * r[u];
          if (CONJ) x = x - m2 * dv[u];
          gn[u] = x;
          if (!VEC && j0 + u >= l) continue;
          const bool in_set = !ACT || in[h][u];
          if (in_set && al[h][u] < up_b[h][u])
            take_first_max(v, vi, x, h * l + j0 + u);
          if (in_set && al[h][u] > lo_b[h][u]) m = fmin(m, x);
        }
        store_cols<T, VEC>(G_out + o + (size_t)h * l, gn, j0, l);
      }
      j0 += step;
      if (j0 >= l) break;
      load_state(j0);
    }
  }
  lane_pick<T, true>(v, vi, m, part_v, part_i, part_m, tickets, gi_out,
                     i_out, gdn_out);
}

// act == nullptr selects the variants without the mask, dirv == nullptr
// those without the conjugate direction (mu2 and r_out are then unused);
// gram_idx == nullptr reads lane b's rows from entry b (pre-gathered rows).
// part_v, part_i and part_m are (B, nb_cap) scratch for the blocks a lane
// that launch_lanes picks, tickets B zeroed counters (left zeroed).
template <typename T>
int update_wss_rows(const T* gram_i, const T* gram_j,
                    const long long* gram_idx, const int* i_idx,
                    const int* j_idx, const T* G, const T* alpha, const T* L,
                    const T* U, const T* mu, const bool* act, const T* dirv,
                    const T* mu2, T* G_out, T* part_v, int* part_i,
                    T* part_m, unsigned* tickets, int* i_out, T* gi_out,
                    T* gdn_out, T* r_out, int B, int H, int l, int nb_cap,
                    long long bank_stride, long long row_stride,
                    int device, void* stream) {
  constexpr int V = bank_cols<T>();
  if (H != 1 && H != 2) return (int)cudaErrorInvalidValue;
  if (dirv != nullptr && (mu2 == nullptr || r_out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool vec = l % V == 0 && aligned16(gram_i) && aligned16(gram_j) &&
                   aligned16(G) && aligned16(alpha) && aligned16(L) &&
                   aligned16(U) && aligned16(dirv) && aligned16(G_out) &&
                   aligned16(r_out) &&
                   reinterpret_cast<std::uintptr_t>(act) % V == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(HH, A, C, W)                                          \
  return launch_lanes<T>(update_wss_rows_kernel<T, HH, A, C, W>, B, l,      \
                         nb_cap, s, gram_i, gram_j, gram_idx, i_idx, j_idx, \
                         G, alpha, L, U, mu, act, dirv, mu2, G_out, part_v, \
                         part_i, part_m, tickets, i_out, gi_out, gdn_out,   \
                         r_out, l, bank_stride, row_stride)
#define REPRO_ALIGNED(HH, A, C)                                            \
  if (vec) REPRO_LAUNCH(HH, A, C, true);                                   \
  else REPRO_LAUNCH(HH, A, C, false)
#define REPRO_MASKED(HH, C)                                                \
  if (act == nullptr) { REPRO_ALIGNED(HH, false, C); }                     \
  else { REPRO_ALIGNED(HH, true, C); }
  const bool conj = dirv != nullptr;
  if (H == 1 && !conj) { REPRO_MASKED(1, false); }
  else if (H == 1) { REPRO_MASKED(1, true); }
  else if (!conj) { REPRO_MASKED(2, false); }
  else { REPRO_MASKED(2, true); }
#undef REPRO_MASKED
#undef REPRO_ALIGNED
#undef REPRO_LAUNCH
}

}  // namespace repro

extern "C" {

int update_wss_batched_rows_f32(
    const float* gram_i, const float* gram_j, const long long* gram_idx,
    const int* i_idx, const int* j_idx, const float* G, const float* alpha,
    const float* L, const float* U, const float* mu, const bool* act,
    const float* dirv, const float* mu2, float* G_out, float* part_v,
    int* part_i, float* part_m, unsigned* tickets, int* i_out,
    float* gi_out, float* gdn_out, float* r_out, int B, int H, int l,
    int nb_cap, long long bank_stride, long long row_stride,
    int device, void* stream) {
  return repro::update_wss_rows<float>(
      gram_i, gram_j, gram_idx, i_idx, j_idx, G, alpha, L, U, mu, act, dirv,
      mu2, G_out, part_v, part_i, part_m, tickets, i_out, gi_out, gdn_out,
      r_out, B, H, l, nb_cap, bank_stride, row_stride, device, stream);
}

int update_wss_batched_rows_f64(
    const double* gram_i, const double* gram_j, const long long* gram_idx,
    const int* i_idx, const int* j_idx, const double* G,
    const double* alpha, const double* L, const double* U,
    const double* mu, const bool* act, const double* dirv,
    const double* mu2, double* G_out, double* part_v, int* part_i,
    double* part_m, unsigned* tickets, int* i_out, double* gi_out,
    double* gdn_out, double* r_out, int B, int H, int l, int nb_cap,
    long long bank_stride, long long row_stride, int device,
    void* stream) {
  return repro::update_wss_rows<double>(
      gram_i, gram_j, gram_idx, i_idx, j_idx, G, alpha, L, U, mu, act, dirv,
      mu2, G_out, part_v, part_i, part_m, tickets, i_out, gi_out, gdn_out,
      r_out, B, H, l, nb_cap, bank_stride, row_stride, device, stream);
}

}  // extern "C"
