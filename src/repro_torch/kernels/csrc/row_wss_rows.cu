// Pass A of the fused PA-SMO iteration over the Gram bank, lane-batched:
// the WSS2 second-order choice of j from the bank row of each lane's
// working-set point i, returned as the lane's (j, gain).  One kernel, four
// variants:
//
//  * one state half (H = 1): the (C, gamma) and one-class grids;
//  * two state halves (H = 2): the doubled e-SVR operator.  Its 2l
//    coordinates share the l base rows (row k is the base row of k mod l),
//    so lane b reads gram[gram_idx[b], i mod l, :] and applies each base
//    column j to half 0 (coordinate j) and half 1 (coordinate l + j);
//  * either of those with an active-set mask (ACT, soft shrinking): a
//    (B, H l) bool mask takes a masked coordinate out of the
//    j-candidates; a lane whose mask is all false returns index 0 and
//    -inf.
//
// Replaces: src/repro/kernels/rbf_row_wss.py, row_wss_batched_rows_pallas
// (_kernel_batched_rows + _select_from_k) and the cross-block argmax after
// it: H = 1 and H = 2, with and without the active-set mask; no conjugate
// direction.
//
// What bounds it on an H100: bytes.  Per launch it reads B bank rows (l
// values each, whatever H) and four (B, H l) state rows, plus B H l mask
// bytes with ACT, and writes B results; about 20 operations per value
// read, far below the card's operations per byte.  At B = 18 (H = 2) and
// B = 1 the bytes take a few microseconds, so the launch, the latency of
// the index-dependent row load and the cross-block pick weigh as much as
// the bandwidth.
//
// Design: each lane reads its row gram[gram_idx[b], i_idx[b], :] in place
// (no gather launch), at e bank_stride + i row_stride, e = gram_idx[b]:
// the bank is (n_stack, l, l) with strides l l and l, and pre-gathered
// rows KR (B, l), the reference's form, are a bank with a null gram_idx
// (e = b), bank stride l and row stride 0.  A thread owns a 16-byte group
// of columns a step (bank_pass.cuh): it issues its first group's state
// loads (G, alpha, L, U, the mask as packed bytes) before the row's
// address is known, so they are in flight while i_idx and gram_idx come
// back, then the row load; the grid is one wave of blocks striding over
// their lane's columns, 128 threads wide down to 32 on small grids, so a
// B = 1 launch still spreads over every SM.  The gain is computed per
// element exactly as the reference's _select_from_k orders it (and as the
// kernel this one replaced did, so picks and gains are bitwise its);
// global indices are h l + j, and first max on (value, index) is a total
// order, so half 0 wins a tie against half 1 and the lower index within a
// half.  The lane's pick is folded into the launch (lane_pick): no
// reduction launch follows.  After hard compaction l is the bucketed row
// count, and the half offset is that l.  Bank offsets are size_t:
// (n_stack, l, l) passes 2^31 values at l = 16384 with 8 entries.
#include "bank_pass.cuh"

namespace repro {

template <typename T, int H, bool ACT, bool VEC>
__global__ void __launch_bounds__(kBankMaxThreads)
row_wss_rows_kernel(const T* __restrict__ gram,
                    const long long* __restrict__ gram_idx,
                    const T* __restrict__ G, const T* __restrict__ alpha,
                    const T* __restrict__ L, const T* __restrict__ U,
                    const T* __restrict__ a_i, const T* __restrict__ L_i,
                    const T* __restrict__ U_i, const T* __restrict__ g_i,
                    const int* __restrict__ i_idx,
                    const bool* __restrict__ use_exact,
                    const bool* __restrict__ act, T* __restrict__ part_v,
                    int* __restrict__ part_i,
                    unsigned* __restrict__ tickets, int* __restrict__ j_out,
                    T* __restrict__ gain_out, int l, long long bank_stride,
                    long long row_stride) {
  constexpr int V = bank_cols<T>();
  const int lane = blockIdx.y;
  const int step = gridDim.x * blockDim.x * V;
  int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;

  T v = -pos_inf<T>();
  int vi = INT_MAX;  // columns past l lose every tie to real ones
  if (j0 < l) {
    const int i = i_idx[lane];
    const long long e = gram_idx != nullptr ? gram_idx[lane] : lane;
    const T ai = a_i[lane], gi = g_i[lane];
    const T li = L_i[lane], ui = U_i[lane];
    const bool exact = use_exact[lane];
    const size_t o = (size_t)lane * H * l;
    T al[H][V], lo_b[H][V], up_b[H][V], g[H][V];
    bool in[H][V];
    // the first group's state goes out before the row's address is known
    auto load_state = [&](int c) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        load_cols<T, VEC>(g[h], G + o + (size_t)h * l, c, l);
        load_cols<T, VEC>(al[h], alpha + o + (size_t)h * l, c, l);
        load_cols<T, VEC>(lo_b[h], L + o + (size_t)h * l, c, l);
        load_cols<T, VEC>(up_b[h], U + o + (size_t)h * l, c, l);
        if (ACT) load_mask<V, VEC>(in[h], act + o + (size_t)h * l, c, l);
      }
    };
    load_state(j0);
    const int ib = (H == 2 && i >= l) ? i - l : i;
    const T* row = gram + (size_t)e * bank_stride + (size_t)ib * row_stride;
#pragma unroll 1
    while (true) {
      T k[V];
      load_cols<T, VEC>(k, row, j0, l);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int j = j0 + u;
        if (!VEC && j >= l) break;
        const T q = fmax(T(2) - T(2) * k[u], T(kTau));  // RBF diag == 1
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int gj = h * l + j;
          const T lv = gi - g[h][u];
          T gain;
          if (exact) {
            const T lo = fmax(li - ai, al[h][u] - up_b[h][u]);
            const T hi = fmin(ui - ai, al[h][u] - lo_b[h][u]);
            const T mu = fmin(fmax(lv / q, lo), hi);
            gain = lv * mu - T(0.5) * q * mu * mu;
          } else {
            gain = T(0.5) * lv * lv / q;
          }
          const bool ok = al[h][u] > lo_b[h][u] && lv > T(0) && gj != i &&
                          (!ACT || in[h][u]);
          take_first_max(v, vi, ok ? gain : -pos_inf<T>(), gj);
        }
      }
      j0 += step;
      if (j0 >= l) break;
      load_state(j0);
    }
  }
  lane_pick<T, false>(v, vi, T(0), part_v, part_i, nullptr, tickets,
                      gain_out, j_out, nullptr);
}

// act == nullptr selects the variants without the mask; gram_idx ==
// nullptr reads lane b's row from entry b (pre-gathered rows).  part_v and
// part_i are (B, nb_cap) scratch for the blocks a lane that launch_lanes
// picks, tickets B zeroed counters (left zeroed).
template <typename T>
int row_wss_rows(const T* gram, const long long* gram_idx, const T* G,
                 const T* alpha, const T* L, const T* U, const T* a_i,
                 const T* L_i, const T* U_i, const T* g_i, const int* i_idx,
                 const bool* use_exact, const bool* act, T* part_v,
                 int* part_i, unsigned* tickets, int* j_out, T* gain_out,
                 int B, int H, int l, int nb_cap,
                 long long bank_stride, long long row_stride, int device,
                 void* stream) {
  constexpr int V = bank_cols<T>();
  if (H != 1 && H != 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool vec = l % V == 0 && aligned16(gram) && aligned16(G) &&
                   aligned16(alpha) && aligned16(L) && aligned16(U) &&
                   reinterpret_cast<std::uintptr_t>(act) % V == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(HH, A, W)                                             \
  return launch_lanes<T>(row_wss_rows_kernel<T, HH, A, W>, B, l, nb_cap,    \
                         s, gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i,  \
                         g_i, i_idx, use_exact, act, part_v, part_i,        \
                         tickets, j_out, gain_out, l, bank_stride,          \
                         row_stride)
#define REPRO_ALIGNED(HH, A)                                               \
  if (vec) REPRO_LAUNCH(HH, A, true);                                      \
  else REPRO_LAUNCH(HH, A, false)
  if (H == 1 && act == nullptr) { REPRO_ALIGNED(1, false); }
  else if (H == 1) { REPRO_ALIGNED(1, true); }
  else if (act == nullptr) { REPRO_ALIGNED(2, false); }
  else { REPRO_ALIGNED(2, true); }
#undef REPRO_ALIGNED
#undef REPRO_LAUNCH
}

}  // namespace repro

extern "C" {

int row_wss_batched_rows_f32(const float* gram, const long long* gram_idx,
                             const float* G, const float* alpha,
                             const float* L, const float* U,
                             const float* a_i, const float* L_i,
                             const float* U_i, const float* g_i,
                             const int* i_idx, const bool* use_exact,
                             const bool* act, float* part_v, int* part_i,
                             unsigned* tickets, int* j_out, float* gain_out,
                             int B, int H, int l, int nb_cap,
                             long long bank_stride, long long row_stride,
                             int device, void* stream) {
  return repro::row_wss_rows<float>(
      gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i, g_i, i_idx, use_exact,
      act, part_v, part_i, tickets, j_out, gain_out, B, H, l, nb_cap,
      bank_stride, row_stride, device, stream);
}

int row_wss_batched_rows_f64(const double* gram, const long long* gram_idx,
                             const double* G, const double* alpha,
                             const double* L, const double* U,
                             const double* a_i, const double* L_i,
                             const double* U_i, const double* g_i,
                             const int* i_idx, const bool* use_exact,
                             const bool* act, double* part_v, int* part_i,
                             unsigned* tickets, int* j_out,
                             double* gain_out, int B, int H, int l,
                             int nb_cap, long long bank_stride,
                             long long row_stride, int device,
                             void* stream) {
  return repro::row_wss_rows<double>(
      gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i, g_i, i_idx, use_exact,
      act, part_v, part_i, tickets, j_out, gain_out, B, H, l, nb_cap,
      bank_stride, row_stride, device, stream);
}

}  // extern "C"
