// Pass A of the fused PA-SMO iteration over the Gram bank, lane-batched:
// the WSS2 second-order choice of j from the bank row of each lane's
// working-set point i, reduced to a per-block (max, first argmax).  One
// kernel, four variants:
//
//  * one state half (H = 1): the (C, gamma) and one-class grids;
//  * two state halves (H = 2): the doubled e-SVR operator.  Its 2l
//    coordinates share the l base rows (row k is the base row of k mod l),
//    so lane b reads gram[gram_idx[b], i mod l, :] and each thread applies
//    its base column j once to half 0 (coordinate j), then to half 1
//    (coordinate l + j);
//  * either of those with an active-set mask (ACT, soft shrinking): a
//    (B, H l) bool mask, read per coordinate, takes a masked coordinate
//    out of the j-candidates; a lane whose mask is all false returns
//    index 0 and -inf.
//
// Replaces: src/repro/kernels/rbf_row_wss.py, row_wss_batched_rows_pallas
// (_kernel_batched_rows + _select_from_k): H = 1 and H = 2, with and
// without the active-set mask; no conjugate direction.
//
// What bounds it on an H100: bytes.  Per launch it reads B bank rows (l
// values each, whatever H) and four (B, H l) state rows, plus B H l mask
// bytes with ACT, and does about 20 operations per value read: far below
// the card's operations per byte.
//
// Design: the Pallas kernel takes the rows pre-gathered into a (B, l)
// block; here each lane reads its row gram[gram_idx[b], i_idx[b], :] in
// place, which saves the gather launch and 2 B l values of traffic per
// iteration.  The row of lane b starts at e bank_stride + i row_stride,
// e = gram_idx[b]: the bank is (n_stack, l, l) with strides l l and l.
// Pre-gathered rows KR (B, l), the reference's form, are a bank with a
// null gram_idx (e = b), bank stride l and row stride 0.  Lanes go along
// gridDim.y, one thread owns one base column, and neighbouring threads
// read neighbouring columns of every row (coalesced).  The gain, the mask and the block's first-max reduction
// stay in registers and shared memory; only (B, nb) pairs reach device
// memory.  Global indices are h l + j; first-max is a total order on
// (value, index), so half 0 wins a tie against half 1 and the lower index
// wins within a half.  After hard compaction l is the bucketed row count,
// and the half offset is that l.  The bank offset is computed in size_t:
// (n_stack, l, l) passes 2^31 values at l = 16384 with 8 entries.  The
// cross-block first-max stays in PyTorch (repro_torch/kernels/ops.py).
#include "common.cuh"

namespace repro {

template <typename T, int H, bool ACT>
__global__ void __launch_bounds__(kBlockL)
row_wss_rows_kernel(const T* __restrict__ gram,
                    const long long* __restrict__ gram_idx,
                    const T* __restrict__ G, const T* __restrict__ alpha,
                    const T* __restrict__ L, const T* __restrict__ U,
                    const T* __restrict__ a_i, const T* __restrict__ L_i,
                    const T* __restrict__ U_i, const T* __restrict__ g_i,
                    const int* __restrict__ i_idx,
                    const bool* __restrict__ use_exact,
                    const bool* __restrict__ act, T* __restrict__ bmax,
                    int* __restrict__ barg, int l, long long bank_stride,
                    long long row_stride) {
  __shared__ T red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int tid = threadIdx.x;
  const int j = blockIdx.x * kBlockL + tid;
  const int lane = blockIdx.y;

  T v = -pos_inf<T>();
  int vi = j;  // out-of-range columns lose every tie to real ones
  if (j < l) {
    const int i = i_idx[lane];
    const int ib = (H == 2 && i >= l) ? i - l : i;
    const long long e = gram_idx != nullptr ? gram_idx[lane] : lane;
    const size_t row = (size_t)e * bank_stride + (size_t)ib * row_stride;
    const T k = gram[row + j];
    const T q = fmax(T(2) - T(2) * k, T(kTau));  // RBF diag == 1
    const T ai = a_i[lane], gi = g_i[lane];
    const bool exact = use_exact[lane];
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
      const bool ok = al > lo_b && lv > T(0) && gj != i && (!ACT || act[o]);
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

// act == nullptr selects the variants without the mask; gram_idx ==
// nullptr reads lane b's row from entry b (pre-gathered rows).
template <typename T>
int row_wss_rows(const T* gram, const long long* gram_idx, const T* G,
                 const T* alpha, const T* L, const T* U, const T* a_i,
                 const T* L_i, const T* U_i, const T* g_i, const int* i_idx,
                 const bool* use_exact, const bool* act, T* bmax, int* barg,
                 int B, int H, int l, long long bank_stride,
                 long long row_stride, int device, void* stream) {
  if (H != 1 && H != 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_blocks(l), B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(HH, A)                                               \
  row_wss_rows_kernel<T, HH, A><<<grid, kBlockL, 0, s>>>(                 \
      gram, gram_idx, G, alpha, L, U, a_i, L_i, U_i, g_i, i_idx,          \
      use_exact, act, bmax, barg, l, bank_stride, row_stride)
  if (H == 1 && act == nullptr) REPRO_LAUNCH(1, false);
  else if (H == 1) REPRO_LAUNCH(1, true);
  else if (act == nullptr) REPRO_LAUNCH(2, false);
  else REPRO_LAUNCH(2, true);
#undef REPRO_LAUNCH
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
                             const bool* act, float* bmax, int* barg, int B,
                             int H, int l, long long bank_stride,
                             long long row_stride, int device,
                             void* stream) {
  return repro::row_wss_rows<float>(gram, gram_idx, G, alpha, L, U, a_i,
                                    L_i, U_i, g_i, i_idx, use_exact, act,
                                    bmax, barg, B, H, l, bank_stride,
                                    row_stride, device, stream);
}

int row_wss_batched_rows_f64(const double* gram, const long long* gram_idx,
                             const double* G, const double* alpha,
                             const double* L, const double* U,
                             const double* a_i, const double* L_i,
                             const double* U_i, const double* g_i,
                             const int* i_idx, const bool* use_exact,
                             const bool* act, double* bmax, int* barg, int B,
                             int H, int l, long long bank_stride,
                             long long row_stride, int device,
                             void* stream) {
  return repro::row_wss_rows<double>(gram, gram_idx, G, alpha, L, U, a_i,
                                     L_i, U_i, g_i, i_idx, use_exact, act,
                                     bmax, barg, B, H, l, bank_stride,
                                     row_stride, device, stream);
}

}  // extern "C"
