// Pass A of the fused PA-SMO iteration, lane-batched (kernel 1): RBF
// kernel rows of the working-set points i fused with the WSS2 second-order
// choice of j, reduced to a per-block (max, argmax).  These variants:
//
//  * one state half (H = 1): the SVC and grid lanes;
//  * two state halves (H = 2): the doubled e-SVR operator, whose 2l
//    coordinates share the l base rows (row k is the base row of k mod l),
//    so each base column is computed once and applied to half 0, then
//    half 1;
//  * either of those with an active-set mask (ACT, soft shrinking): a
//    (B, H l) bool mask takes a masked coordinate out of the j-candidates;
//    nothing else changes, so a lane whose mask is all false returns index
//    0 and -inf like an all-masked lane.
//
// Replaces: src/repro/kernels/rbf_row_wss.py, rbf_row_wss_batched_pallas
// (_kernel_batched + _select_from_k; H = 1 and H = 2, with and without the
// active-set mask).  The single-lane kernel 6 (rbf_row_wss_pallas) is in
// rbf_row_wss_single.cu.
//
// What bounds it on an H100: bytes.  A launch must read X once (l d
// values), four (B, H l) state rows (and the B H l mask bytes), and the B
// query rows; at the grid's B = 90 and d = 128 its 2 B l d operations take
// about half as long on the f64 tensor cores (67 TFLOP/s) as the bytes at
// 3.35 TB/s.
//
// Design (rbf_tile.cuh): one block of 512 threads (f32: 256) per
// 128-column block of l walks every lane group (8-32 lanes, 4-32 in f32),
// so X reaches shared memory once a launch through a cp.async ring
// (resident for every group at d <= 128 in f64 and d <= 256 in f32,
// streamed again from the L2 per group beyond).  The distances' product
// runs on the f64 tensor cores (f32: a CUDA-core micro-tile of up to 4
// lanes x 4 columns a thread).
// Before a group's product the block asks the L2 for the group's state
// rows; the epilogue turns every accumulator into its curvature first,
// then loads G, alpha, L, U (and the mask) for all of its columns in
// 16-byte vectors and reduces across threads last.  Only (B, nb) pairs
// reach device memory.  Global indices are h l + j; first-max is a total
// order on (value, index), so half 0 wins a tie against half 1 and the
// lower index wins within a half, whatever the reduction order.  The
// cross-block first-max stays in PyTorch (repro_torch/kernels/ops.py), as
// the reference keeps it outside its kernel.
#pragma once

#include "rbf_tile.cuh"

namespace repro {

template <typename T, int LG, int H, bool ACT>
__global__ void __launch_bounds__(Tile<T, LG, 1>::kThreads, 1)
row_wss_tile_kernel(const T* __restrict__ XT, const T* __restrict__ sqn,
                    const T* __restrict__ G, const T* __restrict__ alpha,
                    const T* __restrict__ L, const T* __restrict__ U,
                    const T* __restrict__ XQ, const T* __restrict__ sqq,
                    const T* __restrict__ a_i, const T* __restrict__ L_i,
                    const T* __restrict__ U_i, const T* __restrict__ g_i,
                    const int* __restrict__ i_idx,
                    const bool* __restrict__ use_exact,
                    const T* __restrict__ gammas,
                    const bool* __restrict__ act, T* __restrict__ bmax,
                    int* __restrict__ barg, int B, int l, int d, bool xvec,
                    bool vec) {
  using S = Tile<T, LG, 1>;
  constexpr int W = S::W, TM = S::TM, TN = S::TN, NV = TN / W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* red_v = smem + ring_elems<T, LG, 1>();
  int* red_i = reinterpret_cast<int*>(red_v + LG * S::WC);
  const TileThread<T, LG, 1> th;
  const int j0 = blockIdx.x * kBlockL;
  const int ncols = min(kBlockL, l - j0);
  const T* const xq[1] = {XQ};

  auto pre = [&](int g) {
    const size_t r0 = (size_t)g * LG * H;
    const int rows = (min(LG, B - g * LG)) * H;
    prefetch_rows(G, r0, rows, l, j0, ncols);
    prefetch_rows(alpha, r0, rows, l, j0, ncols);
    prefetch_rows(L, r0, rows, l, j0, ncols);
    prefetch_rows(U, r0, rows, l, j0, ncols);
    if (ACT) prefetch_rows(act, r0, rows, l, j0, ncols);
  };

  auto body = [&](auto vec_c, int g, auto& acc) {
    constexpr bool VEC = decltype(vec_c)::value;
    // the thread's column vectors: first column, valid columns (<= 0 past
    // l), and sqn there
    int jv[NV], nv[NV];
    T sn[TN];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      jv[v] = j0 + th.col(v * W);
      nv[v] = l - jv[v];
      ldg<W, VEC>(sqn + (nv[v] > 0 ? jv[v] : 0), nv[v], sn + v * W);
    }
    // every accumulator to its curvature q = max(2 - 2 k, tau) first, so
    // no lane's loads wait for another lane's reduction
    const T tau = T(kTau);
    int lc[TM];
    bool lok[TM];
    T q[TM][TN];
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      const int lane = g * LG + th.lane(u);
      lok[u] = lane < B;
      lc[u] = lok[u] ? lane : 0;
      const T sq = sqq[lc[u]], gam = gammas[lc[u]];
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const T k = rbf_entry(sq, sn[n], acc[0][u][n], gam);
        q[u][n] = fmax(T(2) - T(2) * k, tau);  // RBF diag == 1
      }
    }
    T v[TM];
    int vi[TM];
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      v[u] = -pos_inf<T>();
      vi[u] = j0 + th.col(0);  // out-of-range columns lose every tie
      const int ln = lc[u];
      const T ai = a_i[ln], gi = g_i[ln], li = L_i[ln], ui = U_i[ln];
      const bool exact = use_exact[ln];
      const int ii = i_idx[ln];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        T gv[TN], al[TN], lo_b[TN], up_b[TN];
        bool in_set[TN];
#pragma unroll
        for (int w = 0; w < NV; ++w) {
          const bool ok = lok[u] && nv[w] > 0;
          const size_t o = ok ? ((size_t)ln * H + h) * l + jv[w] : 0;
          const int n = ok ? nv[w] : 0;
          ldg<W, VEC>(G + o, n, gv + w * W);
          ldg<W, VEC>(alpha + o, n, al + w * W);
          ldg<W, VEC>(L + o, n, lo_b + w * W);
          ldg<W, VEC>(U + o, n, up_b + w * W);
          if (ACT) ldg_mask<W, VEC>(act + o, n, in_set + w * W);
        }
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          const int w = n / W, p = n % W;
          const int gj = h * l + jv[w] + p;
          const T lv = gi - gv[n];
          T gain;
          if (exact) {
            const T lo = fmax(li - ai, al[n] - up_b[n]);
            const T hi = fmin(ui - ai, al[n] - lo_b[n]);
            const T mu = fmin(fmax(lv / q[u][n], lo), hi);
            gain = lv * mu - T(0.5) * q[u][n] * mu * mu;
          } else {
            gain = T(0.5) * lv * lv / q[u][n];
          }
          const bool ok = lok[u] && p < nv[w] && al[n] > lo_b[n] &&
                          lv > T(0) && gj != ii && (!ACT || in_set[n]);
          take_first_max(v[u], vi[u], ok ? gain : -pos_inf<T>(), gj);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      row_first_max<S::kMma>(v[u], vi[u]);
      if (th.leader()) {
        red_v[th.lane(u) * S::WC + th.wc] = v[u];
        red_i[th.lane(u) * S::WC + th.wc] = vi[u];
      }
    }
    __syncthreads();
    const int lane = g * LG + threadIdx.x;
    if (threadIdx.x < LG && lane < B) {
      const int e = threadIdx.x * S::WC;
      T bv = red_v[e];
      int bi = red_i[e];
#pragma unroll
      for (int w = 1; w < S::WC; ++w)
        take_first_max(bv, bi, red_v[e + w], red_i[e + w]);
      const size_t out = (size_t)lane * gridDim.x + blockIdx.x;
      bmax[out] = bv;
      barg[out] = bi;
    }
  };

  auto epi = [&](int g, auto& acc) {
    if (vec)
      body(Bool<true>{}, g, acc);
    else
      body(Bool<false>{}, g, acc);
  };

  tile_lane_groups<T, LG, 1>(XT, xq, B, l, d, xvec, smem, pre, epi);
}

template <typename T, int LG, int H, bool ACT>
int launch_row_wss_tile(const T* XT, const T* sqn, const T* G,
                        const T* alpha, const T* L, const T* U, const T* XQ,
                        const T* sqq, const T* a_i, const T* L_i,
                        const T* U_i, const T* g_i, const int* i_idx,
                        const bool* use_exact, const T* gammas,
                        const bool* act, T* bmax, int* barg, int B, int l,
                        int d, int device, cudaStream_t s) {
  static std::atomic<bool> ready[kMaxDevices];
  constexpr size_t smem = tile_smem_bytes<T, LG, 1>();
  auto kern = row_wss_tile_kernel<T, LG, H, ACT>;
  cudaError_t err = allow_smem(kern, smem, ready, device);
  if (err != cudaSuccess) return (int)err;
  constexpr int kVec = Tile<T, LG, 1>::kVec;
  const bool xvec = l % kVec == 0 && aligned16(XT);
  const bool vec = l % kVec == 0 && aligned16(sqn) && aligned16(G) &&
                   aligned16(alpha) && aligned16(L) && aligned16(U) &&
                   (act == nullptr || aligned16(act));
  kern<<<n_blocks(l), Tile<T, LG, 1>::kThreads, smem, s>>>(
      XT, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i, g_i, i_idx,
      use_exact, gammas, act, bmax, barg, B, l, d, xvec, vec);
  return (int)cudaGetLastError();
}

// act == nullptr selects the variants without the mask.
template <typename T>
int row_wss(const T* XT, const T* sqn, const T* G, const T* alpha,
            const T* L, const T* U, const T* XQ, const T* sqq, const T* a_i,
            const T* L_i, const T* U_i, const T* g_i, const int* i_idx,
            const bool* use_exact, const T* gammas, const bool* act,
            T* bmax, int* barg, int B, int H, int l, int d, int device,
            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_variant<T>(B, H, act != nullptr, false,
                          [&](auto lg, auto h, auto m, auto) {
    return launch_row_wss_tile<T, decltype(lg)::value, decltype(h)::value,
                               decltype(m)::value>(
        XT, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i, U_i, g_i, i_idx,
        use_exact, gammas, act, bmax, barg, B, l, d, device, s);
  });
}

template <typename T>
int row_wss_attrs(int B, int H, bool masked, int* out) {
  return dispatch_variant<T>(B, H, masked, false,
                          [&](auto lg, auto h, auto m, auto) {
    constexpr int LG = decltype(lg)::value;
    return tile_attrs(
        row_wss_tile_kernel<T, LG, decltype(h)::value, decltype(m)::value>,
        tile_smem_bytes<T, LG, 1>(), out);
  });
}

}  // namespace repro
