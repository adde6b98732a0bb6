// Pass B of the fused PA-SMO iteration, lane-batched (kernel 2): the rows
// k_i and k_j of the chosen working sets, the gradient update
// G_new = G - mu (k_i - k_j), and per block the next-i first-max over
// alpha < U and the gap's other end, min G over alpha > L.  These variants:
//
//  * one state half (H = 1): both rows recomputed from X;
//  * two state halves (H = 2): the doubled e-SVR operator, the base columns
//    of both rows computed once and applied to half 0, then half 1;
//  * either of those with an active-set mask (ACT, soft shrinking): a
//    (B, H l) bool mask restricts the next-i scan and the min to the active
//    coordinates.  The update of G is never masked: G stays exact on every
//    coordinate, so a coordinate that comes back into the set needs no
//    repair;
//  * any of those four with the Conjugate-SMO direction (CONJ): a (B, l)
//    base-width row dirv, the previous direction's Q-product, and a
//    per-lane mu2 add the axpy G_new -= mu2 dirv after the mu update, and
//    the base row difference r = k_i - k_j, the next direction, is written
//    as a (B, l) output.  With H = 2 the operator is Q = [[K, K], [K, K]],
//    so one base value of dirv serves both halves.
//
// Replaces: src/repro/kernels/rbf_update_wss.py,
// rbf_update_wss_batched_pallas (_kernel_batched + _update_from_rows; H = 1
// and H = 2, with and without the active-set mask, with and without the
// conjugate direction dirv/mu2/r).  The single-lane kernel 7
// (rbf_update_wss_pallas) is in rbf_update_wss_single.cu.
//
// What bounds it on an H100: bytes.  A launch must read X once (l d
// values) for both query sets, four (B, H l) state rows and write one; the
// mask adds B H l bytes read, the direction B l values read (dirv) and
// B l written (r).  At the grid's B = 90 and d = 128 its 4 B l d
// operations take about as long on the f64 tensor cores (67 TFLOP/s) as
// the bytes at 3.35 TB/s, so the product has to run there, at the tensor
// cores' rate, while the state streams in.
//
// Design: the lane-group walk of pass A (rbf_tile.cuh), in blocks of 256
// threads, with both query sets in the ring and two accumulators per
// (lane, column), so X is read once a launch for both rows and every lane
// group.  Before a group's product the block asks the L2 for the group's
// state rows (G, alpha, L, U, the mask, dirv); the epilogue turns every
// accumulator pair into r = k_i - k_j first, then reads the state and
// writes G (and r) 16 bytes a thread, and reduces across threads last.
// No recomputed row reaches device memory except r in the conjugate
// variants, written once per base column.  G is written out of place; a
// lane with mu == 0 (and mu2 == 0) writes its G back bitwise unchanged
// (G - 0 * r - 0 * dirv == G for finite dirv), which is how the solvers
// freeze converged lanes, and a lane with mu2 == 0 writes the G of the
// variant without the direction.  Global indices are h l + j, first-max a
// total order on (value, index).  The cross-block reductions stay in
// PyTorch (repro_torch/kernels/ops.py).
#pragma once

#include "rbf_tile.cuh"

namespace repro {

template <typename T, int LG, int H, bool ACT, bool CONJ>
__global__ void __launch_bounds__(Tile<T, LG, 2>::kThreads, 1)
update_wss_tile_kernel(const T* __restrict__ XT, const T* __restrict__ sqn,
                       const T* __restrict__ G, const T* __restrict__ alpha,
                       const T* __restrict__ L, const T* __restrict__ U,
                       const T* __restrict__ XQi, const T* __restrict__ sqqi,
                       const T* __restrict__ XQj, const T* __restrict__ sqqj,
                       const T* __restrict__ mu, const T* __restrict__ gammas,
                       const bool* __restrict__ act,
                       const T* __restrict__ dirv, const T* __restrict__ mu2,
                       T* __restrict__ G_out, T* __restrict__ bmax,
                       int* __restrict__ barg, T* __restrict__ bmin,
                       T* __restrict__ r_out, int B, int l, int d, bool xvec,
                       bool vec) {
  using S = Tile<T, LG, 2>;
  constexpr int W = S::W, TM = S::TM, TN = S::TN, NV = TN / W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* red_v = smem + ring_elems<T, LG, 2>();
  T* red_m = red_v + LG * S::WC;
  int* red_i = reinterpret_cast<int*>(red_m + LG * S::WC);
  const TileThread<T, LG, 2> th;
  const int j0 = blockIdx.x * kBlockL;
  const int ncols = min(kBlockL, l - j0);
  const T* const xq[2] = {XQi, XQj};

  auto pre = [&](int g) {
    const int nl = min(LG, B - g * LG);
    const size_t r0 = (size_t)g * LG * H;
    prefetch_rows(G, r0, nl * H, l, j0, ncols);
    prefetch_rows(alpha, r0, nl * H, l, j0, ncols);
    prefetch_rows(L, r0, nl * H, l, j0, ncols);
    prefetch_rows(U, r0, nl * H, l, j0, ncols);
    if (ACT) prefetch_rows(act, r0, nl * H, l, j0, ncols);
    if (CONJ) prefetch_rows(dirv, (size_t)g * LG, nl, l, j0, ncols);
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
    // every accumulator pair to its row difference r = k_i - k_j first, so
    // no lane's loads wait for another lane's reduction
    int lc[TM];
    bool lok[TM];
    T r[TM][TN];
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      const int lane = g * LG + th.lane(u);
      lok[u] = lane < B;
      lc[u] = lok[u] ? lane : 0;
      const T gam = gammas[lc[u]], sqi = sqqi[lc[u]], sqj = sqqj[lc[u]];
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const T ki = rbf_entry(sqi, sn[n], acc[0][u][n], gam);
        const T kj = rbf_entry(sqj, sn[n], acc[1][u][n], gam);
        r[u][n] = ki - kj;
      }
    }
    T v[TM], m[TM];
    int vi[TM];
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      v[u] = -pos_inf<T>();
      vi[u] = j0 + th.col(0);  // out-of-range columns lose every tie
      m[u] = pos_inf<T>();
      const int ln = lc[u];
      const T mul = mu[ln];
      const T m2 = CONJ ? mu2[ln] : T(0);
      T dv[TN];
      if (CONJ) {
#pragma unroll
        for (int w = 0; w < NV; ++w) {
          const bool ok = lok[u] && nv[w] > 0;
          const size_t ob = ok ? (size_t)ln * l + jv[w] : 0;
          ldg<W, VEC>(dirv + ob, ok ? nv[w] : 0, dv + w * W);
          if (ok) stg<W, VEC>(r_out + ob, nv[w], r[u] + w * W);
        }
      }
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
          T gn = gv[n] - mul * r[u][n];
          if (CONJ) gn = gn - m2 * dv[n];
          gv[n] = gn;
        }
#pragma unroll
        for (int w = 0; w < NV; ++w) {
          if (lok[u] && nv[w] > 0)
            stg<W, VEC>(G_out + ((size_t)ln * H + h) * l + jv[w], nv[w],
                   gv + w * W);
        }
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          const int w = n / W, p = n % W;
          const bool on = lok[u] && p < nv[w] && (!ACT || in_set[n]);
          if (on && al[n] < up_b[n])
            take_first_max(v[u], vi[u], gv[n], h * l + jv[w] + p);
          if (on && al[n] > lo_b[n]) m[u] = fmin(m[u], gv[n]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      row_first_max<S::kMma>(v[u], vi[u]);
      row_min<S::kMma>(m[u]);
      if (th.leader()) {
        const int e = th.lane(u) * S::WC + th.wc;
        red_v[e] = v[u];
        red_i[e] = vi[u];
        red_m[e] = m[u];
      }
    }
    __syncthreads();
    const int lane = g * LG + threadIdx.x;
    if (threadIdx.x < LG && lane < B) {
      const int e = threadIdx.x * S::WC;
      T bv = red_v[e], bm = red_m[e];
      int bi = red_i[e];
#pragma unroll
      for (int w = 1; w < S::WC; ++w) {
        take_first_max(bv, bi, red_v[e + w], red_i[e + w]);
        bm = fmin(bm, red_m[e + w]);
      }
      const size_t out = (size_t)lane * gridDim.x + blockIdx.x;
      bmax[out] = bv;
      barg[out] = bi;
      bmin[out] = bm;
    }
  };

  auto epi = [&](int g, auto& acc) {
    if (vec)
      body(Bool<true>{}, g, acc);
    else
      body(Bool<false>{}, g, acc);
  };

  tile_lane_groups<T, LG, 2>(XT, xq, B, l, d, xvec, smem, pre, epi);
}

template <typename T, int LG, int H, bool ACT, bool CONJ>
int launch_update_wss_tile(const T* XT, const T* sqn, const T* G,
                           const T* alpha, const T* L, const T* U,
                           const T* XQi, const T* sqqi, const T* XQj,
                           const T* sqqj, const T* mu, const T* gammas,
                           const bool* act, const T* dirv, const T* mu2,
                           T* G_out, T* bmax, int* barg, T* bmin, T* r_out,
                           int B, int l, int d, int device, cudaStream_t s) {
  static std::atomic<bool> ready[kMaxDevices];
  constexpr size_t smem = tile_smem_bytes<T, LG, 2>();
  auto kern = update_wss_tile_kernel<T, LG, H, ACT, CONJ>;
  cudaError_t err = allow_smem(kern, smem, ready, device);
  if (err != cudaSuccess) return (int)err;
  constexpr int kVec = Tile<T, LG, 2>::kVec;
  const bool xvec = l % kVec == 0 && aligned16(XT);
  const bool vec = l % kVec == 0 && aligned16(sqn) && aligned16(G) &&
                   aligned16(alpha) && aligned16(L) && aligned16(U) &&
                   aligned16(G_out) && (!ACT || aligned16(act)) &&
                   (!CONJ || (aligned16(dirv) && aligned16(r_out)));
  kern<<<n_blocks(l), Tile<T, LG, 2>::kThreads, smem, s>>>(
      XT, sqn, G, alpha, L, U, XQi, sqqi, XQj, sqqj, mu, gammas, act, dirv,
      mu2, G_out, bmax, barg, bmin, r_out, B, l, d, xvec, vec);
  return (int)cudaGetLastError();
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
  if (dirv != nullptr && (mu2 == nullptr || r_out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_variant<T>(B, H, act != nullptr, dirv != nullptr,
                          [&](auto lg, auto h, auto m, auto c) {
    return launch_update_wss_tile<T, decltype(lg)::value, decltype(h)::value,
                                  decltype(m)::value, decltype(c)::value>(
        XT, sqn, G, alpha, L, U, XQi, sqqi, XQj, sqqj, mu, gammas, act, dirv,
        mu2, G_out, bmax, barg, bmin, r_out, B, l, d, device, s);
  });
}

template <typename T>
int update_wss_attrs(int B, int H, bool masked, bool conj, int* out) {
  return dispatch_variant<T>(B, H, masked, conj,
                          [&](auto lg, auto h, auto m, auto c) {
    constexpr int LG = decltype(lg)::value;
    return tile_attrs(update_wss_tile_kernel<T, LG, decltype(h)::value,
                                             decltype(m)::value,
                                             decltype(c)::value>,
                      tile_smem_bytes<T, LG, 2>(), out);
  });
}

}  // namespace repro
