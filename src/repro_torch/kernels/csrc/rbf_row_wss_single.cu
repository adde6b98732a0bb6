// Kernel 6, single-lane pass A of the fused PA-SMO iteration: the RBF
// kernel row of the working-set point i, stored to device memory for pass
// B and the O(1) step algebra, fused with the WSS2 second-order choice of
// j, reduced to one (max, argmax) per 128-column segment.  An optional
// device flag `run` turns a launch into a no-op that leaves the stored row
// as it was (Alg. 3's relaunch for the B^(t-2) candidate, decided on the
// card without a host sync).
//
// Replaces: src/repro/kernels/rbf_row_wss.py, rbf_row_wss_pallas
// (_kernel).
//
// What bounds it on an H100: bytes.  It moves l d + 6 l values (X once,
// sqn and four state vectors in, the stored row out); its 2 l d
// operations take a fortieth of that time.
//
// What held it back: one thread a column in 128-thread blocks, each
// thread walking its column of XT four loads at a time, so an SM had at
// most 4 KB of X in flight (2 KB in f32) where streaming at the card's
// rate needs some 16-25 KB: 24% of the bound at l = 16384, d = 128.
//
// Design (rbf_single.cuh): one 256-thread block a segment asks for X
// through a cp.async ring of 64 KB (two 32-feature stages in f64, four in
// f32), all of it in flight from the start, with the query slice beside
// each stage and the segment's sqn, G, alpha, L and U in the first commit
// group; the d-sum is split over two halves of the block and combined once
// in a fixed order.
// The epilogue (one thread a column) stores the row, computes the gains
// and reduces to the segment's first max.  A false `run` returns before
// any copy or barrier, uniformly over the block.  Global indices are j;
// first-max is a total order on (value, index).  What holds it now (see
// PERF.md) is not the bytes in flight, whose ablation stops paying at 64
// KB a block, but the fixed cost of a launch and the rate at which one
// block an SM streams X.

#include "rbf_single.cuh"

namespace repro {

template <typename T, bool VEC>
__global__ void __launch_bounds__(kSingleThreads, 1)
row_wss_single_kernel(const T* __restrict__ XT, const T* __restrict__ sqn,
                      const T* __restrict__ G, const T* __restrict__ alpha,
                      const T* __restrict__ L, const T* __restrict__ U,
                      const T* __restrict__ xq, const T* __restrict__ sqq,
                      const T* __restrict__ a_i, const T* __restrict__ L_i,
                      const T* __restrict__ U_i, const T* __restrict__ g_i,
                      const int* __restrict__ i_idx,
                      const bool* __restrict__ use_exact,
                      const T* __restrict__ gamma,
                      const bool* __restrict__ run, T* __restrict__ k_out,
                      T* __restrict__ bmax, int* __restrict__ barg, int l,
                      int d) {
  // a relaunch whose flag is false does nothing (uniform over the block,
  // before any copy or barrier): the stored row stays as it was
  if (run != nullptr && !*run) return;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red_v[kWarps];
  __shared__ int red_i[kWarps];
  const SingleSegment<T, VEC> seg(reinterpret_cast<T*>(smem_raw), l, d);
  enum { SQN, GV, AL, LO, UP };
  seg.stage(SQN, sqn);
  seg.stage(GV, G);
  seg.stage(AL, alpha);
  seg.stage(LO, L);
  seg.stage(UP, U);
  // the lane's scalars, asked for before the stream so they arrive with it
  const T sq = *sqq, gam = *gamma, ai = *a_i, li = *L_i, ui = *U_i,
          gi = *g_i;
  const int ii = *i_idx;
  const bool exact = *use_exact;
  const T prod = seg.run(XT, xq);

  const int tid = threadIdx.x;
  if (tid >= kBlockL) return;  // no barrier follows for the other parts
  const int j = seg.j0 + tid;
  T v = -pos_inf<T>();
  int vi = j;  // out-of-range columns lose every tie to real ones
  if (j < l) {
    const T k = rbf_entry(sq, seg.state(SQN), prod, gam);
    k_out[j] = k;
    const T q = fmax(T(2) - T(2) * k, T(kTau));  // RBF diag == 1
    const T al = seg.state(AL), lo_b = seg.state(LO), up_b = seg.state(UP);
    const T lv = gi - seg.state(GV);
    T gain;
    if (exact) {
      const T lo = fmax(li - ai, al - up_b);
      const T hi = fmin(ui - ai, al - lo_b);
      const T mu = fmin(fmax(lv / q, lo), hi);
      gain = lv * mu - T(0.5) * q * mu * mu;
    } else {
      gain = T(0.5) * lv * lv / q;
    }
    if (al > lo_b && lv > T(0) && j != ii) v = gain;
  }
  warp_first_max(v, vi);
  if ((tid & 31) == 0) {
    red_v[tid >> 5] = v;
    red_i[tid >> 5] = vi;
  }
  // the first kWarps warps only: the block's other parts have returned
  asm volatile("bar.sync 1, %0;" ::"n"(kBlockL) : "memory");
  if (tid == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      take_first_max(v, vi, red_v[w], red_i[w]);
    bmax[blockIdx.x] = v;
    barg[blockIdx.x] = vi;
  }
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
  static std::atomic<bool> ready[2][kMaxDevices];
  return launch_single<T>(row_wss_single_kernel<T, true>,
                          row_wss_single_kernel<T, false>, ready, XT, l,
                          device, static_cast<cudaStream_t>(stream), XT, sqn,
                          G, alpha, L, U, xq, sqq, a_i, L_i, U_i, g_i, i_idx,
                          use_exact, gamma, run, k_out, bmax, barg, l, d);
}

template <typename T>
int row_wss_single_attrs(int* out) {
  return tile_attrs(row_wss_single_kernel<T, true>, single_smem_bytes<T>(),
                    out);
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

// Resources of the variant the main path launches (16-byte copies of X):
// out = {registers a thread, local bytes a thread (spills included),
// static shared bytes, dynamic shared bytes}.
int rbf_row_wss_attrs_f32(int* out) {
  return repro::row_wss_single_attrs<float>(out);
}

int rbf_row_wss_attrs_f64(int* out) {
  return repro::row_wss_single_attrs<double>(out);
}

}  // extern "C"
