// Kernel 7, single-lane pass B of the fused PA-SMO iteration: k_i read
// from the row kernel 6 stored, k_j recomputed from X, the gradient update
// G_new = G - mu (k_i - k_j), and per 128-column segment the next-i
// first-max over alpha < U and the gap's other end, min G over alpha > L.
//
// Replaces: src/repro/kernels/rbf_update_wss.py, rbf_update_wss_pallas
// (_kernel).
//
// What bounds it on an H100: bytes.  It moves l d + 7 l values (X once,
// sqn, G, k_i and three state vectors in, G out); its 2 l d operations
// take a fortieth of that time.
//
// What held it back: as kernel 6 (rbf_row_wss_single.cu), one thread a
// column with at most 4 KB of X in flight on an SM (2 KB in f32): 24% of
// the bound at l = 16384, d = 128.
//
// Design (rbf_single.cuh): kernel 6's X stream, a cp.async ring of 64 KB
// (two 32-feature stages in f64, four in f32), with the query row of j
// beside each stage and the segment's sqn, G, k_i, alpha, L and U in the
// first commit group; the d-sum split over two halves of the block and
// combined once in a fixed order.  The epilogue (one thread a
// column) writes G out of place (mu == 0 writes it back bitwise unchanged)
// and reduces to the segment's first max and min.  The cross-segment
// reductions stay in PyTorch (repro_torch/kernels/ops.py).  What holds it
// now is kernel 6's: the fixed cost of a launch and the rate at which one
// block an SM streams X (PERF.md).

#include "rbf_single.cuh"

namespace repro {

template <typename T, bool VEC>
__global__ void __launch_bounds__(kSingleThreads, 1)
update_wss_single_kernel(const T* __restrict__ XT,
                         const T* __restrict__ sqn, const T* __restrict__ G,
                         const T* __restrict__ k_i,
                         const T* __restrict__ alpha,
                         const T* __restrict__ L, const T* __restrict__ U,
                         const T* __restrict__ xqj,
                         const T* __restrict__ sqqj,
                         const T* __restrict__ mu,
                         const T* __restrict__ gamma, T* __restrict__ G_out,
                         T* __restrict__ bmax, int* __restrict__ barg,
                         T* __restrict__ bmin, int l, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ T red_m[kWarps];
  const SingleSegment<T, VEC> seg(reinterpret_cast<T*>(smem_raw), l, d);
  enum { SQN, GV, KI, AL, LO, UP };
  seg.stage(SQN, sqn);
  seg.stage(GV, G);
  seg.stage(KI, k_i);
  seg.stage(AL, alpha);
  seg.stage(LO, L);
  seg.stage(UP, U);
  // the lane's scalars, asked for before the stream so they arrive with it
  const T sq = *sqqj, m = *mu, gam = *gamma;
  const T prod = seg.run(XT, xqj);

  const int tid = threadIdx.x;
  if (tid >= kBlockL) return;  // no barrier follows for the other parts
  const int j = seg.j0 + tid;
  T v = -pos_inf<T>();
  int vi = j;  // out-of-range columns lose every tie to real ones
  T mn = pos_inf<T>();
  if (j < l) {
    const T kj = rbf_entry(sq, seg.state(SQN), prod, gam);
    const T g = seg.state(GV) - m * (seg.state(KI) - kj);
    G_out[j] = g;
    const T al = seg.state(AL);
    if (al < seg.state(UP)) v = g;
    if (al > seg.state(LO)) mn = g;
  }
  warp_first_max(v, vi);
  warp_min(mn);
  if ((tid & 31) == 0) {
    red_v[tid >> 5] = v;
    red_i[tid >> 5] = vi;
    red_m[tid >> 5] = mn;
  }
  // the first kWarps warps only: the block's other parts have returned
  asm volatile("bar.sync 1, %0;" ::"n"(kBlockL) : "memory");
  if (tid == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      take_first_max(v, vi, red_v[w], red_i[w]);
      mn = fmin(mn, red_m[w]);
    }
    bmax[blockIdx.x] = v;
    barg[blockIdx.x] = vi;
    bmin[blockIdx.x] = mn;
  }
}

template <typename T>
int update_wss_single(const T* XT, const T* sqn, const T* G, const T* k_i,
                      const T* alpha, const T* L, const T* U, const T* xqj,
                      const T* sqqj, const T* mu, const T* gamma, T* G_out,
                      T* bmax, int* barg, T* bmin, int l, int d, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  static std::atomic<bool> ready[2][kMaxDevices];
  return launch_single<T>(update_wss_single_kernel<T, true>,
                          update_wss_single_kernel<T, false>, ready, XT, l,
                          device, static_cast<cudaStream_t>(stream), XT, sqn,
                          G, k_i, alpha, L, U, xqj, sqqj, mu, gamma, G_out,
                          bmax, barg, bmin, l, d);
}

template <typename T>
int update_wss_single_attrs(int* out) {
  return tile_attrs(update_wss_single_kernel<T, true>,
                    single_smem_bytes<T>(), out);
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

// Resources of the variant the main path launches (16-byte copies of X):
// out = {registers a thread, local bytes a thread (spills included),
// static shared bytes, dynamic shared bytes}.
int rbf_update_wss_attrs_f32(int* out) {
  return repro::update_wss_single_attrs<float>(out);
}

int rbf_update_wss_attrs_f64(int* out) {
  return repro::update_wss_single_attrs<double>(out);
}

}  // extern "C"
