// Shared pieces of the Gram-bank passes (row_wss_rows.cu, kernel 4, and
// update_wss_rows.cu, kernel 5): 16-byte column groups, a one-wave grid of
// blocks striding over their lane's columns, and the lane's cross-block
// pick folded into the launch.
//
// A thread owns one group of V = 16 / sizeof(T) neighbouring columns (two
// doubles, four floats) a step and reads each of its rows with one 16-byte
// load when the launch is aligned (VEC: l a multiple of V and every row
// base 16-byte aligned, so every row start is too), or with V scalar loads
// that stop at l otherwise.  Both are the same kernel; the launcher picks
// VEC from the pointers and l.  A block is 32, 64 or 128 threads
// (blockDim.x, narrower on small grids so that they still cover every SM);
// lanes go along gridDim.y.  launch_lanes gives a lane only as many
// blocks as one wave of the card holds beside the other lanes' (from the
// kernel's occupancy), and each block strides over its lane's columns in
// equal steps: every block is resident at once, and the pick below is
// paid once a block, not once a wave.
//
// The pick: every block reduces its columns to one partial (first max on
// (value, index), and with MIN the minimum), writes it to the (B, nb)
// scratch and draws a ticket from its lane's counter with an acquire-
// release add (the partial is visible before the ticket moves).  Warp 0 of
// the block that draws the lane's last ticket reads the lane's partials
// past L1 (__ldcg), reduces them, writes the lane's result and sets the
// counter back to 0 for the next launch.  First max is a total order on
// (value, index) and min is exact, so the result is bitwise that of any
// other reduction order, the per-block partials reduced by a second pass
// included.
#pragma once

#include <cstdint>
#include <cuda/atomic>

#include "common.cuh"

namespace repro {

constexpr int kBankMaxThreads = 128;
constexpr int kBankMaxWarps = kBankMaxThreads / 32;

template <typename T> struct Word16;
template <> struct Word16<double> { using type = double2; };
template <> struct Word16<float> { using type = float4; };

// Columns a thread: one 16-byte word of T.
template <typename T>
__host__ __device__ constexpr int bank_cols() {
  return 16 / sizeof(T);
}

__device__ __forceinline__ void unpack(const double2& w, double* o) {
  o[0] = w.x;
  o[1] = w.y;
}
__device__ __forceinline__ void unpack(const float4& w, float* o) {
  o[0] = w.x;
  o[1] = w.y;
  o[2] = w.z;
  o[3] = w.w;
}
__device__ __forceinline__ double2 pack(const double* v) {
  return make_double2(v[0], v[1]);
}
__device__ __forceinline__ float4 pack(const float* v) {
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The V values of row p at columns j0 .. j0 + V - 1: one 16-byte load with
// VEC, else scalar loads, 0 past l.
template <typename T, bool VEC>
__device__ __forceinline__ void load_cols(T* o, const T* __restrict__ p,
                                          int j0, int l) {
  constexpr int V = bank_cols<T>();
  if constexpr (VEC) {
    unpack(*reinterpret_cast<const typename Word16<T>::type*>(p + j0), o);
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) o[u] = j0 + u < l ? p[j0 + u] : T(0);
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_cols(T* __restrict__ p, const T* v,
                                           int j0, int l) {
  constexpr int V = bank_cols<T>();
  if constexpr (VEC) {
    *reinterpret_cast<typename Word16<T>::type*>(p + j0) = pack(v);
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u)
      if (j0 + u < l) p[j0 + u] = v[u];
  }
}

// The mask bytes of columns j0 .. j0 + V - 1 in one load of V bytes with
// VEC (a 2- or 4-byte word), else one byte at a time, false past l.
template <int V, bool VEC>
__device__ __forceinline__ void load_mask(bool* o, const bool* __restrict__ p,
                                          int j0, int l) {
  const unsigned char* b = reinterpret_cast<const unsigned char*>(p);
  if constexpr (VEC && V == 2) {
    const uchar2 w = *reinterpret_cast<const uchar2*>(b + j0);
    o[0] = w.x != 0;
    o[1] = w.y != 0;
  } else if constexpr (VEC && V == 4) {
    const uchar4 w = *reinterpret_cast<const uchar4*>(b + j0);
    o[0] = w.x != 0;
    o[1] = w.y != 0;
    o[2] = w.z != 0;
    o[3] = w.w != 0;
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) o[u] = j0 + u < l && b[j0 + u] != 0;
  }
}

// The block's (first max, min) in thread 0; sv/si/sm hold one entry a
// warp.
template <typename T, bool MIN>
__device__ __forceinline__ void block_pick(T& v, int& vi, T& m, T* sv,
                                           int* si, T* sm) {
  warp_first_max(v, vi);
  if (MIN) warp_min(m);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sv[w] = v;
    si[w] = vi;
    if (MIN) sm[w] = m;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int nw = blockDim.x >> 5;
    for (int k = 1; k < nw; ++k) {
      take_first_max(v, vi, sv[k], si[k]);
      if (MIN) m = fmin(m, sm[k]);
    }
  }
}

// The lane's pick from every block's (v, vi[, m]): each block writes its
// partial to row blockIdx.y of the (B, gridDim.x) scratch and draws a
// ticket; the last block of the lane reduces the row into out_v/out_i[/
// out_m][lane] and resets the lane's ticket counter.  Called by every
// thread of the block, after its last use of the block's columns.
template <typename T, bool MIN>
__device__ __forceinline__ void lane_pick(
    T v, int vi, T m, T* __restrict__ part_v, int* __restrict__ part_i,
    T* __restrict__ part_m, unsigned* __restrict__ tickets,
    T* __restrict__ out_v, int* __restrict__ out_i, T* __restrict__ out_m) {
  __shared__ T sv[kBankMaxWarps];
  __shared__ int si[kBankMaxWarps];
  __shared__ T sm[kBankMaxWarps];
  __shared__ bool last;
  const int lane = blockIdx.y;
  const int nb = gridDim.x;
  const size_t row = (size_t)lane * nb;
  block_pick<T, MIN>(v, vi, m, sv, si, sm);
  if (threadIdx.x == 0) {
    part_v[row + blockIdx.x] = v;
    part_i[row + blockIdx.x] = vi;
    if (MIN) part_m[row + blockIdx.x] = m;
    // release: the partial is visible before the ticket moves; acquire:
    // the last block reads every other block's partial after it
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> ticket(
        tickets[lane]);
    last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) ==
           (unsigned)(nb - 1);
  }
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  // warp 0 of the last block reduces the lane's partials, eight a thread
  // in flight at once
  v = -pos_inf<T>();
  vi = INT_MAX;
  m = pos_inf<T>();
  constexpr int kU = 8;
  for (int base = threadIdx.x; base < nb; base += kU * 32) {
    T pv[kU], pm[kU];
    int pi[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int k = base + u * 32;
      const bool in = k < nb;
      pv[u] = in ? __ldcg(part_v + row + k) : -pos_inf<T>();
      pi[u] = in ? __ldcg(part_i + row + k) : INT_MAX;
      if (MIN) pm[u] = in ? __ldcg(part_m + row + k) : pos_inf<T>();
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      take_first_max(v, vi, pv[u], pi[u]);
      if (MIN) m = fmin(m, pm[u]);
    }
  }
  warp_first_max(v, vi);
  if (MIN) warp_min(m);
  if (threadIdx.x == 0) {
    out_v[lane] = v;
    out_i[lane] = vi;
    if (MIN) out_m[lane] = m;
    tickets[lane] = 0u;
  }
}

inline bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// Bytes of a row a block covers at the least (32 threads of one 16-byte
// word): the wrapper sizes the (B, nb_cap) partials from it.
constexpr int kBankMinBlockBytes = 32 * 16;

// Launch a bank pass over B lanes of l columns in one wave.  A block is
// 128 threads, narrowed to 64 and 32 until the grid holds two blocks per
// SM (B = 1 over l = 16384 doubles: 256 blocks of 32).  A lane then takes
// no more blocks than one wave of the card holds beside the other lanes'
// (from the kernel's own occupancy), each block striding over its lane's
// columns in equal steps (l = 16384, B = 90, doubles: 10 or 11 blocks a
// lane, six or seven steps each).  nb_cap, the partials' row length, must
// hold a block per kBankMinBlockBytes of a row.
template <typename T, typename Kernel, typename... Args>
int launch_lanes(Kernel kernel, int B, int l, int nb_cap, cudaStream_t s,
                 Args... args) {
  constexpr int V = bank_cols<T>();
  const long long row_bytes = (long long)l * sizeof(T);
  if (B < 1 || B > 65535 || l < 1 ||
      nb_cap < (row_bytes + kBankMinBlockBytes - 1) / kBankMinBlockBytes)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int threads = kBankMaxThreads, nb = 0;
  for (;; threads /= 2) {
    nb = (l + threads * V - 1) / (threads * V);
    if (threads == 32 || (long long)B * nb >= 2LL * sms) break;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  if (err != cudaSuccess) return (int)err;
  const int per_lane = sms * (per_sm > 0 ? per_sm : 1) / B;
  const int steps = (nb + (per_lane > 0 ? per_lane : 1) - 1) /
                    (per_lane > 0 ? per_lane : 1);
  kernel<<<dim3((nb + steps - 1) / steps, B), threads, 0, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace repro
