// The X stream shared by the single-lane rbf passes (kernel 6,
// rbf_row_wss_single.cu, and kernel 7, rbf_update_wss_single.cu).
//
// One block of kSingleThreads threads owns one kBlockL-column segment of
// the example axis.  XT (d, l) reaches shared memory through a ring of
// kSingleNS<T> stages of kSingleKD feature rows x kBlockL columns, filled
// by cp.async (16-byte pieces where the rows are 16-byte aligned, single
// values otherwise), with the query's slice of the same features beside
// each stage.  The whole ring is in flight from the start: two stages of
// 32 KB in f64, four of 16 KB in f32, 64 KB of X a block either way.  A
// deeper f64 ring (four stages, the whole segment at d = 128) ran 2-3%
// slower on an H100 (PERF.md, section 6).  The lane's state for the
// segment's columns rides in the first commit group, ahead of X, so the
// epilogue finds it in shared memory.
//
// The sum over d: thread (part p, column c) sums the features p KD / P to
// (p + 1) KD / P - 1 of every stage, in feature order; part 0 then adds
// the other parts' sums in part order through shared memory.  No atomics
// and no order that depends on timing: a launch is bitwise repeatable.
#pragma once

#include "rbf_tile.cuh"

namespace repro {

// Feature rows of X in one stage, stages in the ring (by the size of a
// value), threads a block, and the parts the d-sum is split into (one
// column a thread in each part).
constexpr int kSingleKD = 32;
template <typename T>
constexpr int kSingleNS = sizeof(T) == 8 ? 2 : 4;
constexpr int kSingleThreads = 256;
constexpr int kSingleParts = kSingleThreads / kBlockL;
static_assert(kSingleKD % kSingleParts == 0 && kSingleParts >= 1 &&
                  kSingleKD <= kBlockL,
              "parts of a stage; part 0 copies the state and the query");

// Vectors of the lane's state a pass stages beside X (kernel 6: sqn, G,
// alpha, L, U; kernel 7 adds k_i).
constexpr int kSingleState = 6;

// Dynamic shared memory: the X ring, the query ring, the state, the other
// parts' sums.
template <typename T>
__host__ __device__ constexpr size_t single_smem_bytes() {
  return sizeof(T) * ((size_t)kSingleNS<T> * kSingleKD * kBlockL +
                      kSingleNS<T> * kSingleKD + kSingleState * kBlockL +
                      (kSingleParts - 1) * kBlockL);
}

// The block's column segment: its shared memory, and the dot products
// x_j . xq of its columns.  stage(v, src) copies this segment's columns of
// the (l,) vector src into state slot v (zeros past l); it must be called
// before run(), which issues them in the first commit group.
template <typename T, bool VEC>
struct SingleSegment {
  static constexpr int KD = kSingleKD, NS = kSingleNS<T>, BL = kBlockL;
  static constexpr int kVec = 16 / (int)sizeof(T);
  T* xs;    // [NS][KD][BL]
  T* qs;    // [NS][KD]
  T* st;    // [kSingleState][BL]
  T* part;  // [kSingleParts - 1][BL]
  int j0, l, d;

  __device__ SingleSegment(T* smem, int l_, int d_)
      : xs(smem),
        qs(smem + NS * KD * BL),
        st(smem + NS * KD * BL + NS * KD),
        part(smem + NS * KD * BL + NS * KD + kSingleState * BL),
        j0(blockIdx.x * BL),
        l(l_),
        d(d_) {}

  __device__ __forceinline__ void stage(int v, const T* src) const {
    const int c = threadIdx.x;
    if (c < BL) {
      const bool ok = j0 + c < l;
      cp_async<sizeof(T)>(st + v * BL + c, ok ? src + j0 + c : src,
                          ok ? (int)sizeof(T) : 0);
    }
  }

  __device__ __forceinline__ T state(int v) const {
    return st[v * BL + (threadIdx.x % BL)];
  }

  // Stage t of the stream (features t KD .. t KD + KD - 1) into ring slot
  // t % NS; one commit group per call, empty past the end.
  __device__ __forceinline__ void issue(const T* __restrict__ XT,
                                        const T* __restrict__ xq, int t,
                                        int nch) const {
    if (t < nch) {
      const int k0 = t * KD, tid = threadIdx.x;
      T* dst = xs + (t % NS) * KD * BL;
      if constexpr (VEC) {
        constexpr int P = BL / kVec;
        for (int e = tid; e < KD * P; e += kSingleThreads) {
          const int kk = e / P, jj = (e % P) * kVec;
          const bool ok = k0 + kk < d && j0 + jj < l;
          cp_async<16>(dst + kk * BL + jj,
                       ok ? XT + (size_t)(k0 + kk) * l + j0 + jj : XT,
                       ok ? 16 : 0);
        }
      } else {
        for (int e = tid; e < KD * BL; e += kSingleThreads) {
          const int kk = e / BL, jj = e % BL;
          const bool ok = k0 + kk < d && j0 + jj < l;
          cp_async<sizeof(T)>(dst + kk * BL + jj,
                              ok ? XT + (size_t)(k0 + kk) * l + j0 + jj : XT,
                              ok ? (int)sizeof(T) : 0);
        }
      }
      if (tid < KD) {
        const bool ok = k0 + tid < d;
        cp_async<sizeof(T)>(qs + (t % NS) * KD + tid,
                            ok ? xq + k0 + tid : xq, ok ? (int)sizeof(T) : 0);
      }
    }
    cp_async_commit();
  }

  // x_j . xq for the thread's column, complete in the threads of part 0
  // (threadIdx.x < kBlockL) and meaningless in the others.  Ends with the
  // block's state slots landed and visible.
  __device__ __forceinline__ T run(const T* __restrict__ XT,
                                   const T* __restrict__ xq) const {
    constexpr int KP = KD / kSingleParts;
    const int tid = threadIdx.x, c = tid % BL, p = tid / BL;
    const int nch = (d + KD - 1) / KD;
    for (int t = 0; t < NS; ++t) issue(XT, xq, t, nch);
    T acc = T(0);
    for (int t = 0; t < nch; ++t) {
      // stage t has landed once at most NS - 1 newer groups are pending
      cp_async_wait<NS - 1>();
      __syncthreads();
      const T* xk = xs + (t % NS) * KD * BL + p * KP * BL + c;
      const T* qk = qs + (t % NS) * KD + p * KP;
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) acc = fma(qk[kk], xk[kk * BL], acc);
      // every thread is done with slot t % NS before it is filled again
      __syncthreads();
      issue(XT, xq, t + NS, nch);
    }
    cp_async_wait<0>();
    if (p > 0) part[(p - 1) * BL + c] = acc;
    __syncthreads();
    if (p == 0) {
#pragma unroll
      for (int q = 1; q < kSingleParts; ++q) acc += part[(q - 1) * BL + c];
    }
    return acc;
  }
};

// Launch kernel<VEC>: 16-byte copies of X when l is a multiple of a
// 16-byte piece and XT is 16-byte aligned.  The dynamic shared memory is
// allowed once per device, at the kernel's first launch there (the
// solvers make it eagerly, outside any CUDA graph capture); later
// launches, the no-op relaunches of kernel 6 included, only read a flag.
template <typename T, typename KV, typename KS, typename... Args>
int launch_single(KV kern_vec, KS kern_scalar,
                  std::atomic<bool> (&ready)[2][kMaxDevices],
                  const T* XT, int l, int device, cudaStream_t s,
                  Args... args) {
  constexpr size_t smem = single_smem_bytes<T>();
  const bool vec = l % (16 / (int)sizeof(T)) == 0 && aligned16(XT);
  cudaError_t err = vec ? allow_smem(kern_vec, smem, ready[1], device)
                        : allow_smem(kern_scalar, smem, ready[0], device);
  if (err != cudaSuccess) return (int)err;
  if (vec)
    kern_vec<<<n_blocks(l), kSingleThreads, smem, s>>>(args...);
  else
    kern_scalar<<<n_blocks(l), kSingleThreads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace repro
