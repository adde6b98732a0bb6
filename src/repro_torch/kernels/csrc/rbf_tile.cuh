// The lane-tiled distance product shared by the batched rbf passes
// (rbf_row_wss.cuh, kernel 1, and rbf_update_wss.cuh, kernel 2).
//
// A block of 256 or 512 threads owns one kBlockL-column block of the
// example axis and walks over every lane group in turn, LG lanes at a
// time.  X, stored transposed as XT (d, l), reaches shared memory through
// a ring of NS stages of kStageD feature rows x kBlockL columns, filled by
// cp.async (16-byte pieces where the rows are 16-byte aligned, single
// values otherwise) kept NS - 1 stages ahead of the product.  The whole
// (d, kBlockL) tile fits in the ring at d <= 128 (f64) and d <= 256 (f32):
// it is then loaded once, during the first lane group, and stays resident
// for the others; otherwise each lane group streams it again (from the
// L2).  The query rows of a lane group ride in the same ring, one
// (kStageD, LG) slice per stage and query set.
//
// The product: f64 runs on the tensor cores (mma.sync m8n8k4.f64, lanes x
// columns x features), each warp a tile of 8-16 lanes x 8-32 columns; f32
// stays on the CUDA cores (IEEE fma, no TF32), each thread a micro-tile of
// up to 4 lanes x 4 columns.  Either way every shared-memory value feeds several
// products, and the sum over d runs in a fixed order (feature order, four
// at a time in the tensor cores): no split of d, no atomics, so a launch
// is bitwise repeatable.
//
// The epilogue of a group first turns every accumulator into its kernel
// value, then loads the lanes' state for all of the thread's columns at
// once (16-byte vectors, no branch between them, after asking the L2 for
// the group's rows before its product), and reduces across threads only
// at the end, so its loads make one round trip, not one a lane.  Whether
// the rows allow 16-byte vectors is decided once a launch: the kernel runs
// one of two copies of its epilogue (VEC), so no load is behind a branch.
#pragma once

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace repro {

// Feature rows of X in one stage of the ring.
constexpr int kStageD = 16;
// Devices whose shared-memory attribute a launcher tracks.
constexpr int kMaxDevices = 64;

// The thread layout for LG lanes.  f32 (CUDA cores): a warp is 4 lane rows
// x 8 column groups, each thread TM lanes x TN columns; its columns come
// in vectors of W neighbours and its lanes in vectors of WQ, so the 8
// column groups of a warp read neighbouring 16-byte pieces of a shared
// row.  f64 (tensor cores): a warp holds MT x NT 8 x 8 accumulator tiles,
// thread t lane t / 4 of each and columns 2 (t % 4) and 2 (t % 4) + 1; X
// rows and query rows are padded in shared memory so that a warp's
// fragment loads hit 32 distinct banks.  f64 pass A (one query set, NQ =
// 1) runs 16 warps, so a thread holds half the accumulators of 8 (under
// 128 registers) and twice as many of the epilogue's loads are in flight
// on the SM; pass B, whose accumulators are twice as many, runs 8.
template <typename T, int LG, int NQ>
struct Tile {
  static constexpr bool kMma = std::is_same<T, double>::value;
  static constexpr int kThreads = kMma && NQ == 1 ? 512 : 256;
  static constexpr int kVec = 16 / (int)sizeof(T);
  // tensor-core tiles of a warp (f64): NT x MT tiles of 8 x 8; the
  // CUDA-core micro-tile of a thread (f32): TM x TN
  static constexpr int NT = (LG >= 16 ? 4 : 2) * 256 / kThreads;
  static constexpr int TN = kMma ? 2 * NT : (LG >= 8 ? 4 : 2);
  static constexpr int WC = kMma ? kBlockL / (8 * NT) : kBlockL / (8 * TN);
  static constexpr int WL = kThreads / 32 / WC;
  static constexpr int MT = kMma ? LG / (8 * WL) : 1;
  static constexpr int TM = kMma ? MT : LG / (4 * WL);
  static constexpr int W = kMma ? 2 : (TN < kVec ? TN : kVec);
  static constexpr int WQ = TM < kVec ? TM : kVec;
  // shared-memory strides: an X row, a query row (f64: [lane][feature];
  // f32: [feature][lane])
  static constexpr int XS = kBlockL + (kMma ? 4 : 0);
  static constexpr int QS = kMma ? kStageD + 4 : LG;
  static constexpr int NS = kMma ? 8 : 16;
  static_assert(WL * WC * 32 == kThreads && TM >= 1 && TN % W == 0 &&
                    (kMma ? 8 * MT * WL == LG && LG >= 8
                          : 4 * TM * WL == LG && TM % WQ == 0),
                "tile shape");
};

// Lanes per group: f32 the smallest of 4, 8, 16 that holds B, else 32; f64
// at least 8 (a tensor-core tile's rows).
template <typename T>
inline int tile_lanes(int B) {
  if (B <= 4 && !Tile<T, 8, 1>::kMma) return 4;
  if (B <= 8) return 8;
  if (B <= 16) return 16;
  return 32;
}

template <int N> using Int = std::integral_constant<int, N>;
template <bool V> using Bool = std::integral_constant<bool, V>;

// Call f(Int<LG>, Int<H>, Bool<masked>, Bool<conj>) with the launch's lane
// group, state halves, mask and direction flags as compile-time constants.
template <typename T, typename F>
int dispatch_variant(int B, int H, bool masked, bool conj, F&& f) {
  auto lanes = [&](auto h, auto m, auto c) -> int {
    switch (tile_lanes<T>(B)) {
      case 4:
        if constexpr (!Tile<T, 8, 1>::kMma) return f(Int<4>{}, h, m, c);
        return (int)cudaErrorInvalidValue;
      case 8: return f(Int<8>{}, h, m, c);
      case 16: return f(Int<16>{}, h, m, c);
      default: return f(Int<32>{}, h, m, c);
    }
  };
  auto conjs = [&](auto h, auto m) -> int {
    return conj ? lanes(h, m, Bool<true>{}) : lanes(h, m, Bool<false>{});
  };
  auto masks = [&](auto h) -> int {
    return masked ? conjs(h, Bool<true>{}) : conjs(h, Bool<false>{});
  };
  if (H == 1) return masks(Int<1>{});
  if (H == 2) return masks(Int<2>{});
  return (int)cudaErrorInvalidValue;
}

// Elements of T in the ring (X stages, then query stages) for NQ query
// sets; the block's reduction scratch follows them.
template <typename T, int LG, int NQ>
__host__ __device__ constexpr int ring_elems() {
  using S = Tile<T, LG, NQ>;
  return S::NS * kStageD * S::XS +
         S::NS * NQ * (S::kMma ? LG * S::QS : kStageD * LG);
}

// Dynamic shared memory of a tiled kernel: the ring, then per (lane,
// warp column) the block maxima (and, with two query sets, minima) in T
// and the argmax in int.
template <typename T, int LG, int NQ>
__host__ __device__ constexpr size_t tile_smem_bytes() {
  return sizeof(T) * ring_elems<T, LG, NQ>() +
         (size_t)LG * Tile<T, LG, NQ>::WC * (NQ * sizeof(T) + sizeof(int));
}

// A thread's place in the tile.
template <typename T, int LG, int NQ>
struct TileThread {
  using S = Tile<T, LG, NQ>;
  int t, wl, wc;
  __device__ TileThread() {
    t = threadIdx.x & 31;
    wl = (threadIdx.x >> 5) / S::WC;
    wc = (threadIdx.x >> 5) % S::WC;
  }
  // the lane within the group of the thread's u-th lane
  __device__ __forceinline__ int lane(int u) const {
    if constexpr (S::kMma) return wl * 8 * S::MT + u * 8 + (t >> 2);
    return wl * 4 * S::TM + (u / S::WQ) * 4 * S::WQ + (t & 3) * S::WQ +
           u % S::WQ;
  }
  // the column within the block of the thread's n-th column
  __device__ __forceinline__ int col(int n) const {
    if constexpr (S::kMma)
      return wc * 8 * S::NT + (n >> 1) * 8 + 2 * (t & 3) + (n & 1);
    return wc * 8 * S::TN + (n / S::W) * 8 * S::W + (t >> 2) * S::W +
           n % S::W;
  }
  // whether the thread writes its lane rows' reduction for its warp
  __device__ __forceinline__ bool leader() const {
    return S::kMma ? (t & 3) == 0 : (t >> 2) == 0;
  }
};

template <typename T, int N> struct VecOf;
template <> struct VecOf<double, 1> { using type = double; };
template <> struct VecOf<double, 2> { using type = double2; };
template <> struct VecOf<float, 1> { using type = float; };
template <> struct VecOf<float, 2> { using type = float2; };
template <> struct VecOf<float, 4> { using type = float4; };

template <int N> struct MaskOf;
template <> struct MaskOf<1> { using type = unsigned char; };
template <> struct MaskOf<2> { using type = unsigned short; };
template <> struct MaskOf<4> { using type = unsigned int; };

// N values from shared memory, aligned to N values.
template <int N, typename T>
__device__ __forceinline__ void lds(const T* p, T* out) {
  using V = typename VecOf<T, N>::type;
  const V v = *reinterpret_cast<const V*>(p);
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = e[i];
}

// N read-only values from device memory: one vector load with VEC (the
// caller has checked alignment and that all N lie inside the row), else
// the first n of them one by one and zeros after; no branch either way.
template <int N, bool VEC, typename T>
__device__ __forceinline__ void ldg(const T* p, int n, T* out) {
  if constexpr (VEC) {
    using V = typename VecOf<T, N>::type;
    const V v = __ldg(reinterpret_cast<const V*>(p));
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = e[i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = i < n ? __ldg(p + i) : T(0);
  }
}

template <int N, bool VEC>
__device__ __forceinline__ void ldg_mask(const bool* p, int n, bool* out) {
  if constexpr (VEC) {
    using M = typename MaskOf<N>::type;
    const M m = __ldg(reinterpret_cast<const M*>(p));
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = (m >> (8 * i)) & 0xff;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = i < n && p[i];
  }
}

template <int N, bool VEC, typename T>
__device__ __forceinline__ void stg(T* p, int n, const T* in) {
  if constexpr (VEC) {
    using V = typename VecOf<T, N>::type;
    V v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = in[i];
    *reinterpret_cast<V*>(p) = v;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < n) p[i] = in[i];
  }
}

// Asynchronous copy of N bytes (4, 8 or 16) into shared memory; only the
// first src_bytes are read, the rest of the N are zero-filled.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(N), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a b for one 8 x 8 x 4 f64 tile on the tensor cores: a is the
// thread's element of A (8 x 4, row-major), b of B (4 x 8, column-major),
// c0/c1 its two elements of C (8 x 8).
__device__ __forceinline__ void dmma(double& c0, double& c1, double a,
                                     double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

// Ask the L2 for columns [j0, j0 + n) of rows [r0, r0 + rows) of a
// row-major array whose rows are ld elements apart: one prefetch per
// 128-byte line, so the epilogue's loads of a lane group's state find it
// there instead of starting a round trip to device memory.
template <typename E>
__device__ __forceinline__ void prefetch_rows(const E* a, size_t r0,
                                              int rows, size_t ld, int j0,
                                              int n) {
  const int bytes = n * (int)sizeof(E);
  const int per = (bytes + 127) / 128 + 1;
  for (int e = threadIdx.x; e < rows * per; e += blockDim.x) {
    const int r = e / per, k = e % per;
    const char* p = reinterpret_cast<const char*>(a + (r0 + r) * ld + j0);
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + min(128 * k, bytes - 1)));
  }
}

// First-max and min across the threads of a warp that share lane rows
// (lane bits 0-1 with the tensor cores, 2-4 on the CUDA cores); every
// thread ends with the result of its rows.
template <bool MMA, typename T>
__device__ __forceinline__ void row_first_max(T& v, int& i) {
#pragma unroll
  for (int off = MMA ? 1 : 4; off < (MMA ? 4 : 32); off <<= 1) {
    const T ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    take_first_max(v, i, ov, oi);
  }
}

template <bool MMA, typename T>
__device__ __forceinline__ void row_min(T& m) {
#pragma unroll
  for (int off = MMA ? 1 : 4; off < (MMA ? 4 : 32); off <<= 1)
    m = fmin(m, __shfl_xor_sync(0xffffffffu, m, off));
}

// Walk every lane group of the block's column tile.  For group g, pre(g)
// runs first (before the group's first stage is waited for), then
// acc[s][u][n] = sum_k XQ[s][(g LG + lane(u)) d + k] XT[k l + j0 + col(n)]
// in feature order, then epi(g, acc).  Lanes at or past B and columns at
// or past l compute with zeros.  xvec: l is a multiple of 16 bytes' worth
// of T and XT is 16-byte aligned, so X moves in 16-byte pieces.
template <typename T, int LG, int NQ, typename Pre, typename Epi>
__device__ __forceinline__ void tile_lane_groups(
    const T* __restrict__ XT, const T* const (&XQ)[NQ], int B, int l, int d,
    bool xvec, T* smem, Pre&& pre, Epi&& epi) {
  using S = Tile<T, LG, NQ>;
  constexpr int KD = kStageD, BL = kBlockL, NS = S::NS, XS = S::XS;
  constexpr int QE = S::kMma ? LG * S::QS : KD * LG;  // a query set's stage
  T* const xs = smem;                // [NS][KD][XS]
  T* const qs = smem + NS * KD * XS;  // [NS][NQ][QE]
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * BL;
  const int nch = (d + KD - 1) / KD;
  const bool resident = nch <= NS;
  const int ngroups = (B + LG - 1) / LG;
  const int total = ngroups * nch;
  const TileThread<T, LG, NQ> th;

  // stage t of the stream (group t / nch, feature chunk t % nch) into ring
  // slot t % NS (X: slot t % nch = chunk when resident, loaded in group 0
  // only); one commit group per call, empty past the end
  auto issue = [&](int t) {
    if (t < total) {
      const int g = t / nch, c = t % nch, k0 = c * KD;
      if (!resident || g == 0) {
        T* dst = xs + (resident ? c : t % NS) * KD * XS;
        if (xvec) {
          constexpr int P = BL / S::kVec;
          for (int e = tid; e < KD * P; e += S::kThreads) {
            const int kk = e / P, jj = (e % P) * S::kVec;
            const bool ok = k0 + kk < d && j0 + jj < l;
            cp_async<16>(dst + kk * XS + jj,
                         ok ? XT + (size_t)(k0 + kk) * l + j0 + jj : XT,
                         ok ? 16 : 0);
          }
        } else {
          for (int e = tid; e < KD * BL; e += S::kThreads) {
            const int kk = e / BL, jj = e % BL;
            const bool ok = k0 + kk < d && j0 + jj < l;
            cp_async<sizeof(T)>(dst + kk * XS + jj,
                                ok ? XT + (size_t)(k0 + kk) * l + j0 + jj
                                   : XT,
                                ok ? (int)sizeof(T) : 0);
          }
        }
      }
      T* qdst = qs + (t % NS) * NQ * QE;
#pragma unroll
      for (int s = 0; s < NQ; ++s) {
        for (int e = tid; e < LG * KD; e += S::kThreads) {
          const int b = e / KD, kk = e % KD;
          const int lane = g * LG + b;
          const bool ok = lane < B && k0 + kk < d;
          cp_async<sizeof(T)>(
              qdst + s * QE + (S::kMma ? b * S::QS + kk : kk * LG + b),
              ok ? XQ[s] + (size_t)lane * d + k0 + kk : XQ[s],
              ok ? (int)sizeof(T) : 0);
        }
      }
    }
    cp_async_commit();
  };

  for (int t = 0; t < NS - 1; ++t) issue(t);
  for (int g = 0; g < ngroups; ++g) {
    pre(g);
    T acc[NQ][S::TM][S::TN];
#pragma unroll
    for (int s = 0; s < NQ; ++s)
#pragma unroll
      for (int u = 0; u < S::TM; ++u)
#pragma unroll
        for (int n = 0; n < S::TN; ++n) acc[s][u][n] = T(0);
    for (int c = 0; c < nch; ++c) {
      const int t = g * nch + c;
      // stage t has landed once at most NS - 2 newer groups are pending;
      // the barrier also frees slot (t - 1) % NS for the next issue
      cp_async_wait<NS - 2>();
      __syncthreads();
      issue(t + NS - 1);
      const T* xk = xs + (resident ? c : t % NS) * KD * XS;
      const T* qk = qs + (t % NS) * NQ * QE;
      if constexpr (S::kMma) {
        // A = queries (lanes x features), B = X (features x columns)
        const T* xb = xk + (th.t & 3) * XS + th.wc * 8 * S::NT + (th.t >> 2);
        const T* qb = qk + (th.wl * 8 * S::MT + (th.t >> 2)) * S::QS +
                      (th.t & 3);
#pragma unroll
        for (int k4 = 0; k4 < KD; k4 += 4) {
          T b[S::NT];
#pragma unroll
          for (int nt = 0; nt < S::NT; ++nt) b[nt] = xb[k4 * XS + nt * 8];
#pragma unroll
          for (int s = 0; s < NQ; ++s)
#pragma unroll
            for (int mt = 0; mt < S::MT; ++mt) {
              const T a = qb[s * QE + mt * 8 * S::QS + k4];
#pragma unroll
              for (int nt = 0; nt < S::NT; ++nt)
                dmma(acc[s][mt][2 * nt], acc[s][mt][2 * nt + 1], a, b[nt]);
            }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          T xv[S::TN];
#pragma unroll
          for (int n = 0; n < S::TN; n += S::W)
            lds<S::W>(xk + kk * XS + th.col(n), xv + n);
#pragma unroll
          for (int s = 0; s < NQ; ++s) {
            T qv[S::TM];
#pragma unroll
            for (int u = 0; u < S::TM; u += S::WQ)
              lds<S::WQ>(qk + s * QE + kk * LG + th.lane(u), qv + u);
#pragma unroll
            for (int u = 0; u < S::TM; ++u)
#pragma unroll
              for (int n = 0; n < S::TN; ++n)
                acc[s][u][n] = fma(qv[u], xv[n], acc[s][u][n]);
          }
        }
      }
    }
    epi(g, acc);
  }
  cp_async_wait<0>();
}

// Set a tiled kernel's dynamic shared memory once per device (before its
// first launch there, which the solvers make eagerly, outside any CUDA
// graph capture).  The flags are atomic: the lane-sharded engine launches
// from one host thread a device, and two threads may set one attribute
// at once (which is harmless: the value is the same).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes,
                       std::atomic<bool> (&done)[kMaxDevices], int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done[device].store(true, std::memory_order_release);
  return err;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A kernel's resources: registers a thread, local memory a thread (spills
// included; 0 means none), static and dynamic shared memory a block.
template <typename K>
int tile_attrs(K kernel, size_t dyn_smem, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)dyn_smem;
  return 0;
}

}  // namespace repro
