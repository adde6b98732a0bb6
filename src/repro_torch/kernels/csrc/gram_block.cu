// Tiled RBF cross-Gram K[a, b] = exp(-gamma max((s1_a + s2_b) - 2 x1_a.x2_b,
// 0)) with the distance and exp epilogue fused before the one store, and
// a symmetric mode (X2 is X1) that computes each pair of tiles once.
//
// Replaces: src/repro/kernels/gram_block.py, gram_pallas (_kernel).
//
// What bounds it on an H100: operations for a cross Gram at the predict
// shapes (2 m n d of them against m n values written, d = 128), bytes for
// the symmetric bank in f64 (half the products, every value written).
// The design keeps the product near the card's rate and the epilogue and
// stores beside it:
//
// - f64 runs the product on the tensor cores (mma.sync f64, DMMA), f32 on
//   the CUDA cores (IEEE fma, no TF32).  Either way the sum over d runs in
//   a fixed order (feature order, a few at a time in the tensor cores):
//   no split of d, no atomics, so a launch is bitwise repeatable.
// - A block owns one TM x TN output tile and streams the features of its
//   TM rows of X1 and TN rows of X2 through a cp.async ring of NS stages
//   of KS features, kept NS - 1 stages ahead of the product.  f64 stores a
//   stage row-major ([row][feature], rows padded by 4 values so that a
//   warp's fragment loads hit distinct banks) and copies 16-byte pieces
//   where d is even and X1, X2 are 16-byte aligned, single values
//   otherwise (a second instance, chosen at launch).  f32 stores it
//   feature-major ([feature][row], rows of the stage padded by 8 values)
//   so that a thread reads its rows and columns as float4; the copies
//   transpose, so they move single values whatever the alignment, a warp
//   8 rows x 4 features at a time (distinct banks).
// - f64: 128 x 64 tiles, 8 warps of 32 x 32, a ring of 3 stages of 16
//   features (93.7 KB of shared memory) and at most 128 registers a
//   thread, so two blocks share an SM and one block's epilogue and stores
//   overlap the other's product.  f32: 128 x 128 tiles, 8 x 8
//   values a thread (64 fma per 16 values read from shared memory), a
//   ring of 4 stages of 8 features (35 KB), also two blocks an SM; the
//   single-value copies need the deeper ring to keep enough in flight.
// - The epilogue reads s1 and s2 of the tile from shared memory (copied
//   with the first stage) and stores straight from registers: 16-byte
//   vectors where the output's rows and base allow them, single values
//   otherwise (out may be bank[g], whose offset g l^2 is odd at odd l).
// - Symmetric mode walks only the tiles on or above the diagonal (a 1-D
//   grid, column tile by column tile) and writes each twice: as it stands
//   (entries a <= b) and transposed (entries a < b).  The transpose happens
//   in registers: a thread's values form small blocks, so the transposed
//   store fills whole 32-byte sectors as the direct one does, and no
//   staging through shared memory is needed.  Each value is computed once
//   and written to (a, b) and (b, a), so K is bitwise symmetric by
//   construction.
#include <climits>

#include "rbf_tile.cuh"

namespace repro {

template <typename T> struct GramTile;

// f64: 8 warps as WR (rows) x WC (columns), each WM x 32 = MT x 4
// tensor-core tiles of 16 x 8.  A 128 x 128 tile (one block an SM, 64 x
// 32 a warp) ran slower on an H100: with no second block on the SM, the
// exp epilogue and the stores stand between one tile's product and the
// next.
template <> struct GramTile<double> {
  static constexpr int TM = 128, TN = 64, KS = 16, NS = 3, kThreads = 256;
  static constexpr int WC = TN / 32, WR = kThreads / 32 / WC, WM = TM / WR;
  static constexpr int MT = WM / 16;
  static constexpr int kMinBlocks = 2;
  static constexpr int S = KS + 4;                    // a stage row
  static constexpr int kStage = (TM + TN) * S;        // values a stage
};

// f32: 16 x 16 threads, each rows ty*4 + {0..3} and 64 + ty*4 + {0..3},
// columns likewise with tx; a warp is 4 ty x 8 tx.
template <> struct GramTile<float> {
  static constexpr int TM = 128, TN = 128, KS = 8, NS = 4, kThreads = 256;
  static constexpr int kMinBlocks = 2;
  static constexpr int S = TM + 8;                    // a stage's feature
  static constexpr int kStage = 2 * KS * S;
};

template <typename T>
__host__ __device__ constexpr size_t gram_smem_bytes() {
  using G = GramTile<T>;
  return sizeof(T) * ((size_t)G::NS * G::kStage + G::TM + G::TN);
}

// Tiles of a launch: every (TM, TN) tile of an m x n cross Gram, or in
// symmetric mode (m = n = l, TM = R TN) the row tiles i of each column
// tile q with R i <= q: the tiles that hold an entry a <= b.
template <typename T>
long long gram_tiles(int m, int n, bool sym) {
  using G = GramTile<T>;
  const long long tn = (n + G::TN - 1) / G::TN;
  if (!sym) return (long long)((m + G::TM - 1) / G::TM) * tn;
  constexpr int R = G::TM / G::TN;
  long long t = 0;
  for (long long q = 0; q < tn; ++q) t += q / R + 1;
  return t;
}

// Block t's tile (row tile bi, column tile bj).  Cross: column tile by
// column tile, row tiles inner.  Symmetric: column tiles q = R J ..
// R J + R - 1 hold J + 1 row tiles each, so R J (J + 1) / 2 tiles come
// before them.
template <typename T>
__device__ __forceinline__ void gram_tile_of(long long t, int m, bool sym,
                                             int& bi, int& bj) {
  using G = GramTile<T>;
  if (!sym) {
    const int tm = (m + G::TM - 1) / G::TM;
    bi = (int)(t % tm);
    bj = (int)(t / tm);
    return;
  }
  constexpr long long R = G::TM / G::TN;
  long long J = (long long)((sqrt(8.0 * (double)t / R + 1.0) - 1.0) / 2.0);
  while (R * (J + 1) * (J + 2) / 2 <= t) ++J;
  while (R * J * (J + 1) / 2 > t) --J;
  const long long rem = t - R * J * (J + 1) / 2;
  bj = (int)(R * J + rem / (J + 1));
  bi = (int)(rem % (J + 1));
}

// c += a b for one 16 x 8 x 4 f64 tile on the tensor cores: a[h] is
// A[g + 8 h][t], b is B[t][g], c[2 h + e] is C[g + 8 h][2 t + e] for lane
// = 4 g + t.  Of the f64 shapes sm_90 takes (m8n8k4, m16n8k4, m16n8k8,
// m16n8k16) this one ran fastest here: m8n8k4 needs two instructions for
// the same work, and the k8 and k16 shapes' fragments spill at the 128
// registers that two blocks an SM allow.
__device__ __forceinline__ void dmma16x8x4(double (&c)[4],
                                           const double (&a)[2], double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// Issue stage c of the ring (features c KS .. c KS + KS - 1 of the tile's
// rows; zeros past m, n and d) into slot c % NS, and commit; an empty
// group past the last stage.
template <typename T, bool VEC>
__device__ __forceinline__ void gram_issue(T* ring, int c, int nch,
                                           const T* __restrict__ X1,
                                           const T* __restrict__ X2, int i0,
                                           int j0, int m, int n, int d) {
  using G = GramTile<T>;
  constexpr int TM = G::TM, TN = G::TN, KS = G::KS, S = G::S;
  const int tid = threadIdx.x;
  if (c < nch) {
    T* dst = ring + (c % G::NS) * G::kStage;
    const int k0 = c * KS;
    if constexpr (sizeof(T) == 8) {
      // [row][feature]: rows 0..TM-1 of X1, then TN rows of X2
      constexpr int P = VEC ? KS / 2 : KS;  // copies a row
      constexpr int W = VEC ? 16 : 8;       // bytes a copy
      for (int e = tid; e < (TM + TN) * P; e += G::kThreads) {
        const int r = e / P, kk = (e % P) * (W / 8);
        const bool a = r < TM;
        const int gr = a ? i0 + r : j0 + (r - TM);
        const T* src = a ? X1 : X2;
        // with VEC, d is even, so a piece is all in or all out
        const bool ok = gr < (a ? m : n) && k0 + kk < d;
        cp_async<W>(dst + r * S + kk,
                    ok ? src + (size_t)gr * d + k0 + kk : src, ok ? W : 0);
      }
    } else {
      // [operand][feature][row]; a warp copies 8 rows x 4 features of one
      // operand at a time, chunk by chunk over 4 row groups x KS / 4
      // feature groups, so it reads each row's KS features in turn
      constexpr int KG = KS / 4, PER_OP = (TM / 8) * KG;
      const int w = tid >> 5, lane = tid & 31;
      constexpr int kWarpsG = G::kThreads / 32;
      for (int ch = w * (2 * PER_OP / kWarpsG);
           ch < (w + 1) * (2 * PER_OP / kWarpsG); ++ch) {
        const int op = ch / PER_OP, rc = ch % PER_OP;
        const int r = (rc / KG) * 8 + (lane & 7);
        const int kk = (rc % KG) * 4 + (lane >> 3);
        const int gr = (op ? j0 : i0) + r;
        const T* src = op ? X2 : X1;
        const bool ok = gr < (op ? n : m) && k0 + kk < d;
        cp_async<4>(dst + op * KS * S + kk * S + r,
                    ok ? src + (size_t)gr * d + k0 + kk : src, ok ? 4 : 0);
      }
    }
  }
  cp_async_commit();
}

// A thread's f64 accumulators: MT x 4 tensor-core tiles of 16 x 8, four
// values each.
using GramAcc64 = double[GramTile<double>::MT][4][4];

// The f64 tensor-core product of one stage into acc (a warp's WM x 32).
__device__ __forceinline__ void gram_product_f64(const double* __restrict__ st,
                                                 GramAcc64& acc) {
  using G = GramTile<double>;
  constexpr int S = G::S, KS = G::KS, MT = G::MT;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const double* pa = st + ((w / G::WC) * G::WM + g) * S + t;
  const double* pb = st + (G::TM + (w % G::WC) * 32 + g) * S + t;
#pragma unroll
  for (int k = 0; k < KS; k += 4) {
    double a[MT][2], b[4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) a[mt][h] = pa[(mt * 16 + 8 * h) * S + k];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) b[nt] = pb[nt * 8 * S + k];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) dmma16x8x4(acc[mt][nt], a[mt], b[nt]);
  }
}

// The f32 CUDA-core product of one stage into acc (8 x 8 a thread).
__device__ __forceinline__ void gram_product_f32(const float* __restrict__ st,
                                                 float (&acc)[8][8]) {
  using G = GramTile<float>;
  constexpr int S = G::S, KS = G::KS;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = (w & 1) * 8 + (lane & 7), ty = (w >> 1) * 4 + (lane >> 3);
  const float* pa = st + ty * 4;
  const float* pb = st + KS * S + tx * 4;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    float a[8], b[8];
    lds<4>(pa + k * S, a);
    lds<4>(pa + k * S + 64, a + 4);
    lds<4>(pb + k * S, b);
    lds<4>(pb + k * S + 64, b + 4);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
  }
}

// The f64 epilogue: a thread's 2 x 4 tiles of 16 x 8, rows g and g + 8,
// columns 2 t and 2 t + 1 of each.
__device__ __forceinline__ void gram_store_f64(
    const GramAcc64& acc, const double* sv, double gamma,
    double* __restrict__ out, int i0, int j0, int m, int n, bool sym,
    bool svec) {
  using G = GramTile<double>;
  constexpr int TM = G::TM;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t ld = (size_t)n;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = (w / G::WC) * G::WM + mt * 16 + g + 8 * h;
      const int row = i0 + rl;
      const double si = sv[rl];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int cl = (w % G::WC) * 32 + nt * 8 + 2 * t;
        const int col = j0 + cl;
        double v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = rbf_entry(si, sv[TM + cl + e], acc[mt][nt][2 * h + e],
                           gamma);
        // as it stands (symmetric: entries a <= b)
        if (row < m) {
          if (svec && col < n && (!sym || row <= col)) {
            stg<2, true>(out + row * ld + col, 2, v);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (col + e < n && (!sym || row <= col + e))
                out[row * ld + col + e] = v[e];
          }
        }
        // transposed (symmetric: entries a < b, into b, a)
        if (sym) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (row < col + e && col + e < n)
              out[(size_t)(col + e) * ld + row] = v[e];
        }
      }
    }
}

// The f32 epilogue: a thread's rows rl(0..7) and columns cl(0..7), each
// two runs of 4 neighbours.
__device__ __forceinline__ void gram_store_f32(
    float (&acc)[8][8], const float* sv, float gamma, float* __restrict__ out,
    int i0, int j0, int m, int n, bool sym, bool svec) {
  constexpr int TM = GramTile<float>::TM;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = (w & 1) * 8 + (lane & 7), ty = (w >> 1) * 4 + (lane >> 3);
  auto rl = [&](int i) { return (i >> 2) * 64 + ty * 4 + (i & 3); };
  auto cl = [&](int j) { return (j >> 2) * 64 + tx * 4 + (j & 3); };
  const size_t ld = (size_t)n;
  float si[8], sj[8];
  lds<4>(sv + rl(0), si);
  lds<4>(sv + rl(4), si + 4);
  lds<4>(sv + TM + cl(0), sj);
  lds<4>(sv + TM + cl(4), sj + 4);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j] = rbf_entry(si[i], sj[j], acc[i][j], gamma);
  // as it stands (symmetric: entries a <= b): rows of 4 columns
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = i0 + rl(i);
    if (row >= m) continue;
#pragma unroll
    for (int jb = 0; jb < 8; jb += 4) {
      const int col = j0 + cl(jb);
      if (svec && col < n && (!sym || row <= col)) {
        stg<4, true>(out + row * ld + col, 4, &acc[i][jb]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < n && (!sym || row <= col + e))
            out[row * ld + col + e] = acc[i][jb + e];
      }
    }
  }
  if (!sym) return;
  // transposed (entries a < b, into b, a): columns of 4 rows
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j0 + cl(j);
    if (col >= n) continue;
#pragma unroll
    for (int ib = 0; ib < 8; ib += 4) {
      const int row = i0 + rl(ib);
      const float v[4] = {acc[ib][j], acc[ib + 1][j], acc[ib + 2][j],
                          acc[ib + 3][j]};
      if (svec && row + 3 < col) {
        stg<4, true>(out + (size_t)col * ld + row, 4, v);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (row + e < col) out[(size_t)col * ld + row + e] = v[e];
      }
    }
  }
}

// The block's tile.  VEC: 16-byte copies of X1 and X2 (f64 only).  sym:
// X2 is X1 (m = n), only tiles with an entry a <= b are launched, and
// each is written twice.  svec: out's rows and base are 16-byte aligned.
template <typename T, bool VEC>
__global__ void __launch_bounds__(GramTile<T>::kThreads,
                                  GramTile<T>::kMinBlocks)
gram_kernel(const T* __restrict__ X1, const T* __restrict__ X2,
            const T* __restrict__ s1, const T* __restrict__ s2, T gamma,
            T* __restrict__ out, int m, int n, int d, bool sym, bool svec) {
  using G = GramTile<T>;
  constexpr int TM = G::TM, TN = G::TN, NS = G::NS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);
  T* const sv = ring + NS * G::kStage;  // s1 of the rows, s2 of the columns
  int bi, bj;
  gram_tile_of<T>(blockIdx.x, m, sym, bi, bj);
  const int i0 = bi * TM, j0 = bj * TN;
  const int nch = (d + G::KS - 1) / G::KS;

  // the norms ride in the first commit group
  for (int e = threadIdx.x; e < TM + TN; e += G::kThreads) {
    const bool a = e < TM;
    const int gr = a ? i0 + e : j0 + (e - TM);
    const T* src = a ? s1 : s2;
    const bool ok = gr < (a ? m : n);
    cp_async<sizeof(T)>(sv + e, ok ? src + gr : src, ok ? (int)sizeof(T) : 0);
  }
  for (int c = 0; c < NS - 1; ++c)
    gram_issue<T, VEC>(ring, c, nch, X1, X2, i0, j0, m, n, d);

  // stage c has landed once at most NS - 2 newer groups are pending; the
  // barrier also frees slot (c - 1) % NS for the next issue
  auto stream = [&](auto& acc, auto&& product) {
    for (int c = 0; c < nch; ++c) {
      cp_async_wait<NS - 2>();
      __syncthreads();
      gram_issue<T, VEC>(ring, c + NS - 1, nch, X1, X2, i0, j0, m, n, d);
      product(ring + (c % NS) * G::kStage, acc);
    }
    cp_async_wait<0>();
    __syncthreads();
  };
  if constexpr (sizeof(T) == 8) {
    GramAcc64 acc = {};
    stream(acc, [](const double* st, GramAcc64& a) {
      gram_product_f64(st, a);
    });
    gram_store_f64(acc, sv, gamma, out, i0, j0, m, n, sym, svec);
  } else {
    float acc[8][8] = {};
    stream(acc, [](const float* st, float (&a)[8][8]) {
      gram_product_f32(st, a);
    });
    gram_store_f32(acc, sv, gamma, out, i0, j0, m, n, sym, svec);
  }
}

template <typename T, bool VEC>
int gram_launch(const T* X1, const T* X2, const T* s1, const T* s2, T* out,
                double gamma, int m, int n, int d, bool sym, int device,
                cudaStream_t stream) {
  static std::atomic<bool> ready[kMaxDevices];
  const long long tiles = gram_tiles<T>(m, n, sym);
  if (tiles == 0) return 0;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  constexpr size_t smem = gram_smem_bytes<T>();
  auto kern = gram_kernel<T, VEC>;
  const cudaError_t err = allow_smem(kern, smem, ready, device);
  if (err != cudaSuccess) return (int)err;
  const bool svec = aligned16(out) && n % (16 / (int)sizeof(T)) == 0;
  kern<<<(unsigned)tiles, GramTile<T>::kThreads, smem, stream>>>(
      X1, X2, s1, s2, static_cast<T>(gamma), out, m, n, d, sym, svec);
  return (int)cudaGetLastError();
}

template <typename T>
int gram(const T* X1, const T* X2, const T* s1, const T* s2, T* out,
         double gamma, int m, int n, int d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // X2 is X1: the same rows (the wrapper passes the same pointer only for
  // the same tensor)
  const bool sym = X1 == X2 && s1 == s2 && m == n;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 8) {
    if (d % 2 == 0 && aligned16(X1) && aligned16(X2))
      return gram_launch<T, true>(X1, X2, s1, s2, out, gamma, m, n, d, sym,
                                  device, s);
  }
  return gram_launch<T, false>(X1, X2, s1, s2, out, gamma, m, n, d, sym,
                               device, s);
}

// Resources of the instance with (vec) or without 16-byte copies: out =
// {registers a thread, local bytes a thread (spills included), static
// shared bytes, dynamic shared bytes, TM, TN}.
template <typename T>
int gram_attrs(int vec, int* out) {
  constexpr bool kV = sizeof(T) == 8;
  const int err =
      vec && kV
          ? tile_attrs(gram_kernel<T, kV>, gram_smem_bytes<T>(), out)
          : tile_attrs(gram_kernel<T, false>, gram_smem_bytes<T>(), out);
  out[4] = GramTile<T>::TM;
  out[5] = GramTile<T>::TN;
  return err;
}

}  // namespace repro

extern "C" {

int gram_block_f32(const float* X1, const float* X2, const float* s1,
                   const float* s2, float* out, double gamma, int m, int n,
                   int d, int device, void* stream) {
  return repro::gram<float>(X1, X2, s1, s2, out, gamma, m, n, d, device,
                            stream);
}

int gram_block_f64(const double* X1, const double* X2, const double* s1,
                   const double* s2, double* out, double gamma, int m, int n,
                   int d, int device, void* stream) {
  return repro::gram<double>(X1, X2, s1, s2, out, gamma, m, n, d, device,
                             stream);
}

int gram_block_attrs_f32(int vec, int* out) {
  return repro::gram_attrs<float>(vec, out);
}

int gram_block_attrs_f64(int vec, int* out) {
  return repro::gram_attrs<double>(vec, out);
}

}  // extern "C"
