// Thread-block cluster helpers for kernels that spread one draw over the
// CTAs of a cluster (the cluster tiers of settle_cluster.cu, dare.cu and
// cycle_reduction_tiers.cu):
// the cluster's barriers, the address of a location in a peer CTA's shared
// memory (distributed shared memory), and cluster_mm, tile_mm's products
// (small_linalg.cuh) on row panels spread over the cluster.
#pragma once

#include "small_linalg.cuh"

namespace gcp {

constexpr int kClusterUnroll = 2;    // 8-wide steps of a product's loop at once
constexpr int kClusterMaxCtas = 8;   // the portable cluster size

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Barrier over every thread of the cluster; shared-memory writes before it
// (local or into a peer) are visible to every CTA after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n\t"
      "barrier.cluster.wait.aligned;" ::: "memory");
}

// The two halves of cluster_sync, for work in between that no peer waits
// for: the writes before the arrival are visible to every CTA after the
// wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The generic address of the same shared-memory location in CTA `rank` of
// the cluster (every CTA has the same layout).
template <typename T>
__device__ __forceinline__ T* peer(T* p, int rank) {
  unsigned long long out;
  asm("mapa.u64 %0, %1, %2;"
      : "=l"(out)
      : "l"(reinterpret_cast<unsigned long long>(p)), "r"(rank));
  return reinterpret_cast<T*>(out);
}

// This CTA's place in its draw: it holds the rows row0 .. row0 + rows - 1
// of T, the work buffers, PZt and K (CTA r of the cluster the r-th panel of
// `rows` rows, a multiple of 32); nloc of them are stored rows of the draw
// (< ceil16(n)) and rloc logical ones (< n).
struct ClusterPart {
  int rank, ctas, rows, row0, nloc, rloc;
};

// One product of cluster_mm: value(i, j) = sign * (A op(B) [+ A2 B2'])(i, j)
// [+ (i == j)] [+ E(i, j)] [+ G(i, j)] for the rows i = row0 + il, il <
// nloc, of an (r x m) result.  A, E and C hold those rows (local row il);
// B is whole in this CTA (distB false) or spread over the cluster in the
// panels of ClusterPart (distB true); B2 (c2 > 0) is spread and transposed.
struct PanelProduct {
  const double* A; int lda;
  const double* B; int ldb; bool transB; bool distB;
  int row0, nloc, r, c, m;
  const double* A2; int lda2;
  const double* B2; int ldb2; int c2;
  double sign; bool eye;
  const double* E; int lde;
  double* C; int ldc;
};

// A product of this CTA's panel: rows row0 .. of an (r x m) result over c
// terms; no second term, sign +1, no identity and no epilogue matrix.
__device__ __forceinline__ PanelProduct panel_product(
    const ClusterPart& cp, const double* A, int lda, const double* B,
    int ldb, bool transB, bool distB, int r, int c, int m, double* C,
    int ldc) {
  return PanelProduct{A, lda, B, ldb, transB, distB, cp.row0, cp.nloc, r, c,
                      m, nullptr, 0, nullptr, 0, 0, 1.0, false, nullptr, 0,
                      C, ldc};
}

// tile_mm for the panels of a cluster: the same fragments and order of the
// sums, on work items of 16 kTiles rows x 16 columns, so that each operand
// of B, the one read across the cluster, feeds kTiles row tiles (A and C
// then need a whole number of items of stored rows), and with B read where
// its rows are.  Transposed, an item's 16 rows of B lie in one CTA; not
// transposed, the inner dimension walks the CTAs' panels in order (each a
// whole number of 8-wide steps, so the sums run as in tile_mm).  A peer's
// rows are read through distributed shared memory (generic loads of mapa
// addresses).  G and O are indexed by the global row.  With kOneChain each
// row tile's sums run as tile_mm's kTall items sum them (every 4-wide step
// of the inner dimension into one set of accumulators, in order) instead of
// in two sets of alternate steps added at the end.
template <typename S, int kTiles = 2, bool kOneChain = false>
__device__ __forceinline__ void cluster_mm(const PanelProduct& p, int rows,
                                           const S* G, int ldg, S* O, int ldo,
                                           WarpCtx w) {
  constexpr int kItemRows = 16 * kTiles;
  const int g = w.lane >> 2, t = w.lane & 3;
  const int col_tiles = (p.m + 7) >> 3;
  const int chunks = (col_tiles + 1) >> 1;
  const int items = ((p.nloc + kItemRows - 1) / kItemRows) * chunks;
  for (int item = w.warp; item < items; item += w.n_warps) {
    const int ic = item / chunks;
    const int i0 = ic * kItemRows, j0 = (item - ic * chunks) << 4;
    const bool second = (j0 >> 3) + 1 < col_tiles;
    const int jr = second ? j0 + 8 : j0;
    // [set of the inner dimension][row tile][left or right 8 columns]
    // [fragment]
    double acc[2][kTiles][2][4] = {};
    auto accumulate = [&](const double* a0, int lda, const double* b0,
                          const double* b1, int step, int c) {
#pragma unroll (kClusterUnroll)
      for (int l = 0; l < c; l += 8) {
        double x[kTiles][4];
#pragma unroll
        for (int rt = 0; rt < kTiles; ++rt) {
          const double* ar = a0 + 16 * rt * lda;
          x[rt][0] = ar[l];
          x[rt][1] = ar[8 * lda + l];
          x[rt][2] = ar[l + 4];
          x[rt][3] = ar[8 * lda + l + 4];
        }
        const double y0 = b0[l * step], y1 = b1[l * step];
        const double y2 = b0[(l + 4) * step], y3 = b1[(l + 4) * step];
#pragma unroll
        for (int rt = 0; rt < kTiles; ++rt) {
          dmma_16x8x4(acc[0][rt][0], x[rt][0], x[rt][1], y0);
          dmma_16x8x4(acc[0][rt][1], x[rt][0], x[rt][1], y1);
          dmma_16x8x4(acc[kOneChain ? 0 : 1][rt][0], x[rt][2], x[rt][3], y2);
          dmma_16x8x4(acc[kOneChain ? 0 : 1][rt][1], x[rt][2], x[rt][3], y3);
        }
      }
    };
    const double* a = p.A + (i0 + g) * p.lda + t;
    if (p.transB) {
      // B(l, j) = B[j][l]: rows j0 .. j0 + 15 of B
      const double* bt = p.B;
      int jl = j0;
      if (p.distB) {
        const int rk = j0 / rows;
        bt = peer(p.B, rk);
        jl = j0 - rk * rows;
      }
      accumulate(a, p.lda, bt + (jl + g) * p.ldb + t,
                 bt + (jl + jr - j0 + g) * p.ldb + t, 1, p.c);
    } else if (!p.distB) {
      accumulate(a, p.lda, p.B + (j0 + g) + t * p.ldb,
                 p.B + (jr + g) + t * p.ldb, p.ldb, p.c);
    } else {
      // B(l, j) = B[l][j]: `rows` rows of the inner dimension a CTA
      for (int l0 = 0, rk = 0; l0 < p.c; l0 += rows, ++rk) {
        const double* bp = peer(p.B, rk);
        const int len = p.c - l0 < rows ? p.c - l0 : rows;
        accumulate(a + l0, p.lda, bp + (j0 + g) + t * p.ldb,
                   bp + (jr + g) + t * p.ldb, p.ldb, len);
      }
    }
    if (p.c2 > 0) {
      const int rk = j0 / rows;
      const double* bt = peer(p.B2, rk);
      const int jl = j0 - rk * rows;
      accumulate(p.A2 + (i0 + g) * p.lda2 + t, p.lda2,
                 bt + (jl + g) * p.ldb2 + t,
                 bt + (jl + jr - j0 + g) * p.ldb2 + t, 1, p.c2);
    }
    const bool bounded = G != nullptr || O != nullptr || p.eye;
#pragma unroll
    for (int rt = 0; rt < kTiles; ++rt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int il = i0 + 16 * rt + 8 * h + g;
        const int i = p.row0 + il;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q == 1 && !second) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + 8 * q + 2 * t + e;
            const int f = 2 * h + e;
            double val = p.sign * (kOneChain ? acc[0][rt][q][f]
                                             : acc[0][rt][q][f] +
                                                   acc[1][rt][q][f]);
            if (p.E) val += p.E[il * p.lde + j];
            if (bounded) {
              if (i < p.r && j < p.m) {
                if (p.eye && i == j) val += 1.0;
                if (G) val += double(G[i * ldg + j]);
                if (O) O[i * ldo + j] = S(val);
              } else {
                val = 0.0;
              }
            }
            if (p.C) p.C[il * p.ldc + j] = val;
          }
        }
      }
    }
  }
}

}  // namespace gcp
