#!/usr/bin/env python3
"""Write a copy of the cycle-reduction sources with bounds checks, for
``tools/cr_variants.py src=DIR``.

Run from the root of a checkout:

    python3 tools/cr_checked_copy.py [--panel 8] DIR
    python3 tools/cr_variants.py --n 104 --m 7 --tiers cluster src=DIR

It copies ``geconpy_torch/csrc`` into ``DIR/geconpy_torch/csrc`` (put DIR
under ``build/``, which ``.gitignore`` covers), sets the cluster tier's
panel width ``kCrPanel`` (``cycle_reduction_tiers.cu``) to ``--panel``, and
inserts checks that print the failing indices and trap:

- every ``tile_mm`` and ``cluster_mm`` reads and writes its operands that
  lie in the CTA's own shared memory (``__isShared``) inside the block's
  dynamic shared memory, up to the last row and column its 8- or 4-wide
  steps touch; ``cluster_mm`` checks its peers' operands at the same
  offsets in its own CTA (every CTA of a cluster has the same layout);
- ``peer`` maps a rank of the cluster, from an address inside the block's
  shared memory; a ``cluster_mm`` item's rows lie inside the CTA's panel;
- the cluster tier's layout fits its launch, its cluster has the CTAs the
  plan says, and its pivot rows and output rows (``lpos``) lie in 0..n-1.

A width that is not a multiple of 8 also drops the ``static_assert`` that
forbids it, to build what a panel-width knob once could: ``tile_mm``'s
8-wide steps then read rows of the panel's pivot rows past their end.
"""

from __future__ import annotations

import argparse
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

CHECK_MACROS = r'''#include <cstdio>

// bounds checks (tools/cr_checked_copy.py)
#define GCP_CHK(cond, tag, a, b)                                            \
  do {                                                                      \
    if (!(cond)) {                                                          \
      printf("CHK %s block %d thread %d: %lld %lld\n", tag, (int)blockIdx.x, \
             (int)threadIdx.x, (long long)(a), (long long)(b));             \
      __trap();                                                             \
    }                                                                       \
  } while (0)
// p[0 .. count - 1] inside the block's dynamic shared memory, where p is
// this CTA's shared memory
#define GCP_CHK_SMEM(p, count, tag)                                         \
  do {                                                                      \
    if ((p) != nullptr && __isShared(p)) {                                  \
      extern __shared__ __align__(16) unsigned char gcp_chk_smem[];         \
      unsigned dyn_;                                                        \
      asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn_));        \
      const long long lo_ = (long long)__cvta_generic_to_shared(            \
          gcp_chk_smem);                                                    \
      const long long at_ = (long long)__cvta_generic_to_shared(p);         \
      const long long end_ = at_ + (long long)sizeof(*(p)) * (count);       \
      GCP_CHK(at_ >= lo_ && end_ <= lo_ + dyn_, tag, end_ - lo_, dyn_);     \
    }                                                                       \
  } while (0)
'''

# (file, anchor, text inserted after the anchor[, or before it])
INSERTS = [
    ("small_linalg.cuh", "#include <math.h>\n", CHECK_MACROS),
    ("small_linalg.cuh",
     "  const int sj = p.transB ? p.ldb : 1, sl = p.transB ? 1 : p.ldb;\n",
     """  {
    const int lmax = kTall ? ((p.c + 3) & ~3) : ((p.c + 7) & ~7);
    const int imax = ((p.r + (1 << kRowShift) - 1) >> kRowShift)
                     << kRowShift;
    const int jmax = (p.m + 7) & ~7;
    GCP_CHK_SMEM(p.A, (long long)(imax - 1) * p.lda + lmax, "tile_mm A");
    GCP_CHK_SMEM(p.B, (long long)(jmax - 1) * sj + (long long)(lmax - 1) * sl
                          + 1, "tile_mm B");
    if (p.c2 > 0) {
      const int l2 = ((p.c2 + 7) & ~7);
      GCP_CHK_SMEM(p.A2, (long long)(imax - 1) * p.lda2 + l2, "tile_mm A2");
      GCP_CHK_SMEM(p.B2, (long long)(jmax - 1) * p.ldb2 + l2, "tile_mm B2");
    }
    GCP_CHK_SMEM(p.E, (long long)(imax - 1) * p.lde + jmax, "tile_mm E");
    GCP_CHK_SMEM(p.C, (long long)(imax - 1) * p.ldc + jmax, "tile_mm C");
  }
"""),
    ("cluster_linalg.cuh",
     "template <typename T>\n__device__ __forceinline__ T* peer(T* p, int rank) {\n",
     """  {
    unsigned nct;
    asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(nct));
    GCP_CHK(rank >= 0 && rank < (int)nct, "peer rank", rank, nct);
    GCP_CHK_SMEM(p, 1, "peer address");
  }
"""),
    ("cluster_linalg.cuh",
     "  const int items = ((p.nloc + kItemRows - 1) / kItemRows) * chunks;\n",
     """  {
    const int lmax = (p.c + 7) & ~7;
    const int imax = (p.nloc + kItemRows - 1) / kItemRows * kItemRows;
    const int jmax = (p.m + 7) & ~7;
    GCP_CHK(imax <= rows, "cluster_mm rows", imax, rows);
    GCP_CHK_SMEM(p.A, (long long)(imax - 1) * p.lda + lmax, "cluster_mm A");
    if (p.transB)   // a peer's rows j - rank * rows
      GCP_CHK_SMEM(p.B, (long long)((p.distB ? rows : jmax) - 1) * p.ldb
                            + lmax, "cluster_mm B");
    else            // a peer's rows l - rank * rows
      GCP_CHK_SMEM(p.B, (long long)((p.distB ? ((rows + 7) & ~7) : lmax) - 1)
                            * p.ldb + jmax, "cluster_mm B");
    if (p.c2 > 0)
      GCP_CHK_SMEM(p.B2, (long long)(rows - 1) * p.ldb2 + ((p.c2 + 7) & ~7),
                   "cluster_mm B2");
    GCP_CHK_SMEM(p.E, (long long)(imax - 1) * p.lde + jmax, "cluster_mm E");
    GCP_CHK_SMEM(p.C, (long long)(imax - 1) * p.ldc + jmax, "cluster_mm C");
  }
"""),
    ("cycle_reduction_tiers.cu",
     "      const int P = prow[j];\n      const double pi = pinv[j];\n",
     "      GCP_CHK(P >= 0 && P < n, \"pivot row\", P, n);\n"),
    ("cycle_reduction_tiers.cu",
     "    T_out[lpos[row0 + il] * n + j] = S(aug[il * lda + n8 + j]);\n",
     "    GCP_CHK(lpos[row0 + il] >= 0 && lpos[row0 + il] < n, \"T row\",\n"
     "            lpos[row0 + il], n);\n", True),
    ("cycle_reduction_tiers.cu",
     "    R_out[lpos[row0 + il] * m + j] = S(aug[il * lda + n8 + j]);\n",
     "    GCP_CHK(lpos[row0 + il] >= 0 && lpos[row0 + il] < n, \"R row\",\n"
     "            lpos[row0 + il], n);\n", True),
    ("cycle_reduction_tiers.cu",
     "  const CrClusterLayout L(n, m, rows);\n",
     """  {
    unsigned dyn, nct;
    asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
    asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(nct));
    GCP_CHK((long long)L.total * 8 <= dyn, "layout", L.total * 8, dyn);
    GCP_CHK((int)nct == ctas, "ctas", ctas, nct);
  }
"""),
]


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("dir", type=pathlib.Path)
    parser.add_argument("--panel", type=int, default=8)
    opts = parser.parse_args()
    out = opts.dir.resolve() / "geconpy_torch" / "csrc"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(ROOT / "geconpy_torch" / "csrc", out)
    for name, anchor, text, *before in INSERTS:
        path = out / name
        src = path.read_text()
        if src.count(anchor) != 1:
            print(f"cr_checked_copy: {name}: the anchor {anchor!r} is not "
                  "there once; the source has moved", file=sys.stderr)
            return 1
        path.write_text(src.replace(
            anchor, text + anchor if before else anchor + text))
    tiers = out / "cycle_reduction_tiers.cu"
    src = tiers.read_text()
    old = "constexpr int kCrPanel = 8;"
    if src.count(old) != 1:
        print("cr_checked_copy: kCrPanel moved", file=sys.stderr)
        return 1
    src = src.replace(old, f"constexpr int kCrPanel = {opts.panel};")
    if opts.panel % 8:
        src = "".join(line for line in src.splitlines(keepends=True)
                      if not line.startswith("static_assert(kCrPanel % 8"))
    tiers.write_text(src)
    print(f"cr_checked_copy: {out} (kCrPanel = {opts.panel})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
