// K1 single-channel instantiations for output-strided 2-D plans (no
// shuffles; N the register cache's ceil(N / sh) rows), a translation unit
// of its own so it builds beside the stride-1 tables: one an exact row
// count up to 16 (every plan of up to 32 filter rows at a row stride of 2
// or more), P = 16 (16 rows by 32 columns an item keep the eight warps
// busy on tiles that are the input's sh * sw-th part); above 16 rows
// (reachable at row stride 1 only) one instantiation of 32 rows, P = 8,
// that loads only the rows its taps read. On the card (separate runs of
// chip_smoke.py), buckets of 4 and 8 rows in place of the exact 2, 3 and
// 5 made the forward 30-75 % slower (128 registers, at the cap, against
// 122).
#include "ssam_window.cuh"

namespace ssam {

#define SSAM_2D_STRIDED(n) \
  case n:                  \
    return window_kernel<n, 1, 16, kThreads2d, true>;

KernelFn pick_2d_strided(int N) {
  switch (N) {
    SSAM_2D_STRIDED(1) SSAM_2D_STRIDED(2) SSAM_2D_STRIDED(3)
    SSAM_2D_STRIDED(4) SSAM_2D_STRIDED(5) SSAM_2D_STRIDED(6)
    SSAM_2D_STRIDED(7) SSAM_2D_STRIDED(8) SSAM_2D_STRIDED(9)
    SSAM_2D_STRIDED(10) SSAM_2D_STRIDED(11) SSAM_2D_STRIDED(12)
    SSAM_2D_STRIDED(13) SSAM_2D_STRIDED(14) SSAM_2D_STRIDED(15)
    SSAM_2D_STRIDED(16)
    default:
      return N <= 32 ? window_kernel<32, 1, 8, kThreads2d, true> : nullptr;
  }
}

}  // namespace ssam
