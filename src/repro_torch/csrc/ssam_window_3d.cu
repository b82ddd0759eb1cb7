// K1 single-channel instantiations for 3-D plans: N rows and D slices in
// [1, 5], 512 threads a block, P rows of register-cached outputs per
// thread (the cache holds D * C values, C = N + P - 1): P = 16 where that
// cache at P = 16 holds at most 54 values (D * (N + 15) <= 54: the 3 x 3
// footprints), else P = 8, so that no instantiation spills. Paired runs on
// the card: P = 8 was 20-25 % faster than P = 4 on 3 x 3, 12-26 % on 5 x 5
// at t = 1 (within 4 % at t = 2), P = 2 slower; P = 16 another 9-18 % on
// 3d7pt and poisson (3d27pt within 4 %).
#include "ssam_window.cuh"

namespace ssam {

#define SSAM_3D(n, d) \
  if (N == n && D == d) \
    return window_kernel<n, d, (d * (n + 15) <= 54 ? 16 : 8), kThreads3d, \
                         false>;
#define SSAM_3D_ROW(n) \
  SSAM_3D(n, 1) SSAM_3D(n, 2) SSAM_3D(n, 3) SSAM_3D(n, 4) SSAM_3D(n, 5)

KernelFn pick_3d(int N, int D) {
  SSAM_3D_ROW(1) SSAM_3D_ROW(2) SSAM_3D_ROW(3) SSAM_3D_ROW(4) SSAM_3D_ROW(5)
  return nullptr;
}

}  // namespace ssam
