// K1 instantiations for 3-D plans: N rows and D slices in [1, 5], P = 4
// rows of register-cached outputs per thread (the cache holds D * C
// values, C = N + P - 1).
#include "ssam_window.cuh"

namespace ssam {

#define SSAM_3D(n, d) \
  if (N == n && D == d) return window_kernel<n, d, 4>;
#define SSAM_3D_ROW(n) \
  SSAM_3D(n, 1) SSAM_3D(n, 2) SSAM_3D(n, 3) SSAM_3D(n, 4) SSAM_3D(n, 5)

KernelFn pick_3d(int N, int D) {
  SSAM_3D_ROW(1) SSAM_3D_ROW(2) SSAM_3D_ROW(3) SSAM_3D_ROW(4) SSAM_3D_ROW(5)
  return nullptr;
}

}  // namespace ssam
