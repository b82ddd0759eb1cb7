// K1 instantiations for 2-D plans: N filter rows in [1, 32], P = 8 rows
// of register-cached outputs per thread.
#include "ssam_window.cuh"

namespace ssam {

#define SSAM_2D(n) \
  case n:          \
    return window_kernel<n, 1, 8>;

KernelFn pick_2d(int N) {
  switch (N) {
    SSAM_2D(1) SSAM_2D(2) SSAM_2D(3) SSAM_2D(4) SSAM_2D(5) SSAM_2D(6)
    SSAM_2D(7) SSAM_2D(8) SSAM_2D(9) SSAM_2D(10) SSAM_2D(11) SSAM_2D(12)
    SSAM_2D(13) SSAM_2D(14) SSAM_2D(15) SSAM_2D(16) SSAM_2D(17) SSAM_2D(18)
    SSAM_2D(19) SSAM_2D(20) SSAM_2D(21) SSAM_2D(22) SSAM_2D(23) SSAM_2D(24)
    SSAM_2D(25) SSAM_2D(26) SSAM_2D(27) SSAM_2D(28) SSAM_2D(29) SSAM_2D(30)
    SSAM_2D(31) SSAM_2D(32)
    default:
      return nullptr;
  }
}

}  // namespace ssam
