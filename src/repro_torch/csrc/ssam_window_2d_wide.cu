// K1 single-channel instantiations for 2-D plans of N in [17, 32] filter
// rows, P = 16 (a translation unit of its own so it builds beside
// ssam_window_2d.cu; paired runs: 11-14 % faster than P = 8 on 17 x 17 and
// 20 x 20 filters, up to 127 registers, no spills; P = 32 gained 3 % at
// t = 1 and lost 3 % at t = 2).
#include "ssam_window.cuh"

namespace ssam {

#define SSAM_2D(n) \
  case n:          \
    return window_kernel<n, 1, 16, kThreads2d, false>;

KernelFn pick_2d_wide(int N) {
  switch (N) {
    SSAM_2D(17) SSAM_2D(18) SSAM_2D(19) SSAM_2D(20) SSAM_2D(21) SSAM_2D(22)
    SSAM_2D(23) SSAM_2D(24) SSAM_2D(25) SSAM_2D(26) SSAM_2D(27) SSAM_2D(28)
    SSAM_2D(29) SSAM_2D(30) SSAM_2D(31) SSAM_2D(32)
    default:
      return nullptr;
  }
}

}  // namespace ssam
