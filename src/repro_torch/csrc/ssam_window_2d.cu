// K1 single-channel instantiations for 2-D plans of N in [1, 16] filter
// rows: P = 32 rows of register-cached outputs per thread up to N = 13,
// P = 16 above (the cache of N + P - 1 rows stays in 128 registers, no
// spills). Paired runs on the card: P = 16 was 15-25 % faster than P = 8;
// P = 32 another 4-15 % at t = 1 (most on the star stencils, whose steps
// each hold one tap), within 7 % either way on dense filters at t = 2.
#include "ssam_window.cuh"

namespace ssam {

#define SSAM_2D(n) \
  case n:          \
    return window_kernel<n, 1, (n <= 13 ? 32 : 16), kThreads2d, false>;

KernelFn pick_2d_narrow(int N) {
  switch (N) {
    SSAM_2D(1) SSAM_2D(2) SSAM_2D(3) SSAM_2D(4) SSAM_2D(5) SSAM_2D(6)
    SSAM_2D(7) SSAM_2D(8) SSAM_2D(9) SSAM_2D(10) SSAM_2D(11) SSAM_2D(12)
    SSAM_2D(13) SSAM_2D(14) SSAM_2D(15) SSAM_2D(16)
    default:
      return nullptr;
  }
}

}  // namespace ssam
