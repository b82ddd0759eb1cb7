// K1 single-channel instantiations for fused pipelines of 2-D stages (a
// translation unit of its own so it builds beside the others): N the
// first of core/engine.py::WINDOW_CHAIN_ROWS at or above the largest
// stage's rows, P as for the plans that are no chain (32 up to 13 rows,
// 16 above). A stage with fewer rows loads the instantiation's.
#include "ssam_window.cuh"

namespace ssam {

#define SSAM_CHAIN_2D(n) \
  if (N <= n)            \
    return window_kernel<n, 1, (n <= 13 ? 32 : 16), kThreads2d, false, true>;

KernelFn pick_chain_2d(int N) {
  if (N < 1) return nullptr;
  SSAM_CHAIN_2D(1) SSAM_CHAIN_2D(2) SSAM_CHAIN_2D(3) SSAM_CHAIN_2D(4)
  SSAM_CHAIN_2D(5) SSAM_CHAIN_2D(7) SSAM_CHAIN_2D(9) SSAM_CHAIN_2D(11)
  SSAM_CHAIN_2D(13) SSAM_CHAIN_2D(17) SSAM_CHAIN_2D(21) SSAM_CHAIN_2D(25)
  SSAM_CHAIN_2D(32)
  return nullptr;
}

}  // namespace ssam
