// K1's single-channel instantiations for footprints walked in bands (see
// ssam_window.cuh): one a row count of core/engine.py::WINDOW_CHAIN_ROWS,
// the first at or above the largest band's rows (core/engine.py::
// window_inst), P as the plain 2-D tables (32 up to 13 rows, 16 above).
#include "ssam_window.cuh"

namespace ssam {

#define SSAM_BAND_2D(n) \
  case n:               \
    return window_kernel<n, 1, (n <= 13 ? 32 : 16), kThreads2d, false, false, \
                         true>;

KernelFn pick_band_2d(int N) {
  switch (N) {
    SSAM_BAND_2D(1) SSAM_BAND_2D(2) SSAM_BAND_2D(3) SSAM_BAND_2D(4)
    SSAM_BAND_2D(5) SSAM_BAND_2D(7) SSAM_BAND_2D(9) SSAM_BAND_2D(11)
    SSAM_BAND_2D(13) SSAM_BAND_2D(17) SSAM_BAND_2D(21) SSAM_BAND_2D(25)
    SSAM_BAND_2D(32)
    default:
      return nullptr;
  }
}

}  // namespace ssam
