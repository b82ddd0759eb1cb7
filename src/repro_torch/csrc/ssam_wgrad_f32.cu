// K3 single-channel instantiations, fp32 input (V = 4 values a lane):
// one per width bucket and its band rows and per walk (a filter per
// image or not), the table SSAM_WGRAD_F32
// that the build generates from core/engine.py::WGRAD_BAND_ROWS.
#include "ssam_wgrad.cuh"

namespace ssam {

WgradFn pick_wgrad_f32(int mb, int nb, bool runs) {
#define SSAM_WG(MB, NB)                                  \
  if (mb == MB && nb == NB)                              \
    return runs ? &wgrad_rows_kernel<false, MB, NB, true> \
                : &wgrad_rows_kernel<false, MB, NB, false>;
  SSAM_WGRAD_F32(SSAM_WG)
#undef SSAM_WG
  return nullptr;
}

}  // namespace ssam
