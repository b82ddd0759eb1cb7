// K2 single-channel instantiations for fused pipelines (a translation unit
// of its own so that it builds beside ssam_mxu.cu): one a chain's largest
// entry (1-4 k-steps), never strided. The stage records and mid-chain ops
// live only in these, so the plans that are no chain keep their code.
#include "ssam_mxu.cuh"

namespace ssam {

MxuChainKernelFn pick_mxu_chain(int kkmax) {
  switch (kkmax) {
    case 1: return mxu_window_kernel<1, false, true>;
    case 2: return mxu_window_kernel<2, false, true>;
    case 3: return mxu_window_kernel<3, false, true>;
    case 4: return mxu_window_kernel<4, false, true>;
  }
  return nullptr;
}

}  // namespace ssam
