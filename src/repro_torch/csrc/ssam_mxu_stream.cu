// K2 single-channel instantiations for streamed launches (a translation
// unit of its own so that it builds beside ssam_mxu.cu): a plan whose B
// tiles a block cannot keep resident (more than 1024 taps, or too many
// tiles for shared memory beside the staged input), its tiles brought in
// a group of entries at a time (see ssam_mxu.cuh). One a plan's largest
// entry (1-4 k-steps), never strided, never a chain.
#include "ssam_mxu.cuh"

namespace ssam {

MxuKernelFn pick_mxu_stream(int kkmax) {
  switch (kkmax) {
    case 1: return mxu_window_kernel<1, false, false, true>;
    case 2: return mxu_window_kernel<2, false, false, true>;
    case 3: return mxu_window_kernel<3, false, false, true>;
    case 4: return mxu_window_kernel<4, false, false, true>;
  }
  return nullptr;
}

}  // namespace ssam
