// K1 single-channel instantiations for fused pipelines of 3-D stages: N
// rows and D slices each the first of core/engine.py::WINDOW_CHAIN_3D (3,
// 5) at or above the largest stage's, 512 threads, P = 8 (the records'
// registers put the 3 x 3 x 3 cache at P = 16 over the 128 a thread may
// use).
#include "ssam_window.cuh"

namespace ssam {

#define SSAM_CHAIN_3D(n, d) \
  if (N <= n && D <= d) return window_kernel<n, d, 8, kThreads3d, false, true>;

KernelFn pick_chain_3d(int N, int D) {
  if (N < 1 || D < 1) return nullptr;
  SSAM_CHAIN_3D(3, 3) SSAM_CHAIN_3D(3, 5) SSAM_CHAIN_3D(5, 3)
  SSAM_CHAIN_3D(5, 5)
  return nullptr;
}

}  // namespace ssam
