// Plain C entry of K1 (see ssam_window.cuh), loaded with ctypes.
#include "ssam_window.cuh"

extern "C" int ssam_window_launch(
    const void* x, void* out, int io_bf16, const float* cvals,
    const int* cidx, const int* shifts, int batch, int zin, int hin, int win,
    int zo, int ho, int wo, int lz, int ly, int lx, int ndim, int D, int N,
    int steps, int M, int t, int variant, int bz, int bh, int bw,
    int smem_bytes, void* stream) {
  ssam::KernelFn fn = ndim == 2 ? ssam::pick_2d(N) : ssam::pick_3d(N, D);
  if (fn == nullptr || steps < 1 || steps > ssam::kMaxSteps ||
      steps * D * N > ssam::kMaxSlots || M < 1 || M > ssam::kWarp || t < 1)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  ssam::WindowArgs a;
  a.x = x;
  a.out = out;
  a.io_bf16 = io_bf16;
  a.cvals = cvals;
  a.cidx = cidx;
  a.shifts = shifts;
  a.batch = batch;
  a.zin = zin;
  a.hin = hin;
  a.win = win;
  a.zo = zo;
  a.ho = ho;
  a.wo = wo;
  a.lz = lz;
  a.ly = ly;
  a.lx = lx;
  a.steps = steps;
  a.M = M;
  a.t = t;
  a.variant = variant;
  a.bz = bz;
  a.bh = bh;
  a.bw = bw;
  const int tiles_z = (zo + bz - 1) / bz;
  dim3 grid((wo + bw - 1) / bw, (ho + bh - 1) / bh, batch * tiles_z);
  fn<<<grid, ssam::kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
