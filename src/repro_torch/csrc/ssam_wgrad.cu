// Plain C entry of K3's single-channel path (the kernel and its design
// note: ssam_wgrad.cuh), loaded with ctypes, and the pass that adds the
// blocks' partial sums in block order.
//
// x (batch, hin, win) and g (batch, ho, wo) at row pitches of a multiple of
// 16 bytes (x_pitch, g_pitch, elements), fp32 or bf16, image b feeding
// filter b % filters; out (filters, N, M) fp32; part (grid + filters - 1,
// N, M) fp32, or out itself when grid == 1; red_bytes the reduction
// buffer's own bytes after the ring (0 with one filter: it reuses the
// ring). The layout is
// core/engine.py::WgradLayout's, passed as it is: the width bucket mb, the
// band rows nb a thread holds, the bands and row groups of a block, the
// chunk's rows, the ring, a stage's regions, the grid, and ntiles tiles of
// the footprint's taps, 7 ints each (core/engine.py::WgradTile: n0, m0,
// n, m, ly, goff, d), one launch each. This entry checks the layout; it
// derives none of it.
// Returns a cudaError_t, or kTmaError + the CUresult where a tensor map
// cannot be encoded.
#include "ssam_wgrad.cuh"

namespace ssam {

// out[c][e] = sum over the blocks k whose run of units (from k (rounds -
// 1) + min(k, rem), rounds or rounds - 1 of them) meets channel
// c's (units [c upc, (c + 1) upc)) of their partial part[k + c][e], in
// block order; with one filter (a walk of stride grid), every block's.
__global__ void wgrad_sum_kernel(const float* part, float* out, int grid,
                                 int rounds, int rem, int upc, int filters,
                                 int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)filters * n) return;
  const int c = (int)(i / n), e = (int)(i % n);
  const long long lo = (long long)c * upc, hi = lo + upc;
  float s = 0.f;
  for (int k = 0; k < grid; ++k) {
    const long long r0 = (long long)k * (rounds - 1) + min(k, rem);
    const long long r1 = r0 + rounds - (k < rem ? 0 : 1);
    if (filters == 1 || (r0 < hi && r1 > lo))
      s += part[(size_t)(k + c) * n + e];
  }
  out[i] = s;
}

}  // namespace ssam

extern "C" int ssam_wgrad_launch(
    const void* x, const void* g, int io_bf16, float* part, float* out,
    int batch, int hin, int win, int x_pitch, int ho, int wo, int g_pitch,
    int N, int M, int mb, int nb, int nbands, int rgroups, int rows, int hw,
    int stages, int stage_bytes, int gh_off, int x_off, int grid,
    int smem_bytes, int filters, int red_bytes, int ntiles, const int* tiles,
    void* stream) {
  using namespace ssam;
  const int V = io_bf16 ? 8 : 4, es = io_bf16 ? 2 : 4, SW = 32 * V;
  WgradFn fn = io_bf16 ? pick_wgrad_bf16(mb, nb, filters > 1)
                       : pick_wgrad_f32(mb, nb, filters > 1);
  const int strips = (win + SW - 1) / SW, chunks = (ho + rows - 1) / rows;
  const long long units = (long long)batch * chunks * strips;
  const int threads = 32 * nbands * rgroups;
  const long long red = 4LL * threads / 32 * nb * mb;
  if (fn == nullptr || N < 1 || M < 1 || nbands < 1 || rgroups < 1 ||
      threads > wg_threads(mb) || rows < 1 || hw < 0 || hw > 256 ||
      hw % V || batch < 1 || hin < 1 || win < 1 || ho < 1 || wo < 1 ||
      units > 0x7fffffffLL || grid < 1 || grid > units || stages < 2 ||
      stages > kWgMaxStages || stage_bytes % 128 || gh_off % 128 ||
      x_off % 128 || gh_off < rows * SW * es ||
      x_off < gh_off + rows * hw * es ||
      filters < 1 || batch % filters ||
      (filters > 1 ? red_bytes < red : red_bytes != 0) ||
      smem_bytes < 256 + stages * stage_bytes + red_bytes ||
      smem_bytes < 256 + red ||
      (x_pitch * es) % 16 || x_pitch < win || (g_pitch * es) % 16 ||
      g_pitch < wo || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(g) & 15) || ntiles < 1)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const CUtensorMapDataType dt = io_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint32_t ones[3] = {1, 1, 1};
  const cuuint64_t xdims[3] = {(cuuint64_t)win, (cuuint64_t)hin,
                               (cuuint64_t)batch};
  const cuuint64_t gdims[3] = {(cuuint64_t)wo, (cuuint64_t)ho,
                               (cuuint64_t)batch};
  const cuuint64_t xrow = (cuuint64_t)x_pitch * es;
  const cuuint64_t grow = (cuuint64_t)g_pitch * es;
  const cuuint64_t xstr[2] = {xrow, xrow * hin}, gstr[2] = {grow, grow * ho};
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int t = 0; t < ntiles; ++t) {
    const int* tl = tiles + 7 * t;
    const int n0 = tl[0], m0 = tl[1], n = tl[2], m = tl[3];
    WgradRowsArgs a;
    a.part = (grid > 1 ? part : out) + n0 * M + m0;
    a.pstride = N * M;
    a.ld = M;
    a.ho = ho;
    a.N = n;
    a.M = m;
    a.ly = tl[4];
    a.goff = tl[5];
    a.d = tl[6];
    a.hw = hw;
    a.nbands = nbands;
    a.rgroups = rgroups;
    a.rows = rows;
    a.strips = strips;
    a.chunks = chunks;
    a.units = (int)units;
    a.filters = filters;
    a.upc = (int)(units / filters);
    a.red_off = red_bytes ? stages * stage_bytes : 0;
    a.rounds = (int)((units + grid - 1) / grid);
    a.rem = units % grid ? (int)(units % grid) : grid;
    a.stages = stages;
    a.stage_bytes = stage_bytes;
    a.gh_off = gh_off;
    a.x_off = x_off;
    const int xrows = rows + n - 1;
    a.tx_bytes = (rows * (SW + hw) + xrows * SW) * es;
    if (n0 < 0 || m0 < 0 || n < 1 || m < 1 || n0 + n > N || m0 + m > M ||
        m > mb || (n + nbands - 1) / nbands > nb || xrows > 256 ||
        a.goff % V || a.d < 0 || a.d >= V || hw < a.d + m - 1 ||
        stage_bytes < x_off + xrows * SW * es)
      return (int)cudaErrorInvalidValue;
    CUtensorMap maps[3];
    const void* base[3] = {x, g, g};
    const cuuint64_t* dims[3] = {xdims, gdims, gdims};
    const cuuint64_t* strides[3] = {xstr, gstr, gstr};
    const cuuint32_t boxes[3][3] = {{(cuuint32_t)SW, (cuuint32_t)xrows, 1},
                                    {(cuuint32_t)SW, (cuuint32_t)rows, 1},
                                    {(cuuint32_t)(hw ? hw : V),
                                     (cuuint32_t)rows, 1}};
    for (int k = 0; k < 3; ++k) {
      const CUresult r = encode(
          &maps[k], dt, 3, const_cast<void*>(base[k]), dims[k], strides[k],
          boxes[k], ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      if (r != CUDA_SUCCESS) return kTmaError + (int)r;
    }
    fn<<<grid, threads, smem_bytes, st>>>(maps[0], maps[1], maps[2], a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (grid == 1) return 0;
  const int nm = N * M;
  const long long all = (long long)filters * nm;
  const int rounds = (int)((units + grid - 1) / grid);
  const int rem = units % grid ? (int)(units % grid) : grid;
  wgrad_sum_kernel<<<(int)((all + 255) / 256), 256, 0, st>>>(
      part, out, grid, rounds, rem, (int)(units / filters), filters, nm);
  return (int)cudaGetLastError();
}
