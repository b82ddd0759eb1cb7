// Plain C entry of K1's single-channel path (see ssam_window.cuh), loaded
// with ctypes. `geom` holds core/engine.py::WindowLayout.geom: kGeomInts
// ints
//   ndim, D, N, M, steps, ntaps, t, variant,
//   batch, zin, hin, win, pitch (x's row pitch, elements),
//   zo, ho, wo, lz, ly, lx, bz, bh, bw,
//   box_x, box_y, box_z, nbx, nby, nbz,
//   stages, stage_bytes, buf_c0, buf_a, buf_b, smem_bytes, grid,
//   filters, fsz (the filters cycled over the images and the
//   coefficients of one, 1 and 0 for one filter),
//   sh, sw (the output stride), o_row, o_col, o_plane, o_img (the
//   output's step, elements), bands (1: a banded launch),
// then the steps' records (shift, first tap, taps, dense), 4 ints each;
// `table` on the card holds the records too, then the taps' slots and
// coefficient indices (into one filter of `cvals`). `chain` holds
// core/engine.py::WindowLayout.chain: nchain, N and D of the instantiation,
// nmid, then nchain records (first step, steps, N | D << 8 | M << 16, mid
// ops first | count << 8), then nmid ops (code, value's float bits, index
// of a bias in `cvals` or -1); a plan that is no chain has one record, run
// t times, a chain's t is 1; a banded launch has one record a band (first
// step, steps, Nb | 1 << 8 | Mb << 16, r0 | c0 << 16), every application
// walking all of them, and no mid-chain ops. The epilogue: epi_ops
// and epi_vals host arrays of kMaxEpi entries, `bias` a scalar, or one a
// filter, on the card (or null), `resid` the
// residual in the output's dtype and dense layout (or null).
// Returns a cudaError_t, or kTmaError + the CUresult where the tensor map
// cannot be encoded.
#include <string.h>

#include "ssam_window.cuh"

extern "C" int ssam_window_launch(const void* x, void* out, int io_bf16,
                                  const float* cvals, const int* table,
                                  const int* geom, int ngeom,
                                  const int* chain, int nchain_ints,
                                  const float* bias, const void* resid,
                                  const int* epi_ops, const float* epi_vals,
                                  int n_epi, void* stream) {
  using namespace ssam;
  if (ngeom < kGeomInts || geom[4] < 1 ||
      geom[4] > (geom[43] ? kMaxBandSteps : kMaxSteps) ||
      ngeom != kGeomInts + 4 * geom[4])
    return (int)cudaErrorInvalidValue;
  const int* g = geom;
  WindowArgs a;
  a.out = out;
  a.io_bf16 = io_bf16;
  a.cvals = cvals;
  a.table = table;
  a.ndim = g[0];
  a.D = g[1];
  a.N = g[2];
  a.M = g[3];
  a.steps = g[4];
  a.ntaps = g[5];
  a.t = g[6];
  a.variant = g[7];
  a.batch = g[8];
  const int zin = g[9], hin = g[10], win = g[11], pitch = g[12];
  a.zo = g[13];
  a.ho = g[14];
  a.wo = g[15];
  a.lz = g[16];
  a.ly = g[17];
  a.lx = g[18];
  a.bz = g[19];
  a.bh = g[20];
  a.bw = g[21];
  a.box_x = g[22];
  a.box_y = g[23];
  a.box_z = g[24];
  a.nbx = g[25];
  a.nby = g[26];
  a.nbz = g[27];
  a.stages = g[28];
  a.stage_bytes = g[29];
  a.buf_c0 = g[30];
  a.buf_a = g[31];
  a.buf_b = g[32];
  const int smem_bytes = g[33], grid = g[34];
  a.filters = g[35];
  a.fsz = g[36];
  a.sh = g[37];
  a.sw = g[38];
  a.o_row = g[39];
  a.o_col = g[40];
  a.o_plane = g[41];
  a.o_img = g[42];
  a.bands = g[43];
  if (n_epi < 0 || n_epi > kMaxEpi) return (int)cudaErrorInvalidValue;
  a.bias = bias;
  a.resid = resid;
  for (int s = 0; s < kMaxEpi; ++s) {
    a.epi_op[s] = s < n_epi ? epi_ops[s] : 0;
    a.epi_val[s] = s < n_epi ? epi_vals[s] : 0.f;
    if ((a.epi_op[s] == 1 && bias == nullptr) ||
        (a.epi_op[s] == 6 && resid == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  a.n_epi = n_epi;
  for (int m = 0; m < kMaxSteps; ++m) {
    const int* r = geom + kGeomInts + 4 * (m < a.steps ? m : 0);
    a.step[m] = make_int4(r[0], r[1], r[2], r[3]);
  }
  if (nchain_ints < 4) return (int)cudaErrorInvalidValue;
  a.nchain = chain[0];
  a.inst_n = chain[1];
  a.inst_d = chain[2];
  const int nmid = chain[3];
  if (a.nchain < 1 || a.nchain > kMaxChain || nmid < 0 || nmid > kMaxMid ||
      nchain_ints != 4 + 4 * a.nchain + 3 * nmid ||
      (a.nchain > 1 && a.t != 1 && !a.bands) ||
      (a.bands && (nmid != 0 || a.ndim != 2)))
    return (int)cudaErrorInvalidValue;
  // the records: steps in range, footprints within the instantiation, the
  // applications' shrinkage the staged extent's (a band: within the plan's
  // footprint)
  int grow_n = 0, grow_m = 0, grow_d = 0;
  for (int k = 0; k < kMaxChain; ++k) {
    const int* r = chain + 4 + 4 * (k < a.nchain ? k : 0);
    a.chain[k] = make_int4(r[0], r[1], r[2], r[3]);
    if (k >= a.nchain) continue;
    const int n = r[2] & 255, d = (r[2] >> 8) & 255, m = r[2] >> 16;
    const int e0 = r[3] & 255, ne = r[3] >> 8;
    if (r[0] < 0 || r[1] < 1 || r[0] + r[1] > a.steps || n < 1 ||
        n > a.inst_n || d < 1 || d > a.inst_d || m < 1 || m > kWarp)
      return (int)cudaErrorInvalidValue;
    if (a.bands) {
      const int r0 = r[3] & 0xffff, c0 = r[3] >> 16;
      if (d != 1 || r0 + n > a.N || c0 < 0 || c0 + m > a.M)
        return (int)cudaErrorInvalidValue;
      continue;
    }
    if (e0 + ne > nmid) return (int)cudaErrorInvalidValue;
    grow_n += n - 1;
    grow_m += m - 1;
    grow_d += d - 1;
  }
  if (!a.bands &&
      (grow_n != a.N - 1 || grow_m != a.M - 1 || grow_d != a.D - 1))
    return (int)cudaErrorInvalidValue;
  for (int e = 0; e < kMaxMid; ++e) {
    const int* r = chain + 4 + 4 * a.nchain + 3 * (e < nmid ? e : 0);
    a.mid_op[e] = e < nmid ? r[0] : 0;
    float v = 0.f;
    if (e < nmid) memcpy(&v, &r[1], sizeof v);
    a.mid_val[e] = v;
    a.mid_bias[e] = e < nmid ? r[2] : -1;
    if (e < nmid && (r[0] < 1 || r[0] > 5 || (r[0] == 1 && r[2] < 0)))
      return (int)cudaErrorInvalidValue;
  }
  a.sy = a.nby * a.box_y;
  a.sz = a.nbz * a.box_z;
  const int es = io_bf16 ? 2 : 4;
  a.xblock = ((a.sz * a.sy * a.box_x * es + 127) & ~127) / es;
  a.tiles_x = (a.wo + a.bw - 1) / a.bw;
  a.tiles_y = (a.ho + a.bh - 1) / a.bh;
  a.tiles_z = (a.zo + a.bz - 1) / a.bz;
  const long long ntiles = (long long)a.batch * a.tiles_z * a.tiles_y *
                           a.tiles_x;
  a.ntiles = (int)ntiles;
  const bool strided = a.sh != 1 || a.sw != 1;
  // cache rows: a chain's largest stage's
  const int nt = strided ? (a.N + a.sh - 1) / a.sh : a.inst_n;
  const bool fused = a.nchain > 1;
  KernelFn fn = a.ndim == 3 ? (strided || a.bands ? nullptr
                               : fused  ? pick_chain_3d(nt, a.inst_d)
                                        : pick_3d(nt, a.inst_d))
                : a.bands   ? (strided ? nullptr : pick_band_2d(nt))
                : strided   ? pick_2d_strided(nt)
                : fused     ? pick_chain_2d(nt)
                : nt <= 16  ? pick_2d_narrow(nt)
                            : pick_2d_wide(nt);
  const long long box_bytes =
      (long long)a.box_x * a.box_y * a.box_z * es * a.nbx * a.nby * a.nbz;
  if (fn == nullptr || (a.ndim != 2 && a.ndim != 3) ||
      (a.ndim == 2 && a.D != 1) || a.steps < 1 ||
      a.steps > (a.bands ? kMaxBandSteps : kMaxSteps) || a.ntaps < 1 ||
      (!a.bands && (a.ntaps > kMaxTaps || a.M > kWarp)) || a.M < 1 ||
      a.t < 1 || a.variant < 0 || a.variant > 1 || a.batch < 1 ||
      a.zo < 1 || a.ho < 1 || a.wo < 1 || a.bz < 1 || a.bh < 1 ||
      a.bw < 1 || ntiles > 0x7fffffffLL || grid < 1 || grid > a.ntiles ||
      a.box_x < 1 || a.box_x > 256 || a.box_y < 1 || a.box_y > 256 ||
      a.box_z < 1 || a.box_z > 256 || (a.box_x * es) % 16 ||
      (a.nbz > 1 && a.nby > 1 && a.box_z > 1) ||
      a.sh < 1 || a.sw < 1 || (strided && (a.t != 1 || a.nchain != 1)) ||
      a.o_col < 1 || (a.ndim == 2 && a.inst_d != 1) ||
      a.filters < 1 || a.batch % a.filters ||
      (a.filters > 1 && a.fsz < 1) ||
      a.sy < a.sh * (a.bh - 1) + 1 + a.t * (a.N - 1) ||
      a.sz < a.bz + a.t * (a.D - 1) ||
      a.nbx * a.box_x < a.sw * (a.bw - 1) + a.t * (a.M - 1) + 16 / es ||
      a.stages < 1 || a.stages > kMaxStages || a.stage_bytes % 128 ||
      a.stage_bytes < a.nbx * a.xblock * es ||
      (a.nby > 1 && (a.box_y * a.box_x * es) % 128) ||
      (a.nbz > 1 && (a.box_z * a.sy * a.box_x * es) % 128) ||
      a.stage_bytes < box_bytes || (pitch * es) % 16 || pitch < win ||
      (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & (es - 1)))
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const CUtensorMapDataType dt = io_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const cuuint64_t row = (cuuint64_t)pitch * es;
  CUtensorMap xmap;
  CUresult r;
  if (a.ndim == 2) {
    const cuuint64_t dim[3] = {(cuuint64_t)win, (cuuint64_t)hin,
                               (cuuint64_t)a.batch};
    const cuuint64_t str[2] = {row, row * hin};
    const cuuint32_t box[3] = {(cuuint32_t)a.box_x, (cuuint32_t)a.box_y, 1};
    r = encode(&xmap, dt, 3, const_cast<void*>(x), dim, str, box, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dim[4] = {(cuuint64_t)win, (cuuint64_t)hin,
                               (cuuint64_t)zin, (cuuint64_t)a.batch};
    const cuuint64_t str[3] = {row, row * hin, row * hin * zin};
    const cuuint32_t box[4] = {(cuuint32_t)a.box_x, (cuuint32_t)a.box_y,
                               (cuuint32_t)a.box_z, 1};
    r = encode(&xmap, dt, 4, const_cast<void*>(x), dim, str, box, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  if (r != CUDA_SUCCESS) return kTmaError + (int)r;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int threads = a.ndim == 3 ? kThreads3d : kThreads2d;
  fn<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(xmap,
                                                                       a);
  return (int)cudaGetLastError();
}
