// K2 on Hopper, single-channel path: the plain C entry, and the
// instantiations of the plans that are no chain. The kernel, its design and
// what it replaces (src/repro/core/engine.py::_apply_plan_mxu) are in
// ssam_mxu.cuh; a fused pipeline's instantiations in ssam_mxu_chain.cu.
#include <string.h>

#include "ssam_mxu.cuh"

namespace ssam {

// One instantiation a plan's largest entry (1-4 k-steps); the strided
// plans share the one of 4, since their chunks walk an entry's k-steps in
// a runtime loop (s < kk) either way.
MxuKernelFn pick_mxu(int kkmax, bool strided) {
  if (kkmax < 1 || kkmax > 4) return nullptr;
  if (strided) return mxu_window_kernel<4, true, false>;
  switch (kkmax) {
    case 1: return mxu_window_kernel<1, false, false>;
    case 2: return mxu_window_kernel<2, false, false>;
    case 3: return mxu_window_kernel<3, false, false>;
  }
  return mxu_window_kernel<4, false, false>;
}

// Sets the kernel's dynamic shared memory and launches it on `stream`.
template <class Fn, class Args>
int launch_mx(Fn fn, const CUtensorMap& xmap, const Args& a, int grid,
              int smem_bytes, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  fn<<<grid, kMxThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      xmap, a);
  return (int)cudaGetLastError();
}

}  // namespace ssam

// Plain C entry of K2's single-channel path, loaded with ctypes. `geom`
// holds core/engine.py::MxuLayout.geom, kMxGeomInts ints:
//   ndim, D, N, M, t, nent, batch, zin, hin, win, pitch (x's row pitch),
//   zo, ho, wo, lz, ly, lx, bz, bh, bw, box_x, box_y, box_z, nby, nbz,
//   stages, stage_bytes, pc, c0_words, bufa_words, bufb_words, b_words,
//   table_ints, smem_bytes, grid, slack, kkmax (the most k-steps of an
//   entry), sh, sw (the output stride), o_row, o_col, o_plane, o_img (the
//   output's step, elements), ngroups, slot_words, gtab (a streamed
//   launch's groups, the fp32 words of a ring slot and the offset of the
//   group records in `table`; ngroups 0: the B tiles resident);
// `table` on the card holds the entries (dz, r, cmin, span, KK, B offset,
// column table offset, 0) and their column tables (per column of the
// span: an index into cvals, or -1), then a streamed launch's group records
// (first entry, entries, first B word, words); `bsrc` its B tiles in device
// memory (core/engine.py::mxu_btiles), or null. `chain` holds
// core/engine.py::MxuLayout.chain: nchain, nmid, then nchain records (first
// entry, entries, N | D << 8 | M << 16, mid-chain ops first | count << 8),
// then nmid ops (code, value's float bits, index of a bias in `cvals` or
// -1); a plan that is no chain has nchain = 0 (D, N, M and its entries
// applied t times), a fused pipeline's t is 1 and its D, N, M the stages'
// summed footprint. The epilogue (the last stage's): epi_ops and epi_vals
// host arrays of kMaxEpi entries, `bias` a scalar on the card (or null),
// `resid` the residual in the output's dtype and dense layout (or null).
// Returns a cudaError_t, or kTmaError + the CUresult where the tensor map
// cannot be encoded.
extern "C" int ssam_mxu_window_launch(const void* x, void* out, int io_bf16,
                                      const float* cvals, const int* table,
                                      const float* bsrc,
                                      const int* geom, int ngeom,
                                      const int* chain, int nchain_ints,
                                      const float* bias, const void* resid,
                                      const int* epi_ops,
                                      const float* epi_vals, int n_epi,
                                      void* stream) {
  using namespace ssam;
  if (ngeom != kMxGeomInts) return (int)cudaErrorInvalidValue;
  const int* g = geom;
  MxuChainArgs a;  // a plan that is no chain launches its MxuArgs part
  a.out = out;
  a.io_bf16 = io_bf16;
  a.cvals = cvals;
  a.table = table;
  a.bsrc = bsrc;
  a.ndim = g[0];
  a.D = g[1];
  a.N = g[2];
  a.M = g[3];
  a.t = g[4];
  a.nent = g[5];
  a.batch = g[6];
  const int zin = g[7], hin = g[8], win = g[9], pitch = g[10];
  a.zo = g[11];
  a.ho = g[12];
  a.wo = g[13];
  a.lz = g[14];
  a.ly = g[15];
  a.lx = g[16];
  a.bz = g[17];
  a.bh = g[18];
  a.bw = g[19];
  a.box_x = g[20];
  a.box_y = g[21];
  a.box_z = g[22];
  a.nby = g[23];
  a.nbz = g[24];
  a.stages = g[25];
  a.stage_bytes = g[26];
  a.pc = g[27];
  a.c0_words = g[28];
  a.bufa_words = g[29];
  a.bufb_words = g[30];
  a.b_words = g[31];
  const int table_ints = g[32], smem_bytes = g[33], grid = g[34];
  const int kkmax = g[36];
  a.slack = g[35];
  a.sh = g[37];
  a.sw = g[38];
  a.o_row = g[39];
  a.o_col = g[40];
  a.o_plane = g[41];
  a.o_img = g[42];
  a.ngroups = g[43];
  a.slot_words = g[44];
  a.gtab = g[45];
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
  const bool strided = a.sh != 1 || a.sw != 1;
  if (chain == nullptr || nchain_ints < 2) return (int)cudaErrorInvalidValue;
  a.nchain = chain[0];
  const int nmid = chain[1];
  if (a.nchain < 0 || a.nchain > kMxMaxChain || nmid < 0 ||
      nmid > kMxMaxMid || nchain_ints != 2 + 4 * a.nchain + 3 * nmid ||
      (a.nchain > 0 && (a.t != 1 || strided)) || (a.nchain == 0 && nmid))
    return (int)cudaErrorInvalidValue;
  // the records: entries in range, the stages' shrinkage the staged
  // extent's, mid-chain ops in range
  int grow_n = 0, grow_m = 0, grow_d = 0;
  for (int k = 0; k < kMxMaxChain; ++k) {
    a.chain[k] = make_int4(0, 0, 0, 0);
    if (k >= a.nchain) continue;
    const int* r = chain + 2 + 4 * k;
    a.chain[k] = make_int4(r[0], r[1], r[2], r[3]);
    const int n = r[2] & 255, d = (r[2] >> 8) & 255, m = r[2] >> 16;
    const int e0 = r[3] & 255, ne = r[3] >> 8;
    if (r[0] < 0 || r[1] < 1 || r[0] + r[1] > a.nent || n < 1 || d < 1 ||
        m < 1 || (a.ndim == 2 && d != 1) || e0 + ne > nmid)
      return (int)cudaErrorInvalidValue;
    grow_n += n - 1;
    grow_m += m - 1;
    grow_d += d - 1;
  }
  if (a.nchain > 0 &&
      (grow_n != a.N - 1 || grow_m != a.M - 1 || grow_d != a.D - 1))
    return (int)cudaErrorInvalidValue;
  for (int e = 0; e < kMxMaxMid; ++e) {
    a.mid_op[e] = 0;
    a.mid_val[e] = 0.f;
    a.mid_bias[e] = -1;
    if (e >= nmid) continue;
    const int* r = chain + 2 + 4 * a.nchain + 3 * e;
    a.mid_op[e] = r[0];
    memcpy(&a.mid_val[e], &r[1], sizeof(float));
    a.mid_bias[e] = r[2];
    if (r[0] < 1 || r[0] > 5 || (r[0] == 1 && r[2] < 0))
      return (int)cudaErrorInvalidValue;
  }
  const bool streamed = a.ngroups > 0;
  MxuKernelFn fn = a.nchain      ? nullptr
                   : streamed ? pick_mxu_stream(kkmax)
                              : pick_mxu(kkmax, strided);
  MxuChainKernelFn fn_chain = a.nchain ? pick_mxu_chain(kkmax) : nullptr;
  a.sy = a.nby * a.box_y;
  a.sz = a.nbz * a.box_z;
  a.tiles_x = (a.wo + a.bw - 1) / a.bw;
  a.tiles_y = (a.ho + a.bh - 1) / a.bh;
  a.tiles_z = (a.zo + a.bz - 1) / a.bz;
  const long long ntiles = (long long)a.batch * a.tiles_z * a.tiles_y *
                           a.tiles_x;
  a.ntiles = (int)ntiles;
  const int es = io_bf16 ? 2 : 4;
  // a streamed launch's application k carries its sums in bufa (k even)
  // or bufb: the tile widened by the applications after it
  bool sums_fit = true;
  for (int k = 0; streamed && k < a.t; ++k) {
    const int g = a.t - 1 - k, w = a.bw + g * (a.M - 1);
    const long long need =
        (long long)(a.bh + g * (a.N - 1)) * ((w + 4) / 8 * 8 + 4);
    sums_fit = sums_fit && need <= ((k & 1) ? a.bufb_words : a.bufa_words);
  }
  const long long box_bytes =
      (long long)a.box_x * a.box_y * a.box_z * es * a.nby * a.nbz;
  if ((fn == nullptr && fn_chain == nullptr) ||
      (a.ndim != 2 && a.ndim != 3) ||
      (a.ndim == 2 && a.D != 1) ||
      a.nent < 1 || a.D < 1 || a.N < 1 || a.M < 1 || a.t < 1 ||
      a.batch < 1 || a.zo < 1 || a.ho < 1 || a.wo < 1 || a.bz < 1 ||
      a.bh < 1 || a.bw < 1 || ntiles > 0x7fffffffLL || grid < 1 ||
      grid > a.ntiles || a.slack < kMxSlack || a.slack % 4 ||
      a.slack < 24 * a.sw + 40 || table_ints < kMxEntInts * a.nent ||
      a.sh < 1 || a.sw < 1 || a.sw > 4 || a.o_col < 1 ||
      (strided && (a.t != 1 || a.ndim != 2)) ||
      a.box_x < 1 || a.box_x > 256 || a.box_y < 1 || a.box_y > 256 ||
      a.box_z < 1 || a.box_z > 256 || (a.box_x * es) % 16 ||
      (a.nbz > 1 && a.nby > 1 && a.box_z > 1) ||
      a.sy < a.sh * (a.bh - 1) + 1 + a.t * (a.N - 1) ||
      a.sz < a.bz + a.t * (a.D - 1) ||
      a.box_x < a.sw * (a.bw - 1) + a.t * (a.M - 1) + 16 / es ||
      a.stages < 1 || a.stages > kMxMaxStages || a.stage_bytes % 128 ||
      a.stage_bytes < box_bytes ||
      (a.nby > 1 && (a.box_y * a.box_x * es) % 128) ||
      (a.nbz > 1 && (a.box_z * a.sy * a.box_x * es) % 128) ||
      (io_bf16 && (a.pc < a.box_x || a.c0_words < a.sz * a.sy * a.pc)) ||
      a.c0_words % 4 || a.bufa_words % 4 || a.bufb_words % 4 ||
      (pitch * es) % 16 || pitch < win || a.ngroups < 0 ||
      (streamed &&
       (a.nchain || strided || a.ndim != 2 || bsrc == nullptr ||
        (reinterpret_cast<uintptr_t>(bsrc) & 15) || a.slot_words < 64 ||
        a.slot_words % 64 || a.gtab < kMxEntInts * a.nent ||
        a.gtab + 4 * a.ngroups > table_ints || !sums_fit)) ||
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
  if (fn_chain != nullptr)
    return launch_mx(fn_chain, xmap, a, grid, smem_bytes, stream);
  return launch_mx(fn, xmap, static_cast<const MxuArgs&>(a), grid,
                   smem_bytes, stream);
}
