// K1 on Hopper, single-channel path: the windowed-plan kernel of the SSAM
// execution model for 2-D and 3-D stencils and single-channel 2-D
// convolution.
//
// Replaces src/repro/core/engine.py::_window_kernel (its block body
// _apply_plan_once, launched by _window_call) for plans with table or
// dense coefficients, 2-D (any N x M the banded walk below holds: every
// footprint up to 64 x 64 and 1-D ones up to 255 taps) or 3-D (up to
// 5 x 5, depth x rows),
// both schedule variants, t >= 1 fused time steps with pad-once semantics,
// fp32 or bf16 input and output with fp32 sums, batch axes, a filter per
// image (a depthwise conv2d over its B * C images), an output stride on
// 2-D plans (one application), and the fused epilogue of
// _apply_epilogue_val (scalar or per-filter bias, GELU, SiLU, ReLU, scale,
// residual) applied once to the fp32 sum after the last application, and
// fused pipelines (core/fuse.py: a chain of stages, each its own taps and
// footprint, one application each in the tile, mid-chain epilogues on the
// iterates).
//
// Bound on an H100: the Table-3 stencils up to 2d64pt, the 3-D ones but
// 3d125pt, and filters up to 7 x 7 are bound by bytes, each input element
// read once and each output written once (8192^2 fp32: 537 MB, 0.160 ms
// at 3.35 TB/s; 512^3: 0.321 ms); 2d81pt, 2d121pt, 3d125pt and filters of
// 9 x 9 and more by fp32 FMAs at 67 TFLOP/s.
//
// The paper's algorithm, kept: each warp is a 32-lane systolic array
// walking the W (lane) axis; a thread keeps a register cache of
// C = N + P - 1 rows of its column (times D slices for 3-D plans) and
// produces P output rows. shift_psum moves the partial sums one column
// step with __shfl_up_sync (lane l then holds column l - (M-1)); shift_data
// moves the data with __shfl_down_sync and keeps the sums (lane l holds
// column l). A shuffle loses the lanes that would cross the warp, so a
// warp keeps V = 33 - M outputs and neighbouring warps overlap by M - 1
// columns.
//
// What the design before this one (one 256-thread block per output tile)
// lost, and what this one does about it. Paired runs on the card (PERF.md
// §6) found the tile's arithmetic, not its loads, the limit:
// with the loads removed a 2d5pt tile took 93 % of its time, with the
// arithmetic removed 71 %.
//  * Nothing was in flight while a block computed. Here blocks are
//    persistent, each walking the output tiles in a fixed order (tile g,
//    g + grid, ...): 2-D plans two 256-thread blocks an SM where shared
//    memory allows, 3-D plans one 512-thread block (their tiles are large:
//    a 3-D tile's halo is recomputed at t > 1). One thread keeps the next
//    tiles' input boxes in flight with TMA (cp.async.bulk.tensor,
//    completion on an mbarrier per stage) into a ring of 1-3 stages while
//    the warps compute; a stage is refilled as soon as the tile's first
//    application has read it.
//  * TMA zero-fills coordinates outside the tensor, negative ones included,
//    so the plan's lead and trail padding costs nothing. A box's innermost
//    start must be a multiple of 16 bytes (else an illegal instruction), so
//    a tile's box starts at the aligned column at or below its first input
//    column and the reads add the difference (`shift`). Boxes are at most
//    256 elements per axis; a wider stage takes several boxes along x, each
//    landing as its own [z][y][x] block (reads map a column to its block).
//    A box lands 128-byte aligned: x-blocks are padded to 128 bytes, and
//    boxes stacked along y or z take a few more rows or slices. Rows whose
//    pitch is not a multiple of 16 bytes take a pitch-padded copy in the
//    wrapper (the map keeps the logical width).
//  * The tap walk cost D * N slot tests and shared-memory coefficient reads
//    per column step. Here the wrapper's table lists, per column step, its
//    shift and its taps compacted in (dz, row) order. The step records sit
//    in the kernel's parameters (uniform loads); each tap is one 8-byte
//    record {slot, coefficient} in shared memory, read one tap ahead. A
//    step whose taps fill every slot (a box, a dense filter) runs a
//    branch-free body unrolled over the D * N slots; any other step walks
//    its taps, each dispatched by a switch on its slot, so the register
//    index stays a compile-time constant and the cache never leaves
//    registers. A step costs P shuffles plus P FMAs per tap and nothing per
//    empty slot. shift_data shuffles only what a step reads: a sparse step
//    the P values of each tap, a dense one the cache (2-D: in place, by the
//    shift since the last in-place shift; 3-D: a copy of one slice at a
//    time, since the cache rolls on to the next slice unshifted).
//  * P, the rows a thread holds, amortises each step's shuffles and
//    dispatch over more FMAs: 32 for 2-D plans of up to 13 rows, 16 for
//    wider ones, 16 for 3-D plans whose cache then holds at most 54 values
//    (the 3 x 3 footprints), 8 for the others (the instantiation files
//    record the paired runs that chose them). No instantiation spills.
//  * Stores were single floats from the V valid lanes of each warp, rows
//    misaligned. Here the last application writes its output tile to
//    shared memory and the block stores it row by row, coalesced, as
//    16-byte vectors where the row allows.
//  * t > 1: every application but the last writes its iterate, fp32, to
//    one of two shared buffers (ping-pong); the iterate is not re-zeroed at
//    the domain edge (pad-once semantics of ref.stencil_iterate).
//  * A fused pipeline generalizes that loop: application k runs stage k's
//    record (its first column step and step count, its N, D and M, its
//    mid-chain epilogue ops), walks that stage's step records and taps, and
//    shrinks the extents by its own footprint. The intermediate stays fp32
//    in the ping-pong buffers and never reaches HBM. Stage k's mid-chain
//    ops (scalar bias, GELU, SiLU, ReLU, scale) are applied to the sums
//    before the iterate is written, at every position the tile computes,
//    halo positions outside the domain included (the reference's pad-once
//    chain). The instantiation is the largest stage's N and D: a stage
//    with fewer rows loads the instantiation's N + P - 1 rows (the wrapper
//    sizes the slack past the buffers for them) and its taps read its
//    own; slices past the source's last are clamped to it. Chains run
//    instantiations of their own (Ch), 3-D ones at P = 8, so that the
//    records' registers cost the plans that are no chain nothing (with
//    them the 3 x 3 x 3 cache at P = 16 spills). A plan that is no chain
//    is one record its t applications repeat (the launch checks it).
//  * 3-D plans walk Z inside the thread: the register cache rolls one slice
//    per output slice. Where a tile's row and column items are too few for
//    the warps, Z is split into chunks.
//  * bf16 input is staged by TMA as bf16 and widened once into an fp32
//    buffer of the stage's layout.
//  * Output-strided plans (2-D, t = 1; the reference's data-stationary
//    read): lane l of a warp item holds output column l of its 32 and reads
//    input column sw * l + cum of each column step from the stage, so no
//    shuffle is needed and all 32 lanes keep their outputs. The register
//    cache holds the rows sh * p + r of the P outputs, one row phase at a
//    time (rows = rho mod sh), so its index stays a compile-time constant:
//    a strided instantiation's N is ceil(N / sh), its P 16, exact up to
//    16 rows; one of 32 rows (P 8) takes 17 to 32 and loads only the
//    ceil(N / sh) + P - 1 rows the taps read. Tiles start at sh * oy0 and
//    sw * ox0 of the input.
//  * The epilogue and the residual are applied as the block stores the
//    tile (fp32, before the bf16 cast): four rows a warp and four columns
//    a lane of each in registers, each stage dispatched once for those 16
//    values (a dispatch an output cost more than a stencil's own
//    arithmetic); the residual is read at the outputs' positions. The
//    store writes through an output step (row pitch, column step, image
//    pitch), so the phases of a strided plan's input adjoint write their
//    positions of dx in place.
//  * A filter per image (a depthwise conv2d's B * C images, image b taking
//    filter b mod C): the tap records hold one filter's coefficients, and
//    a tile whose image takes another filter than the block's last tile
//    rewrites them from L2 between two barriers before its first
//    application (a 3 x 3 filter is 36 bytes against a tile of tens of
//    KB); its bias is bias[b mod C]. The slots, the step records and the
//    branch-free dense body are the single filter's. On the card neither
//    a second set of records filled by cp.async during the tile before
//    nor a walk of consecutive tiles (fewer rewrites) was faster. Staging
//    all C filters at once would cap C by shared memory (1024 filters of
//    7 x 7 take 392 KB of records).
//  * Footprints one walk does not hold (more than 32 rows: the register
//    cache; column steps beyond one warp: a warp keeps 33 - M lanes; more
//    than 32 step records) are walked in bands, the chain's application
//    loop with addition in place of composition. The wrapper
//    (core/engine.py::band_walk) cuts the footprint into row bands of at
//    most 32 rows (equal where that lands on an instantiation's row
//    count, so that every step runs the dense body) and each into column
//    bands of at most 17 columns (a warp keeps at least 16 lanes). A band
//    is a record (its first step and step count, its rows Nb and columns
//    Mb, its first row r0 and column c0); every band walks the same staged
//    tile, read from (r0, c0), over all of the tile's outputs, the first
//    writing the fp32 accumulator (bufb), each later one adding to it
//    after a barrier; the epilogue and the residual are applied once, at
//    the store. One launch a call, a filter per image included (its tap
//    records rewritten as above). All bands' tap records sit in shared
//    memory (64 x 64: 32 KB), and so do their step records (read with one
//    LDS.128 a step instead of from the parameters: a launch may have
//    hundreds), so shared memory is the limit (core/engine.py::
//    band_refusal), with at most 32 bands. The instantiations
//    (ssam_window_band.cu, Bd) are the chain tables' row counts. Costs:
//    a band's lanes keep 16 or 17 of 32, so K1 pays about twice its
//    FMAs, and each band reloads its register cache from shared memory.
//    Tiles take the shape whose staged halo is smallest per output
//    (core/engine.py::_band_block): tall and narrow for tall filters.
// The register cache reads past a source's last row (into the next buffer,
// or the slack the wrapper adds at the end of shared memory) only for rows
// whose outputs are discarded; lanes past its last column read that column.
// What still costs (PERF.md §6): the arithmetic's issue and latency,
// spread over the shuffles, the dispatch and the coefficient loads (none
// above a tenth alone), and the warp edges: a warp keeps 33 - M of its
// lanes, so wide footprints pay 32/V of their FMAs (2.46x at 20 x 20).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssam_epilogue.cuh"
#include "ssam_hopper.cuh"

namespace ssam {

constexpr int kWarp = 32;
constexpr int kThreads2d = 256;  // two blocks share an SM (launch bounds)
constexpr int kThreads3d = 512;  // one block an SM
constexpr int kMaxSteps = 32;
constexpr int kMaxBandSteps = 2048;  // a banded launch's (in shared memory)
constexpr int kMaxChain = 32;  // applications' records (a stage has a step)
                               // or a banded launch's bands
constexpr int kMaxMid = 16;    // mid-chain epilogue ops of a chain
constexpr int kMaxTaps = 1024;
constexpr int kMaxStages = 3;
constexpr int kGeomInts = 44;  // core/engine.py::WindowLayout.geom
constexpr int kEpiRows = 4;    // rows a warp stores at once with an epilogue
constexpr unsigned kFull = 0xffffffffu;

struct WindowArgs {
  void* out;           // batch x zo x ho x wo output
  int io_bf16;         // 1: bf16 input and output, 0: fp32
  const float* cvals;  // coefficient values: `filters` filters of fsz
  const int* table;    // steps x (shift, first, taps, dense), taps x slot,
                       // taps x index into one filter of cvals
  int filters, fsz;    // image b takes filter b % filters (and its bias)
  int ndim, D, N, M, steps, ntaps, t, variant;
  int bands;             // 1: walked in bands (the records below are bands')
  int4 step[kMaxSteps];  // the step records, read uniformly from here (a
                         // banded launch's from shared memory)
  // one record a chain's stage (a plan that is no chain: one record, run
  // t times): (first step, steps, N | D << 8 | M << 16, mid-chain ops
  // first | count << 8, 0 for none); a banded launch's one a band, (first
  // step, steps, Nb | 1 << 8 | Mb << 16, r0 | c0 << 16), all walked in
  // every application
  int4 chain[kMaxChain];
  int nchain, inst_n, inst_d;
  int mid_op[kMaxMid];   // mid-chain ops (codes of ssam_epilogue.cuh)
  float mid_val[kMaxMid];
  int mid_bias[kMaxMid];  // a bias op's value: cvals[mid_bias]
  int batch, zo, ho, wo;
  int lz, ly, lx;      // t * lead per axis: input index of output 0 is -lead
  int bz, bh, bw;      // output tile
  int box_x, box_y, box_z, nbx, nby, nbz;  // TMA boxes of a stage
  int sy, sz;          // staged rows per slice, slices
  int xblock;          // elements of one x-block, padded to 128 bytes
  int stages, stage_bytes;
  int buf_c0, buf_a, buf_b;  // fp32 words: widened bf16 stage, iterates
  int tiles_x, tiles_y, tiles_z, ntiles;
  int sh, sw;          // output stride (strided instantiations; else 1)
  // the output's element (b, z, y, x) at out + b * o_img + z * o_plane +
  // y * o_row + x * o_col; the residual's in the dense output layout
  long long o_img, o_plane;
  int o_row, o_col;
  const float* bias;   // the scalar bias (one a filter), or null
  const void* resid;   // the residual (the output's dtype), or null
  int epi_op[kMaxEpi];
  float epi_val[kMaxEpi];
  int n_epi;
};

// A source of one application: element (z, y, col) lies at
// p[(c / bw) * bstride + c % bw + y * pitch + z * plane], c = col + shift
// (c / bw is the x-box the column landed in; the dense iterates and a
// stage of one x-box have bstride 0 and read p[c + ...]; shift is the
// tile's offset from its aligned box start in the stage, 0 for the
// iterates).
struct Src {
  const float* p;
  int pitch, plane, bw, bstride, shift;
};

// s[p] += c[dz][r + p] * w, p < P: the taps of one footprint slot.
template <int N, int D, int P, int DZ, int R>
__device__ __forceinline__ void fma_slot(const float (&c)[D][N + P - 1],
                                         float (&s)[P], float w) {
#pragma unroll
  for (int p = 0; p < P; ++p) s[p] = fmaf(c[DZ][R + p], w, s[p]);
}

// The same with the data shifted down `cum` lanes first.
template <int N, int D, int P, int DZ, int R>
__device__ __forceinline__ void fma_slot_shfl(const float (&c)[D][N + P - 1],
                                              float (&s)[P], float w,
                                              int cum) {
#pragma unroll
  for (int p = 0; p < P; ++p)
    s[p] = fmaf(__shfl_down_sync(kFull, c[DZ][R + p], cum), w, s[p]);
}

// One tap of a sparse step, dispatched on its slot dz * N + r, its data
// shifted down `cum` lanes first where cum > 0.
template <int N, int D, int P>
__device__ __forceinline__ void tap_fma(int slot,
                                        const float (&c)[D][N + P - 1],
                                        float (&s)[P], float w, int cum) {
  switch (slot) {
#define SSAM_SLOT(k)                                                   \
  case k:                                                              \
    if constexpr (k < D * N) {                                         \
      if (cum)                                                         \
        fma_slot_shfl<N, D, P, k / N, k % N>(c, s, w, cum);            \
      else                                                             \
        fma_slot<N, D, P, k / N, k % N>(c, s, w);                      \
    }                                                                  \
    break;
    SSAM_SLOT(0) SSAM_SLOT(1) SSAM_SLOT(2) SSAM_SLOT(3) SSAM_SLOT(4)
    SSAM_SLOT(5) SSAM_SLOT(6) SSAM_SLOT(7) SSAM_SLOT(8) SSAM_SLOT(9)
    SSAM_SLOT(10) SSAM_SLOT(11) SSAM_SLOT(12) SSAM_SLOT(13) SSAM_SLOT(14)
    SSAM_SLOT(15) SSAM_SLOT(16) SSAM_SLOT(17) SSAM_SLOT(18) SSAM_SLOT(19)
    SSAM_SLOT(20) SSAM_SLOT(21) SSAM_SLOT(22) SSAM_SLOT(23) SSAM_SLOT(24)
    SSAM_SLOT(25) SSAM_SLOT(26) SSAM_SLOT(27) SSAM_SLOT(28) SSAM_SLOT(29)
    SSAM_SLOT(30) SSAM_SLOT(31)
#undef SSAM_SLOT
    default:
      break;
  }
}

// A dense step: every slot in (dz, r) order, its taps' records at tp.
template <int N, int D, int P>
__device__ __forceinline__ void dense_fma(const float (&c)[D][N + P - 1],
                                          float (&s)[P], const int2* tp) {
#pragma unroll
  for (int dz = 0; dz < D; ++dz)
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const float w = __int_as_float(tp[dz * N + r].y);
#pragma unroll
      for (int p = 0; p < P; ++p) s[p] = fmaf(c[dz][r + p], w, s[p]);
    }
}

// One column step's taps. `cum` is the step's cumulative shift under
// shift_data (0 under shift_psum), `done` how far the cache itself has
// been shifted down already: a 2-D dense step shifts the cache in place
// (valid lanes l < V read lanes l + cum <= 31, so chained shifts are
// exact for them); a 3-D one shuffles a copy of one slice at a time, since
// the cache rolls on to the next slice unshifted. A sparse step shuffles
// each tap's P values.
template <int N, int D, int P>
__device__ __forceinline__ void step_taps(float (&c)[D][N + P - 1],
                                          float (&s)[P], int4 st,
                                          const int2* taps, int cum,
                                          int& done) {
  constexpr int C = N + P - 1;
  if (st.w) {
    if (cum == done) {
      dense_fma<N, D, P>(c, s, taps + st.y);
    } else if constexpr (D == 1) {
#pragma unroll
      for (int i = 0; i < C; ++i)
        c[0][i] = __shfl_down_sync(kFull, c[0][i], cum - done);
      done = cum;
      dense_fma<N, D, P>(c, s, taps + st.y);
    } else {  // one slice at a time, in (dz, r) order
#pragma unroll
      for (int dz = 0; dz < D; ++dz) {
        float xs[C];
#pragma unroll
        for (int i = 0; i < C; ++i)
          xs[i] = __shfl_down_sync(kFull, c[dz][i], cum - done);
#pragma unroll
        for (int r = 0; r < N; ++r) {
          const float w = __int_as_float(taps[st.y + dz * N + r].y);
#pragma unroll
          for (int p = 0; p < P; ++p) s[p] = fmaf(xs[r + p], w, s[p]);
        }
      }
    }
  } else {
    // one LDS.64 per tap, the next one read ahead of the dispatch
    int2 tp = taps[st.y];
    for (int k = st.y; k < st.y + st.z; ++k) {
      const int2 nx = taps[k + 1];
      tap_fma<N, D, P>(tp.x, c, s, __int_as_float(tp.y), cum - done);
      tp = nx;
    }
  }
}

// Stage k's mid-chain ops on the P sums a thread holds (rec: its record's
// first | count << 8), each op dispatched once for the P values.
template <int P>
__device__ __forceinline__ void mid_epilogue(const WindowArgs& a, int rec,
                                             float (&s)[P]) {
  const int e0 = rec & 255, e1 = e0 + (rec >> 8);
  for (int e = e0; e < e1; ++e) {
    const float val = a.mid_val[e];
    switch (a.mid_op[e]) {
      case 1: epilogue_each<1, P>(s, val, a.cvals[a.mid_bias[e]]); break;
      case 2: epilogue_each<2, P>(s, val, 0.f); break;
      case 3: epilogue_each<3, P>(s, val, 0.f); break;
      case 4: epilogue_each<4, P>(s, val, 0.f); break;
      case 5: epilogue_each<5, P>(s, val, 0.f); break;
    }
  }
}

// One valid application of the plan (Ch: of a chain's stage, Bd: of a
// band, the record rec's: its steps, its footprint Nk x Mk, Dk slices; N and
// D are then the instantiation's, at least those) on a source of extent
// (zs, hs, ws). The result, (zs-Dk+1, hs-Nk+1, ws-Mk+1), is written densely
// to dst, the stage's mid-chain ops applied first; a band after the first
// (acc) adds it to dst. A banded launch reads its step records from
// `steps` in shared memory.
template <int N, int D, int P, int T, bool Ch, bool Bd = false>
__device__ __forceinline__ void apply_once(const WindowArgs& a, const Src& src,
                                           int zs, int hs, int ws, float* dst,
                                           const int2* taps, int4 rec,
                                           const int4* steps = nullptr,
                                           bool acc = false) {
  constexpr int C = N + P - 1;
  constexpr int kWarps = T / kWarp;
  constexpr bool kRec = Ch || Bd;  // the footprint from the record
  const int Nk = kRec ? rec.z & 255 : N, Dk = kRec ? (rec.z >> 8) & 255 : D;
  const int M = kRec ? rec.z >> 16 : a.M;
  const int V = kWarp - (M - 1);
  const int zd = zs - (Dk - 1), hd = hs - (Nk - 1), wd = ws - (M - 1);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwc = (wd + V - 1) / V;
  const int nyc = (hd + P - 1) / P;
  const int base_items = nwc * nyc;
  // Split Z into chunks when the W x H items alone cannot feed the warps.
  int zsplit = (kWarps + base_items - 1) / base_items;
  zsplit = max(1, min(zsplit, zd));
  const int zlen = (zd + zsplit - 1) / zsplit;
  const int items = base_items * zsplit;

  for (int it = warp; it < items; it += kWarps) {
    const int zc = it / base_items;
    const int r = it - zc * base_items;
    const int yc = r / nwc, wc = r - yc * nwc;
    const int col = wc * V + lane;  // source column this lane holds
    const int y0 = yc * P;
    const int zb = zc * zlen, ze = min(zd, zb + zlen);
    // lanes past the source's last column read it again (their outputs
    // are discarded)
    const int sc = min(col, ws - 1) + src.shift;
    const int xoff = src.bstride ? (sc / src.bw) * src.bstride + sc % src.bw
                                 : sc;
    const float* p0 = src.p + xoff + y0 * src.pitch;
    float c[D][C];
    // slices zb .. zb + D - 2 into c[1 ..]; each output slice rolls one in
    // (slices past the source's last, which only a stage of fewer slices
    // than D reaches and its taps never read, read the last)
#pragma unroll
    for (int dz = 1; dz < D; ++dz) {
      const float* pz =
          p0 + (Ch ? min(zb + dz - 1, zs - 1) : zb + dz - 1) * src.plane;
#pragma unroll
      for (int i = 0; i < C; ++i) c[dz][i] = pz[i * src.pitch];
    }
    for (int z = zb; z < ze; ++z) {
#pragma unroll
      for (int dz = 0; dz + 1 < D; ++dz)
#pragma unroll
        for (int i = 0; i < C; ++i) c[dz][i] = c[dz + 1][i];
      const float* pz =
          p0 + (Ch ? min(z + D - 1, zs - 1) : z + D - 1) * src.plane;
#pragma unroll
      for (int i = 0; i < C; ++i) c[D - 1][i] = pz[i * src.pitch];
      float s[P];
#pragma unroll
      for (int p = 0; p < P; ++p) s[p] = 0.f;
      int oc;
      bool valid;
      const int m0 = kRec ? rec.x : 0, m1 = kRec ? rec.x + rec.y : a.steps;
      if (a.variant == 0) {  // shift_psum
        int done = 0;
        for (int m = m0; m < m1; ++m) {
          const int4 st = Bd ? steps[m] : a.step[m];
          if (st.x) {
#pragma unroll
            for (int p = 0; p < P; ++p)
              s[p] = __shfl_up_sync(kFull, s[p], st.x);
          }
          step_taps<N, D, P>(c, s, st, taps, 0, done);
        }
        oc = col - (M - 1);
        valid = lane >= M - 1 && oc < wd;
      } else {  // shift_data
        int cum = 0, done = 0;
        for (int m = m0; m < m1; ++m) {
          const int4 st = Bd ? steps[m] : a.step[m];
          cum += st.x;
          step_taps<N, D, P>(c, s, st, taps, cum, done);
        }
        oc = col;
        valid = lane < V && oc < wd;
      }
      if (!valid) continue;
      if constexpr (Ch)
        if (rec.w) mid_epilogue<P>(a, rec.w, s);
      float* d = dst + ((size_t)z * hd + y0) * wd + oc;
      if (Bd && acc) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          if (y0 + p < hd) d[p * wd] += s[p];
      } else {
#pragma unroll
        for (int p = 0; p < P; ++p)
          if (y0 + p < hd) d[p * wd] = s[p];
      }
    }
  }
}

// One application of an output-strided 2-D plan on a source of extent
// (hs, ws): the (hd, wd) outputs, written densely to dst. Lane l of an item
// holds output column wc * 32 + l and reads input column sw * oc + cum of
// each step; the cache holds rows sh * (y0 + i) + rho for one row phase rho
// at a time, N here being the instantiation's ceil(N / sh) rows, or 32
// for 17 to 32 of which it loads the ceil(N / sh) + P - 1 that the taps
// read (rows past the source's last read that row, columns past the last
// output read its columns: their outputs are discarded). Tap records are
// {rho << 8 | q, coefficient}, row r = sh * q + rho, in (step, rho, q)
// order.
template <int N, int P, int T>
__device__ __forceinline__ void apply_strided(const WindowArgs& a,
                                              const Src& src, int hs, int hd,
                                              int wd, float* dst,
                                              const int2* taps) {
  constexpr int C = N + P - 1;
  constexpr int kWarps = T / kWarp;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwc = (wd + kWarp - 1) / kWarp;
  const int items = nwc * ((hd + P - 1) / P);
  constexpr bool kBucket = N == 32;  // the instantiation of 17 to 32 rows
  const int cn = (a.N + a.sh - 1) / a.sh + P - 1;  // the rows the taps read
  for (int it = warp; it < items; it += kWarps) {
    const int yc = it / nwc, wc = it - yc * nwc;
    const int oc = wc * kWarp + lane;
    const int y0 = yc * P;
    const int colbase = a.sw * min(oc, wd - 1) + src.shift;
    float c[1][C];
    float s[P];
#pragma unroll
    for (int p = 0; p < P; ++p) s[p] = 0.f;
    int cum = 0;
    for (int m = 0; m < a.steps; ++m) {
      const int4 st = a.step[m];
      cum += st.x;
      const int sc = colbase + cum;
      const float* pc =
          src.p + (src.bstride ? (sc / src.bw) * src.bstride + sc % src.bw
                               : sc);
      int k = st.y;
      const int end = st.y + st.z;
      while (k < end) {
        const int rho = taps[k].x >> 8;
#pragma unroll
        for (int i = 0; i < C; ++i)
          if (!kBucket || i < cn)
            c[0][i] = pc[min(a.sh * (y0 + i) + rho, hs - 1) * src.pitch];
        for (; k < end; ++k) {
          const int2 tp = taps[k];
          if ((tp.x >> 8) != rho) break;
          tap_fma<N, 1, P>(tp.x & 255, c, s, __int_as_float(tp.y), 0);
        }
      }
    }
    if (oc >= wd) continue;
    float* d = dst + (size_t)y0 * wd + oc;
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (y0 + p < hd) d[p * wd] = s[p];
  }
}

// Thread 0: the TMA boxes of tile `tile` into the stage at dst, completing
// on bar. A 2-D plan's map is (W, H, batch), a 3-D plan's (W, H, Z, batch).
__device__ __forceinline__ void issue_tile(const CUtensorMap* xmap,
                                           const WindowArgs& a, int tile,
                                           uint32_t dst, uint32_t bar) {
  const int tx = tile % a.tiles_x;
  int r = tile / a.tiles_x;
  const int ty = r % a.tiles_y;
  r /= a.tiles_y;
  const int tz = r % a.tiles_z, b = r / a.tiles_z;
  const int per = a.io_bf16 ? 8 : 4;  // elements of 16 bytes
  const int ix0 = tx * a.bw * a.sw - a.lx;
  const int x0 = ix0 - ((ix0 % per) + per) % per;  // aligned at or below
  const int y0 = ty * a.bh * a.sh - a.ly, z0 = tz * a.bz - a.lz;
  const int es = a.io_bf16 ? 2 : 4;
  const uint32_t box = a.box_x * a.box_y * a.box_z * es;
  mbar_expect_tx(bar, box * a.nbx * a.nby * a.nbz);
  for (int jx = 0; jx < a.nbx; ++jx)
    for (int jz = 0; jz < a.nbz; ++jz)
      for (int jy = 0; jy < a.nby; ++jy) {
        const uint32_t off =
            (jx * a.xblock + (jz * a.box_z * a.sy + jy * a.box_y) * a.box_x) *
            es;
        if (a.ndim == 2)
          tma_load_3d(dst + off, xmap, bar, x0 + jx * a.box_x,
                      y0 + jy * a.box_y, b);
        else
          tma_load_4d(dst + off, xmap, bar, x0 + jx * a.box_x,
                      y0 + jy * a.box_y, z0 + jz * a.box_z, b);
      }
}

// S: an output-strided instantiation (2-D, t = 1; N = ceil(N / sh), or 32
// for 17 to 32 rows). Ch: a fused pipeline's (N and D the largest stage's;
// instantiations of their own, so that the records' registers cost the
// plans that are no chain nothing). Bd: a banded launch's (2-D, N at or
// above the largest band's rows; instantiations of their own too).
template <int N, int D, int P, int T, bool S, bool Ch = false,
          bool Bd = false>
__global__ void __launch_bounds__(T, T == kThreads2d ? 2 : 1)
    window_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ WindowArgs a) {
  constexpr int kWarps = T / kWarp;
  extern __shared__ uint8_t smem_raw[];
  // the ring first, 128-byte aligned; then the fp32 buffers, the table and
  // the barriers (the register cache's over-reads land in those)
  uint8_t* ring = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  float* c0 = reinterpret_cast<float*>(ring + a.stages * a.stage_bytes);
  float* bufa = c0 + a.buf_c0;
  float* bufb = bufa + a.buf_a;
  // a banded launch's step records, then the taps {slot, coef}
  int4* steps = reinterpret_cast<int4*>(bufb + a.buf_b);
  int2* taps = reinterpret_cast<int2*>(steps + (Bd ? a.steps : 0));
  uint64_t* full = reinterpret_cast<uint64_t*>(taps + a.ntaps + 1);

  const int tid = threadIdx.x;
  const int* cidx = a.table + 4 * a.steps + a.ntaps;
  for (int k = tid; k < a.ntaps; k += T)
    taps[k] = make_int2(a.table[4 * a.steps + k],
                        __float_as_int(a.cvals[cidx[k]]));
  if constexpr (Bd)
    for (int k = tid; k < a.steps; k += T)
      steps[k] = reinterpret_cast<const int4*>(a.table)[k];
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(smem_addr(&full[s]), 1);
    fence_mbarrier_init();
  }
  __syncthreads();

  const int G = gridDim.x;
  if (tid == 0)
    for (int s = 0; s < a.stages; ++s) {
      const int tile = blockIdx.x + s * G;
      if (tile < a.ntiles)
        issue_tile(&xmap, a, tile, smem_addr(ring + s * a.stage_bytes),
                   smem_addr(&full[s]));
    }

  const int t = a.t;
  const int per = a.io_bf16 ? 8 : 4;
  const int warp = tid / kWarp, lane = tid % kWarp;
  int filt = 0;  // the filter whose coefficients the tap records hold
  int i = 0;
  for (int tile = blockIdx.x; tile < a.ntiles; tile += G, ++i) {
    const int s = i % a.stages;
    uint8_t* stage = ring + s * a.stage_bytes;
    const int txi = tile % a.tiles_x;
    int r = tile / a.tiles_x;
    const int tyi = r % a.tiles_y;
    r /= a.tiles_y;
    const int tzi = r % a.tiles_z, b = r / a.tiles_z;
    if (b % a.filters != filt) {
      // a filter per image: this image's coefficients into the records
      // (every warp is past the last tile's taps, the barrier that ends
      // it), read from L2 where a block's tiles cycle through the filters
      filt = b % a.filters;
      const float* cv = a.cvals + (size_t)filt * a.fsz;
      for (int k = tid; k < a.ntaps; k += T)
        taps[k].y = __float_as_int(cv[cidx[k]]);
      __syncthreads();
    }
    const int oz0 = tzi * a.bz, oy0 = tyi * a.bh, ox0 = txi * a.bw;
    const int tz = min(a.bz, a.zo - oz0), ty = min(a.bh, a.ho - oy0);
    const int tx = min(a.bw, a.wo - ox0);
    const int ix0 = ox0 * a.sw - a.lx;
    const int shift = ((ix0 % per) + per) % per;
    int zs = tz + t * (a.D - 1), hs = a.sh * (ty - 1) + 1 + t * (a.N - 1),
        ws = a.sw * (tx - 1) + 1 + t * (a.M - 1);

    mbar_wait(smem_addr(&full[s]), (i / a.stages) & 1);
    // the stage as the first application reads it (x-boxes as blocks)
    Src src{reinterpret_cast<const float*>(stage), a.box_x,
            a.sy * a.box_x, a.box_x,
            a.nbx > 1 ? a.xblock : 0, shift};
    if (a.io_bf16) {  // widen once into c0, in the stage's layout
      const __nv_bfloat16* sb = reinterpret_cast<const __nv_bfloat16*>(stage);
      for (int k = tid; k < a.nbx * a.xblock; k += T)
        c0[k] = __bfloat162float(sb[k]);
      __syncthreads();
      src.p = c0;
    }
    if constexpr (S) {
      apply_strided<N, P, T>(a, src, hs, ty, tx, bufb, taps);
      __syncthreads();
      if (tid == 0 && tile + a.stages * G < a.ntiles)
        issue_tile(&xmap, a, tile + a.stages * G, smem_addr(stage),
                   smem_addr(&full[s]));  // the stage is read: refill it
    } else if constexpr (Bd) {
      // t applications, each every band over the same source: band j reads
      // it from its row r0 and column c0 and walks its own Nb x Mb
      // footprint over the application's outputs, the first writing the
      // fp32 accumulator, the others adding to it
      for (int k = 0; k < t; ++k) {
        float* dst = ((t - 1 - k) & 1) ? bufa : bufb;  // the last: bufb
        const int hd = hs - (a.N - 1), wd = ws - (a.M - 1);
        for (int j = 0; j < a.nchain; ++j) {
          const int4 rec = a.chain[j];
          Src bs = src;
          bs.p += (rec.w & 0xffff) * src.pitch;
          bs.shift += rec.w >> 16;
          apply_once<N, 1, P, T, false, true>(a, bs, 1, hd + (rec.z & 255) - 1,
                                              wd + (rec.z >> 16) - 1, dst,
                                              taps, rec, steps, j > 0);
          __syncthreads();
        }
        if (k == 0 && tid == 0 && tile + a.stages * G < a.ntiles)
          issue_tile(&xmap, a, tile + a.stages * G, smem_addr(stage),
                     smem_addr(&full[s]));  // the stage is read: refill it
        hs = hd;
        ws = wd;
        src = Src{dst, ws, hs * ws, 1, 0, 0};
      }
    } else {
      // the applications: t of the plan, or a chain's stages in order
      const int napp = Ch ? a.nchain : t;
      for (int k = 0; k < napp; ++k) {
        const int4 rec = Ch ? a.chain[k] : make_int4(0, 0, 0, 0);
        float* dst = ((napp - 1 - k) & 1) ? bufa : bufb;  // the last: bufb
        apply_once<N, D, P, T, Ch>(a, src, zs, hs, ws, dst, taps, rec);
        __syncthreads();
        if (k == 0 && tid == 0 && tile + a.stages * G < a.ntiles)
          issue_tile(&xmap, a, tile + a.stages * G, smem_addr(stage),
                     smem_addr(&full[s]));  // the stage is read: refill it
        zs -= (Ch ? (rec.z >> 8) & 255 : D) - 1;
        hs -= (Ch ? rec.z & 255 : N) - 1;
        ws -= (Ch ? rec.z >> 16 : a.M) - 1;
        src = Src{dst, ws, hs * ws, 1, 0, 0};
      }
    }
    // the output tile (tz, ty, tx), dense in bufb, row by row; with an
    // epilogue, kEpiRows rows a warp at a time and four columns a lane of
    // each, the chain applied to those values in registers with one
    // dispatch a stage for all of them (a dispatch an output cost more than
    // a stencil's own arithmetic), the residual read at their positions
    const bool vec = !a.io_bf16 && a.o_col == 1 && a.o_row % 4 == 0 &&
                     a.o_plane % 4 == 0 && a.o_img % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(a.out) & 15) == 0 &&
                     ox0 % 4 == 0 && tx % 4 == 0;
    const int rows = tz * ty;
    auto dense_at = [&](int rr) {  // the residual's (dense) row start
      return (((size_t)b * a.zo + oz0 + rr / ty) * a.ho + oy0 + rr % ty) *
                 a.wo + ox0;
    };
    auto out_at = [&](int rr) {    // the output's row start
      return b * a.o_img + (oz0 + rr / ty) * a.o_plane +
             (long long)(oy0 + rr % ty) * a.o_row + (long long)ox0 * a.o_col;
    };
    if (a.n_epi == 0) {
      for (int rr = warp; rr < rows; rr += kWarps) {
        const float* srow = bufb + rr * tx;
        const long long go = out_at(rr);
        if (vec) {
          float4* orow =
              reinterpret_cast<float4*>(static_cast<float*>(a.out) + go);
          const float4* s4 = reinterpret_cast<const float4*>(srow);
          for (int q = lane; q < tx / 4; q += kWarp) orow[q] = s4[q];
        } else {
          for (int x = lane; x < tx; x += kWarp) {
            const long long at = go + (long long)x * a.o_col;
            if (a.io_bf16)
              static_cast<__nv_bfloat16*>(a.out)[at] =
                  __float2bfloat16(srow[x]);
            else
              static_cast<float*>(a.out)[at] = srow[x];
          }
        }
      }
    } else {
      // the scalar bias, loaded here so that no register holds it while
      // the taps run
      const float bias0 = a.bias ? a.bias[filt] : 0.f;
      for (int r0 = warp; r0 < rows; r0 += kWarps * kEpiRows)
        for (int q = lane; 4 * q < tx; q += kWarp) {
          const int x0 = 4 * q, nv = min(4, tx - x0);
          float v[4 * kEpiRows], r[4 * kEpiRows];
#pragma unroll
          for (int j = 0; j < kEpiRows; ++j) {
            const int rr = r0 + j * kWarps;
            const bool ok = rr < rows;
            const float* src = bufb + (ok ? rr : 0) * tx + x0;
            if (tx % 4 == 0) {
              const float4 t4 = *reinterpret_cast<const float4*>(src);
              v[4 * j] = t4.x, v[4 * j + 1] = t4.y, v[4 * j + 2] = t4.z,
                    v[4 * j + 3] = t4.w;
            } else {
#pragma unroll
              for (int k = 0; k < 4; ++k) v[4 * j + k] = k < nv ? src[k] : 0.f;
            }
            float rj[4];
            load_residual4(ok ? a.resid : nullptr, a.io_bf16,
                           dense_at(ok ? rr : 0) + x0, nv, rj);
#pragma unroll
            for (int k = 0; k < 4; ++k) r[4 * j + k] = rj[k];
          }
          apply_epilogue_regs<4 * kEpiRows>(a.epi_op, a.epi_val, a.n_epi,
                                            bias0, v,
                                            [&](int k) { return r[k]; });
#pragma unroll
          for (int j = 0; j < kEpiRows; ++j) {
            const int rr = r0 + j * kWarps;
            if (rr >= rows) break;
            const long long go = out_at(rr);
            if (vec) {
              reinterpret_cast<float4*>(static_cast<float*>(a.out) + go)[q] =
                  make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2],
                              v[4 * j + 3]);
              continue;
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (k >= nv) break;
              const long long at = go + (long long)(x0 + k) * a.o_col;
              if (a.io_bf16)
                static_cast<__nv_bfloat16*>(a.out)[at] =
                    __float2bfloat16(v[4 * j + k]);
              else
                static_cast<float*>(a.out)[at] = v[4 * j + k];
            }
          }
        }
    }
    __syncthreads();  // bufb is free for the next tile
  }
}

using KernelFn = decltype(&window_kernel<1, 1, 8, kThreads2d, false>);

// Instantiation tables, one translation unit each so they build in
// parallel; P and N as core/engine.py::window_p and window_rows state
// them.
KernelFn pick_2d_narrow(int N);   // N in [1, 16]: P = 32 to 13 rows, then 16
KernelFn pick_2d_wide(int N);     // N in [17, 32], P = 16
KernelFn pick_2d_strided(int N);  // N = ceil(N / sh) in [1, 16]: P = 16;
                                  // 17 to 32 rows: one of 32, P = 8
KernelFn pick_3d(int N, int D);  // N, D in [1, 5]: P = 16 or 8
// fused pipelines (ssam_window_chain_2d.cu, _chain_3d.cu): N, D buckets
// at or above the largest stage's (core/engine.py::window_inst); 2-D P as
// above, 3-D P = 8
KernelFn pick_chain_2d(int N);   // N in WINDOW_CHAIN_ROWS
KernelFn pick_chain_3d(int N, int D);  // N, D in WINDOW_CHAIN_3D
// banded launches (ssam_window_band.cu): N in WINDOW_CHAIN_ROWS at or above
// the largest band's rows, P as the 2-D tables
KernelFn pick_band_2d(int N);

}  // namespace ssam
