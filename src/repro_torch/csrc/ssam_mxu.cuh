// K2 on Hopper, single-channel path: the tensor-core strategy of the
// windowed-plan engine (strategy="mxu") for table and dense single-channel
// plans: 2-D and 3-D stencils, conv2d valid, same and batched (2-D
// filters of any size up to 64 x 64, and rows up to the columns one TMA
// box stages: 1 x 249 at a tile one column wide), t >= 1
// fused time steps with pad-once semantics, a fused pipeline's chain of
// stages in one launch, fp32 or bf16 input and output
// with fp32 sums, an output stride on 2-D plans (one application) and the
// fused epilogue (scalar bias, GELU, SiLU, ReLU, scale, residual) applied
// to the fp32 sum at the store. The kernel template is here; its
// instantiations and the C entry in ssam_mxu.cu (plans that are no chain),
// ssam_mxu_chain.cu (fused pipelines) and ssam_mxu_stream.cu (streamed B
// tiles).
//
// Replaces src/repro/core/engine.py::_apply_plan_mxu, the strategy="mxu"
// body of _window_kernel (launched at the same pallas_call as K1): im2row
// over the plan's tap set, contracted with the coefficients on the matrix
// unit with an fp32 accumulator. Channel (NCHW) plans run K2's wgmma
// kernel, ssam_mxu_tc.cu.
//
// Bound on an H100: the stencils and filters up to about 13 x 13 by
// device-memory bytes (8192^2 fp32: 537 MB, 0.160 ms at 3.35 TB/s), the
// largest footprints by the tensor cores: per output and tapped row the
// kernel does 8 * ceil((span + 7) / 8) products, three times (3xTF32),
// so conv 20 x 20 does about 258 GFLOP of TF32 products, 0.52 ms at 495
// TFLOP/s.
//
// The earlier design of this kernel put the tap set on K: every A element
// was a scalar shared-memory gather through a tap offset, the coefficient
// vector was B's only useful column (7 of 8 tensor-core columns multiplied
// zeros), and each block staged its skirt with 4-byte loads before any
// product started. This one:
//  * Toeplitz coefficient tiles. The footprint's tapped rows (dz, r) are
//    split into entries of at most 25 consecutive columns [cmin, cmin +
//    span). For an entry, B_s[k][n] = c(dz, r, cmin + 8s + k - n) for the
//    k-steps s < KK = ceil((span + 7) / 8): K walks a window of input
//    columns, N = 8 consecutive output columns, and every column of every
//    product is an output. A is the staged input itself, offset by (dz, r)
//    rows and a column block: row m of a fragment is output row y0 + m
//    (M = 16 rows), its k-th column the input column x0 + cmin + 8j + k.
//    No im2row gather: a lane reads A from shared memory at a fixed
//    offset from its row, and the row pitch is 4 mod 8 words, so the 32
//    lanes of a fragment load hit 32 banks. The block builds the B tiles
//    from the tap table in shared memory at its start.
//  * A warp item is 16 output rows x 4 chunks of 8 columns of one slice.
//    Input block j (8 columns) feeds chunk c at k-step j - c, so a
//    fragment, split once, serves up to 4 products: an entry loads 4 + KK
//    - 1 fragments for 4 KK products per chunk.
//  * mma.sync m16n8k8 in TF32, not wgmma: wgmma's A from shared memory
//    must sit in its core-matrix layout (8 rows x 16 bytes, rows
//    contiguous), and the shifted-row A of an entry starts at any column,
//    so it would need a copy per entry and shift; from registers it needs
//    the same fragment loads as mma.sync, with 64-row tiles that leave
//    most of a small tile's rows idle.
//  * fp32 parity by 3xTF32 (ssam_tf32.cuh): each operand is split by
//    truncation into big + small; big*big is accumulated in the tensor
//    core over whole entries, at least 8 k-steps, then added to the fp32
//    sum with a round-to-nearest add; big*small + small*big accumulate in
//    the tensor core. The kernel is instantiated for the plan's largest
//    entry (1 to 4 k-steps), so its fragment arrays are no larger. The Toeplitz zeros split to zeros. bf16 inputs are widened once
//    per tile into an fp32 buffer; the output is cast back.
//  * Inputs by TMA into a ring of 1-3 stages, persistent blocks, as K1's
//    single-channel path (ssam_window.cuh): one thread keeps the next
//    tiles' boxes in flight while the warps compute. A box starts at the
//    16-byte aligned column at or below the tile's first input column
//    (reads add the difference, `shift`), lands 128-byte aligned, and
//    coordinates outside the tensor read zeros, so the plan's padding
//    costs nothing. Boxes stack along y and z where a tile's input is
//    taller than 256 rows or slices.
//  * t > 1: every application but the last writes its iterate, fp32, to
//    one of two shared buffers (ping-pong, pitch 4 mod 8); the iterate is
//    not re-zeroed at the domain edge (pad-once semantics). The last
//    application stores from the accumulators to device memory.
//  * A fused pipeline (the reference's stage loop, _window_kernel lines
//    388-408, each stage on _apply_plan_mxu): the stages' entries one after
//    another in one table, their B tiles all built at the block's start,
//    one record a stage (its first entry and entry count, its footprint,
//    its mid-chain ops). Application k walks stage k's entries against its
//    B tiles, shrinks by stage k's own footprint (the iterate's pitch
//    follows its width), and applies stage k's mid-chain ops (scalar bias,
//    GELU, SiLU, ReLU, scale) to a thread's 16 fp32 sums after the
//    non-finite check below and before it writes the fp32 iterate; the
//    last stage stores through the epilogue. Chains run instantiations of
//    their own (C), so the plans that are no chain keep their registers.
//  * Output-strided plans (2-D, t = 1): the Toeplitz tile stays a band,
//    only steeper, B_s[k][n] = c(cmin + 8s + k - sw * n), so an entry's
//    k-steps KK = ceil((span + 7 sw) / 8) walk the window of input columns
//    that 8 outputs sw apart read (an entry spans at most 32 - 7 sw
//    columns, so sw <= 4), and A reads rows sh * m + r of the stage. A
//    chunk's window starts sw * 8 columns after the previous chunk's, so
//    each chunk loads its own fragments (KK each). One instantiation (of
//    4 k-steps) serves every strided plan.
//  * The epilogue and the residual (read at the output's position) are
//    applied to a thread's 16 fp32 sums in registers as the last
//    application stores them, one dispatch a stage for the 16, before the
//    bf16 cast. The store writes through an output step (row pitch,
//    column step, image pitch), so the phases of a strided plan's input
//    adjoint write their positions of dx in place.
//  * Streamed B tiles (a plan that is no chain, 2-D, unstrided, t >= 1,
//    whose tiles a block cannot keep resident: more than 1024 taps, as
//    33 x 33 and 64 x 64 filters, or tiles that leave no room for the
//    staged input at a 1 x 1 tile). Kept resident, a 64 x 64 filter's 192
//    entries would take 180 KB of tiles. Every other plan keeps its tiles
//    resident, whatever their size (255 x 1: 64 KB). The wrapper builds the tiles once a call in device memory
//    (core/engine.py::mxu_btiles) and cuts the entries, in order, into
//    groups whose tiles fill a ring slot (core/engine.py::mxu_stream,
//    slots as large as shared memory leaves beside a tile's input). A
//    block brings a group's tiles into one of two slots by cp.async, 16
//    bytes a copy, while its warps run the group before on the other, one
//    barrier a group; the staged A tile keeps the whole footprint's halo
//    and every group walks it. A warp's mma.sync sums of a group are added
//    into the application's fp32 accumulator in shared memory (the first
//    group writes, the last reads), so an item's sums carry across groups
//    without registers. At t > 1 each application walks every group
//    again; its accumulator is the buffer its iterate then takes (bufa,
//    bufb in turn, pitch 4 mod 8), the last group writing the iterate in
//    place after the vote, and the last application stores from the
//    accumulators. F3 holds across groups: the vote runs on the
//    final fp32 sums, and an item with a non-finite sum is summed again
//    tap by tap from the same staged input, over every group's entries
//    (their column tables and the coefficients read from device memory).
//    One launch a call. Tiles are chosen to move the fewest words an
//    output into shared memory, the halo and the tiles of every group
//    (core/engine.py::_mxu_stream_block): 64 x 64 for 64 x 64, 64 x 128
//    for 33 x 33. Costs: each tile reloads every group's tiles from L2
//    (180 KB a tile at 64 x 64), and each group a barrier.
//  * Non-finite inputs: an inf or nan meets the tiles' zero coefficients
//    as well, and inf * 0 is nan. A warp whose item's sums are not all
//    finite takes them again on the CUDA cores, tap by tap, so the
//    non-finite outputs are the plain version's (see apply_mx). This runs
//    in every application, so an iterate that carries an inf or a nan into
//    the next stage of a chain is re-summed from that iterate.
// Reads past a source's last column or row (the columns a ragged chunk's
// window covers, clamped rows) stay in shared memory the block zeroed at
// its start, so every A element is finite and meets a zero coefficient:
// the outputs they reach are never stored.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ssam_epilogue.cuh"
#include "ssam_hopper.cuh"
#include "ssam_tf32.cuh"

namespace ssam {

constexpr int kMxThreads = 256;
constexpr int kMxWarps = kMxThreads / 32;
constexpr int kMxRows = 16;      // output rows of an item (mma's M)
constexpr int kMxChunks = 4;     // 8-column chunks of an item (mma's N each)
constexpr int kMxFlush = 8;      // k-steps big*big sums in the tensor core
constexpr int kMxMaxStages = 3;
constexpr int kMxSlack = 64;     // words the over-reads may reach past a source
                                 // (a strided plan's: 24 sw + 40)
constexpr int kMxGeomInts = 46;  // core/engine.py::MxuLayout.geom
constexpr int kMxEntInts = 8;    // one entry's record in the table
constexpr int kMxMaxChain = 32;  // stage records (engine.py MXU_MAX_CHAIN)
constexpr int kMxMaxMid = 16;    // mid-chain ops of a chain (WINDOW_MAX_MID)

struct MxuArgs {
  void* out;           // batch x zo x ho x wo output
  int io_bf16;         // 1: bf16 input and output, 0: fp32
  const float* cvals;  // coefficient values
  const int* table;    // entries x 8 ints, then their column tables (and a
                       // streamed launch's group records)
  const float* bsrc;   // a streamed launch's B tiles in device memory
  int ndim, D, N, M, t, nent;
  // a streamed launch: its groups of entries, the fp32 words of a ring slot
  // and the groups' records in `table` (first entry, entries, first B word,
  // words); ngroups 0 for a launch whose B tiles stay resident
  int ngroups, slot_words, gtab;
  int batch, zo, ho, wo;
  int lz, ly, lx;      // t * lead per axis: input index of output 0 is -lead
  int bz, bh, bw;      // output tile
  int box_x, box_y, box_z, nby, nbz, sy, sz;
  int stages, stage_bytes;
  int pc;              // row pitch of the widened bf16 stage (words)
  int c0_words, bufa_words, bufb_words, b_words;
  int tiles_x, tiles_y, tiles_z, ntiles;
  int slack;           // zeroed words past the last buffer
  int sh, sw;          // output stride (strided instantiations; else 1)
  // the output's element (b, z, y, x) at out + b * o_img + z * o_plane +
  // y * o_row + x * o_col; the residual's in the dense output layout
  long long o_img, o_plane;
  int o_row, o_col;
  const float* bias;   // the scalar bias, or null
  const void* resid;   // the residual (the output's dtype), or null
  int epi_op[kMaxEpi];
  float epi_val[kMaxEpi];
  int n_epi;
};

// A fused pipeline's launch: the plan's arguments (D, N, M its stages'
// summed footprint, t = 1, the entries all its stages'), then one record a
// stage, (first entry, entries, N | D << 8 | M << 16, mid-chain ops first
// | count << 8, 0 for none), and the mid-chain ops. The plans that are no
// chain take MxuArgs alone, so their kernels keep their parameters.
struct MxuChainArgs : MxuArgs {
  int nchain;
  int4 chain[kMxMaxChain];
  int mid_op[kMxMaxMid];   // mid-chain ops (codes of ssam_epilogue.cuh)
  float mid_val[kMxMaxMid];
  int mid_bias[kMxMaxMid];  // a bias op's value: cvals[mid_bias]
};

template <bool C>
using MxArgs = std::conditional_t<C, MxuChainArgs, MxuArgs>;

// A stage's mid-chain ops (rec: its record's first | count << 8) on the N
// sums a thread holds, each op dispatched once for the N values.
template <int N>
__device__ __forceinline__ void mx_mid_ops(const MxuChainArgs& a, int rec,
                                           float (&v)[N]) {
  const int e0 = rec & 255, e1 = e0 + (rec >> 8);
  for (int e = e0; e < e1; ++e) {
    const float val = a.mid_val[e];
    switch (a.mid_op[e]) {
      case 1: epilogue_each<1, N>(v, val, a.cvals[a.mid_bias[e]]); break;
      case 2: epilogue_each<2, N>(v, val, 0.f); break;
      case 3: epilogue_each<3, N>(v, val, 0.f); break;
      case 4: epilogue_each<4, N>(v, val, 0.f); break;
      case 5: epilogue_each<5, N>(v, val, 0.f); break;
    }
  }
}

// A source of one application: element (z, y, col) at
// p[z * plane + y * pitch + col + shift].
struct MxSrc {
  const float* p;
  int pitch, plane, shift;
};

// One group of a streamed launch as apply_mx walks it: every entry of the
// plan (for the tap-by-tap re-sum), the group's first B word (its tiles
// sit in a ring slot from there on), the tile's fp32 accumulator `part`
// (pitch ppitch) that carries the sums across groups, and whether the
// group is the tile's first (writes part) or last (reads it, votes, stores).
struct MxGroup {
  const int4* ent_all;
  int bsub;
  float* part;
  int ppitch;
  bool first, final;
};

__device__ __forceinline__ void mx_cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// All threads: group gi's B tiles (whole entries' k-step tiles, 256 bytes
// each) from device memory into the ring slot at dst, 16 bytes a copy.
__device__ __forceinline__ void mx_load_group(const MxuArgs& a, int gi,
                                              float* dst) {
  const int* gr = a.table + a.gtab + 4 * gi;
  const float4* s = reinterpret_cast<const float4*>(a.bsrc + gr[2]);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int k = threadIdx.x; k < gr[3] / 4; k += kMxThreads)
    mx_cp_async16(d + k, s + k);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// One valid application on a source of extent (zs, hs, ws): the result
// (zd, hd, wd) goes to dst (pitch dpitch) or, for the last application, to
// the output tile at (b, oz0, oy0, ox0) through the epilogue. KKM: the most
// k-steps of an entry of the plan; S: an output-strided instantiation
// (zd = 1, the caller's (hd, wd) the tile's outputs); C: a chain's stage,
// its nent_c entries from ent and its mid-chain ops `mid` (a record's
// field), applied before dst is written (a plan that is no chain walks
// all a.nent entries). St: one group of a streamed launch (its nent_c
// entries from ent, its B tiles at btile from word grp.bsub on); a group
// but the last adds its fp32 sums into grp.part, the last adds grp.part to
// its own before the vote, and the re-sum walks every entry of the plan.
template <int KKM, bool S, bool C = false, class Args = MxuArgs,
          bool St = false>
__device__ __forceinline__ void apply_mx(const Args& a, const MxSrc& src,
                                         int zd, int hd, int wd, float* dst,
                                         int dpitch, bool last, int b,
                                         int oz0, int oy0, int ox0,
                                         const int4* ent,
                                         const float* btile, int nent_c = 0,
                                         int mid = 0, MxGroup grp = {}) {
  const int nent = C || St ? nent_c : a.nent;
  const int nyg = (hd + kMxRows - 1) / kMxRows;
  const int nxg = (wd + 8 * kMxChunks - 1) / (8 * kMxChunks);
  const int per_z = nyg * nxg;
  const int items = zd * per_z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, q = lane & 3;
  const int sh = S ? a.sh : 1, sw = S ? a.sw : 1;
  for (int it = warp; it < items; it += kMxWarps) {
    const int z = it / per_z;
    const int r0 = it - z * per_z;
    const int y0 = (r0 / nxg) * kMxRows, x0 = (r0 % nxg) * 8 * kMxChunks;
    // rows past the source's last output row read that row (their sums
    // are not stored)
    const int ya = min(y0 + g, hd - 1), yb = min(y0 + g + 8, hd - 1);
    // acc: the fp32 sum; hi: big*big in the tensor core since the last
    // flush (whole entries, kMxFlush k-steps or more); cor: the cross terms
    float acc[kMxChunks][4], cor[kMxChunks][4], hi[kMxChunks][4];
#pragma unroll
    for (int c = 0; c < kMxChunks; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][i] = cor[c][i] = hi[c][i] = 0.f;
    int pend = 0;
    for (int e = 0; e < nent; ++e) {
      const int4 h = ent[2 * e];       // dz, r, cmin, KK
      const int boff = ent[2 * e + 1].x - (St ? grp.bsub : 0);
      const int kk = h.w;
      const float* row = src.p + (z + h.x) * src.plane + sw * x0 + h.z +
                         src.shift + q;
      const float* pa = row + (sh * ya + h.y) * src.pitch;
      const float* pb = row + (sh * yb + h.y) * src.pitch;
      // B fragments of the entry's k-steps: b0 = B[q][g], b1 = B[q + 4][g]
      uint32_t bb[KKM][2], bs[KKM][2];
      const float* bt = btile + boff + q * 8 + g;
#pragma unroll
      for (int s = 0; s < KKM; ++s) {
        bb[s][0] = bb[s][1] = bs[s][0] = bs[s][1] = 0u;
        if (s < kk) {
          split_tf32_trunc(__float_as_uint(bt[s * 64]), bb[s][0], bs[s][0]);
          split_tf32_trunc(__float_as_uint(bt[s * 64 + 32]), bb[s][1],
                           bs[s][1]);
        }
      }
      if constexpr (S) {
        // chunk c's window starts sw * 8c columns in: its own fragments
#pragma unroll
        for (int c = 0; c < kMxChunks; ++c)
#pragma unroll
          for (int s = 0; s < KKM; ++s) {
            if (s < kk) {
              const int o = sw * 8 * c + 8 * s;
              uint32_t ab[4], as[4];
              split_tf32_trunc(__float_as_uint(pa[o]), ab[0], as[0]);
              split_tf32_trunc(__float_as_uint(pb[o]), ab[1], as[1]);
              split_tf32_trunc(__float_as_uint(pa[o + 4]), ab[2], as[2]);
              split_tf32_trunc(__float_as_uint(pb[o + 4]), ab[3], as[3]);
              mma_tf32(hi[c], ab, bb[s]);
              mma_tf32(cor[c], as, bb[s]);
              mma_tf32(cor[c], ab, bs[s]);
            }
          }
      } else {
#pragma unroll
      for (int j = 0; j < kMxChunks + KKM - 1; ++j) {
        if (j < kMxChunks + kk - 1) {
          // A rows g and g + 8, columns q and q + 4 of input block j
          uint32_t ab[4], as[4];
          split_tf32_trunc(__float_as_uint(pa[8 * j]), ab[0], as[0]);
          split_tf32_trunc(__float_as_uint(pb[8 * j]), ab[1], as[1]);
          split_tf32_trunc(__float_as_uint(pa[8 * j + 4]), ab[2], as[2]);
          split_tf32_trunc(__float_as_uint(pb[8 * j + 4]), ab[3], as[3]);
#pragma unroll
          for (int c = 0; c < kMxChunks; ++c) {
            const int s = j - c;  // the k-step block j is for chunk c
            const int si = s < 0 ? 0 : (s < KKM ? s : 0);
            if (s >= 0 && s < KKM && s < kk) {
              mma_tf32(hi[c], ab, bb[si]);
              mma_tf32(cor[c], as, bb[si]);
              mma_tf32(cor[c], ab, bs[si]);
            }
          }
        }
      }
      }
      pend += kk;
      if (pend >= kMxFlush || e == nent - 1) {
        // the tensor core's fp32 sums truncate: big*big goes to the sum
        // with a round-to-nearest add every few k-steps
#pragma unroll
        for (int c = 0; c < kMxChunks; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[c][i] += hi[c][i];
            hi[c][i] = 0.f;
          }
        pend = 0;
      }
    }
    if constexpr (St) {
      // the tile's fp32 sums carried across groups: a group but the last
      // adds its own to them (the first writes them), the last takes them
      // into its accumulator before the vote
#pragma unroll
      for (int c = 0; c < kMxChunks; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int y = y0 + g + 8 * (i >> 1), x = x0 + 8 * c + 2 * q + (i & 1);
          if (y >= hd || x >= wd) continue;
          float* pp = grp.part + (z * hd + y) * grp.ppitch + x;
          if (!grp.final)
            *pp = (grp.first ? 0.f : *pp) + (acc[c][i] + cor[c][i]);
          else if (!grp.first)
            acc[c][i] += *pp;
        }
      if (!grp.final) continue;
    }
    // A non-finite value in the item's source meets the Toeplitz tiles'
    // zeros (inf * 0 is nan) and would reach outputs its taps do not: a
    // finite source gives finite sums (short of an overflow), so the warp
    // votes on them, and where one is not finite the item's sums are
    // taken again on the CUDA cores, tap by tap from the same source (the
    // entries' columns in order), so that an output is non-finite where
    // the plain version's is.
    bool bad = false;
#pragma unroll
    for (int c = 0; c < kMxChunks; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) bad |= nonfinite(acc[c][i] + cor[c][i]);
    if (__any_sync(0xffffffffu, bad)) {
      // a streamed launch: every group's entries, their columns in order
      const int4* er = St ? grp.ent_all : ent;
      const int ne = St ? a.nent : nent;
#pragma unroll
      for (int c = 0; c < kMxChunks; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int y = min(y0 + g + 8 * (i >> 1), hd - 1);
          const int x = min(x0 + 8 * c + 2 * q + (i & 1), wd - 1);
          float v = 0.f;
          for (int e = 0; e < ne; ++e) {
            const int4 h = er[2 * e];            // dz, r, cmin, KK
            const int4 h2 = er[2 * e + 1];       // B offset, span, columns
            const int* col = a.table + h2.z;
            const float* row = src.p + (z + h.x) * src.plane +
                               (sh * y + h.y) * src.pitch + sw * x + h.z +
                               src.shift;
            for (int k = 0; k < h2.y; ++k) {
              const int ci = col[k];
              if (ci >= 0) v = __fadd_rn(v, __fmul_rn(row[k], a.cvals[ci]));
            }
          }
          acc[c][i] = v;
          cor[c][i] = 0.f;
        }
    }
    if constexpr (C) {
      if (!last && mid) {
        // the stage's mid-chain ops on the fp32 iterate, after the check
        float v[kMxChunks * 4];
#pragma unroll
        for (int c = 0; c < kMxChunks; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v[4 * c + i] = acc[c][i] + cor[c][i];
            cor[c][i] = 0.f;
          }
        mx_mid_ops<kMxChunks * 4>(a, mid, v);
#pragma unroll
        for (int c = 0; c < kMxChunks; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[c][i] = v[4 * c + i];
      }
    }
    // the accumulator: d[0], d[1] row g, columns 2q, 2q + 1; d[2], d[3]
    // row g + 8
    if (last && a.n_epi) {
      // the chain on the thread's 16 sums in registers, one dispatch a
      // stage for all of them; the residual at each output's position;
      // the scalar bias loaded here so that no register holds it while
      // the products run
      const float bias0 = a.bias ? a.bias[0] : 0.f;
      float v[kMxChunks * 4];
#pragma unroll
      for (int c = 0; c < kMxChunks; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[4 * c + i] = acc[c][i] + cor[c][i];
          cor[c][i] = 0.f;
        }
      apply_epilogue_regs<kMxChunks * 4>(
          a.epi_op, a.epi_val, a.n_epi, bias0, v, [&](int k) {
            const int y = y0 + g + 8 * ((k & 3) >> 1);
            const int x = x0 + 8 * (k >> 2) + 2 * q + (k & 1);
            return y < hd && x < wd
                       ? load_residual(a.resid, a.io_bf16,
                                       (((size_t)b * a.zo + oz0 + z) * a.ho +
                                        oy0 + y) * a.wo + ox0 + x)
                       : 0.f;
          });
#pragma unroll
      for (int c = 0; c < kMxChunks; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[c][i] = v[4 * c + i];
    }
#pragma unroll
    for (int c = 0; c < kMxChunks; ++c) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int y = y0 + g + 8 * hh;
        const int x = x0 + 8 * c + 2 * q;
        if (y >= hd || x >= wd) continue;
        const float v0 = acc[c][2 * hh] + cor[c][2 * hh];
        const float v1 = acc[c][2 * hh + 1] + cor[c][2 * hh + 1];
        const bool two = x + 1 < wd;
        if (!last) {
          float* d = dst + (z * hd + y) * dpitch + x;
          d[0] = v0;
          if (two) d[1] = v1;
          continue;
        }
        const long long go = b * a.o_img + (oz0 + z) * a.o_plane +
                             (long long)(oy0 + y) * a.o_row +
                             (long long)(ox0 + x) * a.o_col;
        // a pair of columns in one store where they are adjacent and
        // aligned
        if (a.io_bf16) {
          __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.out) + go;
          if (two && a.o_col == 1 &&
              (reinterpret_cast<uintptr_t>(o) & 3) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            o[0] = __float2bfloat16(v0);
            if (two) o[a.o_col] = __float2bfloat16(v1);
          }
        } else {
          float* o = static_cast<float*>(a.out) + go;
          if (two && a.o_col == 1 &&
              (reinterpret_cast<uintptr_t>(o) & 7) == 0) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = v0;
            if (two) o[a.o_col] = v1;
          }
        }
      }
    }
  }
}

// Thread 0: the TMA boxes of tile `tile` into the stage at dst, completing
// on bar. A 2-D plan's map is (W, H, batch), a 3-D plan's (W, H, Z, batch).
__device__ __forceinline__ void issue_mx_tile(const CUtensorMap* xmap,
                                              const MxuArgs& a, int tile,
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
  mbar_expect_tx(bar, box * a.nby * a.nbz);
  for (int jz = 0; jz < a.nbz; ++jz)
    for (int jy = 0; jy < a.nby; ++jy) {
      const uint32_t off =
          (jz * a.box_z * a.sy + jy * a.box_y) * a.box_x * es;
      if (a.ndim == 2)
        tma_load_3d(dst + off, xmap, bar, x0, y0 + jy * a.box_y, b);
      else
        tma_load_4d(dst + off, xmap, bar, x0, y0 + jy * a.box_y,
                    z0 + jz * a.box_z, b);
    }
}

// St: a streamed launch (2-D, no chain, no stride): its B tiles, built by
// the wrapper in device memory, come a group of entries at a time into a
// ring of two slots, the next group's by cp.async while the warps run this
// one; bufa and bufb hold the applications' fp32 sums across groups.
template <int KKM, bool S, bool C, bool St = false>
__global__ void __launch_bounds__(kMxThreads, 2)
    mxu_window_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ MxArgs<C> a) {
  extern __shared__ uint8_t smem_raw[];
  // the ring first, 128-byte aligned; then the fp32 buffers and the slack
  // the over-reads reach (all zeroed here), the B tiles (a streamed
  // launch's two slots), the entries and the barriers
  uint8_t* ring = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  float* c0 = reinterpret_cast<float*>(ring + a.stages * a.stage_bytes);
  float* bufa = c0 + a.c0_words;
  float* bufb = bufa + a.bufa_words;
  float* btile = bufb + a.bufb_words + a.slack;
  int4* ent = reinterpret_cast<int4*>(btile + (St ? 2 * a.slot_words
                                                 : a.b_words));
  uint64_t* full = reinterpret_cast<uint64_t*>(ent + 2 * a.nent);

  const int tid = threadIdx.x;
  {
    float4* z4 = reinterpret_cast<float4*>(ring);
    const int n4 = (a.stages * a.stage_bytes) / 16 +
                   (a.c0_words + a.bufa_words + a.bufb_words + a.slack) / 4;
    for (int k = tid; k < n4; k += kMxThreads)
      z4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // the entries (dz, r, cmin, KK | B offset, span, column table) and
  // their Toeplitz tiles B_s[k][n] = c(dz, r, cmin + 8s + k - sw * n)
  for (int e = tid; e < a.nent; e += kMxThreads) {
    const int* h = a.table + kMxEntInts * e;
    ent[2 * e] = make_int4(h[0], h[1], h[2], h[4]);
    ent[2 * e + 1] = make_int4(h[5], h[3], h[6], 0);
  }
  for (int e = 0; e < (St ? 0 : a.nent); ++e) {
    const int* h = a.table + kMxEntInts * e;
    const int span = h[3], kk = h[4], boff = h[5];
    const int* col = a.table + h[6];
    for (int i = tid; i < kk * 64; i += kMxThreads) {
      const int s = i >> 6, k = (i >> 3) & 7, n = i & 7;
      const int qq = 8 * s + k - a.sw * n;
      const int ci = (qq >= 0 && qq < span) ? col[qq] : -1;
      btile[boff + i] = ci >= 0 ? a.cvals[ci] : 0.f;
    }
  }
  fence_proxy_async();  // the zeroed ring before TMA writes it
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
        issue_mx_tile(&xmap, a, tile, smem_addr(ring + s * a.stage_bytes),
                      smem_addr(&full[s]));
    }

  if constexpr (St) mx_load_group(a, 0, btile);  // the first group's tiles
  int seq = 0;  // groups walked: group seq's tiles sit in slot seq & 1

  const int t = a.t;
  const int per = a.io_bf16 ? 8 : 4;
  int i = 0;
  for (int tile = blockIdx.x; tile < a.ntiles; tile += G, ++i) {
    const int s = i % a.stages;
    uint8_t* stage = ring + s * a.stage_bytes;
    const int txi = tile % a.tiles_x;
    int r = tile / a.tiles_x;
    const int tyi = r % a.tiles_y;
    r /= a.tiles_y;
    const int tzi = r % a.tiles_z, b = r / a.tiles_z;
    const int oz0 = tzi * a.bz, oy0 = tyi * a.bh, ox0 = txi * a.bw;
    const int tz = min(a.bz, a.zo - oz0), ty = min(a.bh, a.ho - oy0);
    const int tx = min(a.bw, a.wo - ox0);
    const int ix0 = ox0 * a.sw - a.lx;
    const int shift = ((ix0 % per) + per) % per;
    int zs = tz + t * (a.D - 1), hs = ty + t * (a.N - 1),
        ws = tx + t * (a.M - 1);

    mbar_wait(smem_addr(&full[s]), (i / a.stages) & 1);
    MxSrc src{reinterpret_cast<const float*>(stage), a.box_x,
              a.sy * a.box_x, shift};
    bool refilled = false;
    if (a.io_bf16) {  // widen once into c0, rows at pitch pc
      const __nv_bfloat16* sb = reinterpret_cast<const __nv_bfloat16*>(stage);
      const int rows = a.sz * a.sy;
      for (int k = tid; k < rows * a.box_x; k += kMxThreads) {
        const int rr = k / a.box_x, xx = k - rr * a.box_x;
        c0[rr * a.pc + xx] = __bfloat162float(sb[k]);
      }
      __syncthreads();  // the stage is read: refill it
      if (tid == 0 && tile + a.stages * G < a.ntiles)
        issue_mx_tile(&xmap, a, tile + a.stages * G, smem_addr(stage),
                      smem_addr(&full[s]));
      refilled = true;
      src = MxSrc{c0, a.pc, a.sy * a.pc, shift};
    }
    if constexpr (St) {
      // t applications, each a group of entries at a time, its sums
      // carried in bufa or bufb (ping-pong, pitch 4 mod 8), where an
      // application but the last leaves its fp32 iterate in place for the
      // next; group gi's tiles landed in slot seq & 1 by the copies issued
      // one group before, and the next group's (the next application's or
      // the next tile's first after the last) go into the other slot while
      // this one runs. One group: loaded once.
      for (int k = 0; k < t; ++k) {
        const bool last = k == t - 1;
        const int hd = hs - (a.N - 1), wd = ws - (a.M - 1);
        const int ppitch = (wd + 4) / 8 * 8 + 4;
        float* part = (k & 1) ? bufb : bufa;
        for (int gi = 0; gi < a.ngroups; ++gi) {
          asm volatile("cp.async.wait_all;" ::: "memory");
          __syncthreads();  // the slot is filled; the other one is free
          if (a.ngroups > 1 &&
              (gi + 1 < a.ngroups || !last || tile + G < a.ntiles))
            mx_load_group(a, gi + 1 < a.ngroups ? gi + 1 : 0,
                          btile + ((seq + 1) & 1) * a.slot_words);
          const int* gr = a.table + a.gtab + 4 * gi;
          const MxGroup grp{ent, gr[2], part, ppitch, gi == 0,
                            gi == a.ngroups - 1};
          apply_mx<KKM, false, false, MxuArgs, true>(
              a, src, 1, hd, wd, part, ppitch, last && grp.final, b, oz0,
              oy0, ox0, ent + 2 * gr[0], btile + (seq & 1) * a.slot_words,
              gr[1], 0, grp);
          if (a.ngroups > 1) ++seq;
        }
        __syncthreads();
        if (!refilled && tid == 0 && tile + a.stages * G < a.ntiles)
          issue_mx_tile(&xmap, a, tile + a.stages * G, smem_addr(stage),
                        smem_addr(&full[s]));  // the stage is read: refill it
        refilled = true;
        hs = hd;
        ws = wd;
        src = MxSrc{part, ppitch, hs * ppitch, 0};
      }
    } else if constexpr (C) {
      // a chain: one application a stage, each walking the stage's own
      // entries and shrinking by its own footprint (Dk, Nk, Mk)
      for (int k = 0; k < a.nchain; ++k) {
        const bool last = k == a.nchain - 1;
        const int4 rec = a.chain[k];
        const int Nk = rec.z & 255, Dk = (rec.z >> 8) & 255;
        const int Mk = rec.z >> 16;
        float* dst = (k & 1) ? bufb : bufa;
        const int dpitch = (ws - (Mk - 1) + 4) / 8 * 8 + 4;  // 4 mod 8
        apply_mx<KKM, S, C>(a, src, zs - (Dk - 1), hs - (Nk - 1),
                            ws - (Mk - 1), dst, dpitch, last, b, oz0, oy0,
                            ox0, ent + 2 * rec.x, btile, rec.y, rec.w);
        __syncthreads();
        if (!refilled && tid == 0 && tile + a.stages * G < a.ntiles)
          issue_mx_tile(&xmap, a, tile + a.stages * G, smem_addr(stage),
                        smem_addr(&full[s]));  // the stage is read: refill
        refilled = true;
        zs -= Dk - 1;
        hs -= Nk - 1;
        ws -= Mk - 1;
        src = MxSrc{dst, dpitch, hs * dpitch, 0};
      }
    } else {
      for (int k = 0; k < t; ++k) {
        const bool last = k == t - 1;
        float* dst = (k & 1) ? bufb : bufa;
        // >= width, 4 mod 8
        const int dpitch = (ws - (a.M - 1) + 4) / 8 * 8 + 4;
        if constexpr (S)
          apply_mx<KKM, S>(a, src, 1, ty, tx, dst, dpitch, last, b, oz0,
                           oy0, ox0, ent, btile);
        else
          apply_mx<KKM, S>(a, src, zs - (a.D - 1), hs - (a.N - 1),
                           ws - (a.M - 1), dst, dpitch, last, b, oz0, oy0,
                           ox0, ent, btile);
        __syncthreads();
        if (!refilled && tid == 0 && tile + a.stages * G < a.ntiles)
          issue_mx_tile(&xmap, a, tile + a.stages * G, smem_addr(stage),
                        smem_addr(&full[s]));  // the stage is read: refill
        refilled = true;
        zs -= a.D - 1;
        hs -= a.N - 1;
        ws -= a.M - 1;
        src = MxSrc{dst, dpitch, hs * dpitch, 0};
      }
    }
  }
}

using MxuKernelFn = decltype(&mxu_window_kernel<1, false, false>);
using MxuChainKernelFn = decltype(&mxu_window_kernel<1, false, true>);

// The instantiation of a plan that is no chain (ssam_mxu.cu), of a fused
// pipeline (ssam_mxu_chain.cu) and of a streamed launch (ssam_mxu_stream.cu)
// for its largest entry's k-steps.
MxuKernelFn pick_mxu(int kkmax, bool strided);
MxuChainKernelFn pick_mxu_chain(int kkmax);
MxuKernelFn pick_mxu_stream(int kkmax);

}  // namespace ssam
