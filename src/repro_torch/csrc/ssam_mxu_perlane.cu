// K2 on Hopper, per-lane path: the tensor-core strategy (strategy="mxu")
// for per-lane coefficient plans, i.e. the depthwise causal conv1d of Mamba
// blocks and its input adjoint, fp32 or bf16 input and output with fp32
// sums, and the fused epilogue (per-lane bias, GELU, SiLU, ReLU, scale,
// residual) applied to the fp32 sum at the store.
//
// Replaces the per-lane branch of src/repro/core/engine.py::_apply_plan_mxu
// (the strategy="mxu" body of _window_kernel, launched at the same
// pallas_call as K1): the tap views stacked into A (taps padded to 8, rows,
// lanes) and the per-lane rows w[coeff_id, lane] into Wm (taps, lanes),
// contracted over the taps under a lane batch with an fp32 accumulator.
//
//   out[b, t, d] = epi( sum_r x[b, t + r - lead, d] * w[cid[r], d] )
//
// over the footprint rows r < N <= 8 that carry a tap (cid[r] >= 0), zeros
// where the read leaves [0, T). The forward plan has lead K-1 and cid[r] =
// r; its input adjoint has lead 0 and the reflected cid[r] = K-1-r.
//
// Bound on an H100: bytes. At Hymba's (2, 2048, 3200) fp32 the input and
// output are 104.9 MB, 0.031 ms at 3.35 TB/s; the tensor-core work (6 TF32
// products of m16n8k8 per lane and 128 outputs) is about 1.3 GFLOP.
//
// Design (a lane's taps as a Toeplitz band on the tensor cores, in the
// spirit of the single-channel path's tiles, ssam_mxu.cu):
//  * For one lane, an mma.sync m16n8k8 tile covers 128 consecutive outputs:
//    D[i][j] is output t0 + 8i + j (16 rows of 8 steps). A[i][m] = x[t0 -
//    lead + 8i + m] for m in 0..15 (two k-steps of 8) and B is the lane's
//    16 x 8 band B[m][j] = wr[m - j] where 0 <= m - j < N, else 0 (wr[r] =
//    w[cid[r], lane]): sum_m A[i][m] B[m][j] = sum_r x[t0 - lead + 8i + j +
//    r] wr[r]. Every tensor-core column is an output; the band's zeros are
//    the padding of the reference's taps to 8.
//  * A unit is 128 output rows x 128 bytes of lanes (32 fp32, 64 bf16) of
//    one sequence; persistent blocks walk units with the time tile fastest,
//    so blocks in flight share their 8 halo rows in L2. A unit's 136 input
//    rows, its filter rows and its bias come by cp.async, 16 bytes a copy
//    (element by element where D or a pointer leaves the rows unaligned),
//    zeros outside [0, T) and past D, into one of two stages: the next
//    unit's copies are in flight while the block computes and stores this
//    one. A row's eight 16-byte chunks are permuted by an XOR of bits 0, 1
//    and 3 of the row, so the fragment loads below (rows 8g + c and 8g + c
//    + 8 in one phase of 8 lanes) hit eight different chunks: no bank
//    conflicts.
//  * Each warp walks chunks (4 fp32 or 8 bf16 lanes). A thread's A fragment
//    elements of all the chunk's lanes come from 8 16-byte shared loads (4
//    fragment registers x 2 k-steps), each holding the same time row of
//    every lane of the chunk; each lane then takes its own word.
//  * fp32 by 3xTF32 (ssam_tf32.cuh): both operands split by truncation;
//    big*big of each k-step starts from zero and is added to the fp32 sum,
//    the cross terms accumulate in the tensor core. A bf16 x is exact in
//    TF32, so it takes the two products on w's split only.
//  * The outputs leave through a staging tile in shared memory (chunks
//    permuted by bits 1-3 of the row) as 16-byte rows. A residual is staged
//    into that tile first by cp.async, in the output's layout, and each
//    thread reads it where it will write its own outputs. The epilogue runs
//    on a thread's fp32 sums in registers, one dispatch a stage for all of
//    them; SiLU takes the hardware exponential and the approximate division
//    as K1's per-lane path does.
// A row that x holds but an output's taps do not reach still meets a zero
// coefficient of the band, so a non-finite x there (inf, nan) reaches that
// output as nan where the plain version's sum skips it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ssam_epilogue.cuh"
#include "ssam_tf32.cuh"

namespace {

constexpr int kThreads = 128;          // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 8;             // 16-byte chunks of a tile row
constexpr int kOut = 128;              // output rows of a unit: 16 x 8
constexpr int kInRows = kOut + 8;      // the 16-row window of the last 8
constexpr int kMaxRows = 8;            // footprint rows (filter taps)
constexpr int kStages = 2;             // units in flight a block
constexpr int kBlocksPerSm = 4;        // core/engine.py::MXU_PL_BLOCKS_PER_SM

struct MxuPerlaneArgs {
  const void* x;      // (batch, T, D), fp32 or bf16
  void* out;          // (batch, To, D), x's dtype
  const float* w;     // (K, D) fp32
  const float* bias;  // (D,) fp32, or null
  const void* resid;  // (batch, To, D) residual in x's dtype, or null
  int cid[kMaxRows];  // per footprint row: the row of w, -1 = no tap
  int epi_op[ssam::kMaxEpi];
  float epi_val[ssam::kMaxEpi];
  int n_epi;
  int T, D, To, lead, N, aligned;
  int gx, gy, units;  // lane tiles, row tiles, all units (with sequences)
};

// A stage of the ring: a unit's input rows, filter rows and bias.
template <int kLanes>
struct Stage {
  uint4 x[kInRows][kChunks];
  float w[kMaxRows][kLanes];
  float bias[kLanes];
};

// Bytes of dynamic shared memory: the stages and the staging tile.
template <bool kBf16>
constexpr int smem_bytes() {
  return kStages * (int)sizeof(Stage<kBf16 ? 64 : 32>) +
         kOut * kChunks * 16;
}

// the chunk a row's 16-byte chunk k lands in: input tile, output tile
__device__ __forceinline__ int swz_in(int r) {
  return (r & 3) | ((r >> 1) & 4);
}
__device__ __forceinline__ int swz_out(int r) { return (r >> 1) & 7; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(Pending) : "memory");
}

// The fp32 bits of lane v of a 16-byte chunk (bf16: the high half).
template <bool kBf16>
__device__ __forceinline__ uint32_t lane_bits(const uint4& u, int v) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (kBf16)
    return (v & 1) ? (w[v >> 1] & 0xffff0000u) : (w[v >> 1] << 16);
  else
    return w[v];
}

// 16 bytes of lanes from their fp32 values (bf16: rounded to nearest even,
// the low half first), built in registers.
template <bool kBf16, int V>
__device__ __forceinline__ uint4 pack_lanes(const float (&o)[V][4], int i) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (kBf16) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * k][i],
                                                     o[2 * k + 1][i]);
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
    } else {
      w[k] = __float_as_uint(o[k][i]);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Up to 16 bytes of a row, from `n` < 16-byte elements: 2- or 4-byte words
// packed, zeros past n.
template <bool kBf16, class T>
__device__ __forceinline__ uint4 load_lanes(const T* src, int n) {
  constexpr int V = kBf16 ? 8 : 4;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (v >= n) break;
    if constexpr (kBf16)
      w[v >> 1] |= (uint32_t)__bfloat16_as_ushort(src[v]) << (16 * (v & 1));
    else
      w[v] = __float_as_uint(src[v]);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int Op, int V>
__device__ __forceinline__ void each(float (&o)[V][4], float val) {
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (Op == 3)
        o[v][i] = __fdividef(o[v][i], 1.f + __expf(-o[v][i]));
      else
        o[v][i] = ssam::apply_epilogue_op(Op, val, nullptr, o[v][i], 0);
    }
}

template <bool kBf16>
struct Unit {
  int l0, t0, b;
  __device__ Unit(const MxuPerlaneArgs& a, int u)
      : l0((u / a.gy) % a.gx * (kChunks * (kBf16 ? 8 : 4))),
        t0(u % a.gy * kOut),
        b(u / a.gy / a.gx) {}
};

// Issue the copies of unit u into stage st: its input rows t0 - lead + r,
// its filter rows and its bias (no copy commits).
template <bool kBf16, class T, int kLanes>
__device__ void stage_unit(const MxuPerlaneArgs& a, int u,
                           Stage<kLanes>& st) {
  constexpr int V = kBf16 ? 8 : 4;
  const Unit<kBf16> un(a, u);
  const T* x = static_cast<const T*>(a.x) + (size_t)un.b * a.T * a.D;
  for (int i = threadIdx.x; i < kInRows * kChunks; i += kThreads) {
    const int r = i / kChunks, k = i % kChunks;
    const int ti = un.t0 - a.lead + r;
    const int l = un.l0 + k * V;
    uint4* dst = &st.x[r][k ^ swz_in(r)];
    if (ti < 0 || ti >= a.T || l >= a.D)
      *dst = make_uint4(0u, 0u, 0u, 0u);
    else if (a.aligned)
      cp_async16(dst, x + (size_t)ti * a.D + l);
    else
      *dst = load_lanes<kBf16>(x + (size_t)ti * a.D + l, a.D - l);
  }
  // the filter rows (zeros where no tap or past D) and the bias, 4 fp32
  // lanes a copy
  constexpr int kQuads = kLanes / 4;
  for (int i = threadIdx.x; i < (kMaxRows + 1) * kQuads; i += kThreads) {
    const int r = i / kQuads, l = (i % kQuads) * 4;
    const int c = r < a.N ? a.cid[r] : -1;
    const float* src = r == kMaxRows ? a.bias
                       : c >= 0      ? a.w + (size_t)c * a.D
                                     : nullptr;
    float* dst = r == kMaxRows ? &st.bias[l] : &st.w[r][l];
    const int d = un.l0 + l;
    if (src != nullptr && d < a.D && a.aligned) {
      cp_async16(dst, src + d);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        dst[v] = src != nullptr && d + v < a.D ? src[d + v] : 0.f;
    }
  }
}

// Four blocks an SM (55.8 KB of shared memory each at most), so ptxas keeps
// to 128 registers; it spills none (left to itself it gave the fp32
// instance 96 registers and spilled one). Of the variants tried on the card
// at Hymba's shape (2 to 4 stages, 2 to 4 blocks an SM), 2 stages at 4
// blocks ran fastest on most cases.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    mxu_perlane_kernel(const __grid_constant__ MxuPerlaneArgs a) {
  constexpr int V = kBf16 ? 8 : 4;        // lanes of a chunk
  constexpr int kLanes = kChunks * V;     // lanes of a tile
  using T = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  Stage<kLanes>* stages = reinterpret_cast<Stage<kLanes>*>(smem);
  uint4(*ost)[kChunks] =
      reinterpret_cast<uint4(*)[kChunks]>(smem +
                                          kStages * sizeof(Stage<kLanes>));

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  // value i of a lane's D fragment is output row 8g + 2c + (i & 1) + 64 (i
  // >> 1) of the unit
  int tr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) tr[i] = 8 * g + 2 * c + (i & 1) + 32 * (i & 2);

  for (int s = 0; s + 1 < kStages; ++s) {  // the first units' copies
    const int u = blockIdx.x + s * gridDim.x;
    if (u < a.units) stage_unit<kBf16, T>(a, u, stages[s]);
    cp_async_commit();
  }
  for (int u = blockIdx.x, k = 0; u < a.units; u += gridDim.x, ++k) {
    Stage<kLanes>& st = stages[k % kStages];
    const Unit<kBf16> un(a, u);
    T* out = static_cast<T*>(a.out) + (size_t)un.b * a.To * a.D;
    // the residual into the staging tile (free since the last store), then
    // the copies of the unit kStages - 1 ahead into the stage freed last
    if (a.resid != nullptr) {
      const T* res = static_cast<const T*>(a.resid) +
                     (size_t)un.b * a.To * a.D;
      for (int i = threadIdx.x; i < kOut * kChunks; i += kThreads) {
        const int r = i / kChunks, q = i % kChunks;
        const int t = un.t0 + r, l = un.l0 + q * V;
        uint4* dst = &ost[r][q ^ swz_out(r)];
        if (t >= a.To || l >= a.D)
          *dst = make_uint4(0u, 0u, 0u, 0u);
        else if (a.aligned)
          cp_async16(dst, res + (size_t)t * a.D + l);
        else
          *dst = load_lanes<kBf16>(res + (size_t)t * a.D + l, a.D - l);
      }
      cp_async_commit();
    }
    const int ahead = u + (kStages - 1) * (int)gridDim.x;
    if (ahead < a.units)
      stage_unit<kBf16, T>(a, ahead, stages[(k + kStages - 1) % kStages]);
    cp_async_commit();
    // this unit's stage (and the residual, committed after the units ahead)
    // has landed
    if (a.resid != nullptr)
      cp_async_wait<1>();
    else
      cp_async_wait<kStages - 1>();
    __syncthreads();

    for (int q = warp; q < kChunks; q += kWarps) {
      if (un.l0 + q * V >= a.D) break;     // the tile's last lanes
      // A fragments: a0..a3 at rows 8g + c (+64 for rows g + 8, +4 for
      // columns c + 4), + 8 a k-step
      uint4 av[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int r = 8 * g + c + 8 * ks + ((f & 1) ? 64 : 0) +
                        ((f & 2) ? 4 : 0);
          av[ks][f] = st.x[r][q ^ swz_in(r)];
        }
      float o[V][4];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        // the band: b0 = wr[8ks + c - g], b1 = wr[8ks + c + 4 - g]
        uint32_t bb[2][2], bs[2][2];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 8 * ks + c + 4 * h - g;
            const float wv =
                (r >= 0 && r < kMaxRows) ? st.w[r][q * V + v] : 0.f;
            ssam::split_tf32_trunc(__float_as_uint(wv), bb[ks][h],
                                   bs[ks][h]);
          }
        float acc[4] = {0.f, 0.f, 0.f, 0.f}, cor[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t ab[4], as[4];
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const uint32_t e = lane_bits<kBf16>(av[ks][f], v);
            if constexpr (kBf16) {
              ab[f] = e;
              as[f] = 0u;
            } else {
              ssam::split_tf32_trunc(e, ab[f], as[f]);
            }
          }
          if constexpr (kBf16) {
            float hi[4] = {0.f, 0.f, 0.f, 0.f};
            ssam::mma_tf32(hi, ab, bb[ks]);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i] += hi[i];
            ssam::mma_tf32(cor, ab, bs[ks]);
          } else {
            ssam::mma_3xtf32(acc, cor, ab, as, bb[ks], bs[ks]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) o[v][i] = acc[i] + cor[i];
      }
      for (int s = 0; s < a.n_epi; ++s) {
        const float val = a.epi_val[s];
        switch (a.epi_op[s]) {
          case 1:
#pragma unroll
            for (int v = 0; v < V; ++v)
#pragma unroll
              for (int i = 0; i < 4; ++i) o[v][i] += st.bias[q * V + v];
            break;
          case 2: each<2, V>(o, val); break;
          case 3: each<3, V>(o, val); break;
          case 4: each<4, V>(o, val); break;
          case 5: each<5, V>(o, val); break;
          case 6:  // the residual where this thread's outputs go
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const uint4 rv = ost[tr[i]][q ^ swz_out(tr[i])];
#pragma unroll
              for (int v = 0; v < V; ++v)
                o[v][i] += __uint_as_float(lane_bits<kBf16>(rv, v));
            }
            break;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ost[tr[i]][q ^ swz_out(tr[i])] = pack_lanes<kBf16, V>(o, i);
    }
    __syncthreads();
    // the unit's rows, 16 bytes a thread
    for (int i = threadIdx.x; i < kOut * kChunks; i += kThreads) {
      const int r = i / kChunks, q = i % kChunks;
      const int t = un.t0 + r, l = un.l0 + q * V;
      if (t >= a.To || l >= a.D) continue;
      const uint4 val = ost[r][q ^ swz_out(r)];
      T* dst = out + (size_t)t * a.D + l;
      if (a.aligned) {
        *reinterpret_cast<uint4*>(dst) = val;
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (l + v >= a.D) break;
          const uint32_t bits = lane_bits<kBf16>(val, v);
          if constexpr (kBf16)
            dst[v] = __ushort_as_bfloat16((unsigned short)(bits >> 16));
          else
            dst[v] = __uint_as_float(bits);
        }
      }
    }
    __syncthreads();     // the staging tile and this stage are free again
  }
  cp_async_wait<0>();
}

}  // namespace

// Plain C entry of K2's per-lane path, loaded with ctypes. `blocks` is the
// persistent grid (core/engine.py::mxu_perlane_layout).
extern "C" int ssam_mxu_perlane_launch(
    const void* x, void* out, int io_bf16, const float* w, const int* cid,
    int N, const float* bias, const void* resid, const int* epi_ops,
    const float* epi_vals, int n_epi, int batch, int T, int D, int To,
    int lead, int blocks, void* stream) {
  const int V = io_bf16 ? 8 : 4;
  if (N < 1 || N > kMaxRows || n_epi < 0 || n_epi > ssam::kMaxEpi ||
      batch < 1 || T < 1 || D < 1 || To < 1 || lead < 0 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  MxuPerlaneArgs a;
  a.x = x;
  a.out = out;
  a.w = w;
  a.bias = bias;
  a.resid = resid;
  for (int r = 0; r < kMaxRows; ++r) a.cid[r] = r < N ? cid[r] : -1;
  for (int s = 0; s < ssam::kMaxEpi; ++s) {
    a.epi_op[s] = s < n_epi ? epi_ops[s] : 0;
    a.epi_val[s] = s < n_epi ? epi_vals[s] : 0.f;
    if ((a.epi_op[s] == 1 && bias == nullptr) ||
        (a.epi_op[s] == 6 && resid == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  a.n_epi = n_epi;
  a.T = T;
  a.D = D;
  a.To = To;
  a.lead = lead;
  a.N = N;
  auto al16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  a.aligned = D % V == 0 && al16(x) && al16(out) && al16(w) &&
              (bias == nullptr || al16(bias)) &&
              (resid == nullptr || al16(resid));
  const long long lanes = kChunks * V;
  a.gx = (int)((D + lanes - 1) / lanes);
  a.gy = (To + kOut - 1) / kOut;
  const long long units = (long long)a.gx * a.gy * batch;
  if (units > 0x7fffffff) return (int)cudaErrorInvalidValue;
  a.units = (int)units;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = blocks < a.units ? blocks : a.units;
  cudaError_t e;
  if (io_bf16) {
    e = cudaFuncSetAttribute(mxu_perlane_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<true>());
    if (e != cudaSuccess) return (int)e;
    mxu_perlane_kernel<true><<<grid, kThreads, smem_bytes<true>(), s>>>(a);
  } else {
    e = cudaFuncSetAttribute(mxu_perlane_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<false>());
    if (e != cudaSuccess) return (int)e;
    mxu_perlane_kernel<false><<<grid, kThreads, smem_bytes<false>(), s>>>(a);
  }
  return (int)cudaGetLastError();
}
