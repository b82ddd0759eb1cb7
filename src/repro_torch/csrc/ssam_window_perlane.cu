// K1 on Hopper, per-lane path: depthwise (per-lane coefficient) windowed
// plans, i.e. the depthwise causal conv1d of Mamba blocks and its input
// adjoint, with a per-lane bias and an activation fused.
//
// Replaces src/repro/core/engine.py::_window_kernel for plans with
// coeff_mode 'perlane' (depthwise_conv1d_plan and its input adjoint): the
// per-lane coefficient rows of _coeff (w[coeff_id, lane]) and the per-lane
// bias of _apply_epilogue_val, applied at the flush.
//
//   out[b, t, d] = epi( sum_r x[b, t + r - lead, d] * w[cid[r], d] )
//
// over the footprint rows r that carry a tap (cid[r] >= 0), with zeros
// where the read leaves [0, T) (the plan's lead/trail padding is never
// materialised). The forward plan has lead K-1 and cid[r] = r; its input
// adjoint has lead 0 (trail K-1) and the reflected cid[r] = K-1-r, so the
// kernel reads w through cid, never through the row index.
//
// Bound on an H100: bytes. Each output costs 2N FLOPs against 8 bytes of
// fp32 I/O, far below the card's operations-per-byte line; at Hymba's
// (2, 2048, 3200) the input and output are 104.9 MB, 0.031 ms at 3.35 TB/s.
//
// Design (the paper's "vertical" direction, section 5.4: the taps walk
// time, the cheap in-thread direction, and M = 1 needs no shuffles):
//  * Each thread owns 16 bytes of channels (4 fp32 or 8 bf16) of one
//    sequence and streams down 32 output rows; 128 threads a block, so a
//    time row of a block is 2 KB, read and written with 16-byte accesses.
//    Paired runs on the card: 32-row tiles (896 blocks at Hymba's shape,
//    about 7 an SM) ran 3-4 % faster than 64-row ones, 16 rows in flight
//    a thread 2-7 % slower than 8.
//  * Rows arrive through a cp.async ring of kStages rows per thread in
//    shared memory: each thread copies its own 16 bytes of a row ahead
//    (cp.async.cg, one commit group per row) and reads them back when the
//    row is due, so 8 rows (128 bytes) a thread are in flight without
//    registers. No thread reads another's slot: no block barrier.
//  * The window of the last NM input rows stays in registers (NM = 4 for
//    filters of up to 4 taps, else 8); footprint slots below NM - N have
//    zero weights and rows that are never loaded, so the sum runs over the
//    taps in row order, in fp32, for fp32 and bf16 I/O.
//  * The epilogue chain is fixed per launch: template instances for the
//    chains the port and its tests launch (none; bias + SiLU; ReLU; bias +
//    GELU + scale) with the per-lane bias held in registers, and a generic
//    instance that walks any other chain at run time (a residual, read at
//    the output's position, among them).
//  * D that is not a multiple of 4 (fp32) or 8 (bf16), or an operand not
//    16-byte aligned, leaves rows unaligned for 16-byte copies: such a
//    launch loads and stores element by element, masked at D.
// The design before this one (PR 15) held one channel a thread with 4-byte
// loads and stores, 4 rows in flight, and applied the epilogue through a
// runtime loop with the bias loaded per output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ssam_epilogue.cuh"

namespace {

constexpr int kThreads = 128;  // threads per block, 16 bytes of channels each
constexpr int kRows = 32;      // output rows per block
constexpr int kMaxRows = 8;    // footprint rows (filter taps)
constexpr int kStages = 8;     // rows in flight per thread

struct PerlaneArgs {
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
};

// One fixed epilogue step; the bias is the lane's own, from registers.
// SiLU takes the hardware exponential and the approximate division (a few
// ulp from expf and the division; exp(-v) = inf gives 0): paired runs on
// the card put the exact forms' cost at 6-8 % of the forward's time.
template <int Op>
__device__ __forceinline__ float epi_step(float v, float bias, float val) {
  if constexpr (Op == 1)
    return v + bias;
  else if constexpr (Op == 3)
    return __fdividef(v, 1.f + __expf(-v));
  else
    return ssam::apply_epilogue_op(Op, val, nullptr, v, 0);
}

template <int... Ops>
struct Epi {
  static constexpr bool kBias = ((Ops == 1) || ... || false);
  template <int V>
  __device__ static void apply(float (&o)[V], const float (&bias)[V],
                               const PerlaneArgs& a, int, int, size_t) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      int k = 0;
      ((o[v] = epi_step<Ops>(o[v], bias[v], a.epi_val[k++])), ...);
      (void)k;
    }
  }
};

// Any other chain, walked at run time: one (uniform) dispatch a step, each
// step over the thread's channels, the bias and the residual (op 6, at the
// output's position `at`) read per output.
struct EpiGeneric {
  static constexpr bool kBias = false;
  template <int Op, int V>
  __device__ static void each(float (&o)[V], float val) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      o[v] = ssam::apply_epilogue_op(Op, val, nullptr, o[v], 0);
  }
  template <int V>
  __device__ static void apply(float (&o)[V], const float (&)[V],
                               const PerlaneArgs& a, int d0, int nv,
                               size_t at) {
    for (int s = 0; s < a.n_epi; ++s) {
      const float val = a.epi_val[s];
      switch (a.epi_op[s]) {
        case 1:
#pragma unroll
          for (int v = 0; v < V; ++v)
            if (v < nv) o[v] += a.bias[d0 + v];
          break;
        case 2: each<2>(o, val); break;
        case 3: each<3>(o, val); break;
        case 4: each<4>(o, val); break;
        case 5: each<5>(o, val); break;
        case 6:
#pragma unroll
          for (int v = 0; v < V; ++v)
            if (v < nv) o[v] += ssam::load_residual(a.resid, V == 8, at + v);
          break;
      }
    }
  }
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
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

template <int V>
using Elem = typename std::conditional<V == 8, __nv_bfloat16, float>::type;

template <int V>
__device__ __forceinline__ float widen(Elem<V> v) {
  if constexpr (V == 8)
    return __bfloat162float(v);
  else
    return v;
}

template <int V>
__device__ __forceinline__ Elem<V> narrow(float v) {
  if constexpr (V == 8)
    return __float2bfloat16(v);
  else
    return v;
}

// 16 bytes of a row (V elements) widened to fp32, and back.
template <int V>
__device__ __forceinline__ void unpack16(const uint4 raw, float (&f)[V]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (V == 8) {  // bf16 pairs: the low half is the first
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      f[i] = __uint_as_float(w[i]);
    }
  }
}

template <int V>
__device__ __forceinline__ uint4 pack16(const float (&f)[V]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (V == 8)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1]))
              << 16);
    else
      w[i] = __float_as_uint(f[i]);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// NM: window rows in registers (>= N); V: channels a thread (16 bytes).
template <int NM, int V, class E>
__global__ void __launch_bounds__(kThreads)
    window_perlane_kernel(const __grid_constant__ PerlaneArgs a) {
  using T = Elem<V>;
  __shared__ __align__(16) T ring[kStages][kThreads][V];
  const int d0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (d0 >= a.D) return;
  const int nv = min(V, a.D - d0);
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kRows;
  const int t1 = min(t0 + kRows, a.To);
  const T* x = static_cast<const T*>(a.x) + (size_t)b * a.T * a.D + d0;
  T* out = static_cast<T*>(a.out) + (size_t)b * a.To * a.D + d0;
  const bool vec = a.aligned;

  // window slot j holds input row t - lead + j - (NM - N) of output row t
  const int skip = NM - a.N;
  float wr[NM][V];
#pragma unroll
  for (int j = 0; j < NM; ++j) {
    const int r = j - skip;
    const int c = r >= 0 ? a.cid[r] : -1;
#pragma unroll
    for (int v = 0; v < V; ++v)
      wr[j][v] = (c >= 0 && v < nv) ? a.w[(size_t)c * a.D + d0 + v] : 0.f;
  }
  float bias[V];
#pragma unroll
  for (int v = 0; v < V; ++v)
    bias[v] = (E::kBias && v < nv) ? a.bias[d0 + v] : 0.f;

  // stream row i is input row r0 + i; output row t0 + i - (NM - 1) follows
  // it. Rows of the zero-weight slots are never loaded.
  const int r0 = t0 - a.lead - skip;
  const int total = (t1 - t0) + NM - 1;
  auto issue = [&](int i) {
    T* slot = ring[i % kStages][threadIdx.x];
    const int row = r0 + i;
    if (i >= total || i < skip || row < 0 || row >= a.T) {
#pragma unroll
      for (int v = 0; v < V; ++v) slot[v] = narrow<V>(0.f);
    } else if (vec) {
      cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(slot)),
                 x + (size_t)row * a.D);
    } else {
      const T* src = x + (size_t)row * a.D;
#pragma unroll
      for (int v = 0; v < V; ++v) slot[v] = v < nv ? src[v] : narrow<V>(0.f);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages; ++i) issue(i);

  float c[NM][V];
#pragma unroll
  for (int j = 0; j < NM; ++j)
#pragma unroll
    for (int v = 0; v < V; ++v) c[j][v] = 0.f;
  for (int i = 0; i < total; ++i) {
    cp_async_wait<kStages - 1>();  // row i has landed
    const T* slot = ring[i % kStages][threadIdx.x];
#pragma unroll
    for (int j = 0; j + 1 < NM; ++j)
#pragma unroll
      for (int v = 0; v < V; ++v) c[j][v] = c[j + 1][v];
    if (vec) {
      unpack16<V>(*reinterpret_cast<const uint4*>(slot), c[NM - 1]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) c[NM - 1][v] = widen<V>(slot[v]);
    }
    issue(i + kStages);  // the slot is read (c holds it): refill it
    const int t = t0 + i - (NM - 1);
    if (t < t0) continue;
    float o[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NM; ++j) s = fmaf(c[j][v], wr[j][v], s);
      o[v] = s;
    }
    E::apply(o, bias, a, d0, nv, ((size_t)b * a.To + t) * a.D + d0);
    T* orow = out + (size_t)t * a.D;
    if (vec) {
      *reinterpret_cast<uint4*>(orow) = pack16<V>(o);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (v < nv) orow[v] = narrow<V>(o[v]);
    }
  }
  cp_async_wait<0>();
}

using PerlaneFn = decltype(&window_perlane_kernel<4, 4, Epi<>>);

template <int NM, int V>
PerlaneFn pick_chain(const PerlaneArgs& a) {
  const int* op = a.epi_op;
  switch (a.n_epi) {
    case 0:
      return window_perlane_kernel<NM, V, Epi<>>;
    case 1:
      if (op[0] == 4) return window_perlane_kernel<NM, V, Epi<4>>;
      break;
    case 2:
      if (op[0] == 1 && op[1] == 3)
        return window_perlane_kernel<NM, V, Epi<1, 3>>;
      break;
    case 3:
      if (op[0] == 1 && op[1] == 2 && op[2] == 5)
        return window_perlane_kernel<NM, V, Epi<1, 2, 5>>;
      break;
  }
  return window_perlane_kernel<NM, V, EpiGeneric>;
}

PerlaneFn pick(const PerlaneArgs& a, int io_bf16) {
  if (a.N <= 4)
    return io_bf16 ? pick_chain<4, 8>(a) : pick_chain<4, 4>(a);
  return io_bf16 ? pick_chain<8, 8>(a) : pick_chain<8, 4>(a);
}

}  // namespace

// Plain C entry of K1's per-lane path, loaded with ctypes.
extern "C" int ssam_window_perlane_launch(
    const void* x, void* out, int io_bf16, const float* w, const int* cid,
    int N, const float* bias, const void* resid, const int* epi_ops,
    const float* epi_vals, int n_epi, int batch, int T, int D, int To, int lead, void* stream) {
  const int V = io_bf16 ? 8 : 4;
  if (N < 1 || N > kMaxRows || n_epi < 0 || n_epi > ssam::kMaxEpi ||
      batch < 1 || T < 1 || D < 1 || To < 1 || lead < 0 || batch > 65535 ||
      (To + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  PerlaneArgs a;
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
  a.aligned = D % V == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
              (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  PerlaneFn fn = pick(a, io_bf16);
  const int lanes = (D + V - 1) / V;
  dim3 grid((lanes + kThreads - 1) / kThreads, (To + kRows - 1) / kRows,
            batch);
  fn<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
