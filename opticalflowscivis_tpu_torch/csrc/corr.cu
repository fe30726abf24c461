// Local cost volume (PWC / UPFlow correlation), forward and backward, for
// Hopper (sm_90a).
//
// Replaces opticalflowscivis_tpu/ops/pallas/correlation.py::cost_volume_pallas
// (_forward / _corr_kernel).  The TPU package has no backward kernel: its VJP
// (_forward_bwd) is 81 jnp passes with a scatter-add.  Here both directions
// are kernels, as in the original correlation_cuda extension.
//
//   out[b, k, y, x] = (1/C) sum_c f1[b, c, y, x] * f2[b, c, y+dy-md, x+dx-md]
//   k = dy * (2 md + 1) + dx,  dy, dx in [0, 2 md],  f2 = 0 outside the plane
//
//   df1[b, c, y, x] = (1/C) sum_k g[b, k, y, x] * f2[b, c, y+dy-md, x+dx-md]
//   df2[b, c, y, x] = (1/C) sum_k g[b, k, p] * f1[b, c, p],
//                     p = (y-dy+md, x-dx+md), terms with p outside dropped
//   Both gradients are gathers: no atomics, and a run repeats bit for bit.
//
// Bound.  Bytes: f1 and f2 read once, (2 md + 1)^2 channels written; at the
// finest UPFlow level ([16, 32, 64, 208], md 4) the output (81 channels) is
// 1.3 times the inputs (2 x 32), so the forward is bound by its own write.  Operations: 2 C (2md+1)^2
// per pixel, which at md 4 is within a factor of three of the byte time at the
// f32 rate outside the tensor cores, so shared-memory traffic per multiply
// matters too.  The backward reads f1, f2 and g and writes two tensors of the
// inputs' size, with twice the forward's operations.
//
// Forward (md 1..4).  One launch covers the batch.  A block owns a tile of
// TH rows x 32 columns of one sample and 3 of the 2 md + 1 row offsets dy
// (blockIdx.z = sample x dy group), so a tile's f1 and window are read 3 times
// at md 4, from L2.  Its 128 threads each own 4 consecutive x of one row, the
// block's 3 dy and all 2 md + 1 dx: 108 f32 sums at md 4.  Per channel a
// thread reads 4 f1 values and 3 window rows of 12 values from shared memory,
// 4 elements a read (10 reads for 108 multiply-adds); a quarter warp reads
// one row, so no bank
// conflicts in f32.  Channels are staged in a ring of 3 stages by cp.async
// (zero-filled outside the plane and beyond C), so 2 stages load while one is
// summed, with no registers held for the loads; shared memory keeps the
// inputs' type (bf16 halves its bytes and widens by a shift when read).  At md
// 4 NCHW rows of a multiple of 4 elements (UPFlow's W = 52, 104, 208) are
// copied 16 or 8 bytes a copy; other layouts one element a copy (bf16 by
// loads and stores: cp.async has no 2-byte copy).  Outputs leave as 16- or
// 8-byte streaming stores where W is a multiple of 4.  Tiles are 16 rows
// (one channel group), or 1 row where 16-row tiles would leave more than
// half of the 132 SMs without a block (UPFlow's two coarsest levels): the 128
// threads are then 16 channel groups of one row, whose sums are added in
// shared memory in group order.  No atomics: two runs agree bit for bit.
//   Registers are capped for 3 blocks per SM with 16-row tiles (168) and for
// 2 with 1-row tiles, whose 16 groups' epilogue needs more; shared memory is
// dynamic, at most 59 KB a block, so copies, sums and other blocks' stores
// overlap.  Staging decodes each slot's place once a stage (stage_part):
// decoding it per copy cost more than the sums on small planes.

// Backward (md 1..4).  Both gradients have one form.  With e = (ey, ex) in
// [0, 2 md]^2 and the window W = f2 (df1) or f1 (df2),
//   d[c, y, x] = (1/C) sum_e a[e, y, x] * W[c, y+ey-md, x+ex-md],
//   a[e, y, x] = g[e, y, x]                          for df1,
//   a[e, y, x] = g[D-1-e, y+ey-md, x+ex-md] (0 out)  for df2,  D = (2md+1)^2
// (df2's sum over k, rewritten with e = 2 md - d).  So df1 and df2 are two
// compile-time instances of one tile function that differ only in what they
// stage; blockIdx.z picks the sample, the gradient and a slab of 32 channels,
// so asking for both gradients is still one launch.
//   A block owns 8 rows x 16 columns of pixels and a slab of 32 channels; its
//   128 threads each own 4 consecutive x of one row and 8 channels (c = group
//   + 4 j), with 32 f32 sums in registers.  Per ey a thread loads its
//   4 x (2md+1) coefficients a[ey, ex] once (36 at md 4, as float4) and, per
//   channel, one window row of 4 + 2md values (three float4 at md 4) for 36
//   multiply-adds: about 1.8 bytes of shared traffic per multiply-add,
//   against 4 for a scalar load per multiply-add.  The inner
//   loop has no bounds test and 32-bit shared offsets only.  The channel
//   stride of the window is 16 words off a multiple of 32 banks and the two
//   channel groups of a quarter-warp read neighbouring channels, so the
//   float4 window loads have no bank conflict; the coefficient loads are
//   broadcast to both groups.
//   Staging is the other half of the time.  The window's first 8 rows are
//   staged before the sums, zero outside the plane; each ey's coefficient
//   planes (df2's shift and bounds tests applied here) and the window row
//   the next ey first reaches are loaded during the ey's sums and stored
//   after them, double-buffered, one barrier per ey.  These loads are
//   volatile PTX, predicated, so that the compiler cannot sink them below
//   the sums, and keep raw bits until they are stored (bf16 widens then, by a
//   shift).  At md 4, the only md the model uses, unit-stride rows of a
//   multiple of 4 elements (its NCHW maps at W = 52, 104, 208) take an
//   instance that reads 4 elements a load (16 or 8 bytes): one element a load
//   keeps too few bytes in flight (bf16 then runs slower than f32).  Shared memory is dynamic (60 KB at md 4),
//   and registers are capped at 168: three blocks per SM.  The 16-column tile
//   leaves few lanes idle at UPFlow's widths 13 to 208.
// Other md have no kernel: the entries return cudaErrorInvalidValue and the
// wrapper refuses them before the launch.  Every configuration of the package
// uses md <= 4.
//
// All tensors are channels-first.  f1, f2 and g are read through their four
// strides, so channels-last tensors from cuDNN and autograd's views need no
// copy (they are read uncoalesced, not wrongly); out, df1 and df2 are written
// contiguous.  f32 accumulation; f32 or bf16 in and out.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError() after
// the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_MD = 4;  // the kernels are instantiated for md 1..MAX_MD

// Backward geometry; ops/kernels/correlation.py::backward_launch mirrors it.
constexpr int BTH = 8;    // tile rows
constexpr int BTW = 16;   // tile columns
constexpr int BPX = 4;    // consecutive x per thread
constexpr int BCB = 8;    // channels per thread
constexpr int BNG = 4;    // channel groups per block
constexpr int BSLAB = BCB * BNG;                    // channels per block
constexpr int BTHREADS = BTH * (BTW / BPX) * BNG;   // 128
constexpr int SMEM_LIMIT = 232448;  // shared memory one block may hold (227 KB)
static_assert(BTHREADS == BTH * BTW, "each thread stages one coefficient column");
static_assert(BTW / BPX == 4 && BNG == 4, "corr_bwd_tile decodes threadIdx in 2-bit fields");
constexpr int STAGE = 16;       // element path: window loads in flight per thread
constexpr int MIN_BLOCKS = 3;   // blocks an SM holds at md 4 (shared memory): <= 168 registers

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Strides {
  int64_t b, c, h, w;
};

// The backward's loads, as volatile PTX: issued where they stand (the
// compiler would otherwise sink a prefetch below the sums it should overlap),
// predicated on `ok` and 0 where it is false.  They keep the raw bits (bf16
// in half words) until `widen` turns them into f32 at the store to shared
// memory; bf16 widens by a shift of its bits, exactly.
__device__ __forceinline__ uint32_t ldg_raw(const float* p, bool ok) {
  uint32_t v;
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %2, 0; mov.b32 %0, 0;\n"
      "  @q ld.global.nc.b32 %0, [%1]; }"
      : "=r"(v) : "l"(p), "r"((int)ok));
  return v;
}
__device__ __forceinline__ uint32_t ldg_raw(const __nv_bfloat16* p, bool ok) {
  unsigned short v;
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %2, 0; mov.b16 %0, 0;\n"
      "  @q ld.global.nc.b16 %0, [%1]; }"
      : "=h"(v) : "l"(p), "r"((int)ok));
  return v;
}
template <typename T>
__device__ __forceinline__ float widen(uint32_t raw) {
  return __uint_as_float(sizeof(T) == 2 ? raw << 16 : raw);
}
// Four consecutive elements at a 4-element-aligned address in one 16-byte
// (f32) or 8-byte (bf16) load, into RAW4<T> words of `r`.
template <typename T>
constexpr int RAW4 = 2 * (int)sizeof(T);
__device__ __forceinline__ void ldg_raw4(const float* p, bool ok, uint32_t* r) {
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %5, 0;\n"
      "  mov.b32 %0, 0; mov.b32 %1, 0; mov.b32 %2, 0; mov.b32 %3, 0;\n"
      "  @q ld.global.nc.v4.b32 {%0, %1, %2, %3}, [%4]; }"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "l"(p), "r"((int)ok));
}
__device__ __forceinline__ void ldg_raw4(const __nv_bfloat16* p, bool ok, uint32_t* r) {
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %3, 0; mov.b32 %0, 0; mov.b32 %1, 0;\n"
      "  @q ld.global.nc.v2.b32 {%0, %1}, [%2]; }"
      : "=r"(r[0]), "=r"(r[1]) : "l"(p), "r"((int)ok));
}
template <typename T>
__device__ __forceinline__ float4 widen4(const uint32_t* r) {
  if constexpr (sizeof(T) == 2)
    return make_float4(__uint_as_float(r[0] << 16), __uint_as_float(r[0] & 0xffff0000u),
                       __uint_as_float(r[1] << 16), __uint_as_float(r[1] & 0xffff0000u));
  else
    return make_float4(__uint_as_float(r[0]), __uint_as_float(r[1]), __uint_as_float(r[2]),
                       __uint_as_float(r[3]));
}
// Whether every sample's rows of a tensor can be read 4 elements a load from
// 4-aligned columns (host side: picks the kernel instance).
bool rows_of_4(const void* base, Strides s, int64_t W, int elem) {
  return s.w == 1 && W % 4 == 0 && s.h % 4 == 0 && s.c % 4 == 0 && s.b % 4 == 0 &&
         reinterpret_cast<uintptr_t>(base) % (4 * elem) == 0;
}

// four consecutive values at a 4-element-aligned address: one 16- or 8-byte store
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c,
                                       float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

// Forward geometry; ops/kernels/correlation.py::forward_launch mirrors it.
constexpr int FTW = 32;                // tile columns
constexpr int FXT = FTW / 4;           // threads across a tile row, 4 x each
constexpr int FNDY = 3;                // row offsets dy per block (and per thread)
constexpr int FTHREADS = 128;
constexpr int FSTAGES = 3;             // channel stages in the cp.async ring
constexpr int FWANT_BLOCKS = 132 / 2;  // 16-row tiles busy at least half the SMs
constexpr int FMIN_BLOCKS_1ROW = 2;    // 1-row tiles: registers for 2 blocks an SM

// A block owns TH rows x FTW columns of one sample and FNDY row offsets; its
// FTHREADS threads are K = FTHREADS / (FXT TH) channel groups of FXT x TH.
// TH 16: one group; TH 1 (small planes): 16 groups, added in shared memory.
template <int TH>
struct FwdTile {
  static_assert(TH == 16 || TH == 1, "forward tiles are 16 rows or 1");
  static constexpr int K = FTHREADS / (FXT * TH);  // channel groups
  static constexpr int CS = TH == 16 ? 4 : 32;     // channels per stage
  static constexpr int CPG = CS / K;               // channels per group and stage
  static constexpr int WR = TH + FNDY - 1;         // window rows
};
template <int MD>
struct FwdWin {
  static constexpr int ND = 2 * MD + 1;
  static constexpr int G = (ND + FNDY - 1) / FNDY;  // dy groups (blocks per tile)
  static constexpr int NV = (4 + 2 * MD + 3) / 4;   // 4-element window reads per row
  static constexpr int WW = FTW + 2 * MD;           // window columns staged
  static constexpr int WW4 = FTW - 4 + 4 * NV;      // window row stride (elements)
};
// one channel of a stage: f1's TH rows of FTW, then the window's WR rows of WW4
template <int MD, int TH>
struct FwdChannel {
  static constexpr int ELEMS = TH * FTW + FwdTile<TH>::WR * FwdWin<MD>::WW4;
};
template <int MD, int TH>
constexpr int fwd_smem_bytes_of(int elem) {
  const int ring = FSTAGES * FwdTile<TH>::CS * FwdChannel<MD, TH>::ELEMS * elem;
  const int scratch = FwdTile<TH>::K > 1 ? FTHREADS * FNDY * FwdWin<MD>::ND * 16 : 0;
  return ring > scratch ? ring : scratch;
}
int fwd_smem_bytes(int md, int th, int elem) {
  const bool rows16 = th == 16;
  switch (md) {
    case 1: return rows16 ? fwd_smem_bytes_of<1, 16>(elem) : fwd_smem_bytes_of<1, 1>(elem);
    case 2: return rows16 ? fwd_smem_bytes_of<2, 16>(elem) : fwd_smem_bytes_of<2, 1>(elem);
    case 3: return rows16 ? fwd_smem_bytes_of<3, 16>(elem) : fwd_smem_bytes_of<3, 1>(elem);
    default: return rows16 ? fwd_smem_bytes_of<4, 16>(elem) : fwd_smem_bytes_of<4, 1>(elem);
  }
}

// cp.async of N bytes (4, 8 or 16) into shared memory, zero-filled where !ok
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(N), "r"(ok ? N : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// four consecutive staged elements (4-aligned) as f32
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const uint32_t r[2] = {v.x, v.y};
  return widen4<__nv_bfloat16>(r);
}

// four consecutive outputs at a 4-aligned address, streamed (evict first)
__device__ __forceinline__ void store4_cs(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}
__device__ __forceinline__ void store4_cs(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  __stcs(reinterpret_cast<uint2*>(p), u);
}

// Lanes that copy one channel's NPC pieces: all threads, or a power of 2
// covering them (so several channels are copied in one pass).
__host__ __device__ constexpr int stage_lanes(int npc) {
  return npc >= FTHREADS ? FTHREADS : npc > 16 ? 32 : npc > 8 ? 16 : 8;
}

// Copy one part (f1's tile or the window) of CS channels into a stage.  A
// channel has NPC pieces of PIECE elements (4: a 4-aligned chunk of a row, one
// 16- or 8-byte cp.async; 1: one element); `where(i, at, in, off)` gives piece
// i's shared offset inside a channel, whether it lies in the plane, and its
// source offset from the channel's start.  A thread copies the pieces at a
// fixed place of the tile (E slots) for every CP-th channel from its first:
// the place is decoded once per slot and stage, the channel added per copy.
// bf16 single elements (cp.async has no 2-byte copy) are loaded, then stored.
template <typename T, int PIECE, int NPC, int CS, int PER_CH, typename Where>
__device__ __forceinline__ void stage_part(T* dst, const T* src, int64_t sc, int64_t c0,
                                           int64_t C, Where where) {
  constexpr int L = stage_lanes(NPC), E = (NPC + L - 1) / L, CP = FTHREADS / L;
  static_assert(CS % CP == 0, "whole passes of channels");
  const int lane = threadIdx.x % L, cc = threadIdx.x / L;
  // one slot at a time: unrolled, the slots' addresses would all be live
#pragma unroll 1
  for (int e = 0; e < E; ++e) {
    const int i = lane + e * L;
    if (NPC % L != 0 && i >= NPC) break;
    int at;
    bool in;
    int64_t off;
    where(i, at, in, off);
    if constexpr (PIECE == 4 || sizeof(T) == 4) {
#pragma unroll
      for (int k = 0; k < CS / CP; ++k) {
        const int c = cc + k * CP;
        cp_async<PIECE * (int)sizeof(T)>(dst + c * PER_CH + at, src + c * sc + off,
                                          in && c0 + c < C);
      }
    } else {
      constexpr int NB = 4;  // loads in flight
#pragma unroll
      for (int k0 = 0; k0 < CS / CP; k0 += NB) {
        uint32_t v[NB];
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          const int c = cc + (k0 + k) * CP;
          v[k] = k0 + k < CS / CP ? ldg_raw(src + c * sc + off, in && c0 + c < C) : 0u;
        }
#pragma unroll
        for (int k = 0; k < NB; ++k)
          if (k0 + k < CS / CP)
            dst[(cc + (k0 + k) * CP) * PER_CH + at] = __ushort_as_bfloat16((unsigned short)v[k]);
      }
    }
  }
}

// Stage FwdTile<TH>::CS channels from c0 into `dst`: f1's tile (rows y0..,
// columns x0..) and f2's window (rows wy0.., columns x0 - MD..), zero outside
// the plane and beyond C.  VEC (md 4, rows of a multiple of 4 elements):
// 4-element chunks, so a window row of 40 columns is 10 copies; otherwise one
// element a copy, through the strides.
template <typename T, int MD, bool VEC, int TH>
__device__ __forceinline__ void fwd_stage(T* dst, const T* f1b, const T* f2b, Strides s1,
                                          Strides s2, int64_t c0, int64_t C, int64_t H,
                                          int64_t W, int64_t y0, int64_t x0, int64_t wy0) {
  using Tl = FwdTile<TH>;
  using Wn = FwdWin<MD>;
  constexpr int PER_CH = FwdChannel<MD, TH>::ELEMS;
  constexpr int P = VEC ? 4 : 1;           // elements a copy
  constexpr int Q1 = FTW / P, Q2 = Wn::WW / P;  // copies of a row
  static_assert(!VEC || MD == 4, "the vector instance is built for md 4 only");
  const int64_t wx0 = x0 - MD;
  stage_part<T, P, TH * Q1, Tl::CS, PER_CH>(
      dst, f1b + c0 * s1.c, s1.c, c0, C, [&](int i, int& at, bool& in, int64_t& off) {
        const int q = i % Q1, r = i / Q1;
        const int64_t y = y0 + r, x = x0 + P * q;
        at = r * FTW + P * q;
        in = y < H && x < W;
        off = in ? y * s1.h + x * s1.w : 0;
      });
  stage_part<T, P, Tl::WR * Q2, Tl::CS, PER_CH>(
      dst, f2b + c0 * s2.c, s2.c, c0, C, [&](int i, int& at, bool& in, int64_t& off) {
        const int q = i % Q2, r = i / Q2;
        const int64_t y = wy0 + r, x = wx0 + P * q;
        at = TH * FTW + r * Wn::WW4 + P * q;
        in = y >= 0 && y < H && x >= 0 && x < W;
        off = in ? y * s2.h + x * s2.w : 0;
      });
}

// out[b, dy ND + dx, y, x] for a tile of TH x FTW pixels of sample b and the
// row offsets dy = d0 .. d0 + FNDY - 1 (those below ND).  A thread owns 4
// consecutive x of one row and sums, per channel of its group, FNDY x ND x 4
// products from one 4-element read of f1 and FNDY window rows of 4 + 2 MD
// values (three 4-element reads each at md 4): 108 multiply-adds for 10 reads.
template <typename T, int MD, bool VEC, int TH>
__global__ void __launch_bounds__(FTHREADS, TH == 16 ? MIN_BLOCKS : FMIN_BLOCKS_1ROW)
corr_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2, T* __restrict__ out,
                int64_t C, int64_t H, int64_t W, Strides s1, Strides s2, float inv_c) {
  using Tl = FwdTile<TH>;
  using Wn = FwdWin<MD>;
  constexpr int ND = Wn::ND, NV = Wn::NV;
  constexpr int PER_CH = FwdChannel<MD, TH>::ELEMS;
  constexpr int STAGE_ELEMS = Tl::CS * PER_CH;
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);

  const int tid = threadIdx.x;
  const int xg = tid % FXT, ty = (tid / FXT) % TH, kg = tid / (FXT * TH);
  const int64_t z = blockIdx.z;
  const int64_t b = z / Wn::G;
  const int d0 = (int)(z % Wn::G) * FNDY;
  const int64_t y0 = (int64_t)blockIdx.y * TH, x0 = (int64_t)blockIdx.x * FTW;
  const int64_t wy0 = y0 + d0 - MD;
  const T* f1b = f1 + b * s1.b;
  const T* f2b = f2 + b * s2.b;

  float4 acc[FNDY][ND];
#pragma unroll
  for (int j = 0; j < FNDY; ++j)
#pragma unroll
    for (int dx = 0; dx < ND; ++dx) acc[j][dx] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int nst = (int)((C + Tl::CS - 1) / Tl::CS);
#pragma unroll
  for (int s = 0; s < FSTAGES - 1; ++s) {
    if (s < nst)
      fwd_stage<T, MD, VEC, TH>(ring + s * STAGE_ELEMS, f1b, f2b, s1, s2, (int64_t)s * Tl::CS,
                                C, H, W, y0, x0, wy0);
    cp_async_commit();
  }
#pragma unroll 1
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<FSTAGES - 2>();  // this thread's copies of stage st have landed
    __syncthreads();               // everyone's have, and stage st - 1 is summed
    const int nx = st + FSTAGES - 1;
    if (nx < nst)
      fwd_stage<T, MD, VEC, TH>(ring + (nx % FSTAGES) * STAGE_ELEMS, f1b, f2b, s1, s2,
                                (int64_t)nx * Tl::CS, C, H, W, y0, x0, wy0);
    cp_async_commit();
    const T* sb = ring + (st % FSTAGES) * STAGE_ELEMS + kg * Tl::CPG * PER_CH;
#pragma unroll
    for (int i = 0; i < Tl::CPG; ++i) {
      const T* ch = sb + i * PER_CH;
      const float4 a = lds4(ch + ty * FTW + 4 * xg);
#pragma unroll
      for (int j = 0; j < FNDY; ++j) {
        if (ND % FNDY != 0 && d0 + j >= ND) break;
        const T* wr = ch + TH * FTW + (ty + j) * Wn::WW4 + 4 * xg;
        float w[4 * NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float4 q = lds4(wr + 4 * v);
          w[4 * v] = q.x;
          w[4 * v + 1] = q.y;
          w[4 * v + 2] = q.z;
          w[4 * v + 3] = q.w;
        }
#pragma unroll
        for (int dx = 0; dx < ND; ++dx) {
          acc[j][dx].x = fmaf(a.x, w[dx], acc[j][dx].x);
          acc[j][dx].y = fmaf(a.y, w[dx + 1], acc[j][dx].y);
          acc[j][dx].z = fmaf(a.z, w[dx + 2], acc[j][dx].z);
          acc[j][dx].w = fmaf(a.w, w[dx + 3], acc[j][dx].w);
        }
      }
    }
  }

  // out of pixel group p (row p / FXT, x group p % FXT) at offset (d0 + j, dx)
  const int64_t plane = H * W;
  T* ob = out + b * (ND * ND) * plane;
  auto put = [&](int p, int j, int dx, float4 v) {
    const int64_t y = y0 + p / FXT, x = x0 + 4 * (p % FXT);
    if (y >= H || x >= W) return;
    T* o = ob + ((d0 + j) * ND + dx) * plane + y * W + x;
    v.x *= inv_c;
    v.y *= inv_c;
    v.z *= inv_c;
    v.w *= inv_c;
    if (W % 4 == 0) {  // x is 4-aligned and x + 3 < W
      store4_cs(o, v);
    } else {
      store(o, v.x);
      if (x + 1 < W) store(o + 1, v.y);
      if (x + 2 < W) store(o + 2, v.z);
      if (x + 3 < W) store(o + 3, v.w);
    }
  };
  if constexpr (Tl::K == 1) {
#pragma unroll
    for (int j = 0; j < FNDY; ++j) {
      if (ND % FNDY != 0 && d0 + j >= ND) break;
#pragma unroll
      for (int dx = 0; dx < ND; ++dx) put(tid, j, dx, acc[j][dx]);
    }
  } else {
    // the K groups' sums added in group order (no atomics): every thread
    // parks its sums, then one thread adds up each output vector
    cp_async_wait<0>();
    __syncthreads();  // the ring is free
    float4* sc = smem4;
#pragma unroll
    for (int j = 0; j < FNDY; ++j)
#pragma unroll
      for (int dx = 0; dx < ND; ++dx) sc[(j * ND + dx) * FTHREADS + tid] = acc[j][dx];
    __syncthreads();
    constexpr int P = FXT * TH;  // pixel groups of a block
    constexpr int NOUT = P * FNDY * ND;
#pragma unroll 1
    for (int i = tid; i < NOUT; i += FTHREADS) {
      const int p = i % P, jd = i / P, j = jd / ND, dx = jd % ND;
      if (ND % FNDY != 0 && d0 + j >= ND) continue;
      const float4* src = sc + jd * FTHREADS + p;
      float4 v = src[0];
#pragma unroll
      for (int k = 1; k < Tl::K; ++k) {
        const float4 u = src[k * P];
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      put(p, j, dx, v);
    }
  }
}

// The forward's launch: grid (x tiles, row tiles, B x dy groups), FTHREADS
// threads, *smem bytes of dynamic shared memory for elements of `elem` bytes,
// and *th rows a tile: 16, or 1 where 16-row tiles would give fewer than
// FWANT_BLOCKS blocks.  False for a shape or md the kernel does not take.
bool fwd_geometry(int64_t B, int64_t C, int64_t H, int64_t W, int md, int elem, dim3* grid,
                  int* th, int* smem) {
  if (md < 1 || md > MAX_MD || B < 1 || C < 1 || H < 1 || W < 1) return false;
  const int64_t groups = (2 * md + 1 + FNDY - 1) / FNDY;
  const int64_t gx = (W + FTW - 1) / FTW, gz = B * groups;
  *th = gx * ((H + 15) / 16) * gz >= FWANT_BLOCKS ? 16 : 1;
  const int64_t gy = (H + *th - 1) / *th;
  if (gx > 2147483647 || gy > 65535 || gz > 65535) return false;
  *grid = dim3((unsigned)gx, (unsigned)gy, (unsigned)gz);
  *smem = fwd_smem_bytes(md, *th, elem);
  return true;
}

// Shared-memory layout of the backward at one md, in floats: the window of
// BSLAB channels (rows of WW4, channels CS apart), then two coefficient
// buffers of ND planes x BTH x BTW.
template <int MD>
struct BwdSmem {
  static constexpr int ND = 2 * MD + 1;
  static constexpr int WH = BTH + 2 * MD;          // window rows
  static constexpr int WW = BTW + 2 * MD;          // window columns staged
  static constexpr int WW4 = (WW + 3) / 4 * 4;     // row stride, float4-aligned
  // channel stride: 16 words off a multiple of the 32 banks
  static constexpr int CS = WH * WW4 + (16 - (WH * WW4) % 32 + 32) % 32;
  static constexpr int NV = (BPX + 2 * MD + 3) / 4;  // float4 loads per window row
  static constexpr int COEF = ND * BTH * BTW;      // one ey's coefficient planes
  static constexpr int BYTES = (BSLAB * CS + 2 * COEF) * (int)sizeof(float);
  static_assert(BYTES <= SMEM_LIMIT, "backward window exceeds shared memory");
};

int bwd_smem_bytes(int md) {
  switch (md) {
    case 1: return BwdSmem<1>::BYTES;
    case 2: return BwdSmem<2>::BYTES;
    case 3: return BwdSmem<3>::BYTES;
    default: return BwdSmem<4>::BYTES;
  }
}

// One block of one gradient: d[c0 + c, y0 + .., x0 + ..] for the slab's
// channels.  `wsrc` is the other feature map (f2 for df1, f1 for df2) and
// `gb` the incoming gradient, both at this sample; `dst` is the gradient's
// sample.
template <bool SECOND, int MD, bool VEC, typename T>
__device__ __forceinline__ void corr_bwd_tile(
    const T* __restrict__ wsrc, Strides sw, const T* __restrict__ gb, Strides sg,
    T* __restrict__ dst, int64_t C, int64_t H, int64_t W, int64_t c0,
    int64_t y0, int64_t x0, float inv_c, float* smem) {
  using S = BwdSmem<MD>;
  constexpr int ND = S::ND;
  constexpr int R4 = RAW4<T>;
  float* win = smem;
  float* coef = smem + BSLAB * S::CS;

  const int tid = threadIdx.x;
  const int xg = tid & 3, cg = (tid >> 2) & 3, ty = tid >> 4;

  // VEC (md 4 only): rows are read 4 elements a load (the launcher checked
  // the layout): the window's, whose rows start 4-aligned at md 4; bf16 g's
  // too, from a 4-aligned column (x0 for df1, x0 - 4 for df2's shifted reads,
  // inside 24 columns).  f32 g is read one element a load: its 4-byte
  // requests carry enough bytes, and on the card the vectors' shifted staging
  // cost more than they saved.  Otherwise one element a load.
  static_assert(!VEC || MD == 4, "the vector instance is built for md 4 only");
  constexpr bool GVEC = VEC && sizeof(T) == 2, WVEC = VEC;

  // Coefficients a[ey, ex] over the tile: as vectors of g's rows (GV a row,
  // from column x0 + GX0), or one element per thread and ex at (srow, scol).
  constexpr int GV = SECOND ? (BTW + 8) / 4 : BTW / 4;
  constexpr int GX0 = SECOND ? -4 : 0;
  constexpr int NGV = ND * BTH * GV;
  constexpr int RG = (NGV + BTHREADS - 1) / BTHREADS;
  // one window row: vectors (md 4) or elements
  constexpr int NWV = BSLAB * (S::WW / 4);
  constexpr int RW = (NWV + BTHREADS - 1) / BTHREADS;
  constexpr int NR = (BSLAB * S::WW + BTHREADS - 1) / BTHREADS;
  // raw words in flight: the coefficients' first, then the window row's
  constexpr int CW = GVEC ? R4 * RG : ND;
  constexpr int RWW = WVEC ? R4 * RW : NR;
  uint32_t stash[CW + RWW];
  const int scol = tid % BTW, srow = tid / BTW;

  auto plane_of = [&](int ey, int ex) {
    return SECOND ? ND * ND - 1 - (ey * ND + ex) : ey * ND + ex;
  };
  auto fetch = [&](int ey) {
    if constexpr (GVEC) {
#pragma unroll
      for (int k = 0; k < RG; ++k) {
        const int i = tid + k * BTHREADS;
        const int v = i % GV, r = i / GV, row = r % BTH, ex = r / BTH;
        const int64_t y = y0 + row + (SECOND ? ey - MD : 0), x = x0 + GX0 + 4 * v;
        ldg_raw4(gb + plane_of(ey, ex) * sg.c + y * sg.h + x,
                 i < NGV && y >= 0 && y < H && x >= 0 && x < W, stash + R4 * k);
      }
    } else {
#pragma unroll
      for (int ex = 0; ex < ND; ++ex) {
        const int64_t y = y0 + srow + (SECOND ? ey - MD : 0);
        const int64_t x = x0 + scol + (SECOND ? ex - MD : 0);
        stash[ex] = ldg_raw(gb + plane_of(ey, ex) * sg.c + y * sg.h + x * sg.w,
                            y >= 0 && y < H && x >= 0 && x < W);
      }
    }
  };
  auto put = [&](int buf) {
    float* cf = coef + buf * S::COEF;
    if constexpr (GVEC) {
#pragma unroll
      for (int k = 0; k < RG; ++k) {
        const int i = tid + k * BTHREADS;
        if (i >= NGV) break;
        const int v = i % GV, r = i / GV, row = r % BTH, ex = r / BTH;
        const float4 f = widen4<T>(stash + R4 * k);
        float* dst_row = cf + (ex * BTH + row) * BTW;
        if constexpr (SECOND) {
          // df2 keeps a[ex] pre-shifted: column c holds g at x0 + c + ex - md
          const int c = GX0 + 4 * v - ex + MD;
          if (c >= 0 && c < BTW) dst_row[c] = f.x;
          if (c + 1 >= 0 && c + 1 < BTW) dst_row[c + 1] = f.y;
          if (c + 2 >= 0 && c + 2 < BTW) dst_row[c + 2] = f.z;
          if (c + 3 >= 0 && c + 3 < BTW) dst_row[c + 3] = f.w;
        } else {
          *reinterpret_cast<float4*>(dst_row + 4 * v) = f;
        }
      }
    } else {
#pragma unroll
      for (int ex = 0; ex < ND; ++ex)
        cf[(ex * BTH + srow) * BTW + scol] = widen<T>(stash[ex]);
    }
  };

  // window element or vector i of a band of `rows` rows from row0
  // (channel-major, rows of WW columns), zero outside the plane and beyond C
  auto window_raw = [&](int i, int rows, int row0) {
    const int col = i % S::WW, r = i / S::WW;
    const int64_t c = c0 + r / rows, y = y0 - MD + row0 + r % rows, x = x0 - MD + col;
    return ldg_raw(wsrc + c * sw.c + y * sw.h + x * sw.w,
                   c < C && y >= 0 && y < H && x >= 0 && x < W);
  };
  auto window_raw4 = [&](int i, int rows, int row0, uint32_t* r4) {
    const int col = 4 * (i % (S::WW / 4)), r = i / (S::WW / 4);
    const int64_t c = c0 + r / rows, y = y0 - MD + row0 + r % rows, x = x0 - MD + col;
    ldg_raw4(wsrc + c * sw.c + y * sw.h + x, c < C && y >= 0 && y < H && x >= 0 && x < W,
             r4);
  };
  auto window_slot = [&](int i, int rows, int row0, int per_row) {
    const int col = i % per_row, r = i / per_row;
    return (r / rows) * S::CS + (row0 + r % rows) * S::WW4 + col * (S::WW / per_row);
  };

  fetch(0);  // in flight during the window's staging

  // The window's first BTH rows now, the others one per ey during the sums.
  constexpr int N0 = BSLAB * BTH * S::WW;
  if constexpr (WVEC) {
    constexpr int NV4 = N0 / 4 / BTHREADS;
    static_assert(NV4 * 4 * BTHREADS == N0, "whole rounds of vector staging");
    uint32_t v[NV4 * R4];
#pragma unroll
    for (int k = 0; k < NV4; ++k) window_raw4(tid + k * BTHREADS, BTH, 0, v + R4 * k);
#pragma unroll
    for (int k = 0; k < NV4; ++k)
      *reinterpret_cast<float4*>(win + window_slot(tid + k * BTHREADS, BTH, 0, S::WW / 4)) =
          widen4<T>(v + R4 * k);
  } else {
    constexpr int N = N0 / BTHREADS;
    static_assert(N * BTHREADS == N0, "whole rounds of staging");
#pragma unroll 1
    for (int base = 0; base < N; base += STAGE) {
      uint32_t v[STAGE];
#pragma unroll
      for (int k = 0; k < STAGE; ++k)
        v[k] = base + k < N ? window_raw(tid + (base + k) * BTHREADS, BTH, 0) : 0u;
#pragma unroll
      for (int k = 0; k < STAGE; ++k)
        if (base + k < N)
          win[window_slot(tid + (base + k) * BTHREADS, BTH, 0, S::WW)] = widen<T>(v[k]);
    }
  }
  put(0);
  __syncthreads();

  // one more window row per ey, fetched during the ey's sums
  uint32_t* nxt = stash + CW;
  auto fetch_row = [&](int row) {
    if constexpr (WVEC) {
#pragma unroll
      for (int k = 0; k < RW; ++k) {
        const int i = tid + k * BTHREADS;
        if (i < NWV) window_raw4(i, 1, row, nxt + R4 * k);
      }
    } else {
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        const int i = tid + k * BTHREADS;
        nxt[k] = i < BSLAB * S::WW ? window_raw(i, 1, row) : 0u;
      }
    }
  };
  auto put_row = [&](int row) {
    if constexpr (WVEC) {
#pragma unroll
      for (int k = 0; k < RW; ++k) {
        const int i = tid + k * BTHREADS;
        if (i < NWV)
          *reinterpret_cast<float4*>(win + window_slot(i, 1, row, S::WW / 4)) =
              widen4<T>(nxt + R4 * k);
      }
    } else {
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        const int i = tid + k * BTHREADS;
        if (i < BSLAB * S::WW) win[window_slot(i, 1, row, S::WW)] = widen<T>(nxt[k]);
      }
    }
  };

  float acc[BCB][BPX];
#pragma unroll
  for (int j = 0; j < BCB; ++j)
#pragma unroll
    for (int p = 0; p < BPX; ++p) acc[j][p] = 0.f;

#pragma unroll 1
  for (int ey = 0; ey < ND; ++ey) {
    // in flight during this ey's sums: the next coefficients and the window
    // row the next ey reaches first
    if (ey + 1 < ND) {
      fetch(ey + 1);
      fetch_row(BTH + ey);
    }
    const float* cb = coef + (ey & 1) * S::COEF + ty * BTW + BPX * xg;
    float4 a[ND];
#pragma unroll
    for (int ex = 0; ex < ND; ++ex)
      a[ex] = *reinterpret_cast<const float4*>(cb + ex * BTH * BTW);
    const float* wr = win + cg * S::CS + (ty + ey) * S::WW4 + BPX * xg;
#pragma unroll
    for (int j = 0; j < BCB; ++j) {
      float w[4 * S::NV];
#pragma unroll
      for (int v = 0; v < S::NV; ++v) {
        const float4 q = *reinterpret_cast<const float4*>(wr + j * BNG * S::CS + 4 * v);
        w[4 * v] = q.x;
        w[4 * v + 1] = q.y;
        w[4 * v + 2] = q.z;
        w[4 * v + 3] = q.w;
      }
#pragma unroll
      for (int ex = 0; ex < ND; ++ex) {
        acc[j][0] = fmaf(a[ex].x, w[ex], acc[j][0]);
        acc[j][1] = fmaf(a[ex].y, w[ex + 1], acc[j][1]);
        acc[j][2] = fmaf(a[ex].z, w[ex + 2], acc[j][2]);
        acc[j][3] = fmaf(a[ex].w, w[ex + 3], acc[j][3]);
      }
    }
    if (ey + 1 < ND) {
      put((ey + 1) & 1);
      put_row(BTH + ey);
    }
    __syncthreads();
  }

  const int64_t y = y0 + ty;
  if (y >= H) return;
  const int64_t x = x0 + BPX * xg;
  // rows of a multiple of 4 take one vector store of the thread's 4 values
  const bool whole = W % BPX == 0 && x < W;
#pragma unroll
  for (int j = 0; j < BCB; ++j) {
    const int64_t c = c0 + cg + BNG * j;
    if (c >= C) break;
    T* o = dst + (c * H + y) * W + x;
    if (whole) {
      store4(o, acc[j][0] * inv_c, acc[j][1] * inv_c, acc[j][2] * inv_c, acc[j][3] * inv_c);
      continue;
    }
#pragma unroll
    for (int p = 0; p < BPX; ++p)
      if (x + p < W) store(o + p, acc[j][p] * inv_c);
  }
}

// Both gradients.  blockIdx.z = (which' * B + b) * slabs + slab, where
// which = first + which' is 0 for df1 (from f2's window) and 1 for df2 (from
// f1's window).  VEC: rows read 4 elements a load (see corr_bwd_tile).
template <typename T, int MD, bool VEC>
__global__ void __launch_bounds__(BTHREADS, MIN_BLOCKS)
corr_bwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                const T* __restrict__ g, T* __restrict__ df1,
                T* __restrict__ df2, int64_t B, int64_t C, int64_t H,
                int64_t W, Strides s1, Strides s2, Strides sg, float inv_c,
                int first, int64_t slabs) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int64_t z = blockIdx.z;
  const int64_t r = z / slabs;
  const int64_t b = r % B;
  const int64_t c0 = (z % slabs) * BSLAB;
  const int64_t y0 = (int64_t)blockIdx.y * BTH, x0 = (int64_t)blockIdx.x * BTW;
  const T* gb = g + b * sg.b;
  if (first + (int)(r / B) == 1)
    corr_bwd_tile<true, MD, VEC>(f1 + b * s1.b, s1, gb, sg, df2 + b * C * H * W,
                                 C, H, W, c0, y0, x0, inv_c, smem);
  else
    corr_bwd_tile<false, MD, VEC>(f2 + b * s2.b, s2, gb, sg, df1 + b * C * H * W,
                                  C, H, W, c0, y0, x0, inv_c, smem);
}

Strides strides(const int64_t* s) { return Strides{s[0], s[1], s[2], s[3]}; }

// The backward's launch: grid (x tiles, row tiles, copies * B * slabs),
// BTHREADS threads, bwd_smem_bytes(md) of dynamic shared memory.  False for
// a shape or md the kernel does not take.
bool bwd_geometry(int64_t B, int64_t C, int64_t H, int64_t W, int md,
                  int copies, dim3* grid, int64_t* slabs) {
  if (md < 1 || md > MAX_MD || copies < 1 || B < 1 || C < 1 || H < 1 || W < 1)
    return false;
  const int64_t gx = (W + BTW - 1) / BTW, gy = (H + BTH - 1) / BTH;
  *slabs = (C + BSLAB - 1) / BSLAB;
  const int64_t gz = B * copies * *slabs;
  if (gx > 2147483647 || gy > 65535 || gz > 65535) return false;
  *grid = dim3((unsigned)gx, (unsigned)gy, (unsigned)gz);
  return true;
}

template <typename T, int MD, bool VEC, int TH>
int launch_fwd_tiled(const void* f1, const void* f2, void* out, int64_t C, int64_t H,
                     int64_t W, Strides s1, Strides s2, dim3 grid, cudaStream_t stream) {
  constexpr int bytes = fwd_smem_bytes_of<MD, TH>((int)sizeof(T));
  // per device and cheap; beyond 48 KB a launch needs it
  const cudaError_t set = cudaFuncSetAttribute(
      corr_fwd_kernel<T, MD, VEC, TH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return (int)set;
  corr_fwd_kernel<T, MD, VEC, TH><<<grid, FTHREADS, bytes, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2), static_cast<T*>(out), C, H, W,
      s1, s2, 1.f / (float)C);
  return (int)cudaGetLastError();
}

template <typename T, int TH>
int forward_th(const void* f1, const void* f2, void* out, int64_t C, int64_t H, int64_t W,
               int md, Strides s1, Strides s2, dim3 grid, cudaStream_t stream) {
  // md 4, the model's, has an instance that reads f1's and f2's rows 4
  // elements a copy where their layout allows
  const int e = (int)sizeof(T);
  if (md == 4 && rows_of_4(f1, s1, W, e) && rows_of_4(f2, s2, W, e))
    return launch_fwd_tiled<T, 4, true, TH>(f1, f2, out, C, H, W, s1, s2, grid, stream);
  switch (md) {
    case 1: return launch_fwd_tiled<T, 1, false, TH>(f1, f2, out, C, H, W, s1, s2, grid, stream);
    case 2: return launch_fwd_tiled<T, 2, false, TH>(f1, f2, out, C, H, W, s1, s2, grid, stream);
    case 3: return launch_fwd_tiled<T, 3, false, TH>(f1, f2, out, C, H, W, s1, s2, grid, stream);
    default: return launch_fwd_tiled<T, 4, false, TH>(f1, f2, out, C, H, W, s1, s2, grid, stream);
  }
}

template <typename T>
int forward(const void* f1, const void* f2, void* out, int64_t B, int64_t C, int64_t H,
            int64_t W, int md, Strides s1, Strides s2, cudaStream_t stream) {
  dim3 grid;
  int th, smem;
  if (!fwd_geometry(B, C, H, W, md, (int)sizeof(T), &grid, &th, &smem))
    return (int)cudaErrorInvalidValue;
  if (th == 16) return forward_th<T, 16>(f1, f2, out, C, H, W, md, s1, s2, grid, stream);
  return forward_th<T, 1>(f1, f2, out, C, H, W, md, s1, s2, grid, stream);
}

template <typename T, int MD, bool VEC>
int launch_bwd_tiled(const void* f1, const void* f2, const void* g, void* df1,
                     void* df2, int64_t B, int64_t C, int64_t H, int64_t W,
                     Strides s1, Strides s2, Strides sg, int first, dim3 grid,
                     int64_t slabs, cudaStream_t stream) {
  constexpr int bytes = BwdSmem<MD>::BYTES;
  // per device and cheap; beyond 48 KB a launch needs it
  const cudaError_t set = cudaFuncSetAttribute(
      corr_bwd_kernel<T, MD, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return (int)set;
  corr_bwd_kernel<T, MD, VEC><<<grid, BTHREADS, bytes, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<const T*>(g), static_cast<T*>(df1), static_cast<T*>(df2), B,
      C, H, W, s1, s2, sg, 1.f / (float)C, first, slabs);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* f1, const void* f2, const void* g, void* df1,
             void* df2, int64_t B, int64_t C, int64_t H, int64_t W, int md,
             Strides s1, Strides s2, Strides sg, cudaStream_t stream) {
  const int first = df1 ? 0 : 1;
  const int copies = (df1 ? 1 : 0) + (df2 ? 1 : 0);
  dim3 grid;
  int64_t slabs;
  if (copies == 0 || !bwd_geometry(B, C, H, W, md, copies, &grid, &slabs))
    return (int)cudaErrorInvalidValue;
  // md 4, the model's, has an instance that reads g's rows and the windows'
  // (f2 for df1, f1 for df2) 4 elements a load where their layout allows
  const int e = (int)sizeof(T);
  const bool vec = md == 4 && rows_of_4(g, sg, W, e) &&
                   (!df1 || rows_of_4(f2, s2, W, e)) && (!df2 || rows_of_4(f1, s1, W, e));
#define CORR_BWD_LAUNCH(MDV, VECV)                                                    \
  return launch_bwd_tiled<T, MDV, VECV>(f1, f2, g, df1, df2, B, C, H, W, s1, s2, sg, \
                                        first, grid, slabs, stream)
  if (vec) CORR_BWD_LAUNCH(4, true);
  switch (md) {
    case 1: CORR_BWD_LAUNCH(1, false);
    case 2: CORR_BWD_LAUNCH(2, false);
    case 3: CORR_BWD_LAUNCH(3, false);
    default: CORR_BWD_LAUNCH(4, false);
  }
#undef CORR_BWD_LAUNCH
}

}  // namespace

// f1, f2 [B, C, H, W] with strides s1[4], s2[4] (elements); out
// [B, (2 md + 1)^2, H, W] contiguous, every element written.  All three are
// bf16 (bf16 = 1) or f32 (0).
extern "C" int corr_forward(const void* f1, const void* f2, void* out,
                            int64_t B, int64_t C, int64_t H, int64_t W,
                            int64_t md, const int64_t* s1, const int64_t* s2,
                            int64_t bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return forward<__nv_bfloat16>(f1, f2, out, B, C, H, W, (int)md, strides(s1), strides(s2), s);
  return forward<float>(f1, f2, out, B, C, H, W, (int)md, strides(s1), strides(s2), s);
}

// f1, f2 [B, C, H, W] and g [B, (2 md + 1)^2, H, W] with the given strides;
// df1, df2 [B, C, H, W] contiguous, every element written, or null where that
// gradient is not wanted (at least one is).  One launch whichever are asked
// for.  All tensors are bf16 (bf16 = 1) or f32 (0).
extern "C" int corr_backward(const void* f1, const void* f2, const void* g,
                             void* df1, void* df2, int64_t B, int64_t C,
                             int64_t H, int64_t W, int64_t md,
                             const int64_t* s1, const int64_t* s2,
                             const int64_t* sg, int64_t bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return backward<__nv_bfloat16>(f1, f2, g, df1, df2, B, C, H, W, (int)md,
                                   strides(s1), strides(s2), strides(sg), s);
  return backward<float>(f1, f2, g, df1, df2, B, C, H, W, (int)md, strides(s1),
                         strides(s2), strides(sg), s);
}

// The launch corr_forward makes for these sizes, in bf16 (1) or f32 (0):
// out[0..5] = grid x, y, z, threads per block, dynamic shared bytes, tile
// rows.  Returns cudaErrorInvalidValue (and writes nothing) for what it refuses.
extern "C" int corr_forward_launch(int64_t B, int64_t C, int64_t H, int64_t W, int64_t md,
                                   int64_t bf16, int64_t* out) {
  dim3 grid;
  int th, smem;
  if (!fwd_geometry(B, C, H, W, (int)md, bf16 ? 2 : 4, &grid, &th, &smem))
    return (int)cudaErrorInvalidValue;
  out[0] = grid.x;
  out[1] = grid.y;
  out[2] = grid.z;
  out[3] = FTHREADS;
  out[4] = smem;
  out[5] = th;
  return 0;
}

// The launch corr_backward makes for these sizes and `copies` gradients:
// out[0..4] = grid x, y, z, threads per block, dynamic shared bytes.  Returns
// cudaErrorInvalidValue (and writes nothing) for what it refuses.
extern "C" int corr_backward_launch(int64_t B, int64_t C, int64_t H, int64_t W,
                                    int64_t md, int64_t copies, int64_t* out) {
  dim3 grid;
  int64_t slabs;
  if (!bwd_geometry(B, C, H, W, (int)md, (int)copies, &grid, &slabs))
    return (int)cudaErrorInvalidValue;
  out[0] = grid.x;
  out[1] = grid.y;
  out[2] = grid.z;
  out[3] = BTHREADS;
  out[4] = bwd_smem_bytes((int)md);
  return 0;
}
