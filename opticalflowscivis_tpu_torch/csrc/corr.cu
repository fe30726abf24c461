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
// finest UPFlow level ([16, 32, 64, 208], md 4) the output is 2.5 times the
// inputs, so the forward is bound by its own write.  Operations: 2 C (2md+1)^2
// per pixel, which at md 4 is within a factor of three of the byte time at the
// f32 rate outside the tensor cores, so shared-memory traffic per multiply
// matters too.  The backward reads f1, f2 and g and writes two tensors of the
// inputs' size, with twice the forward's operations.
//
// Design (md 1..4).  One launch covers the batch; a block
// owns a tile of 8 x 32 pixels of one sample.
//   Forward: f1's tile and f2's (8 + 2 md) x (32 + 2 md) window are staged in
//   shared memory for 8 channels at a time, zero outside the plane, so every
//   input element is read from device memory once per tile (the halo from L2).
//   A thread owns 4 pixels of one column and one dx, and keeps 4 x (2 md + 1)
//   sums in registers: per channel it loads a column of 4 + 2 md window values
//   and 4 f1 values for 4 (2 md + 1) multiply-adds (36 for 12 + 4 loads at md
//   4).  Threads of a warp own consecutive x: shared reads have no bank
//   conflict and the writes of out coalesce.
//   Backward: one kernel serves both gradients; blockIdx.z selects the sample
//   and the gradient, so asking for both is still one launch.  The other
//   feature map's window (f2 for df1, f1 for df2) is staged for 16 channels at
//   a time; a thread owns one pixel and 16 channel sums, reads g from global
//   memory (coalesced over x, reread once per 16 channels, from L2) and the
//   window from shared memory.
// Other md have no kernel: the entries return cudaErrorInvalidValue and the
// wrapper refuses them before the launch.  Every configuration of the package
// uses md <= 4; from md 6 on the backward's window of CB channels would exceed
// the 48 KB of static shared memory and need a smaller channel step.
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

constexpr int TH = 8;    // tile rows
constexpr int TW = 32;   // tile columns: one warp spans a tile row
constexpr int PY = 4;    // forward: pixels (rows) per thread
constexpr int CF = 8;    // forward: channels staged per step
constexpr int CB = 16;   // backward: channels staged per step = sums per thread
constexpr int MAX_MD = 4;  // the kernels are instantiated for md 1..MAX_MD

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Strides {
  int64_t b, c, h, w;
};

// Stage `nc` channels (from c0) of a rows x cols window of one sample into
// shared memory as f32, zero outside the plane and beyond channel C.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, Strides s,
                                      int64_t c0, int64_t C, int64_t ya,
                                      int64_t xa, int64_t H, int64_t W, int nc,
                                      int rows, int cols) {
  const int n = nc * rows * cols;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int wx = i % cols;
    const int r = i / cols;
    const int wy = r % rows;
    const int64_t c = c0 + r / rows;
    const int64_t y = ya + wy, x = xa + wx;
    float v = 0.f;
    if (c < C && y >= 0 && y < H && x >= 0 && x < W)
      v = load_f32(src + c * s.c + y * s.h + x * s.w);
    dst[i] = v;
  }
}

template <typename T, int MD>
__global__ void __launch_bounds__(TW * (TH / PY) * (2 * MD + 1))
corr_fwd_kernel(const T* __restrict__ f1,
                                const T* __restrict__ f2, T* __restrict__ out,
                                int64_t C, int64_t H, int64_t W, Strides s1,
                                Strides s2, float inv_c) {
  constexpr int ND = 2 * MD + 1;
  constexpr int WH = TH + 2 * MD, WW = TW + 2 * MD;
  __shared__ float t1[CF * TH * TW];
  __shared__ float t2[CF * WH * WW];

  const int64_t b = blockIdx.z;
  const int64_t y0 = (int64_t)blockIdx.y * TH, x0 = (int64_t)blockIdx.x * TW;
  const int tx = threadIdx.x % TW;
  const int r = threadIdx.x / TW;
  const int ty = (r % (TH / PY)) * PY;  // first of this thread's PY rows
  const int dx = r / (TH / PY);

  float acc[PY][ND];
#pragma unroll
  for (int p = 0; p < PY; ++p)
#pragma unroll
    for (int dy = 0; dy < ND; ++dy) acc[p][dy] = 0.f;

  for (int64_t c0 = 0; c0 < C; c0 += CF) {
    stage(t1, f1 + b * s1.b, s1, c0, C, y0, x0, H, W, CF, TH, TW);
    stage(t2, f2 + b * s2.b, s2, c0, C, y0 - MD, x0 - MD, H, W, CF, WH, WW);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CF; ++c) {
      float a[PY], v[PY + ND - 1];
#pragma unroll
      for (int p = 0; p < PY; ++p) a[p] = t1[(c * TH + ty + p) * TW + tx];
#pragma unroll
      for (int j = 0; j < PY + ND - 1; ++j)
        v[j] = t2[(c * WH + ty + j) * WW + tx + dx];
#pragma unroll
      for (int p = 0; p < PY; ++p)
#pragma unroll
        for (int dy = 0; dy < ND; ++dy) acc[p][dy] += a[p] * v[p + dy];
    }
    __syncthreads();
  }

  const int64_t x = x0 + tx;
  if (x >= W) return;
  const int64_t plane = H * W;
  T* o = out + b * (ND * ND) * plane + x;
#pragma unroll
  for (int p = 0; p < PY; ++p) {
    const int64_t y = y0 + ty + p;
    if (y >= H) break;
#pragma unroll
    for (int dy = 0; dy < ND; ++dy)
      store(o + (dy * ND + dx) * plane + y * W, acc[p][dy] * inv_c);
  }
}

// Both gradients.  blockIdx.z = which * B + b with which = first + (0 or 1):
// 0 writes df1 from f2's window, 1 writes df2 from f1's window.
template <typename T, int MD>
__global__ void __launch_bounds__(TH * TW)
corr_bwd_kernel(const T* __restrict__ f1,
                                const T* __restrict__ f2,
                                const T* __restrict__ g, T* __restrict__ df1,
                                T* __restrict__ df2, int64_t B, int64_t C,
                                int64_t H, int64_t W, Strides s1, Strides s2,
                                Strides sg, float inv_c, int first) {
  constexpr int ND = 2 * MD + 1;
  constexpr int WH = TH + 2 * MD, WW = TW + 2 * MD;
  __shared__ float win[CB * WH * WW];

  const bool second = first + (int)(blockIdx.z / B) == 1;
  const int64_t b = blockIdx.z % B;
  const int64_t y0 = (int64_t)blockIdx.y * TH, x0 = (int64_t)blockIdx.x * TW;
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int64_t y = y0 + ty, x = x0 + tx;
  const bool live = y < H && x < W;

  const T* other = second ? f1 + b * s1.b : f2 + b * s2.b;
  const Strides so = second ? s1 : s2;
  const T* gb = g + b * sg.b;
  T* dst = (second ? df2 : df1) + b * C * H * W + y * W + x;

  for (int64_t c0 = 0; c0 < C; c0 += CB) {
    stage(win, other, so, c0, C, y0 - MD, x0 - MD, H, W, CB, WH, WW);
    __syncthreads();
    if (live) {
      float acc[CB];
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[c] = 0.f;
      for (int dy = 0; dy < ND; ++dy) {
#pragma unroll
        for (int dx = 0; dx < ND; ++dx) {
          // df1 reads g at its own pixel and the window at +d; df2 reads g at
          // the source pixel p = (y, x) - d + md and the window at that pixel
          const int oy = second ? MD - dy : 0, ox = second ? MD - dx : 0;
          const int64_t py = y + oy, px = x + ox;
          float gk = 0.f;
          if (py >= 0 && py < H && px >= 0 && px < W)
            gk = load_f32(gb + (dy * ND + dx) * sg.c + py * sg.h + px * sg.w);
          const int wy = second ? ty + 2 * MD - dy : ty + dy;
          const int wx = second ? tx + 2 * MD - dx : tx + dx;
          const float* w = win + wy * WW + wx;
#pragma unroll
          for (int c = 0; c < CB; ++c) acc[c] += gk * w[c * WH * WW];
        }
      }
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c0 + c < C) store(dst + (c0 + c) * H * W, acc[c] * inv_c);
    }
    __syncthreads();
  }
}

Strides strides(const int64_t* s) { return Strides{s[0], s[1], s[2], s[3]}; }

dim3 tile_grid(int64_t B, int64_t H, int64_t W, int copies) {
  return dim3((unsigned)((W + TW - 1) / TW), (unsigned)((H + TH - 1) / TH),
              (unsigned)(B * copies));
}

bool grid_fits(int64_t B, int64_t H, int copies) {
  return (H + TH - 1) / TH <= 65535 && B * copies <= 65535;
}

template <typename T, int MD>
void launch_fwd_tiled(const void* f1, const void* f2, void* out, int64_t B,
                      int64_t C, int64_t H, int64_t W, Strides s1, Strides s2,
                      cudaStream_t stream) {
  const int threads = TW * (TH / PY) * (2 * MD + 1);
  corr_fwd_kernel<T, MD><<<tile_grid(B, H, W, 1), threads, 0, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<T*>(out), C, H, W, s1, s2, 1.f / (float)C);
}

template <typename T, int MD>
void launch_bwd_tiled(const void* f1, const void* f2, const void* g, void* df1,
                      void* df2, int64_t B, int64_t C, int64_t H, int64_t W,
                      Strides s1, Strides s2, Strides sg, int first, int copies,
                      cudaStream_t stream) {
  corr_bwd_kernel<T, MD><<<tile_grid(B, H, W, copies), TH * TW, 0, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<const T*>(g), static_cast<T*>(df1), static_cast<T*>(df2), B,
      C, H, W, s1, s2, sg, 1.f / (float)C, first);
}

template <typename T>
int forward(const void* f1, const void* f2, void* out, int64_t B, int64_t C,
            int64_t H, int64_t W, int md, Strides s1, Strides s2,
            cudaStream_t stream) {
  if (md < 1 || md > MAX_MD || !grid_fits(B, H, 1))
    return (int)cudaErrorInvalidValue;
  switch (md) {
    case 1: launch_fwd_tiled<T, 1>(f1, f2, out, B, C, H, W, s1, s2, stream); break;
    case 2: launch_fwd_tiled<T, 2>(f1, f2, out, B, C, H, W, s1, s2, stream); break;
    case 3: launch_fwd_tiled<T, 3>(f1, f2, out, B, C, H, W, s1, s2, stream); break;
    default: launch_fwd_tiled<T, 4>(f1, f2, out, B, C, H, W, s1, s2, stream);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* f1, const void* f2, const void* g, void* df1,
             void* df2, int64_t B, int64_t C, int64_t H, int64_t W, int md,
             Strides s1, Strides s2, Strides sg, cudaStream_t stream) {
  const int first = df1 ? 0 : 1;
  const int copies = (df1 ? 1 : 0) + (df2 ? 1 : 0);
  if (copies == 0 || md < 1 || md > MAX_MD || !grid_fits(B, H, copies))
    return (int)cudaErrorInvalidValue;
  switch (md) {
    case 1: launch_bwd_tiled<T, 1>(f1, f2, g, df1, df2, B, C, H, W, s1, s2, sg, first, copies, stream); break;
    case 2: launch_bwd_tiled<T, 2>(f1, f2, g, df1, df2, B, C, H, W, s1, s2, sg, first, copies, stream); break;
    case 3: launch_bwd_tiled<T, 3>(f1, f2, g, df1, df2, B, C, H, W, s1, s2, sg, first, copies, stream); break;
    default: launch_bwd_tiled<T, 4>(f1, f2, g, df1, df2, B, C, H, W, s1, s2, sg, first, copies, stream);
  }
  return (int)cudaGetLastError();
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
