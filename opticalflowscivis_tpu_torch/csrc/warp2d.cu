// Bilinear backward warp, forward pass and its VJP, for Hopper (sm_90a).
//
// Replaces opticalflowscivis_tpu/ops/pallas/warp.py::backward_warp_pallas:
// the forward (_forward / _warp_kernel) and the fused backward
// (_backward_fused / _bwd_kernel, and the zeros-mode composition in _bwd).
// Both compute what those kernels compute, not their one-hot MXU form, which
// exists only because the TPU has neither a vector gather nor a scatter: the
// GPU gathers natively, and an index clamp in the scatter lands out-of-image
// taps on the border pixels, which is what the TPU's window overlap-add plus
// edge-pad fold does.
//
//   out[b, c, y, x] = sum over the 4 corners of w_corner * img[b, c, iy, ix]
//   (dy, dx) = flow[b, :, y, x], clipped to +-r when r > 0
//   border: corner indices clamped to [0, H-1] x [0, W-1] (the Pallas edge pad
//           plus window); zeros: out-of-range corners dropped (equal to the
//           Pallas border x separable in-bounds weight, ops/pallas/warp.py:241-243)
//   mask[b, 0, y, x] (optional) = sum of the in-range corners' weights, the
//           warp of an image of ones under zeros padding (UPFlow's validity mask)
//
//   dimg[b, c, iy, ix] += w_corner * g[b, c, y, x]      (f32 atomics)
//   dflow[b, 0, y, x]   = sum_c g * d out / d dy, 0 where |dy| >= r (r > 0)
//   dflow[b, 1, y, x]   = sum_c g * d out / d dx, 0 where |dx| >= r (r > 0)
//   In zeros mode a dropped corner has weight 0 in both outputs; away from
//   integer coordinates that equals the Pallas composition
//   border_bwd(g V) + <g, border_out> dV/dflow.
//
// Bound: device-memory bytes.  The forward at [32,160,224,1] f32 moves about
// 1.15 M px x (4 B img + 8 B flow + 4 B out) and does ~30 flops per pixel, far
// below the card's compute rate; the backward reads image, flow and g, writes
// dflow, and for dimg adds a zero-fill and a read-modify-write of the image's
// size.  The 4 taps of a pixel stay within +-(r+1) rows of it, so neighbouring
// threads' gathers and atomics hit L1 and L2.
//
// Forward design.  At 16-20 B per pixel, per-thread instructions and bytes in
// flight set the time, not DRAM, so the forward spends no instruction on index
// decomposition: the grid is (x tiles, row tiles, batch), computed by the
// wrapper, and a thread holds kV = 4 consecutive x of one row, whatever the
// number of channels; a grid-stride loop over rows and batch takes over where
// either exceeds the grid's 65535 limit.  Offsets inside a plane are 32-bit
// (the wrapper refuses a plane of 2^31 elements or more); only the (b, c) base
// is 64-bit.  Each flow plane's 4 values are one 16 B (bf16: 8 B) load when
// the row is aligned and the flow's x stride is 1, a channels-last (dy, dx)
// pair one 8 B (4 B) load, anything else (ragged row ends, misaligned slices)
// element by element; the output row is one vector store where aligned.  The
// image is gathered through the read-only path, 16 loads in flight per thread
// and channel; the channel loop is not unrolled, since its registers would
// cost occupancy.  The validity mask, asked for by a non-null pointer, is
// summed w00 + w01 + w10 + w11 in that order and rounded once, which is what
// the accumulation of an image of ones rounds: the two are bit-equal.  On iid
// random flows the gathers are the limit: each touches its own cache line.
//
// Backward design (simple first): one thread per output pixel (b, y, x),
// consecutive threads on consecutive x so reads of g and writes of dflow
// coalesce; a loop over C; f32 arithmetic, stored in the dtype of the image
// (f32 or bf16).  The flow and dflow share the image's dtype, or are f32
// beside a bf16 image: UPFlow keeps its flows in f32 while its features run in
// bf16, and rounding a 40-pixel flow to bf16 would move the taps by a quarter
// pixel.  Forward and backward share `make_taps`, so the backward recomputes
// exactly the forward's clip, coordinate clamp, corners and weights.  dflow is
// written once per pixel with no atomics.  dimg is accumulated with f32
// atomicAdd into an f32 buffer that the wrapper zero-fills and casts
// afterwards (bf16 atomics would round every add); the kernel is compiled
// without that part for calls whose image needs no gradient.  The flow and g
// are read through their four strides, so the model's channel slices of a
// 4-channel flow, and a g in the channels-last layout cuDNN may hand back,
// need no copy.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError() after
// the launch.

#include "warp_io.cuh"

namespace {

// The four corners of one output pixel: bilinear fractions, per-corner
// weight factor (in-range flag in zeros mode, 1 in border mode), in-range
// flags for the validity mask, clamped offsets into one image plane (32-bit:
// the wrappers refuse planes of 2^31 elements or more), and whether each flow
// component passes a gradient through the +-r clip.
struct Taps {
  float ay, ax;
  float m00, m01, m10, m11;
  float v00, v01, v10, v11;
  int o00, o01, o10, o11;
  bool live_y, live_x;
};

__device__ __forceinline__ Taps make_taps(float dy, float dx, int y, int x, int H, int W,
                                          float r, int zeros) {
  Taps t;
  // strict <: a flow exactly on +-r is clamped and carries no gradient
  // (ops/pallas/warp.py:323)
  t.live_y = !(r > 0.f) || fabsf(dy) < r;
  t.live_x = !(r > 0.f) || fabsf(dx) < r;
  if (r > 0.f) {
    dy = fminf(fmaxf(dy, -r), r);
    dx = fminf(fmaxf(dx, -r), r);
  }
  // Coordinates more than one pixel outside the image sample the same values
  // (border) or nothing (zeros) wherever they lie; clamping them keeps the
  // integer conversion below in range for unbounded (r = 0) flows.
  const float sy = fminf(fmaxf((float)y + dy, -2.f), (float)H + 1.f);
  const float sx = fminf(fmaxf((float)x + dx, -2.f), (float)W + 1.f);
  const float fy = floorf(sy);
  const float fx = floorf(sx);
  t.ay = sy - fy;
  t.ax = sx - fx;
  const int y0 = (int)fy, x0 = (int)fx;
  const int y1 = y0 + 1, x1 = x0 + 1;

  const bool vy0 = y0 >= 0 && y0 < H, vy1 = y1 >= 0 && y1 < H;
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x1 >= 0 && x1 < W;
  t.v00 = (vy0 && vx0) ? 1.f : 0.f;
  t.v01 = (vy0 && vx1) ? 1.f : 0.f;
  t.v10 = (vy1 && vx0) ? 1.f : 0.f;
  t.v11 = (vy1 && vx1) ? 1.f : 0.f;
  t.m00 = zeros ? t.v00 : 1.f;
  t.m01 = zeros ? t.v01 : 1.f;
  t.m10 = zeros ? t.v10 : 1.f;
  t.m11 = zeros ? t.v11 : 1.f;
  const int cy0 = min(max(y0, 0), H - 1);
  const int cy1 = min(max(y1, 0), H - 1);
  const int cx0 = min(max(x0, 0), W - 1);
  const int cx1 = min(max(x1, 0), W - 1);
  t.o00 = cy0 * W + cx0;
  t.o01 = cy0 * W + cx1;
  t.o10 = cy1 * W + cx0;
  t.o11 = cy1 * W + cx1;
  return t;
}

// (dy, dx) of the n <= V pixels from p (the flow at (b, y, x0)) on; 0 for
// the rest, whose taps then stay inside the image.  A channels-last pair is
// one load.
template <int V, typename F>
__device__ __forceinline__ void load_flow_row(const F* p, int64_t fsc, int64_t fsw, int n,
                                              float* dy, float* dx) {
  if (fsc == 1 && (fsw & 1) == 0 && aligned<2 * sizeof(F)>(p)) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      dy[j] = dx[j] = 0.f;
      if (j < n) ldg2(p + j * fsw, &dy[j], &dx[j]);
    }
    return;
  }
  load_row<V>(p, fsw, n, dy);
  load_row<V>(p + fsc, fsw, n, dx);
}

constexpr int kV = 4;  // consecutive output pixels of one row per forward thread

// At most 80 registers, so that 3 blocks of 256 threads share an SM.
template <typename T, typename F>
__global__ void __launch_bounds__(256, 3)
warp2d_kernel(const T* __restrict__ img, const F* __restrict__ flow, T* __restrict__ out,
              T* __restrict__ mask, int B, int C, int H, int W, int64_t fsb, int64_t fsc,
              int64_t fsh, int64_t fsw, float r, int zeros) {
  const unsigned xt = blockIdx.x * blockDim.x + threadIdx.x;
  if (xt >= ((unsigned)W + kV - 1) / kV) return;
  const int x0 = (int)xt * kV;
  const int n = min(kV, W - x0);
  const int plane = H * W;
  // unsigned: a stride past the last row or batch stays below 2^32
  for (unsigned b = blockIdx.z; b < (unsigned)B; b += gridDim.z) {
    for (unsigned y = blockIdx.y * blockDim.y + threadIdx.y; y < (unsigned)H;
         y += gridDim.y * blockDim.y) {
      float dy[kV], dx[kV];
      load_flow_row<kV>(flow + (int64_t)b * fsb + (int64_t)y * fsh + x0 * fsw, fsc, fsw, n, dy,
                    dx);
      float w[kV][4], valid[kV];
      int o[kV][4];
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const Taps k = make_taps(dy[j], dx[j], (int)y, x0 + j, H, W, r, zeros);
        const float wy0 = 1.f - k.ay, wx0 = 1.f - k.ax;
        w[j][0] = wy0 * wx0 * k.m00;
        w[j][1] = wy0 * k.ax * k.m01;
        w[j][2] = k.ay * wx0 * k.m10;
        w[j][3] = k.ay * k.ax * k.m11;
        o[j][0] = k.o00; o[j][1] = k.o01; o[j][2] = k.o10; o[j][3] = k.o11;
        if (mask)  // no contraction: each add rounds as the warp of ones does
          valid[j] = __fadd_rn(__fadd_rn(__fadd_rn(wy0 * wx0 * k.v00, wy0 * k.ax * k.v01),
                                         k.ay * wx0 * k.v10),
                               k.ay * k.ax * k.v11);
      }
      const int64_t base = (int64_t)b * C * plane;
      const int at = (int)y * W + x0;
      for (int c = 0; c < C; ++c) {
        const T* p = img + base + (int64_t)c * plane;
        float acc[kV];
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          float a = w[j][0] * ldg(p + o[j][0]);
          a += w[j][1] * ldg(p + o[j][1]);
          a += w[j][2] * ldg(p + o[j][2]);
          a += w[j][3] * ldg(p + o[j][3]);
          acc[j] = a;
        }
        store_row<kV>(out + base + (int64_t)c * plane + at, acc, n);
      }
      if (mask) store_row<kV>(mask + (int64_t)b * plane + at, valid, n);
    }
  }
}

// NEED_DIMG = false compiles the image-gradient scatter away: the model's
// warps sample input frames, which carry no gradient.
template <typename T, typename F, bool NEED_DIMG>
__global__ void warp2d_bwd_kernel(
    const T* __restrict__ img, const F* __restrict__ flow,
    const T* __restrict__ g, F* __restrict__ dflow, float* __restrict__ dimg,
    int64_t B, int64_t C, int64_t H, int64_t W, int64_t fsb, int64_t fsc,
    int64_t fsh, int64_t fsw, int64_t gsb, int64_t gsc, int64_t gsh,
    int64_t gsw, float r, int zeros) {
  const int64_t n = B * H * W;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t x = i % W;
  const int64_t t = i / W;
  const int64_t y = t % H;
  const int64_t b = t / H;

  const F* f = flow + b * fsb + y * fsh + x * fsw;
  const Taps k = make_taps(load_f32(f), load_f32(f + fsc), (int)y, (int)x, (int)H, (int)W, r,
                           zeros);
  const float w00 = (1.f - k.ay) * (1.f - k.ax) * k.m00;
  const float w01 = (1.f - k.ay) * k.ax * k.m01;
  const float w10 = k.ay * (1.f - k.ax) * k.m10;
  const float w11 = k.ay * k.ax * k.m11;

  const int64_t plane = H * W;
  const T* src = img + b * C * plane;
  const T* gp = g + b * gsb + y * gsh + x * gsw;
  float* dst = NEED_DIMG ? dimg + b * C * plane : nullptr;
  float gy = 0.f, gx = 0.f;
  for (int64_t c = 0; c < C; ++c) {
    const T* p = src + c * plane;
    const float gc = load_f32(gp + c * gsc);
    const float v00 = k.m00 * load_f32(p + k.o00);
    const float v01 = k.m01 * load_f32(p + k.o01);
    const float v10 = k.m10 * load_f32(p + k.o10);
    const float v11 = k.m11 * load_f32(p + k.o11);
    gy += gc * ((1.f - k.ax) * (v10 - v00) + k.ax * (v11 - v01));
    gx += gc * ((1.f - k.ay) * (v01 - v00) + k.ay * (v11 - v10));
    if (NEED_DIMG) {
      float* d = dst + c * plane;
      if (w00 != 0.f) atomicAdd(d + k.o00, w00 * gc);
      if (w01 != 0.f) atomicAdd(d + k.o01, w01 * gc);
      if (w10 != 0.f) atomicAdd(d + k.o10, w10 * gc);
      if (w11 != 0.f) atomicAdd(d + k.o11, w11 * gc);
    }
  }
  F* df = dflow + b * 2 * plane + y * W + x;
  store(df, k.live_y ? gy : 0.f);
  store(df + plane, k.live_x ? gx : 0.f);
}

template <typename T, typename F>
void launch(const void* img, const void* flow, void* out, void* mask, int64_t B, int64_t C,
            int64_t H, int64_t W, int64_t fsb, int64_t fsc, int64_t fsh, int64_t fsw,
            int64_t r, int zeros, dim3 grid, dim3 block, cudaStream_t stream) {
  warp2d_kernel<T, F><<<grid, block, 0, stream>>>(
      static_cast<const T*>(img), static_cast<const F*>(flow), static_cast<T*>(out),
      static_cast<T*>(mask), (int)B, (int)C, (int)H, (int)W, fsb, fsc, fsh, fsw, (float)r, zeros);
}

template <typename T, typename F>
void launch_bwd(const void* img, const void* flow, const void* g, void* dflow,
                void* dimg, int64_t B, int64_t C, int64_t H, int64_t W,
                const int64_t* fs, const int64_t* gs, int64_t r, int zeros,
                cudaStream_t stream) {
  const int threads = 256;
  const int64_t n = B * H * W;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const T* i = static_cast<const T*>(img);
  const F* f = static_cast<const F*>(flow);
  const T* gg = static_cast<const T*>(g);
  F* df = static_cast<F*>(dflow);
  float* di = static_cast<float*>(dimg);
  if (dimg)
    warp2d_bwd_kernel<T, F, true><<<blocks, threads, 0, stream>>>(
        i, f, gg, df, di, B, C, H, W, fs[0], fs[1], fs[2], fs[3], gs[0], gs[1],
        gs[2], gs[3], (float)r, zeros);
  else
    warp2d_bwd_kernel<T, F, false><<<blocks, threads, 0, stream>>>(
        i, f, gg, df, di, B, C, H, W, fs[0], fs[1], fs[2], fs[3], gs[0], gs[1],
        gs[2], gs[3], (float)r, zeros);
}

}  // namespace

// img [B, C, H, W] contiguous; flow [B, 2, H, W] with strides (fsb, fsc, fsh, fsw);
// out [B, C, H, W] contiguous; mask null or [B, 1, H, W] contiguous in the
// image's dtype.  bf16 = 0: all f32; 1: all bf16; 2: img, out and mask bf16,
// flow f32.  H * W < 2^31.  The launch geometry, (gx, gy, gz) blocks of (tx,
// ty) threads with kV = 4 pixels each, comes from the wrapper
// (ops/kernels/warp.py::launch_geometry): gx * tx * 4 >= W, else the call is
// refused, and any gy, gz within the grid's limits (rows and batch are
// grid-stride loops).
extern "C" int warp2d_forward(const void* img, const void* flow, void* out, void* mask,
                              int64_t B, int64_t C, int64_t H, int64_t W,
                              int64_t fsb, int64_t fsc, int64_t fsh,
                              int64_t fsw, int64_t r, int64_t zeros,
                              int64_t bf16, int64_t gx, int64_t gy, int64_t gz,
                              int64_t tx, int64_t ty, void* stream) {
  if (gx * tx * kV < W) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int z = zeros ? 1 : 0;
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz), block((unsigned)tx, (unsigned)ty);
  if (bf16 == 2)
    launch<__nv_bfloat16, float>(img, flow, out, mask, B, C, H, W, fsb, fsc, fsh, fsw, r, z,
                                 grid, block, s);
  else if (bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(img, flow, out, mask, B, C, H, W, fsb, fsc, fsh, fsw,
                                         r, z, grid, block, s);
  else
    launch<float, float>(img, flow, out, mask, B, C, H, W, fsb, fsc, fsh, fsw, r, z, grid,
                         block, s);
  return (int)cudaGetLastError();
}

// img [B, C, H, W] contiguous; flow [B, 2, H, W] and g [B, C, H, W] with the
// given strides; dflow [B, 2, H, W] contiguous, every element written.  bf16 =
// 0: img, flow, g and dflow f32; 1: all bf16; 2: img and g bf16, flow and dflow
// f32.  dimg is null (no image
// gradient wanted) or a zero-filled contiguous f32 [B, C, H, W] buffer that
// the kernel adds into.  H * W < 2^31.
extern "C" int warp2d_backward(const void* img, const void* flow, const void* g,
                               void* dflow, void* dimg, int64_t B, int64_t C,
                               int64_t H, int64_t W, int64_t fsb, int64_t fsc,
                               int64_t fsh, int64_t fsw, int64_t gsb,
                               int64_t gsc, int64_t gsh, int64_t gsw, int64_t r,
                               int64_t zeros, int64_t bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int z = zeros ? 1 : 0;
  const int64_t fs[4] = {fsb, fsc, fsh, fsw};
  const int64_t gs[4] = {gsb, gsc, gsh, gsw};
  if (bf16 == 2)
    launch_bwd<__nv_bfloat16, float>(img, flow, g, dflow, dimg, B, C, H, W, fs, gs, r, z, s);
  else if (bf16)
    launch_bwd<__nv_bfloat16, __nv_bfloat16>(img, flow, g, dflow, dimg, B, C, H, W, fs, gs, r, z, s);
  else
    launch_bwd<float, float>(img, flow, g, dflow, dimg, B, C, H, W, fs, gs, r, z, s);
  return (int)cudaGetLastError();
}
