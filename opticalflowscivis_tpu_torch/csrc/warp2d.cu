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
// Backward design.  At 24 B a pixel (f32, one channel) the backward, like the
// forward, is held by per-thread instructions and loads in flight, not by
// DRAM; at UPFlow's deep coarse levels (3,328 pixels under 128 channels at
// /32) by the pixels alone, which leave most of the card empty; and wherever
// dimg is wanted by the L2's atomic updates, several to each image element.
// It runs on the forward's row grid (ops/kernels/warp.py::backward_geometry):
// a thread holds kV = 4 pixels of one row (consecutive, or blockDim.x apart
// for dimg over several channels), rows and batch are grid-stride loops, no
// index is divided, and the corner offsets are 32-bit with a 64-bit (b, c)
// base.  Where the pixels alone cannot fill the card and
// C > 3, the block's third dimension splits the channels into groups, each
// walking its share for the same pixels; the partial dflow sums meet in shared
// memory and are added in group order by one thread per pixel, which alone
// writes dflow (two runs agree bit for bit).  The geometry picks the groups
// from the shape alone, one at C <= 3 (RIFE's one channel, the photometric
// three), where the shared memory and the barriers are compiled away.  Per row
// a thread reads the flow with `load_flow_row` (a channels-last (dy, dx) pair
// one load, a contiguous row of 4 one vector load) and g with `load_row`,
// gathers the 4 x 4 corners of a channel through the read-only path, and
// writes dflow's rows with one vector store each where aligned; the element
// path takes ragged rows, misaligned slices and channels-last tensors.  f32
// arithmetic, stored in the dtype of the image (f32 or bf16).  The flow and
// dflow share the image's dtype, or are f32 beside a bf16 image: UPFlow keeps
// its flows in f32 while its features run in bf16, and rounding a 40-pixel
// flow to bf16 would move the taps by a quarter pixel.  Forward and backward
// share `make_taps`, so the backward recomputes exactly the forward's clip,
// coordinate clamp, corners and weights; a flow component at or beyond r gets
// exactly 0.  dimg is accumulated with f32 atomic adds into an f32 buffer that
// the wrapper zero-fills and casts afterwards (bf16 atomics would round every
// add), skipping corners of weight 0: at one channel a pixel's two corners of
// a row in one vector atomic (sm_90), over several channels a warp's lanes on
// consecutive pixels, so fewer updates reach the L2 either way.  The flow and
// g are read through their four strides, so the model's channel slices of a
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

constexpr int kV = 4;  // output pixels of one row per thread, forward and backward

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

// Four element strides of a [B, C, H, W] view.
struct Strides {
  int64_t b, c, h, w;
};

// dimg's atomic adds into the f32 buffer.  Hopper adds 2 or 4 consecutive
// floats in one vector atomic (8 B / 16 B aligned); the buffer is 16 B
// aligned and padded by 4 floats (the wrapper's), so a 16 B window that holds
// the values may reach past them, adding 0 to its other elements.

// a to p[0] and b to p[1]: one vector atomic unless a 16 B boundary splits them
__device__ __forceinline__ void add_pair(float* p, float a, float b) {
  if (a == 0.f && b == 0.f) return;
  const unsigned q = (unsigned)(reinterpret_cast<uintptr_t>(p) >> 2) & 3u;
  if ((q & 1u) == 0) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
  } else if (q == 1u) {
    atomicAdd(reinterpret_cast<float4*>(p - 1), make_float4(0.f, a, b, 0.f));
  } else {
    if (a != 0.f) atomicAdd(p, a);
    if (b != 0.f) atomicAdd(p + 1, b);
  }
}

constexpr int kBwdThreads = 256;  // at most per backward block: its __launch_bounds__

// NEED_DIMG = false compiles the image-gradient scatter away: the model's
// warps sample input frames, which carry no gradient.  A thread holds kV = 4
// pixels of one row.  They are consecutive in x, so that its flow, g and
// dflow rows move as vectors and, for dimg at one channel, each pixel's two
// corners of a row go in one vector atomic where 16 B alignment allows;
// except for dimg over several channels (SPREAD: UPFlow's feature warps),
// where they lie blockDim.x apart, as in warp3d_bwd, so that a warp's lanes
// sit on consecutive pixels and, under a smooth flow, a warp's scalar atomics
// fall on few sectors of the L2.  On an NVIDIA H100 80GB HBM3 at 700 W:
// consecutive pixels ran RIFE's one-channel dimg 1.2-1.5 times faster,
// spread ones UPFlow's train step's dimg calls at /4 and /8 1.1-1.3 times
// faster.  The corners' weight flags and the clip's flags are held as bits
// of one register.  CHANNELS: kOne, one channel (RIFE's), no channel loop
// (the loop's instance ran RIFE's shape 4 % slower in f32 and 20 % in bf16);
// kLoop, a channel loop that recomputes the taps per channel (held across it
// they took the registers that let a third block share an SM without dimg);
// kGroups, the block's threadIdx.z splits the channels into blockDim.z
// groups of consecutive channels, each walking its share for the same pixels
// with the taps held; the groups' partial dflow sums meet in shared memory and
// are added in group order by the group-0 thread, which alone writes dflow, so
// two runs agree bit for bit.  Without groups the shared memory and the
// barriers are compiled away.
enum Channels { kOne, kLoop, kGroups };

// Blocks of 256 threads an SM that an instance's registers leave room for
// (its __launch_bounds__): one channel without dimg at most 64 registers, with
// dimg 80, the channel loop 80 without dimg and 128 with it (at 80 it
// spilled), the grouped ones, which hold their taps across the channel loop,
// 128 (at 80 they spilled).  None ran slower than with fewer blocks on an
// NVIDIA H100 80GB HBM3 at 700 W.
constexpr int bwd_min_blocks(bool need_dimg, int channels) {
  if (channels == kOne) return need_dimg ? 3 : 4;
  return channels == kLoop && !need_dimg ? 3 : 2;
}

template <typename T, typename F, bool NEED_DIMG, int CHANNELS>
__global__ void __launch_bounds__(kBwdThreads, bwd_min_blocks(NEED_DIMG, CHANNELS))
warp2d_bwd_kernel(const T* __restrict__ img, const F* __restrict__ flow,
                  const T* __restrict__ g, F* __restrict__ dflow, float* __restrict__ dimg,
                  int B, int C, int H, int W, Strides fs, Strides gs, float r, int zeros) {
  constexpr bool GROUPED = CHANNELS == kGroups;
  constexpr bool SPREAD = NEED_DIMG && CHANNELS != kOne;
  // a block covers blockDim.x * kV pixels of a row: each thread kV consecutive
  // ones, or (SPREAD) kV at a stride of sx = blockDim.x
  const int sx = SPREAD ? (int)blockDim.x : 1;
  const int first_x = (int)(blockIdx.x * blockDim.x) * kV + (SPREAD ? (int)threadIdx.x
                                                                     : (int)threadIdx.x * kV);
  // a grouped block's threads all reach its barriers, those past the row too
  if (!GROUPED && first_x >= W) return;
  const int n = first_x < W ? min(kV, (W - first_x + sx - 1) / sx) : 0;
  int c_begin = 0, c_end = CHANNELS == kOne ? 1 : C;
  if (GROUPED) {
    const int per = (C + (int)blockDim.z - 1) / (int)blockDim.z;
    c_begin = min(C, (int)threadIdx.z * per);
    c_end = min(C, c_begin + per);
  }
  const int plane = H * W;
  // unsigned: a stride past the last row or batch stays below 2^32; the loops
  // run alike for every thread of a block, whose barriers they hold
  for (unsigned b = blockIdx.z; b < (unsigned)B; b += gridDim.z) {
    for (unsigned y0 = blockIdx.y * blockDim.y; y0 < (unsigned)H; y0 += gridDim.y * blockDim.y) {
      const unsigned y = y0 + threadIdx.y;
      const bool active = n > 0 && y < (unsigned)H;
      float gy[kV], gx[kV];
#pragma unroll
      for (int j = 0; j < kV; ++j) gy[j] = gx[j] = 0.f;
      // bit 4j + k: corner k of pixel j carries weight (always in border
      // mode); bit 16 + j / 20 + j: pixel j's dy / dx passes the clip
      unsigned bits = 0;
      int x0 = first_x;
      asm volatile("" : "+r"(x0));
      if (active) {
        float dy[kV], dx[kV];
        load_flow_row<kV>(flow + (int64_t)b * fs.b + (int64_t)y * fs.h + x0 * fs.w, fs.c,
                          fs.w * sx, n, dy, dx);
        float ay[kV], ax[kV];
        int o[kV][4];
        auto taps = [&]() {
          bits = 0;
#pragma unroll
          for (int j = 0; j < kV; ++j) {
            const Taps k = make_taps(dy[j], dx[j], (int)y, x0 + j * sx, H, W, r, zeros);
            ay[j] = k.ay; ax[j] = k.ax;
            o[j][0] = k.o00; o[j][1] = k.o01; o[j][2] = k.o10; o[j][3] = k.o11;
            bits |= (k.m00 != 0.f ? 1u : 0u) << (4 * j) | (k.m01 != 0.f ? 2u : 0u) << (4 * j) |
                    (k.m10 != 0.f ? 4u : 0u) << (4 * j) | (k.m11 != 0.f ? 8u : 0u) << (4 * j) |
                    (k.live_y ? 1u : 0u) << (16 + j) | (k.live_x ? 1u : 0u) << (20 + j);
          }
        };
        if (CHANNELS != kLoop) taps();
        const int64_t base = (int64_t)b * C * plane;
        const T* gp = g + (int64_t)b * gs.b + (int64_t)y * gs.h + x0 * gs.w;
#pragma unroll 1
        for (int c = c_begin; c < c_end; ++c) {
          if (CHANNELS == kLoop) {
#pragma unroll
            for (int j = 0; j < kV; ++j) asm volatile("" : "+f"(dy[j]), "+f"(dx[j]));
            taps();
          }
          float gc[kV];
          load_row<kV>(gp + c * gs.c, gs.w * sx, n, gc);
          const T* p = img + base + (int64_t)c * plane;
#pragma unroll
          for (int j = 0; j < kV; ++j) {
            float v[4];  // the corners, 0 where one carries no weight
#pragma unroll
            for (int k = 0; k < 4; ++k) v[k] = bits >> (4 * j + k) & 1u ? ldg(p + o[j][k]) : 0.f;
            gy[j] += gc[j] * ((1.f - ax[j]) * (v[2] - v[0]) + ax[j] * (v[3] - v[1]));
            gx[j] += gc[j] * ((1.f - ay[j]) * (v[1] - v[0]) + ay[j] * (v[3] - v[2]));
          }
          if (NEED_DIMG) {
            float* d = dimg + base + (int64_t)c * plane;
#pragma unroll
            for (int j = 0; j < kV; ++j) {
              if (j >= n) break;
              const float wy0 = (1.f - ay[j]) * gc[j], wy1 = ay[j] * gc[j];
              float w[4] = {wy0 * (1.f - ax[j]), wy0 * ax[j], wy1 * (1.f - ax[j]), wy1 * ax[j]};
#pragma unroll
              for (int k = 0; k < 4; ++k) w[k] = bits >> (4 * j + k) & 1u ? w[k] : 0.f;
#pragma unroll
              for (int row = 0; row < 4; row += 2) {
                if (!SPREAD && o[j][row + 1] == o[j][row] + 1) {
                  add_pair(d + o[j][row], w[row], w[row + 1]);
                } else {
                  if (w[row] != 0.f) atomicAdd(d + o[j][row], w[row]);
                  if (w[row + 1] != 0.f) atomicAdd(d + o[j][row + 1], w[row + 1]);
                }
              }
            }
          }
        }
      }
      if constexpr (GROUPED) {
        // partial sums of groups 1.. to shared memory, added to group 0's in group order
        __shared__ float part[2 * kV][kBwdThreads];
        const int per_group = (int)(blockDim.x * blockDim.y);
        const int pixel = (int)(threadIdx.y * blockDim.x + threadIdx.x);
        if (threadIdx.z > 0) {
#pragma unroll
          for (int j = 0; j < kV; ++j) {
            part[j][pixel + threadIdx.z * per_group] = gy[j];
            part[kV + j][pixel + threadIdx.z * per_group] = gx[j];
          }
        }
        __syncthreads();
        if (threadIdx.z == 0) {
          for (int k = 1; k < (int)blockDim.z; ++k) {
#pragma unroll
            for (int j = 0; j < kV; ++j) {
              gy[j] += part[j][pixel + k * per_group];
              gx[j] += part[kV + j][pixel + k * per_group];
            }
          }
        }
        __syncthreads();
      }
      if (active && (!GROUPED || threadIdx.z == 0)) {
        // a component at or beyond r carries no gradient: exactly 0
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          gy[j] = bits >> (16 + j) & 1u ? gy[j] : 0.f;
          gx[j] = bits >> (20 + j) & 1u ? gx[j] : 0.f;
        }
        F* df = dflow + (int64_t)b * 2 * plane + (int)y * W + x0;
        if constexpr (!SPREAD) {
          store_row<kV>(df, gy, n);
          store_row<kV>(df + plane, gx, n);
        } else {
#pragma unroll
          for (int j = 0; j < kV; ++j)
            if (j < n) {
              store(df + j * sx, gy[j]);
              store(df + plane + j * sx, gx[j]);
            }
        }
      }
    }
  }
}

template <typename T, typename F>
void launch(const void* img, const void* flow, void* out, void* mask, int64_t B, int64_t C,
            int64_t H, int64_t W, int64_t fsb, int64_t fsc, int64_t fsh, int64_t fsw,
            int64_t r, int zeros, dim3 grid, dim3 block, cudaStream_t stream) {
  warp2d_kernel<T, F><<<grid, block, 0, stream>>>(
      static_cast<const T*>(img), static_cast<const F*>(flow), static_cast<T*>(out),
      static_cast<T*>(mask), (int)B, (int)C, (int)H, (int)W, fsb, fsc, fsh, fsw, (float)r, zeros);
}

template <typename T, typename F, bool NEED_DIMG>
void launch_bwd_channels(const T* img, const F* flow, const T* g, F* dflow, float* dimg,
                         const int64_t* d, const Strides& fs, const Strides& gs, float r,
                         int zeros, dim3 grid, dim3 block, cudaStream_t stream) {
  const int B = (int)d[0], C = (int)d[1], H = (int)d[2], W = (int)d[3];
  if (block.z > 1)
    warp2d_bwd_kernel<T, F, NEED_DIMG, kGroups><<<grid, block, 0, stream>>>(
        img, flow, g, dflow, dimg, B, C, H, W, fs, gs, r, zeros);
  else if (C == 1)
    warp2d_bwd_kernel<T, F, NEED_DIMG, kOne><<<grid, block, 0, stream>>>(
        img, flow, g, dflow, dimg, B, C, H, W, fs, gs, r, zeros);
  else
    warp2d_bwd_kernel<T, F, NEED_DIMG, kLoop><<<grid, block, 0, stream>>>(
        img, flow, g, dflow, dimg, B, C, H, W, fs, gs, r, zeros);
}

template <typename T, typename F>
void launch_bwd(const void* img, const void* flow, const void* g, void* dflow, void* dimg,
                const int64_t* d, const Strides& fs, const Strides& gs, float r, int zeros,
                dim3 grid, dim3 block, cudaStream_t stream) {
  const T* i = static_cast<const T*>(img);
  const F* f = static_cast<const F*>(flow);
  const T* gg = static_cast<const T*>(g);
  F* df = static_cast<F*>(dflow);
  float* di = static_cast<float*>(dimg);
  if (dimg)
    launch_bwd_channels<T, F, true>(i, f, gg, df, di, d, fs, gs, r, zeros, grid, block, stream);
  else
    launch_bwd_channels<T, F, false>(i, f, gg, df, di, d, fs, gs, r, zeros, grid, block, stream);
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
// f32.  dimg is null (no image gradient wanted) or a zero-filled contiguous f32
// [B, C, H, W] buffer, 16 B aligned and followed by 4 more floats, that the
// kernel adds into.  H * W < 2^31.  The launch
// geometry, (gx, gy, gz) blocks of (tx, ty, groups) threads with kV = 4 pixels
// each, comes from the wrapper (ops/kernels/warp.py::backward_geometry):
// gx * tx * 4 >= W, at most 256 threads a block and 64 channel groups, else the
// call is refused; any gy, gz within the grid's limits (rows and batch are
// grid-stride loops).
extern "C" int warp2d_backward(const void* img, const void* flow, const void* g,
                               void* dflow, void* dimg, int64_t B, int64_t C,
                               int64_t H, int64_t W, int64_t fsb, int64_t fsc,
                               int64_t fsh, int64_t fsw, int64_t gsb,
                               int64_t gsc, int64_t gsh, int64_t gsw, int64_t r,
                               int64_t zeros, int64_t bf16, int64_t gx, int64_t gy,
                               int64_t gz, int64_t tx, int64_t ty, int64_t groups,
                               void* stream) {
  if (gx * tx * kV < W || groups < 1 || groups > 64 || tx * ty * groups > kBwdThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int z = zeros ? 1 : 0;
  const int64_t d[4] = {B, C, H, W};
  const Strides fs = {fsb, fsc, fsh, fsw};
  const Strides gs = {gsb, gsc, gsh, gsw};
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz);
  const dim3 block((unsigned)tx, (unsigned)ty, (unsigned)groups);
  if (bf16 == 2)
    launch_bwd<__nv_bfloat16, float>(img, flow, g, dflow, dimg, d, fs, gs, (float)r, z, grid,
                                     block, s);
  else if (bf16)
    launch_bwd<__nv_bfloat16, __nv_bfloat16>(img, flow, g, dflow, dimg, d, fs, gs, (float)r, z,
                                             grid, block, s);
  else
    launch_bwd<float, float>(img, flow, g, dflow, dimg, d, fs, gs, (float)r, z, grid, block, s);
  return (int)cudaGetLastError();
}
