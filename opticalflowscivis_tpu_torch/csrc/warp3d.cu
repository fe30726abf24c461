// Trilinear backward warp of volumes, forward pass and its VJP, for Hopper (sm_90a).
//
// Replaces the slab warp of opticalflowscivis_tpu/ops/warp.py
// (_slab_warp_core / backward_warp3d_slab): on the TPU a scan over 2*r_z+3
// z-taps, each one launch of the bilinear Pallas kernel
// (ops/pallas/warp.py::backward_warp_pallas, z folded into its batch) weighted
// by the hat function max(0, 1 - |flow_z - s|), and under a gradient the fused
// Pallas VJP once per tap.  That decomposition exists because the TPU cannot
// gather from a volume that exceeds its VMEM; of the taps only two carry weight
// per voxel.  The GPU gathers the 8 corners directly, so this kernel computes
// the function of the slab warp, not its scan:
//
//   (dz, dy, dx) = flow[b, :, z, y, x]; dz clipped to +-r_z when r_z > 0,
//                  dy and dx to +-r_yx when r_yx > 0 (the bounded 2-D kernel's
//                  clip on the TPU path)
//   out[b, c, z, y, x] = sum over the 8 corners of w_corner * img[b, c, iz, iy, ix]
//   border: corner indices clamped to the volume (the slab's edge-padded z
//           taps and the 2-D kernel's edge pad);
//   zeros:  out-of-range corners dropped on all three axes.  That equals the
//           slab's in-plane zeros x clip(sum of in-range z weights): with one of
//           the two live z-taps out of range the edge slab stands in for it and
//           the scale removes exactly its weight.
//
//   dimg[b, c, iz, iy, ix] += w_corner * g[b, c, z, y, x]        (f32 atomics)
//   dflow[b, k, z, y, x]    = sum_c g * d out / d flow_k, exactly 0 for a
//                             component at or beyond its radius
//
// Bound: device-memory bytes.  The forward at [4,1,64,64,64] f32 moves 1.05 M
// voxels x (4 B image + 12 B flow + 4 B out) and does ~70 flops per voxel, far
// below the card's compute rate; the backward reads image, flow and g and
// writes 12 B of dflow, and for dimg adds a zero-fill and a read-modify-write of
// the image's size.  The 8 taps of a voxel lie within +-(r+1) of it on each
// axis, so neighbouring threads' gathers and atomics hit L1 and L2.
//
// Forward design.  At 20 B per voxel, per-thread instructions and bytes in
// flight set the time, not DRAM.  The grid is (x tiles, row tiles, B * Z),
// computed by the wrapper; a thread holds kV = 2 consecutive x of one row, so
// the only index arithmetic is one 32-bit division of the plane index by Z
// per plane, and a grid-stride loop over rows and planes takes over beyond the
// grid's 65535 limit.  The forward holds the eight corner offsets in 32 bits
// (the wrapper refuses a volume of 2^31 voxels or more); only the (b, c) base
// is 64-bit.  Each flow channel of a row is one 8 B (bf16: 4 B) load where it
// is contiguous in x and aligned, else read element by element (the
// channels-last-3d layout, ragged rows); the output row is one vector store
// where aligned; the image is gathered through the read-only path, 16 loads in
// flight per thread.  At most 80 registers, so that 3 blocks of 256 threads
// share an SM.  On iid random flows the gathers are the limit: each touches
// its own cache line, as in F.grid_sample, which the kernel then only ties.
//
// Backward design.  At 32 B per voxel (f32) the backward, like the forward,
// is held by per-thread instructions and loads in flight, not by DRAM: on
// smooth flows it is issue-bound, on iid flows the gathers bind.  It runs on
// the forward's grid (launch_geometry): a thread holds kV = 2 voxels of one
// row, planes B * Z and rows are grid-stride loops, the only division is the
// 32-bit one of the plane index by Z, and the corner offsets are 32-bit with a
// 64-bit (b, c) base.  Per row a thread reads the three flow channels and each
// channel of g with `load_row` (one vector load where the row is contiguous in
// x and aligned, else element by element: the channels-last-3d layout,
// misaligned slices, ragged rows), gathers the 2 x 8 corners of a channel
// through the read-only path (16 loads in flight), and writes each dflow
// component's pair with one vector store where aligned.  Forward and backward
// share `make_taps`, so the backward recomputes exactly the forward's clips,
// coordinate clamp, corners and weights.  dflow is written once per voxel with
// no atomics, so two runs agree bit for bit; a component at or beyond its
// radius adds nothing and stays exactly 0.  The instances, all driven by the
// card checks: f32 or bf16; with or without dimg (the model's warps sample
// input frames, which carry no gradient, so every call of a training step
// compiles the scatter away); one channel (every volume of the 3-D models: no
// channel loop, at most 64 registers, 4 blocks of 256 threads an SM) or a
// channel loop (128); border padding (the model's: no corner masks) or zeros.
// dimg is accumulated with f32 atomicAdd into an f32 buffer that the wrapper
// zero-fills and casts afterwards; there a thread's two voxels lie blockDim.x
// apart, so that the lanes of each atomic add hit consecutive voxels.  The
// flow and g are read through their five strides, so the model's channel
// slices of a 6-channel flow, and tensors in the channels-last-3d layout cuDNN
// may hand back, need no copy.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError() after
// the launch.

#include "warp_io.cuh"

namespace {

constexpr int kV = 2;  // output voxels of one row per thread

// Five element strides of a [B, C, Z, Y, X] view.
struct Strides {
  int64_t b, c, z, y, x;
};

// The eight corners of one output voxel, indexed k = 4*hz + 2*hy + hx (the
// corner order of the plain version): trilinear fractions, per-corner validity
// (always 1 in border mode), clamped offsets into one image volume, and whether
// each flow component passes a gradient through its clip.  The offsets are
// 32-bit: the wrappers refuse volumes of 2^31 voxels or more.
struct Taps {
  float az, ay, ax;
  float m[8];
  int o[8];
  bool live_z, live_y, live_x;
};

// One axis: clip the displacement to +-r (r = 0: none), clamp the coordinate to
// one voxel outside the volume (hi = n + 1), split it into floor and fraction.
// Coordinates further outside sample the same values (border) or nothing
// (zeros) wherever they lie; the clamp keeps the integer conversion in range
// for unbounded flows.
__device__ __forceinline__ void axis_taps(float d, int i, int n, float hi, float r, int zeros,
                                          float* frac, int* c0, int* c1, float* v0, float* v1,
                                          bool* live) {
  // strict <: a flow exactly on +-r is clamped and carries no gradient
  *live = !(r > 0.f) || fabsf(d) < r;
  if (r > 0.f) d = fminf(fmaxf(d, -r), r);
  const float s = fminf(fmaxf((float)i + d, -2.f), hi);
  const float f = floorf(s);
  *frac = s - f;
  const int i0 = (int)f, i1 = i0 + 1;
  *v0 = (!zeros || (i0 >= 0 && i0 < n)) ? 1.f : 0.f;
  *v1 = (!zeros || (i1 >= 0 && i1 < n)) ? 1.f : 0.f;
  *c0 = min(max(i0, 0), n - 1);
  *c1 = min(max(i1, 0), n - 1);
}

// The clamp limits (Z + 1, Y + 1, X + 1) as floats.
struct Limits {
  float z, y, x;
};

__device__ __forceinline__ Taps make_taps(float dz, float dy, float dx, int z, int y,
                                          int x, int Z, int Y, int X, float r_z, float r_yx,
                                          int zeros, Limits hi) {
  Taps t;
  int cz[2], cy[2], cx[2];
  float vz[2], vy[2], vx[2];
  axis_taps(dz, z, Z, hi.z, r_z, zeros, &t.az, &cz[0], &cz[1], &vz[0], &vz[1], &t.live_z);
  axis_taps(dy, y, Y, hi.y, r_yx, zeros, &t.ay, &cy[0], &cy[1], &vy[0], &vy[1], &t.live_y);
  axis_taps(dx, x, X, hi.x, r_yx, zeros, &t.ax, &cx[0], &cx[1], &vx[0], &vx[1], &t.live_x);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int hz = k >> 2, hy = (k >> 1) & 1, hx = k & 1;
    t.m[k] = vz[hz] * vy[hy] * vx[hx];
    t.o[k] = (cz[hz] * Y + cy[hy]) * X + cx[hx];
  }
  return t;
}

__device__ __forceinline__ Taps make_taps(float dz, float dy, float dx, int z, int y,
                                          int x, int Z, int Y, int X, float r_z, float r_yx,
                                          int zeros) {
  return make_taps(dz, dy, dx, z, y, x, Z, Y, X, r_z, r_yx, zeros,
                   {(float)Z + 1.f, (float)Y + 1.f, (float)X + 1.f});
}

// w[k] = ((wz * wy) * wx) * m[k], the weight product of the plain version.
__device__ __forceinline__ void corner_weights(const Taps& t, float* w) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float wz = (k >> 2) ? t.az : 1.f - t.az;
    const float wy = ((k >> 1) & 1) ? t.ay : 1.f - t.ay;
    const float wx = (k & 1) ? t.ax : 1.f - t.ax;
    w[k] = wz * wy * wx * t.m[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(256, 3)
warp3d_kernel(const T* __restrict__ img, const T* __restrict__ flow, T* __restrict__ out, int B,
              int C, int Z, int Y, int X, Strides fs, float r_z, float r_yx, int zeros) {
  const unsigned xt = blockIdx.x * blockDim.x + threadIdx.x;
  if (xt >= ((unsigned)X + kV - 1) / kV) return;
  const int x0 = (int)xt * kV;
  const int n = min(kV, X - x0);
  const int vol = Z * Y * X;
  // unsigned: a stride past the last row or plane stays below 2^32 (B * Z < 2^31)
  for (unsigned p = blockIdx.z; p < (unsigned)B * Z; p += gridDim.z) {
    const unsigned b = p / Z, z = p - b * Z;
    for (unsigned y = blockIdx.y * blockDim.y + threadIdx.y; y < (unsigned)Y;
         y += gridDim.y * blockDim.y) {
      const T* f = flow + (int64_t)b * fs.b + (int64_t)z * fs.z + (int64_t)y * fs.y + x0 * fs.x;
      float dz[kV], dy[kV], dx[kV];
      load_row<kV>(f, fs.x, n, dz);
      load_row<kV>(f + fs.c, fs.x, n, dy);
      load_row<kV>(f + 2 * fs.c, fs.x, n, dx);
      float w[kV][8];
      int o[kV][8];
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const Taps k = make_taps(dz[j], dy[j], dx[j], (int)z, (int)y, x0 + j, Z, Y, X, r_z,
                                 r_yx, zeros);
        corner_weights(k, w[j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) o[j][i] = k.o[i];
      }
      const int64_t base = (int64_t)b * C * vol;
      const int at = ((int)z * Y + (int)y) * X + x0;
      for (int c = 0; c < C; ++c) {
        const T* src = img + base + (int64_t)c * vol;
        float acc[kV];
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) a += w[j][i] * ldg(src + o[j][i]);
          acc[j] = a;
        }
        store_row<kV>(out + base + (int64_t)c * vol + at, acc, n);
      }
    }
  }
}

// V values to p, p + step, ..., the first n of them: one vector store where
// the voxels are consecutive and aligned (store_row), else one by one.
template <int V, typename T>
__device__ __forceinline__ void store_voxels(T* p, int step, const float* v, int n) {
  if (step == 1) {
    store_row<V>(p, v, n);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (j < n) store(p + j * step, v[j]);
}

// NEED_DIMG = false compiles the image-gradient scatter away.  Without it a
// thread's two voxels are consecutive in x, so that its flow, g and dflow
// pairs move as vectors; with it they lie blockDim.x apart, so that the lanes
// of each atomic add hit consecutive voxels (consecutive pairs spread each
// atomic over twice the sectors and, on smooth flows, ran slower than one
// voxel a thread).  ONE_CHANNEL: C = 1, no channel loop.  ZEROS: the padding;
// border computes no corner masks.  A one-channel kernel without dimg keeps
// to 64 registers, 4 blocks of 256 threads an SM: on iid flows the gathers in
// flight per SM set the time, on smooth flows the issue rate.
template <typename T, bool NEED_DIMG, bool ONE_CHANNEL, bool ZEROS>
__global__ void __launch_bounds__(256, ONE_CHANNEL && !NEED_DIMG ? 4 : 2)
warp3d_bwd_kernel(const T* __restrict__ img, const T* __restrict__ flow,
                  const T* __restrict__ g, T* __restrict__ dflow, float* __restrict__ dimg,
                  int B, int C, int Z, int Y, int X, Strides fs, Strides gs, float r_z,
                  float r_yx, Limits hi) {
  static_assert(kV == 2, "n below counts the voxels of a pair");
  // x of a thread's first voxel, and the step to its second
  const int step = NEED_DIMG ? (int)blockDim.x : 1;
  const int first_x = NEED_DIMG ? (int)(blockIdx.x * blockDim.x * kV + threadIdx.x)
                                : (int)(blockIdx.x * blockDim.x + threadIdx.x) * kV;
  if (first_x >= X) return;
  const int vol = Z * Y * X;
  // unsigned: a stride past the last row or plane stays below 2^32 (B * Z < 2^31)
  for (unsigned p = blockIdx.z; p < (unsigned)B * Z; p += gridDim.z) {
    const unsigned b = p / Z, z = p - b * Z;
    for (unsigned y = blockIdx.y * blockDim.y + threadIdx.y; y < (unsigned)Y;
         y += gridDim.y * blockDim.y) {
      // what derives from x0 is computed per row: held across the row and
      // plane loops (which a thread walks once unless the grid is cut at
      // 65535), it took registers that the 64-register kernels spilled
      int x0 = first_x;
      asm volatile("" : "+r"(x0));
      const int n = x0 + step < X ? 2 : 1;
      const T* f = flow + (int64_t)b * fs.b + (int64_t)z * fs.z + (int64_t)y * fs.y + x0 * fs.x;
      float dz[kV], dy[kV], dx[kV];
      load_row<kV>(f, fs.x * step, n, dz);
      load_row<kV>(f + fs.c, fs.x * step, n, dy);
      load_row<kV>(f + 2 * fs.c, fs.x * step, n, dx);
      const int64_t base = (int64_t)b * C * vol;
      const T* gp = g + (int64_t)b * gs.b + (int64_t)z * gs.z + (int64_t)y * gs.y + x0 * gs.x;
      float gz[kV], gy[kV], gx[kV];
#pragma unroll
      for (int j = 0; j < kV; ++j) gz[j] = gy[j] = gx[j] = 0.f;
      const int channels = ONE_CHANNEL ? 1 : C;
#pragma unroll 1
      for (int c = 0; c < channels; ++c) {
        if (!ONE_CHANNEL) {
          // the taps are recomputed per channel: hoisted out of the loop, the
          // 2 x 8 offsets and weights would be held across it and spill
#pragma unroll
          for (int j = 0; j < kV; ++j) asm volatile("" : "+f"(dz[j]), "+f"(dy[j]), "+f"(dx[j]));
        }
        float gc[kV];
        load_row<kV>(gp + c * gs.c, gs.x * step, n, gc);
        const T* src = img + base + (int64_t)c * vol;
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          const Taps k = make_taps(dz[j], dy[j], dx[j], (int)z, (int)y, x0 + j * step, Z, Y, X,
                                   r_z, r_yx, ZEROS, hi);
          const float az = k.az, ay = k.ay, ax = k.ax;
          float v[8];  // v[4*hz + 2*hy + hx], dropped corners as 0
#pragma unroll
          for (int i = 0; i < 8; ++i)
            v[i] = !ZEROS || k.m[i] != 0.f ? ldg(src + k.o[i]) : 0.f;
          // d out / d (coordinate) = the difference across that axis,
          // interpolated along the other two; a component at or beyond its
          // radius adds nothing, so its dflow stays exactly 0
          if (k.live_z)
            gz[j] += gc[j] * ((1.f - ay) * ((1.f - ax) * (v[4] - v[0]) + ax * (v[5] - v[1])) +
                              ay * ((1.f - ax) * (v[6] - v[2]) + ax * (v[7] - v[3])));
          if (k.live_y)
            gy[j] += gc[j] * ((1.f - az) * ((1.f - ax) * (v[2] - v[0]) + ax * (v[3] - v[1])) +
                              az * ((1.f - ax) * (v[6] - v[4]) + ax * (v[7] - v[5])));
          if (k.live_x)
            gx[j] += gc[j] * ((1.f - az) * ((1.f - ay) * (v[1] - v[0]) + ay * (v[3] - v[2])) +
                              az * ((1.f - ay) * (v[5] - v[4]) + ay * (v[7] - v[6])));
          if (NEED_DIMG && j < n) {
            float w[8];
            corner_weights(k, w);
            float* dd = dimg + base + (int64_t)c * vol;
#pragma unroll
            for (int i = 0; i < 8; ++i)
              if (w[i] != 0.f) atomicAdd(dd + k.o[i], w[i] * gc[j]);
          }
        }
      }
      T* df = dflow + (int64_t)b * 3 * vol + ((int)z * Y + (int)y) * X + x0;
      store_voxels<kV>(df, step, gz, n);
      store_voxels<kV>(df + vol, step, gy, n);
      store_voxels<kV>(df + 2 * vol, step, gx, n);
    }
  }
}

template <typename T>
void launch(const void* img, const void* flow, void* out, const int64_t* d, const Strides& fs,
            float r_z, float r_yx, int zeros, dim3 grid, dim3 block, cudaStream_t stream) {
  warp3d_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(flow), static_cast<T*>(out), (int)d[0],
      (int)d[1], (int)d[2], (int)d[3], (int)d[4], fs, r_z, r_yx, zeros);
}

template <typename T, bool NEED_DIMG, bool ONE_CHANNEL>
void launch_bwd_padding(const T* img, const T* flow, const T* g, T* dflow, float* dimg,
                        const int64_t* d, const Strides& fs, const Strides& gs, float r_z,
                        float r_yx, int zeros, dim3 grid, dim3 block, cudaStream_t stream) {
  const int B = (int)d[0], C = (int)d[1], Z = (int)d[2], Y = (int)d[3], X = (int)d[4];
  const Limits hi = {(float)Z + 1.f, (float)Y + 1.f, (float)X + 1.f};
  if (zeros)
    warp3d_bwd_kernel<T, NEED_DIMG, ONE_CHANNEL, true><<<grid, block, 0, stream>>>(
        img, flow, g, dflow, dimg, B, C, Z, Y, X, fs, gs, r_z, r_yx, hi);
  else
    warp3d_bwd_kernel<T, NEED_DIMG, ONE_CHANNEL, false><<<grid, block, 0, stream>>>(
        img, flow, g, dflow, dimg, B, C, Z, Y, X, fs, gs, r_z, r_yx, hi);
}

template <typename T>
void launch_bwd(const void* img, const void* flow, const void* g, void* dflow, void* dimg,
                const int64_t* d, const Strides& fs, const Strides& gs, float r_z, float r_yx,
                int zeros, dim3 grid, dim3 block, cudaStream_t s) {
  const T* i = static_cast<const T*>(img);
  const T* f = static_cast<const T*>(flow);
  const T* gg = static_cast<const T*>(g);
  T* df = static_cast<T*>(dflow);
  float* di = static_cast<float*>(dimg);
  const bool one = d[1] == 1;
  if (dimg && one)
    launch_bwd_padding<T, true, true>(i, f, gg, df, di, d, fs, gs, r_z, r_yx, zeros, grid, block,
                                      s);
  else if (dimg)
    launch_bwd_padding<T, true, false>(i, f, gg, df, di, d, fs, gs, r_z, r_yx, zeros, grid, block,
                                       s);
  else if (one)
    launch_bwd_padding<T, false, true>(i, f, gg, df, di, d, fs, gs, r_z, r_yx, zeros, grid, block,
                                       s);
  else
    launch_bwd_padding<T, false, false>(i, f, gg, df, di, d, fs, gs, r_z, r_yx, zeros, grid,
                                        block, s);
}

}  // namespace

// img [B, C, Z, Y, X] contiguous; flow [B, 3, Z, Y, X] with the element strides
// fs[5] = (batch, channel, z, y, x); out [B, C, Z, Y, X] contiguous.  dims[5] =
// (B, C, Z, Y, X), Z * Y * X < 2^31 and B * Z < 2^31.  All three tensors are
// bf16 (bf16 = 1) or f32 (0).  The launch geometry, (gx, gy, gz) blocks of (tx,
// ty) threads with kV = 2 voxels each, comes from the wrapper
// (ops/kernels/warp.py::launch_geometry): gx * tx * 2 >= X, else the call is
// refused, and any gy, gz within the grid's limits (rows and planes are
// grid-stride loops).
extern "C" int warp3d_forward(const void* img, const void* flow, void* out,
                              const int64_t* dims, const int64_t* fs,
                              int64_t r_z, int64_t r_yx, int64_t zeros,
                              int64_t bf16, int64_t gx, int64_t gy, int64_t gz,
                              int64_t tx, int64_t ty, void* stream) {
  if (gx * tx * kV < dims[4]) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides f = {fs[0], fs[1], fs[2], fs[3], fs[4]};
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz), block((unsigned)tx, (unsigned)ty);
  const int z = zeros ? 1 : 0;
  if (bf16)
    launch<__nv_bfloat16>(img, flow, out, dims, f, (float)r_z, (float)r_yx, z, grid, block, s);
  else
    launch<float>(img, flow, out, dims, f, (float)r_z, (float)r_yx, z, grid, block, s);
  return (int)cudaGetLastError();
}

// img [B, C, Z, Y, X] contiguous; flow [B, 3, Z, Y, X] and g [B, C, Z, Y, X]
// with the element strides fs[5] and gs[5]; dflow [B, 3, Z, Y, X] contiguous,
// every element written.  img, flow, g and dflow are bf16 (bf16 = 1) or f32
// (0).  dimg is null (no image gradient wanted) or a zero-filled contiguous f32
// [B, C, Z, Y, X] buffer that the kernel adds into.  dims, the limits and the
// launch geometry are the forward's: the same launch_geometry, refused unless
// gx * tx * 2 >= X.
extern "C" int warp3d_backward(const void* img, const void* flow, const void* g,
                               void* dflow, void* dimg, const int64_t* dims,
                               const int64_t* fs, const int64_t* gs, int64_t r_z,
                               int64_t r_yx, int64_t zeros, int64_t bf16, int64_t gx,
                               int64_t gy, int64_t gz, int64_t tx, int64_t ty,
                               void* stream) {
  if (gx * tx * kV < dims[4]) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides f = {fs[0], fs[1], fs[2], fs[3], fs[4]};
  const Strides gg = {gs[0], gs[1], gs[2], gs[3], gs[4]};
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz), block((unsigned)tx, (unsigned)ty);
  const int z = zeros ? 1 : 0;
  if (bf16)
    launch_bwd<__nv_bfloat16>(img, flow, g, dflow, dimg, dims, f, gg, (float)r_z, (float)r_yx, z,
                              grid, block, s);
  else
    launch_bwd<float>(img, flow, g, dflow, dimg, dims, f, gg, (float)r_z, (float)r_yx, z, grid,
                      block, s);
  return (int)cudaGetLastError();
}
