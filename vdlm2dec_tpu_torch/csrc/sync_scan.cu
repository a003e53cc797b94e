// Sync scan for the D8PSK burst search: branch-0 matched filter, atan2 and
// the 17-phase sync residual at every decimated position, in one pass.
//
// Replaces vdlm2dec_tpu/ops/pallas_sync.py::_kernel (the fused filter +
// sync Pallas kernel).  For each channel c and position t it computes, from
// the (C, T, 2) re/im decimated stream y:
//
//   f(s)  = sum_k taps[k] * y[s - 16 + k]          17-tap branch-0 filter
//   p(s)  = atan2(f_im(s), f_re(s))                0 for s < 0
//   a_k   = p(t - 128 + 8k) - sw[k],  k = 0..16    symbol-spaced phases
//   unwrap a_k by +-2 pi steps, fit a line by least squares:
//   fr    = slope,  err = residual energy          (d8psk.c:241-291)
//
// Two numeric modes, chosen at compile time, each reproducing one JAX path
// operation for operation:
//   MODE_STREAM  libm atan2f and running sums relative to the first phase
//                (ops/demod.py polyphase_filter0 + phase_of + _sync_scan_core)
//   MODE_FUSED   Cephes atan2 and the two-pass mean / slope / residual
//                (ops/pallas_sync.py _atan2 + _kernel)
// All arithmetic uses the _rn intrinsics so no multiply-add is contracted
// into an FMA: the results then round exactly as the plain PyTorch
// versions in ops/sync.py do, bit for bit.
//
// What bounds it on an H100.  Per (channel, position) it moves 16 B of
// device memory (8 B of y in, err and fr out, 4 B each) and does about 350
// float32 operations: 66 for the filter (34 multiplies, 32 adds), ~40 for
// the atan2 with its division, 240 for the 16 unwrap-and-sum steps, 7 for
// the fit (the two-pass fused mode ~380).  At (8, 211 848), the 2 s block of
// 8 channels, that is 27.1 MB, 8.1 us at 3.35 TB/s, against 0.60 G
// operations, 8.9 us at the 67 TFLOP/s peak: the operations bound it, not
// memory.  That peak counts a fused multiply-add as two operations, and none
// may fuse here (see above), so the kernel cannot come nearer than 2x.
//
// What the design does about that.
//   * Large tiles.  A block owns 1024 positions of one channel, so the 128
//     phases of history that a tile recomputes cost 12.5 % more filters and
//     atan2s (a 256-position tile pays 50 %).  A stream too short to give
//     every SM two such blocks takes 256-position tiles instead.
//   * A register window for the filter.  Thread i computes the R = 9
//     consecutive phases i*R .. i*R+8 from 25 input samples that it reads
//     once from shared memory and slides through registers: 2.8 shared
//     loads per phase instead of 17.  R is odd, so the 8-byte loads of a
//     half-warp (stride 9 samples) and the phase stores (stride 9 words)
//     fall into distinct banks.
//   * Constants in the instruction stream.  Taps and sync word arrive as
//     a kernel argument (constant bank); every use in the unrolled loops is
//     an immediate operand, not a shared-memory load.
//   * Independent scans interleaved.  Each thread scans 8 positions, a
//     thread-count apart so that the lanes of a warp read consecutive
//     phases; they run four at a time through the unrolled 16-step loop, so
//     four dependency chains are in flight per thread.
//   * The (C, T, 2) filter output and the (C, T) phases never reach device
//     memory; the input window is read with coalesced 8-byte loads.
//
// Measured (vdlm2dec_tpu_torch/kernel_times.py, the kernel's own time, median
// of 7 replays of a CUDA graph, on an NVIDIA H100 80GB HBM3 at 700 W): 0.0279
// ms stream and 0.0299 ms fused at (8, 211 848), 3.1x the bound of 0.0089 /
// 0.0096 ms (0.0303 / 0.0320 ms, 3.4x / 3.3x, when no launch finds its input
// in the L2 cache), where the 256-position, shared-memory-constant kernel
// before it took 0.0352 and 0.0377 ms.  Tile sizes of 512 to 2048 positions
// and 2 to 8 interleaved scans all land within 10 % of that: what is left is
// the instruction count itself (~420 a position, none fused).
// (4, 5 376) and (1, 130), which take the small tile, run in 0.0033 and
// 0.0031 ms against 0.0031 and 0.0026 before.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;                // threads per block
constexpr int HIST = 128;              // sync window history, 16 symbols
constexpr int RING = 16;               // filter history
constexpr int NTAP = 17;

// A tile: R phases per thread (odd: see above), NT * R phases of which the
// first HIST are history, R - 1 positions scanned per thread, GROUP at a
// time.
template <int R_, int GROUP_>
struct Tile {
  static constexpr int R = R_;
  static constexpr int GROUP = GROUP_;
  static constexpr int NPH = NT * R;            // phases a tile computes
  static constexpr int TILE = NPH - HIST;       // positions per block
  static constexpr int NY = NPH + RING;         // input samples it needs
  static constexpr int PER_THREAD = TILE / NT;  // positions a thread scans
  static_assert(R % 2 == 1, "R must be odd (shared-memory banks)");
  static_assert(HIST == NT && PER_THREAD % GROUP == 0, "tile geometry");
};
using BigTile = Tile<9, 4>;            // 1024 positions, 12.5 % recomputed
using SmallTile = Tile<3, 2>;          // 256 positions, for short streams

constexpr int MODE_STREAM = 0;
constexpr int MODE_FUSED = 1;

struct Consts {
  float taps[NTAP];
  float sw[NTAP];
};

// float32 constants, each rounded from the double the JAX source uses
__device__ __forceinline__ float f32(double v) { return (float)v; }

// Cephes atanf-based atan2 (ops/pallas_sync.py::_atan2), branch-free.
__device__ __forceinline__ float cephes_atan2(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const bool swap = ay > ax;
  const float num = swap ? ax : ay;
  const float den = swap ? ay : ax;
  const float z = __fdiv_rn(num, den == 0.0f ? 1.0f : den);
  const bool red = z > f32(0.4142135623730950);
  const float zr = red ? __fdiv_rn(__fsub_rn(z, 1.0f), __fadd_rn(z, 1.0f)) : z;
  const float w = __fmul_rn(zr, zr);
  float p = __fsub_rn(__fmul_rn(f32(8.05374449538e-2), w), f32(1.38776856032e-1));
  p = __fadd_rn(__fmul_rn(p, w), f32(1.99777106478e-1));
  p = __fsub_rn(__fmul_rn(p, w), f32(3.33329491539e-1));
  float r = __fadd_rn(zr, __fmul_rn(__fmul_rn(zr, w), p));
  if (red) r = __fadd_rn(r, f32(0.7853981633974483));
  if (swap) r = __fsub_rn(f32(1.5707963267948966), r);
  if (den == 0.0f) r = 0.0f;
  if (x < 0.0f) r = __fsub_rn(f32(3.141592653589793), r);
  return y < 0.0f ? -r : r;
}

__device__ __forceinline__ float unwrap_step(float pd) {
  const float pi = f32(3.141592653589793);
  const float two_pi = f32(6.283185307179586);
  return pd > pi ? -two_pi : (pd < -pi ? two_pi : 0.0f);
}

template <int MODE, class TL>
__global__ void __launch_bounds__(NT)
sync_scan_kernel(const float2* __restrict__ y, const __grid_constant__ Consts k,
                 float* __restrict__ err, float* __restrict__ fr, int T) {
  constexpr int R = TL::R, GROUP = TL::GROUP, NPH = TL::NPH, NY = TL::NY,
                TILE = TL::TILE, PER_THREAD = TL::PER_THREAD;
  __shared__ float2 ys[NY];
  __shared__ float ph[NPH];

  const int c = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const float2* yc = y + (size_t)c * T;

  // ys[i] = y[t0 - 144 + i], zero outside the stream
  for (int i = threadIdx.x; i < NY; i += NT) {
    const int s = t0 - HIST - RING + i;
    ys[i] = (s >= 0 && s < T) ? yc[s] : make_float2(0.0f, 0.0f);
  }
  __syncthreads();

  // ph[j] = phase at stream position t0 - 128 + j, for j = j0 .. j0 + R - 1:
  // win holds ys[j0 .. j0 + R + 15], every sample read once
  {
    const int j0 = threadIdx.x * R;
    float2 win[R + RING];
#pragma unroll
    for (int i = 0; i < R + RING; ++i) win[i] = ys[j0 + i];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float fre = __fmul_rn(k.taps[0], win[r].x);
      float fim = __fmul_rn(k.taps[0], win[r].y);
#pragma unroll
      for (int n = 1; n < NTAP; ++n) {
        fre = __fadd_rn(fre, __fmul_rn(k.taps[n], win[r + n].x));
        fim = __fadd_rn(fim, __fmul_rn(k.taps[n], win[r + n].y));
      }
      float p = MODE == MODE_STREAM ? atan2f(fim, fre) : cephes_atan2(fim, fre);
      if (t0 - HIST + j0 + r < 0) p = 0.0f;
      ph[j0 + r] = p;
    }
  }
  __syncthreads();

  // GROUP positions at a time, NT apart: pw[g][8n] = phase at t - 128 + 8n
#pragma unroll 1
  for (int m = 0; m < PER_THREAD; m += GROUP) {
    const float* pw = ph + m * NT + threadIdx.x;
    float e[GROUP], f[GROUP];
    if (MODE == MODE_STREAM) {
      // running sums of the unwrapped phases relative to the first one
      float a0[GROUP], p_prev[GROUP], cum[GROUP], s0[GROUP], s1[GROUP],
          s2[GROUP];
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        a0[g] = __fsub_rn(pw[g * NT], k.sw[0]);
        p_prev[g] = a0[g];
        cum[g] = s0[g] = s1[g] = s2[g] = 0.0f;
      }
#pragma unroll
      for (int n = 1; n < NTAP; ++n) {
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          const float pk = __fsub_rn(pw[g * NT + 8 * n], k.sw[n]);
          cum[g] = __fadd_rn(cum[g], unwrap_step(__fsub_rn(pk, p_prev[g])));
          const float pr = __fadd_rn(__fsub_rn(pk, a0[g]), cum[g]);
          s0[g] = __fadd_rn(s0[g], pr);
          s1[g] = __fadd_rn(s1[g], __fmul_rn((float)(n - 8), pr));
          s2[g] = __fadd_rn(s2[g], __fmul_rn(pr, pr));
          p_prev[g] = pk;
        }
      }
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        f[g] = __fdiv_rn(s1[g], 408.0f);
        e[g] = __fsub_rn(
            __fsub_rn(s2[g],
                      __fmul_rn(__fmul_rn(s0[g], s0[g]), f32(1.0 / 17.0))),
            __fmul_rn(s1[g], f[g]));
      }
    } else {
      // two-pass: unwrapped phases, their mean, slope, then residual
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        float pr[NTAP];
        float a_prev = __fsub_rn(pw[g * NT], k.sw[0]);
        float cum = 0.0f;
        pr[0] = a_prev;
#pragma unroll
        for (int n = 1; n < NTAP; ++n) {
          const float an = __fsub_rn(pw[g * NT + 8 * n], k.sw[n]);
          cum = __fadd_rn(cum, unwrap_step(__fsub_rn(an, a_prev)));
          pr[n] = __fadd_rn(an, cum);
          a_prev = an;
        }
        float mean = pr[0];
#pragma unroll
        for (int n = 1; n < NTAP; ++n) mean = __fadd_rn(mean, pr[n]);
        mean = __fmul_rn(mean, f32(1.0 / 17.0));
        float num = 0.0f;
#pragma unroll
        for (int n = 0; n < NTAP; ++n)
          num = __fadd_rn(num,
                          __fmul_rn(__fsub_rn(pr[n], mean), (float)(n - 8)));
        f[g] = __fmul_rn(num, f32(1.0 / 408.0));
        float acc = 0.0f;
#pragma unroll
        for (int n = 0; n < NTAP; ++n) {
          const float d = __fsub_rn(__fsub_rn(pr[n], mean),
                                    __fmul_rn((float)(n - 8), f[g]));
          acc = __fadd_rn(acc, __fmul_rn(d, d));
        }
        e[g] = acc;
      }
    }
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const int t = t0 + (m + g) * NT + threadIdx.x;
      if (t < T) {
        err[(size_t)c * T + t] = e[g];
        fr[(size_t)c * T + t] = f[g];
      }
    }
  }
}

template <class TL>
void launch(const float2* y, const Consts& k, float* err, float* fr, int C,
            int T, int mode, cudaStream_t s) {
  const dim3 grid((T + TL::TILE - 1) / TL::TILE, C);
  if (mode == MODE_STREAM)
    sync_scan_kernel<MODE_STREAM, TL><<<grid, NT, 0, s>>>(y, k, err, fr, T);
  else
    sync_scan_kernel<MODE_FUSED, TL><<<grid, NT, 0, s>>>(y, k, err, fr, T);
}

}  // namespace

// y: (C, T, 2) float32 contiguous on the device; taps, sw: 17 float32 each
// in HOST memory (they travel as a kernel argument); err, fr: (C, T) float32
// on the device.  Launches on `stream` and returns cudaGetLastError().
extern "C" int vdl2_sync_scan(const float* y, const float* taps,
                              const float* sw, float* err, float* fr, int C,
                              int T, int mode, void* stream) {
  if (C <= 0 || T <= 0 || C > 65535) return (int)cudaErrorInvalidValue;
  Consts k;
  for (int i = 0; i < NTAP; ++i) {
    k.taps[i] = taps[i];
    k.sw[i] = sw[i];
  }
  if (mode != MODE_STREAM && mode != MODE_FUSED)
    return (int)cudaErrorInvalidValue;
  static int sm_count[64];               // by device, asked once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int n_sm = dev < 64 ? sm_count[dev] : 0;
  if (!n_sm) {
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) sm_count[dev] = n_sm;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* y2 = reinterpret_cast<const float2*>(y);
  // the big tile once it gives every SM two blocks, else the small one: a
  // short stream needs the blocks more than it minds the recomputed history
  const long big_blocks = (long)C * ((T + BigTile::TILE - 1) / BigTile::TILE);
  if (big_blocks >= 2L * n_sm)
    launch<BigTile>(y2, k, err, fr, C, T, mode, s);
  else
    launch<SmallTile>(y2, k, err, fr, C, T, mode, s);
  return (int)cudaGetLastError();
}
