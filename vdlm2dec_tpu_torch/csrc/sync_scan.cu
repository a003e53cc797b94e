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
// versions in ops/sync.py do.
//
// What bounds it on an H100: per (channel, position) it moves 16 B of device
// memory (8 B of y in, err and fr out) but executes ~400-500 instructions:
// 1.5 filter phases of 66 multiplies and adds plus an atan2 (~40 with its
// division) each, then a 16-step unwrap and sum scan of ~12 each.  At the
// card's 3.35 TB/s and ~33.5 T fp32 thread-instructions/s that is ~5 ns of
// memory against ~13 ns of instructions per thousand positions: instruction
// throughput, not memory, bounds it, and the design computes nothing twice.
// One block owns 256 positions of one channel, stages their 400-sample
// input window (256 + 144 history) in shared memory with coalesced loads,
// computes the 384 filter phases the window needs once into shared memory
// (1.5 filters and atan2s per position, instead of the 17 a position's
// window reads), and each thread then runs its own scan from shared memory.
// The (C, T, 2) filter output and the (C, T) phases never reach device
// memory.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;              // positions per block (= threads)
constexpr int HIST = 128;              // sync window history, 16 symbols
constexpr int RING = 16;               // filter history
constexpr int NPH = TILE + HIST;       // phases a tile needs
constexpr int NY = NPH + RING;         // input samples a tile needs
constexpr int NTAP = 17;

constexpr int MODE_STREAM = 0;
constexpr int MODE_FUSED = 1;

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

template <int MODE>
__global__ void __launch_bounds__(TILE)
sync_scan_kernel(const float2* __restrict__ y, const float* __restrict__ taps,
                 const float* __restrict__ sw, float* __restrict__ err,
                 float* __restrict__ fr, int T) {
  __shared__ float2 ys[NY];
  __shared__ float ph[NPH];
  __shared__ float tp[NTAP];
  __shared__ float sws[NTAP];

  const int c = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const float2* yc = y + (size_t)c * T;

  if (threadIdx.x < NTAP) {
    tp[threadIdx.x] = taps[threadIdx.x];
    sws[threadIdx.x] = sw[threadIdx.x];
  }
  // ys[i] = y[t0 - 144 + i], zero outside the stream
  for (int i = threadIdx.x; i < NY; i += TILE) {
    const int s = t0 - HIST - RING + i;
    ys[i] = (s >= 0 && s < T) ? yc[s] : make_float2(0.0f, 0.0f);
  }
  __syncthreads();

  // ph[j] = phase at stream position t0 - 128 + j
  for (int j = threadIdx.x; j < NPH; j += TILE) {
    float p = 0.0f;
    if (t0 - HIST + j >= 0) {
      float fre = __fmul_rn(tp[0], ys[j].x);
      float fim = __fmul_rn(tp[0], ys[j].y);
#pragma unroll
      for (int k = 1; k < NTAP; ++k) {
        fre = __fadd_rn(fre, __fmul_rn(tp[k], ys[j + k].x));
        fim = __fadd_rn(fim, __fmul_rn(tp[k], ys[j + k].y));
      }
      p = MODE == MODE_STREAM ? atan2f(fim, fre) : cephes_atan2(fim, fre);
    }
    ph[j] = p;
  }
  __syncthreads();

  const int t = t0 + threadIdx.x;
  if (t >= T) return;
  const float* pw = ph + threadIdx.x;    // pw[8k] = phase at t - 128 + 8k
  float e, f;
  if (MODE == MODE_STREAM) {
    // running sums of the unwrapped phases relative to the first one
    const float a0 = __fsub_rn(pw[0], sws[0]);
    float p_prev = a0, cum = 0.0f, s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 1; k < NTAP; ++k) {
      const float pk = __fsub_rn(pw[8 * k], sws[k]);
      cum = __fadd_rn(cum, unwrap_step(__fsub_rn(pk, p_prev)));
      const float pr = __fadd_rn(__fsub_rn(pk, a0), cum);
      s0 = __fadd_rn(s0, pr);
      s1 = __fadd_rn(s1, __fmul_rn((float)(k - 8), pr));
      s2 = __fadd_rn(s2, __fmul_rn(pr, pr));
      p_prev = pk;
    }
    f = __fdiv_rn(s1, 408.0f);
    e = __fsub_rn(__fsub_rn(s2, __fmul_rn(__fmul_rn(s0, s0), f32(1.0 / 17.0))),
                  __fmul_rn(s1, f));
  } else {
    // two-pass: unwrapped phases, their mean, slope, then residual
    float pr[NTAP];
    float a_prev = __fsub_rn(pw[0], sws[0]);
    float cum = 0.0f;
    pr[0] = a_prev;
#pragma unroll
    for (int k = 1; k < NTAP; ++k) {
      const float ak = __fsub_rn(pw[8 * k], sws[k]);
      cum = __fadd_rn(cum, unwrap_step(__fsub_rn(ak, a_prev)));
      pr[k] = __fadd_rn(ak, cum);
      a_prev = ak;
    }
    float m = pr[0];
#pragma unroll
    for (int k = 1; k < NTAP; ++k) m = __fadd_rn(m, pr[k]);
    m = __fmul_rn(m, f32(1.0 / 17.0));
    float num = 0.0f;
#pragma unroll
    for (int k = 0; k < NTAP; ++k)
      num = __fadd_rn(num, __fmul_rn(__fsub_rn(pr[k], m), (float)(k - 8)));
    f = __fmul_rn(num, f32(1.0 / 408.0));
    e = 0.0f;
#pragma unroll
    for (int k = 0; k < NTAP; ++k) {
      const float d = __fsub_rn(__fsub_rn(pr[k], m), __fmul_rn((float)(k - 8), f));
      e = __fadd_rn(e, __fmul_rn(d, d));
    }
  }
  err[(size_t)c * T + t] = e;
  fr[(size_t)c * T + t] = f;
}

}  // namespace

// y: (C, T, 2) float32 contiguous; taps, sw: 17 float32 each; err, fr:
// (C, T) float32.  Launches on `stream` and returns cudaGetLastError().
extern "C" int vdl2_sync_scan(const float* y, const float* taps,
                              const float* sw, float* err, float* fr, int C,
                              int T, int mode, void* stream) {
  if (C <= 0 || T <= 0 || C > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + TILE - 1) / TILE, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* y2 = reinterpret_cast<const float2*>(y);
  if (mode == MODE_STREAM)
    sync_scan_kernel<MODE_STREAM><<<grid, TILE, 0, s>>>(y2, taps, sw, err, fr, T);
  else if (mode == MODE_FUSED)
    sync_scan_kernel<MODE_FUSED><<<grid, TILE, 0, s>>>(y2, taps, sw, err, fr, T);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
