// Fused u8 channelizer: interleaved cu8 bytes -> per-channel 84 kHz streams.
//
// Replaces vdlm2dec_tpu/ops/pallas_channelizer.py::_kernel (the Pallas
// u8-convert + mix + integrate-and-dump kernel) together with the period
// phase its wrapper applies afterwards (:88-91).  For channel c, period b
// and output k it computes, from the raw bytes (re, im) of the period:
//
//   x(n)    = u8(n) - dc                                  re and im
//   m(n)    = x(n) * lo[c, n]                             complex mix
//   y       = sum_{n in window k} m(n) * w(n)             integrate-and-dump
//   out     = y * ph[c, b]                                complex phase
//
// The dense (P_in, 84) aggregation matrix has one nonzero per input n, in
// the column that owns n, and each column owns a contiguous window; the
// wrapper (ops/chan_u8.py) turns it into window starts and per-input
// weights once, and the kernel sums the same nonzero products as the dense
// product, in ascending n, with 1/84 of its multiply-adds.  Every step uses
// the _rn intrinsics, so no multiply-add contracts into an FMA and each
// product rounds as in the plain PyTorch version.
//
// What bounds it on an H100 (design estimate at 8 channels, a 2 s block of
// B = 2528 periods at 2 Msps): it reads 10.1 MB of raw bytes and writes
// 13.6 MB of output, and does ~8 * 2528 * 2000 complex mixes plus the
// window sums, ~0.3 G float32 operations: at 3.35 TB/s and tens of TFLOP/s
// of float32 both take microseconds.  The plain version instead writes
// (8, 2528, 2000) float32 intermediates of 162 MB each for the mix.  The
// design keeps those out of device memory: one block per period stages the
// period's 2 * P_in bytes (4-12 KB at 2-6 Msps) and the window tables in
// shared memory, and each thread produces (c, k) outputs, reading the LO
// (C * P_in * 8 bytes, 128 KB at 8 channels and 2 Msps) from the L2/L1
// cache.  Several periods per block (LO reuse) and vectorised loads are
// left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr size_t STATIC_SMEM_LIMIT = 48 * 1024;

__global__ void __launch_bounds__(THREADS)
chan_u8_kernel(const uint8_t* __restrict__ raw, const float* __restrict__ lo_r,
               const float* __restrict__ lo_i, const float* __restrict__ ph_r,
               const float* __restrict__ ph_i, const int* __restrict__ starts,
               const float* __restrict__ weights, float dc,
               float2* __restrict__ out, int C, int B, int P_in, int P_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w = reinterpret_cast<float*>(smem);              // P_in weights
  int* st = reinterpret_cast<int*>(w + P_in);              // P_out + 1 starts
  uchar2* xs = reinterpret_cast<uchar2*>(st + P_out + 1);  // P_in byte pairs

  const int b = blockIdx.x;
  const uchar2* rb = reinterpret_cast<const uchar2*>(raw) + (size_t)b * P_in;
  for (int i = threadIdx.x; i < P_in; i += THREADS) {
    xs[i] = rb[i];
    w[i] = weights[i];
  }
  for (int i = threadIdx.x; i <= P_out; i += THREADS) st[i] = starts[i];
  __syncthreads();

  for (int j = threadIdx.x; j < C * P_out; j += THREADS) {
    const int c = j / P_out;
    const int k = j - c * P_out;
    const float* lr = lo_r + (size_t)c * P_in;
    const float* li = lo_i + (size_t)c * P_in;
    float ar = 0.0f, ai = 0.0f;
    for (int n = st[k]; n < st[k + 1]; ++n) {
      const float xr = __fsub_rn((float)xs[n].x, dc);
      const float xi = __fsub_rn((float)xs[n].y, dc);
      const float cr = lr[n], ci = li[n];
      const float mr = __fsub_rn(__fmul_rn(xr, cr), __fmul_rn(xi, ci));
      const float mi = __fadd_rn(__fmul_rn(xr, ci), __fmul_rn(xi, cr));
      ar = __fadd_rn(ar, __fmul_rn(mr, w[n]));
      ai = __fadd_rn(ai, __fmul_rn(mi, w[n]));
    }
    const float pr = ph_r[(size_t)c * B + b];
    const float pi = ph_i[(size_t)c * B + b];
    out[((size_t)c * B + b) * P_out + k] =
        make_float2(__fsub_rn(__fmul_rn(ar, pr), __fmul_rn(ai, pi)),
                    __fadd_rn(__fmul_rn(ar, pi), __fmul_rn(ai, pr)));
  }
}

}  // namespace

// raw: (B * P_in * 2,) uint8 interleaved (re, im); lo_r, lo_i: (C, P_in)
// float32; ph_r, ph_i: (C, B) float32; starts: (P_out + 1,) int32 window
// starts; weights: (P_in,) float32; out: (C, B, P_out, 2) float32.  All
// contiguous.  Launches on `stream` and returns cudaGetLastError() (or an
// error code for arguments it cannot take).
extern "C" int vdl2_chan_u8(const uint8_t* raw, const float* lo_r,
                            const float* lo_i, const float* ph_r,
                            const float* ph_i, const int* starts,
                            const float* weights, float dc, float* out, int C,
                            int B, int P_in, int P_out, void* stream) {
  if (C <= 0 || B <= 0 || P_in <= 0 || P_out <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)P_in * (sizeof(float) + sizeof(uchar2)) +
                      (size_t)(P_out + 1) * sizeof(int);
  if (smem > STATIC_SMEM_LIMIT) {
    const cudaError_t e = cudaFuncSetAttribute(
        chan_u8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  chan_u8_kernel<<<B, THREADS, smem, s>>>(
      raw, lo_r, lo_i, ph_r, ph_i, starts, weights, dc,
      reinterpret_cast<float2*>(out), C, B, P_in, P_out);
  return (int)cudaGetLastError();
}
