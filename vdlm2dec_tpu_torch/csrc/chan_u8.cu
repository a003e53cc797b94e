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
// The dense (P_in, K) aggregation matrix has one nonzero per input n, in the
// column that owns n, and each column owns a contiguous window; the wrapper
// (ops/chan_u8.py) turns it into window starts, per-input weights and the
// transposed slot of every input once, and the kernel sums the same nonzero
// products as the dense product, in ascending n, with 1/K of its
// multiply-adds.  Every step uses the _rn intrinsics, so no multiply-add
// contracts into an FMA and each product rounds as in the plain PyTorch
// version; the sum of a window runs in ascending n in one thread, so the
// result does not depend on the launch geometry.
//
// What bounds it on an H100 (8 channels, a 2 s block of B = 2528 periods of
// P_in = 2000 samples): it must read 10.1 MB of raw bytes and 0.3 MB of
// tables and write 13.6 MB of output, 7.2 us at 3.35 TB/s, and do 40.4 M
// complex mixes and weighted adds of 10 float32 operations each, 6.3 us at
// the 67 TFLOP/s peak.  Memory bounds it, by a little; the peak counts an FMA
// as two operations and none may fuse here (see above), so the arithmetic
// alone takes twice its 6.3 us.  The design must waste neither.
//
// What the design does about that.
//   * The LO is staged once per block, not once per period.  A block owns
//     a group of CG channels and walks many periods (a persistent grid: as
//     many blocks as fit the card at once, each striding over groups of
//     three periods), with its channels' LO and the weights in shared
//     memory (16 KB a channel at 2 Msps, 48 KB at 6 Msps).  CG is the widest
//     of 4, 2, 1 of which two blocks fit an SM, else the widest that fits.
//     Where not even one channel's period fits (P_in above ~9 000, 10 Msps
//     and up), the 84 windows are cut into chunks, one more grid dimension,
//     each block staging only its chunk's tables and bytes: the sums and
//     their order stay the same.  The cut is chosen once per problem.
//   * Transposed tables.  Shared memory holds LO and weights as [i][k], i
//     the index inside window k: the lanes of a warp (consecutive k) read
//     consecutive words at every step, where the natural [n] order put them
//     ~24 words apart (8-way bank conflicts, and 32 separate sectors for an
//     LO read from cache).  The row pitch is odd, which spreads the
//     transposing stores over the banks too.
//   * Bytes arrive asynchronously.  The next three periods' raw bytes are
//     copied into the second of two shared buffers with cp.async (8 bytes a
//     request, in input order) while the current three are summed: no
//     thread waits on device memory between groups.  The 2-byte reads of
//     the bytes are 4-way bank-conflicted and still a fifth of the loop's
//     shared-memory traffic.
//   * Work shared across channels.  A thread owns output k of one period
//     and loops over the block's CG channels inside the window loop: the
//     byte load, the u8 -> float conversion and the DC subtraction happen
//     once per input and CG channels reuse them from registers, with 2 CG
//     independent accumulation chains in flight.
//   * Full warps.  Three periods are summed at a time by 3 * 84 = 252 of
//     256 threads (one period per block left a third pass 62 % full), and
//     outputs are written as coalesced float2 rows.
//
// Measured (vdlm2dec_tpu_torch/kernel_times.py, the kernel's own time, median
// of 7 replays of a CUDA graph, on an NVIDIA H100 80GB HBM3 at 700 W): 0.0372
// ms at 8 x 2528 x 2000 (5.2x its bound of 0.0072 ms; 0.0379 ms when no launch
// finds its bytes in the L2 cache), 0.0653-0.0659 ms at 8 x 4544 x 2000 (5.1x
// of 0.0128) and 0.0118 ms at 4 x 64 x 6000 (bound 0.0004: a launch alone
// takes ~0.003), where the one-period-per-block kernel before it took 0.0997,
// 0.1747 and 0.0343 ms, with the same bits out.  At 8 x 512 x 10 000, cut into
// two window chunks of two channels (four warps a block, one block an SM),
// 0.0825 ms against 0.4676 ms before.  With the window loop removed the
// kernel still takes 0.013 ms (launch, table staging at the L2 cache's rate
// in every block at once, the output stores); the loop's 0.023 ms are 3.6x
// the operations' 0.0063 ms, of which 2x is the unfused multiply-add:
// fusing would cut the loop by 40 % and change the rounding.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int SLICES = 3;              // periods a block sums at a time
constexpr int STAGES = 2;              // byte buffers: one summed, one filling
constexpr int MAX_THREADS = 256;       // SLICES * K outputs, rounded to warps

// Starts the asynchronous copy of the inputs a0 .. a0 + 4 * L4 - 1 of periods
// b0 .. b0 + nb - 1 into dst (Lbuf samples a period), 8 bytes a request, and
// commits it as one group.  Whole periods (4 * L4 = P_in = Lbuf) are one
// contiguous run, copied in one loop: a loop per period costs 1 us a launch.
__device__ __forceinline__ void prefetch(uchar2* dst, const uint8_t* raw,
                                         int b0, int nb, int P_in, int a0,
                                         int L4, int Lbuf) {
  const bool whole = 4 * L4 == P_in;
  const int rows = whole ? 1 : nb, n = whole ? nb * L4 : L4;
  for (int sl = 0; sl < rows; ++sl) {
    const uint2* src = reinterpret_cast<const uint2*>(
        raw + ((size_t)(b0 + sl) * P_in + a0) * 2);
    uint2* d = reinterpret_cast<uint2*>(dst + sl * Lbuf);
    for (int q = threadIdx.x; q < n; q += blockDim.x)
      __pipeline_memcpy_async(d + q, src + q, sizeof(uint2));
  }
  __pipeline_commit();
}

// Block (x, y, z) sums the windows k0 = z * Kc .. k0 + Kc - 1 of the channels
// c0 = y * CG .. c0 + CG - 1, for the period groups x, x + gridDim.x, ...
template <int CG>
__global__ void __launch_bounds__(MAX_THREADS)
chan_u8_kernel(const uint8_t* __restrict__ raw, const float* __restrict__ lo_r,
               const float* __restrict__ lo_i, const float* __restrict__ ph_r,
               const float* __restrict__ ph_i, const int* __restrict__ starts,
               const float* __restrict__ weights, const int* __restrict__ slots,
               float dc, float2* __restrict__ out, int C, int B, int P_in,
               int K, int pitch, int maxlen, int Kc, int Lbuf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitchc = Kc | 1;                              // row of a plane
  const int XS = maxlen * pitchc;                         // one [i][k] plane
  float2* lo_s = reinterpret_cast<float2*>(smem);         // CG planes
  float* w_s = reinterpret_cast<float*>(lo_s + CG * XS);  // 1 plane
  // STAGES buffers of SLICES periods of raw byte pairs, in input order
  uchar2* xs = reinterpret_cast<uchar2*>(w_s + XS + (XS & 1));
  const int XB = SLICES * Lbuf;

  const int c0 = blockIdx.y * CG;
  const int k0 = blockIdx.z * Kc;
  const int kn = min(Kc, K - k0);          // windows of this block
  // (an uncut period needs no look-up before its first bytes can travel)
  const bool cut = gridDim.z > 1;
  const int n0 = cut ? starts[k0] : 0, n1 = cut ? starts[k0 + kn] : P_in;
  // the inputs of those windows, widened to whole 8-byte requests
  const int a0 = n0 & ~3;
  const int L4 = (((n1 + 3) & ~3) - a0) >> 2;
  const int n_groups = (B + SLICES - 1) / SLICES;
  int grp = blockIdx.x;
  if (grp < n_groups)
    prefetch(xs, raw, grp * SLICES, min(SLICES, B - grp * SLICES), P_in, a0,
             L4, Lbuf);

  // tables of this block's channels and windows, transposed: input n, the
  // i-th of window k, goes to plane[i * pitchc + k - k0]
  for (int n = n0 + threadIdx.x; n < n1; n += blockDim.x) {
    int s = slots[n];
    if (cut) {
      const int i = s / pitch;
      s = i * pitchc + (s - i * pitch) - k0;
    }
    w_s[s] = weights[n];
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const bool ok = c0 + c < C;
      const size_t at = (size_t)(c0 + c) * P_in + n;
      lo_s[c * XS + s] =
          ok ? make_float2(lo_r[at], lo_i[at]) : make_float2(0.0f, 0.0f);
    }
  }

  const bool active = threadIdx.x < SLICES * kn;
  const int slice = threadIdx.x / kn;
  const int k = threadIdx.x - slice * kn;  // window k0 + k
  const int st = active ? starts[k0 + k] : 0;
  const int len = active ? starts[k0 + k + 1] - st : 0;

  for (int stage = 0; grp < n_groups; grp += gridDim.x, stage ^= 1) {
    const int b0 = grp * SLICES;
    const int nb = min(SLICES, B - b0);    // periods of this group
    // the next group's bytes travel while this one is summed
    const int next = grp + gridDim.x;
    if (next < n_groups) {
      prefetch(xs + (stage ^ 1) * XB, raw, next * SLICES,
               min(SLICES, B - next * SLICES), P_in, a0, L4, Lbuf);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();           // this group's bytes (and the tables) landed

    if (active && slice < nb) {
      float ar[CG], ai[CG];
#pragma unroll
      for (int c = 0; c < CG; ++c) ar[c] = ai[c] = 0.0f;
      const uchar2* xp = xs + stage * XB + slice * Lbuf + (st - a0);
      const float* wp = w_s + k;
      const float2* lp = lo_s + k;
#pragma unroll 4
      for (int i = 0; i < len; ++i) {
        const uchar2 u = xp[i];
        const float w = wp[i * pitchc];
        const float xr = __fsub_rn((float)u.x, dc);
        const float xi = __fsub_rn((float)u.y, dc);
#pragma unroll
        for (int c = 0; c < CG; ++c) {
          const float2 l = lp[c * XS + i * pitchc];
          const float mr = __fsub_rn(__fmul_rn(xr, l.x), __fmul_rn(xi, l.y));
          const float mi = __fadd_rn(__fmul_rn(xr, l.y), __fmul_rn(xi, l.x));
          ar[c] = __fadd_rn(ar[c], __fmul_rn(mr, w));
          ai[c] = __fadd_rn(ai[c], __fmul_rn(mi, w));
        }
      }
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        if (c0 + c >= C) break;
        const size_t cb = (size_t)(c0 + c) * B + b0 + slice;
        const float pr = ph_r[cb], pi = ph_i[cb];
        out[cb * K + k0 + k] =
            make_float2(__fsub_rn(__fmul_rn(ar[c], pr), __fmul_rn(ai[c], pi)),
                        __fadd_rn(__fmul_rn(ar[c], pi), __fmul_rn(ai[c], pr)));
      }
    }
    __syncthreads();           // all done with this buffer: it refills next
  }
}

using Kernel = decltype(&chan_u8_kernel<1>);

// How one problem (device, C, P_in, K, maxlen) is cut into blocks: chosen at
// its first launch and kept.
struct Plan {
  int dev, C, P_in, K, maxlen;             // the problem
  int cg, kc, lbuf, nt, nbx, n_cg, nk;     // the cut
  size_t smem;
  Kernel kernel;
};

size_t smem_bytes(int cg, int kc, int maxlen, int lbuf) {
  const size_t plane = (size_t)maxlen * (kc | 1);
  return plane * (cg * sizeof(float2) + sizeof(float)) + sizeof(float) +
         (size_t)STAGES * SLICES * lbuf * sizeof(uchar2);
}

// The cut for a problem: as few window chunks as fit the block's shared
// memory (one for every P_in up to ~9 000), and of the channel groups 4, 2, 1
// the widest of which two blocks fit an SM (one hides the other's staging),
// else the widest that fits at all.
cudaError_t make_plan(Plan& p) {
  int n_sm = 0, smem_max = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, p.dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, p.dev);
  if (e != cudaSuccess) return e;
  const size_t limit = (size_t)smem_max;
  p.cg = 0;
  for (p.nk = 1; p.nk <= p.K && !p.cg; ++p.nk) {
    p.kc = (p.K + p.nk - 1) / p.nk;
    // a chunk's inputs, widened to 8-byte requests at both ends
    p.lbuf = min(p.P_in, (p.kc * p.maxlen + 6 + 3) & ~3);
    for (int twice = 1; twice >= 0 && !p.cg; --twice)
      for (int cg = 4; cg >= 1 && !p.cg; cg >>= 1) {
        p.smem = smem_bytes(cg, p.kc, p.maxlen, p.lbuf);
        if (cg <= p.C && (twice ? 2 * (p.smem + 1024) : p.smem) <= limit)
          p.cg = cg;
      }
  }
  if (!p.cg) return cudaErrorInvalidConfiguration;
  p.nk = (p.K + p.kc - 1) / p.kc;
  p.kernel = p.cg == 4   ? chan_u8_kernel<4>
             : p.cg == 2 ? chan_u8_kernel<2>
                         : chan_u8_kernel<1>;
  p.nt = (SLICES * p.kc + 31) / 32 * 32;
  // the card's most, not p.smem: other plans launch the same instance
  e = cudaFuncSetAttribute(reinterpret_cast<const void*>(p.kernel),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_max);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p.kernel, p.nt,
                                                      p.smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // a persistent grid: every block resident at once, striding over the
  // period groups of its channel group and window chunk
  p.n_cg = (p.C + p.cg - 1) / p.cg;
  p.nbx = max(1, n_sm * per_sm / (p.n_cg * p.nk));
  return cudaSuccess;
}

}  // namespace

// raw: (B * P_in * 2,) uint8 interleaved (re, im), 8-byte aligned; lo_r,
// lo_i: (C, P_in) float32; ph_r, ph_i: (C, B) float32; starts: (K + 1,)
// int32 window starts; weights: (P_in,) float32; slots: (P_in,) int32, the
// transposed position i * pitch + k of input n (i = n - starts[k], k its
// window); pitch = K | 1; maxlen: the longest window; out: (C, B, K, 2)
// float32.  All contiguous, P_in a multiple of 4.  Launches on `stream` and
// returns cudaGetLastError() (or an error code for arguments it cannot
// take).
extern "C" int vdl2_chan_u8(const uint8_t* raw, const float* lo_r,
                            const float* lo_i, const float* ph_r,
                            const float* ph_i, const int* starts,
                            const float* weights, const int* slots, float dc,
                            float* out, int C, int B, int P_in, int K,
                            int pitch, int maxlen, void* stream) {
  if (C <= 0 || B <= 0 || P_in <= 0 || K <= 0 || maxlen <= 0 || P_in % 4 ||
      pitch != (K | 1) || C > 65535 || SLICES * K > MAX_THREADS ||
      reinterpret_cast<uintptr_t>(raw) % 8)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  static std::mutex mu;
  static std::vector<Plan> plans;
  Plan p{};
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const Plan& q : plans)
      if (q.dev == dev && q.C == C && q.P_in == P_in && q.K == K &&
          q.maxlen == maxlen)
        p = q;
    if (!p.cg) {
      p.dev = dev, p.C = C, p.P_in = P_in, p.K = K, p.maxlen = maxlen;
      e = make_plan(p);
      if (e != cudaSuccess) return (int)e;
      plans.push_back(p);
    }
  }
  const int n_groups = (B + SLICES - 1) / SLICES;
  p.kernel<<<dim3(min(p.nbx, n_groups), p.n_cg, p.nk), p.nt, p.smem,
             static_cast<cudaStream_t>(stream)>>>(
      raw, lo_r, lo_i, ph_r, ph_i, starts, weights, slots, dc,
      reinterpret_cast<float2*>(out), C, B, P_in, K, pitch, maxlen, p.kc,
      p.lbuf);
  return (int)cudaGetLastError();
}
