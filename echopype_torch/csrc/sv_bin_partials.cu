// Fused survey-processing step for Hopper: float32 dB power -> Sv (written
// out, K3) -> linear domain -> per-ping range-bin sums and counts, in one
// pass over the power block.
//
// Replaces the TPU Pallas kernels in echopype_tpu/ops/pallas_pipeline.py:
//   K3 ep_sv_bin_partials <- sv_bin_partials_pallas (body _kernel_body)
//      Sv = P + 20 log10(r_tvg) + 2 alpha r_tvg + offset, NaN where
//      r_tvg <= 0 or P is NaN; lin = exp(Sv ln10/10) where Sv is not NaN
//   K4 ep_mvbs_partials   <- mvbs_partials_pallas (body _mvbs_kernel_body)
//      MVBS only, no Sv and no log10:
//      lin = exp(ln10/10 (P + 2 alpha r_tvg + offset)) r_tvg^2
//      where r_tvg > 0 and P is not NaN
// with r_tvg = k dr - tvg_shift for sample k, and per ping (c, p)
//   s1[c, p, b] = sum of lin over samples k in [bounds[c, b], bounds[c, b+1])
//   n1[c, p, b] = number of those samples that are valid (data-dependent:
//                 interior NaN power drops out, so no closed form)
//
// What bounds it on an H100: memory.  K3 reads 4 bytes and writes 4 bytes
// of Sv per sample (~800 MB at 5 x 5000 x 4000) plus one log10f and one
// expf per sample; K4 reads 4 bytes per sample and does one expf.  The
// per-ping partials ([C, P, n_r]) are ~1% of the traffic.
//
// Design.  One block per (channel, ping) row.  The block streams its row in
// segments of kSeg samples: each thread computes its samples' Sv (coalesced
// reads, and for K3 coalesced Sv writes) and stages lin in shared memory,
// with -1 marking an invalid sample (lin is never negative).  Then each warp
// takes whole range bins (bin b goes to warp b mod kWarps): its lanes stride
// over the bin's contiguous run of staged samples, sum in float32, count in
// int, and reduce by warp shuffles in a fixed order; lane 0 adds the result
// to the row's partials in global memory, segment after segment.  The
// TPU's 0/1 band matmul (jnp.dot(lin, m) at HIGHEST) is not ported: bins are
// contiguous runs, so plain float32 adds do it with no tensor cores (no TF32)
// and no atomics, and a rerun is bit-identical.  The Pallas tiling (tile_p,
// the VMEM grid, NaN padding of pings) has no counterpart: every row is a
// block of its own.
//
// Numerics.  The bin bounds come from the host (clip(ceil(edge / dr0), 0, R)
// in float32, the unrefined bounds of the JAX cores): nothing is divided on
// the device.  r = k dr and r_tvg = r - shift use round-to-nearest
// intrinsics so no FMA contraction moves r_tvg across 0 (that would change
// the NaN mask), and so do the sums of the sonar equation; expf and log10f
// are the library functions (no fast-math intrinsics).  A valid sample whose
// lin is not finite (inf from an absurd Sv, NaN in K4 from a NaN offset) is
// counted and poisons its own bin only; the TPU's dot (and the plain twin's
// bmm) spreads it as NaN to every bin of the ping.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kLn10Over10 = 0.23025850929940458f;  // 10^(x/10) = exp(x ln10/10)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 4096;  // samples staged per pass: 16 KB of shared memory

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// K3's per-sample step: Sv (NaN where invalid) and its staged lin.
__device__ __forceinline__ float sv_sample(float p, float r_tvg, float ab2, float off) {
  if (!(r_tvg > 0.0f)) return nan_f();
  float sv = __fadd_rn(p, __fmul_rn(20.0f, log10f(r_tvg)));
  sv = __fadd_rn(sv, __fmul_rn(ab2, r_tvg));
  return __fadd_rn(sv, off);
}

template <bool kWriteSv>
__global__ void __launch_bounds__(kThreads)
sv_bin_partials_kernel(const float* __restrict__ power,
                       const float* __restrict__ dr,
                       const float* __restrict__ tvg_shift,
                       const float* __restrict__ absorption,
                       const float* __restrict__ offset,
                       const int* __restrict__ bounds,
                       float* __restrict__ sv_out,
                       float* __restrict__ s1, float* __restrict__ n1,
                       int P, int R, int n_r) {
  __shared__ float s_lin[kSeg];
  const size_t cp = blockIdx.x;  // c * P + p
  const int c = static_cast<int>(cp / static_cast<size_t>(P));
  const float* row = power + cp * R;
  const float d = dr[cp];
  const float sh = tvg_shift[cp];
  const float ab2 = 2.0f * absorption[cp];  // exact
  const float off = offset[cp];
  const int* bnd = bounds + static_cast<size_t>(c) * (n_r + 1);
  float* s1_row = s1 + cp * n_r;
  float* n1_row = n1 + cp * n_r;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  int base = 0;
  do {  // at least once, so an empty row still writes its zero partials
    const int end = min(R, base + kSeg);
    for (int k = base + static_cast<int>(threadIdx.x); k < end; k += kThreads) {
      const float p = row[k];
      const float r_tvg = __fsub_rn(__fmul_rn(static_cast<float>(k), d), sh);
      float lin = -1.0f;
      if (kWriteSv) {
        const float sv = sv_sample(p, r_tvg, ab2, off);
        sv_out[cp * R + k] = sv;
        if (!isnan(sv)) lin = expf(__fmul_rn(sv, kLn10Over10));
      } else if (r_tvg > 0.0f && !isnan(p)) {
        const float e = __fadd_rn(__fadd_rn(p, __fmul_rn(ab2, r_tvg)), off);
        lin = __fmul_rn(expf(__fmul_rn(kLn10Over10, e)), __fmul_rn(r_tvg, r_tvg));
      }
      s_lin[k - base] = lin;
    }
    __syncthreads();
    for (int b = warp; b < n_r; b += kWarps) {
      const int lo = max(bnd[b], base);
      const int hi = min(bnd[b + 1], end);
      float acc = 0.0f;
      int n = 0;
      for (int k = lo + lane; k < hi; k += 32) {
        const float v = s_lin[k - base];
        if (!(v < 0.0f)) {  // valid: lin >= 0, or NaN from a NaN operand
          acc += v;
          ++n;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        acc += __shfl_down_sync(0xffffffffu, acc, o);
        n += __shfl_down_sync(0xffffffffu, n, o);
      }
      if (lane == 0) {
        if (base == 0) {
          s1_row[b] = acc;
          n1_row[b] = static_cast<float>(n);
        } else if (hi > lo) {
          s1_row[b] += acc;
          n1_row[b] += static_cast<float>(n);
        }
      }
    }
    __syncthreads();  // the next segment overwrites s_lin
    base += kSeg;
  } while (base < R);
}

template <bool kWriteSv>
int launch(const void* power, const void* dr, const void* tvg_shift, const void* absorption,
           const void* offset, const void* bounds, void* sv, void* s1, void* n1, int C, int P,
           int R, int n_r, void* stream) {
  if (C == 0 || P == 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid = static_cast<unsigned>(C) * static_cast<unsigned>(P);
  sv_bin_partials_kernel<kWriteSv><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(power), static_cast<const float*>(dr),
      static_cast<const float*>(tvg_shift), static_cast<const float*>(absorption),
      static_cast<const float*>(offset), static_cast<const int*>(bounds),
      static_cast<float*>(sv), static_cast<float*>(s1), static_cast<float*>(n1), P, R, n_r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes: power / sv [C, P, R]; dr, tvg_shift, absorption, offset [C, P];
// bounds [C, n_r + 1] int32 sample bounds in [0, R]; s1, n1 [C, P, n_r].
extern "C" int ep_sv_bin_partials(const void* power, const void* dr, const void* tvg_shift,
                                  const void* absorption, const void* offset,
                                  const void* bounds, void* sv, void* s1, void* n1, int C,
                                  int P, int R, int n_r, void* stream) {
  return launch<true>(power, dr, tvg_shift, absorption, offset, bounds, sv, s1, n1, C, P, R,
                      n_r, stream);
}

extern "C" int ep_mvbs_partials(const void* power, const void* dr, const void* tvg_shift,
                                const void* absorption, const void* offset, const void* bounds,
                                void* s1, void* n1, int C, int P, int R, int n_r,
                                void* stream) {
  return launch<false>(power, dr, tvg_shift, absorption, offset, bounds, nullptr, s1, n1, C, P,
                       R, n_r, stream);
}
