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
// Non-finite values, as the Pallas kernels' 0/1 band product gives them.
// Let F be the valid samples of a ping whose lin is not finite (inf from an
// absurd Sv, NaN in K4 from a NaN offset), anywhere in [0, R).  The product
// multiplies each lin by 0 for every bin the sample is not in, and inf * 0
// and NaN * 0 are NaN; so s1[c, p, b] is NaN when any sample of F lies
// outside bin b, and otherwise the bin's own float32 sum (inf or NaN where F
// lies inside it).  Counts do not change.  The kernels note the first and
// last index of F per ping (a warp min / max, no atomics) and write NaN
// into every bin that [first, last] is not inside; K3 looks for them only
// in a row where some thread saw a lin of inf.
//
// K3 design.  One block per (channel, ping) row.  The block streams its row
// in segments of kSeg samples: each thread computes its samples' Sv
// (coalesced reads and Sv writes) and stages lin in shared memory, with -1
// marking an invalid sample (lin is never negative).  Then each warp takes
// whole range bins (bin b goes to warp b mod kWarps): its lanes stride over
// the bin's staged samples, sum in float32, count in int, and reduce by warp
// shuffles in a fixed order; lane 0 adds the result to the row's partials.
//
// K4 design (Hopper).  One block owns (channel, slab of kSlab = 8 pings):
// one barrier at block start stages the channel's bounds (the same for
// every ping), the slab's per-ping operands and its F slots in shared
// memory, and picks the path; no 64-bit division, no per-row set-up.
// * The threads span the range axis: each owns kVec = 16 consecutive samples
//   of a 4,096-sample segment and loads them as four 16-byte streaming
//   loads a row (scalar loads where R % 4 != 0 or the block is not 16-byte
//   aligned).  kRows = 1 row in flight a thread keeps a thread at 64
//   registers, four blocks an SM: more rows in flight cost more in
//   occupancy than they gain (tools/k4_probe.py).
// * Where every non-empty bin is at least kVec samples wide (20 m bins at
//   dr 0.19 m hold ~105), a thread's run touches at most two regions (bins,
//   or the samples outside every bin).  The thread finds once per segment
//   where its run splits (a binary search of the staged bounds), keeps two
//   float sums and a valid-sample mask a row in registers, and stores them
//   to shared memory as [rows][2][threads] for kBatch = 8 rows at a time.
//   Then one thread per (row, bin) adds the bin's few contiguous entries in
//   thread order and writes the partials coalesced.  No per-sample
//   shared-memory round trip and no shuffle trees in the sample loop.
// * Otherwise (a bin narrower than kVec, bounds that decrease, or more than
//   kMaxBounds - 1 bins), the block takes the general path: one row at a
//   time, every lin staged in shared memory, one thread per bin adding the
//   bin's staged samples in order.
// * Rows longer than one segment add each segment's partials to the first
//   segment's in segment order.
// The TPU's 0/1 band matmul (jnp.dot(lin, m) at HIGHEST) is not ported:
// bins are contiguous runs, so plain float32 adds do it with no tensor cores
// (no TF32) and no atomics, and a rerun is bit-identical.  The Pallas tiling
// (tile_p, the VMEM grid, NaN padding of pings) has no counterpart.
//
// Numerics.  The bin bounds come from the host (clip(ceil(edge / dr0), 0, R)
// in float32, the unrefined bounds of the JAX cores): nothing is divided on
// the device.  r = k dr and r_tvg = r - shift use round-to-nearest
// intrinsics so no FMA contraction moves r_tvg across 0 (that would change
// the NaN mask), and so do the sums of the sonar equation; expf and log10f
// are the library functions (no fast-math intrinsics).
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kLn10Over10 = 0.23025850929940458f;  // 10^(x/10) = exp(x ln10/10)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 4096;  // K3: samples staged per pass, 16 KB of shared memory

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ bool finite_f(float v) { return fabsf(v) < inf_f(); }

// The non-finite rule: a bin is NaN unless every sample of F, which lies in
// [fmin, fmax] (fmin = INT_MAX, fmax = -1 when F is empty), is inside it.
__device__ __forceinline__ bool poisoned(int fmin, int fmax, int lo, int hi) {
  return fmin < lo || fmax >= hi;
}

// Warp-wide first / last index of F; lane 0 folds them into dst[0] / dst[1].
// Every lane of the warp calls it.
__device__ __forceinline__ void note_poison(int fmin, int fmax, int* dst) {
  if (!__any_sync(kFull, fmax >= 0)) return;
  fmin = __reduce_min_sync(kFull, fmin);
  fmax = __reduce_max_sync(kFull, fmax);
  if ((threadIdx.x & 31) == 0) {
    dst[0] = min(dst[0], fmin);
    dst[1] = max(dst[1], fmax);
  }
}

// The row's F range from the per-warp slots.
__device__ __forceinline__ void row_poison(const int (*s_f)[2], int& fmin, int& fmax) {
  fmin = INT_MAX;
  fmax = -1;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    fmin = min(fmin, s_f[w][0]);
    fmax = max(fmax, s_f[w][1]);
  }
}

// ------------------------------------------------------------------- K3
// K3's per-sample step: Sv (NaN where invalid).
__device__ __forceinline__ float sv_sample(float p, float r_tvg, float ab2, float off) {
  if (!(r_tvg > 0.0f)) return nan_f();
  float sv = __fadd_rn(p, __fmul_rn(20.0f, log10f(r_tvg)));
  sv = __fadd_rn(sv, __fmul_rn(ab2, r_tvg));
  return __fadd_rn(sv, off);
}

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
  __shared__ int s_f[kWarps][2];
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
  if (lane == 0) {
    s_f[warp][0] = INT_MAX;
    s_f[warp][1] = -1;
  }
  // F is a lin of inf (K3's lin is never NaN): each thread keeps the largest
  // lin it staged, and a thread that saw inf raises s_any (every writer
  // writes 1), read after the last segment's barrier.
  __shared__ int s_any;
  if (threadIdx.x == 0) s_any = 0;
  float lin_max = 0.0f;

  int base = 0;
  do {  // at least once, so an empty row still writes its zero partials
    const int end = min(R, base + kSeg);
    for (int k = base + static_cast<int>(threadIdx.x); k < end; k += kThreads) {
      const float p = row[k];
      const float r_tvg = __fsub_rn(__fmul_rn(static_cast<float>(k), d), sh);
      const float sv = sv_sample(p, r_tvg, ab2, off);
      sv_out[cp * R + k] = sv;
      float lin = -1.0f;
      if (!isnan(sv)) lin = expf(__fmul_rn(sv, kLn10Over10));
      lin_max = fmaxf(lin_max, lin);
      s_lin[k - base] = lin;
    }
    if (lin_max == inf_f()) s_any = 1;
    __syncthreads();
    for (int b = warp; b < n_r; b += kWarps) {
      const int lo = max(bnd[b], base);
      const int hi = min(bnd[b + 1], end);
      float acc = 0.0f;
      int n = 0;
      for (int k = lo + lane; k < hi; k += 32) {
        const float v = s_lin[k - base];
        if (!(v < 0.0f)) {  // valid: lin >= 0 or inf
          acc += v;
          ++n;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        acc += __shfl_down_sync(kFull, acc, o);
        n += __shfl_down_sync(kFull, n, o);
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

  // Rare: the row holds F.  Each thread finds its first and last sample of
  // F from the Sv it wrote (same k, same thread), then the bins.
  if (!s_any) return;
  int fmin = INT_MAX, fmax = -1;
  for (int k = threadIdx.x; k < R; k += kThreads) {
    const float sv = sv_out[cp * R + k];
    if (!isnan(sv) && !finite_f(expf(__fmul_rn(sv, kLn10Over10)))) {
      fmin = min(fmin, k);
      fmax = k;
    }
  }
  note_poison(fmin, fmax, s_f[warp]);
  __syncthreads();
  if (lane == 0) {  // the lane that wrote bins b = warp mod kWarps
    row_poison(s_f, fmin, fmax);
    for (int b = warp; b < n_r; b += kWarps) {
      if (poisoned(fmin, fmax, bnd[b], bnd[b + 1])) s1_row[b] = nan_f();
    }
  }
}

// ------------------------------------------------------------------- K4
constexpr int kVec = 16;                 // samples a thread owns in a segment
constexpr int kSegK4 = kThreads * kVec;  // 4,096 samples
constexpr int kBatch = 8;                // rows staged before one combine
constexpr int kSlab = 8;                 // pings a block owns
constexpr int kRows = 1;                 // rows whose loads a thread keeps in flight
constexpr int kMaxBounds = 1024;         // bounds staged in shared memory (n_r < 1024)
static_assert(kSlab % kBatch == 0 && kBatch % kRows == 0, "rows tile the slab");
static_assert(kSlab <= kThreads, "one thread stages each ping of the slab");

struct Args {
  const float* power;  // [C, P, R]
  const float* dr;     // [C, P]
  const float* tvg_shift;
  const float* absorption;
  const float* offset;
  const int* bounds;   // [C, n_r + 1]
  float* s1;           // [C, P, n_r]
  float* n1;
  int P, R, n_r;
};

struct Shared {
  union {
    struct {  // the two-region path: per-thread partials of kBatch rows
      float sum[kBatch][2][kThreads];
      int cnt[kBatch][2][kThreads];
    } run;
    float lin[kSegK4];  // the general path: one row's lin, -1 where invalid
  };
  float4 ping[kSlab];  // per ping of the slab: dr, tvg_shift, 2 absorption, offset
  int f[kSlab][kWarps][2];  // per ping and warp: first / last index of F
  int b0[kThreads];  // the bin holding a thread's first sample, or -1
  int bnd[kMaxBounds];  // the two-region path: the channel's bounds, clipped to [0, R]
};

__device__ __forceinline__ int clip_bound(const int* bnd, int b, int R) {
  return min(max(__ldg(bnd + b), 0), R);
}

// kVec samples of one row from sample k0 on, NaN past R (invalid there).
template <bool kV4>
__device__ __forceinline__ void load_run(const float* row, int k0, int R, float (&x)[kVec]) {
  if (kV4) {  // R % 4 == 0 and the block 16-byte aligned
#pragma unroll
    for (int i = 0; i < kVec / 4; ++i) {
      const int k = k0 + 4 * i;
      const float4 v = k < R ? __ldcs(reinterpret_cast<const float4*>(row + k))
                             : make_float4(nan_f(), nan_f(), nan_f(), nan_f());
      x[4 * i] = v.x, x[4 * i + 1] = v.y, x[4 * i + 2] = v.z, x[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) x[j] = k0 + j < R ? __ldcs(row + k0 + j) : nan_f();
  }
}

// One row of a thread's run: the valid mask, the samples of F as a mask,
// and either (kTwo) the sums of the two regions split at sample jsplit of
// the run, or each lin staged (-1 where invalid).  Both masks are set with
// predicated ORs, so that no per-sample flag stays live past its sample.
template <bool kTwo>
__device__ __forceinline__ void row_run(const float (&x)[kVec], int k0, const float4 q,
                                        int jsplit, float* lin_out, float& acc0, float& acc1,
                                        unsigned& vmask, unsigned& fmask) {
  acc0 = acc1 = 0.0f;
  vmask = fmask = 0u;
  const float kf0 = static_cast<float>(k0);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    // k0 + j as a float: exact (k < 2^24), one add
    const float r_tvg = __fsub_rn(__fmul_rn(__fadd_rn(kf0, static_cast<float>(j)), q.x), q.y);
    const bool valid = r_tvg > 0.0f && !isnan(x[j]);
    const float e = __fadd_rn(__fadd_rn(x[j], __fmul_rn(q.z, r_tvg)), q.w);
    const float lin = __fmul_rn(expf(__fmul_rn(kLn10Over10, e)), __fmul_rn(r_tvg, r_tvg));
    if (valid) vmask |= 1u << j;
    if (valid && !finite_f(lin)) fmask |= 1u << j;
    if (kTwo) {
      const float v = valid ? lin : 0.0f;
      if (j < jsplit) {
        acc0 += v;
      } else {
        acc1 += v;
      }
    } else {
      lin_out[j] = valid ? lin : -1.0f;
    }
  }
}

// Write (or, after the first segment, add) one (row, bin) partial; after
// the last segment apply the non-finite rule.
__device__ __forceinline__ void put_partial(const Args& a, const Shared& sm, size_t o, int r,
                                            int lo, int hi, float s, int n, bool first,
                                            bool last) {
  if (!first) {
    s = a.s1[o] + s;
    n += static_cast<int>(a.n1[o]);  // exact integers
  }
  if (last) {
    int fmin, fmax;
    row_poison(sm.f[r], fmin, fmax);
    if (poisoned(fmin, fmax, lo, hi)) s = nan_f();
  }
  a.s1[o] = s;
  a.n1[o] = static_cast<float>(n);
}

// Pings [p_begin, p_end) of channel c, whose per-ping operands are staged.
// kTwo: every non-empty bin is at least kVec samples wide, the bounds do
// not decrease, and they are staged in sm.bnd.
template <bool kV4, bool kTwo>
__device__ __forceinline__ void run_slab(const Args& a, Shared& sm, int c, int p_begin,
                                         int p_end) {
  constexpr int kB = kTwo ? kBatch : 1;
  constexpr int kR = kTwo ? kRows : 1;
  const int warp = threadIdx.x >> 5;
  const int* bnd = a.bounds + static_cast<size_t>(c) * (a.n_r + 1);
  const size_t cp0 = static_cast<size_t>(c) * a.P;
  const auto bound = [&](int b) { return kTwo ? sm.bnd[b] : clip_bound(bnd, b, a.R); };

  for (int p0 = p_begin; p0 < p_end; p0 += kB) {
    const int n_rows = min(kB, p_end - p0);
    const int i0 = p0 - p_begin;  // the batch's first row in the slab
    int seg0 = 0;
    do {  // at least once, so an empty row still writes its zero partials
      const int seg1 = min(a.R, seg0 + kSegK4);
      const bool first = seg0 == 0, last = seg0 + kSegK4 >= a.R;
      const int k0 = seg0 + static_cast<int>(threadIdx.x) * kVec;
      int jsplit = kVec;
      if (kTwo) {
        // j = the last bound <= k0: bin j holds k0 (j in [0, n_r)), or k0
        // lies before every bin (j = -1) or past them (j = n_r)
        int lo = -1, hi = a.n_r;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (bound(mid) <= k0) lo = mid; else hi = mid - 1;
        }
        // the next region starts at the next bound, past k0 (jsplit >= 1)
        jsplit = lo < a.n_r ? min(bound(lo + 1) - k0, kVec) : kVec;
        sm.b0[threadIdx.x] = lo >= 0 && lo < a.n_r ? lo : -1;
      }
      for (int r = 0; r < n_rows; r += kR) {
        float x[kR][kVec];
#pragma unroll
        for (int u = 0; u < kR; ++u) {  // every load of the kR rows first
          if (r + u < n_rows) load_run<kV4>(a.power + (cp0 + p0 + r + u) * a.R, k0, a.R, x[u]);
        }
#pragma unroll
        for (int u = 0; u < kR; ++u) {
          if (r + u >= n_rows) break;
          float acc0, acc1;
          unsigned vmask, fmask;
          float* lin_out = kTwo ? nullptr : sm.lin + (k0 - seg0);
          row_run<kTwo>(x[u], k0, sm.ping[i0 + r + u], jsplit, lin_out, acc0, acc1, vmask,
                        fmask);
          if (kTwo) {
            const unsigned low = (1u << jsplit) - 1u;
            sm.run.sum[r + u][0][threadIdx.x] = acc0;
            sm.run.sum[r + u][1][threadIdx.x] = acc1;
            sm.run.cnt[r + u][0][threadIdx.x] = __popc(vmask & low);
            sm.run.cnt[r + u][1][threadIdx.x] = __popc(vmask & ~low);
          }
          note_poison(fmask ? k0 + __ffs(fmask) - 1 : INT_MAX,
                      fmask ? k0 + 31 - __clz(fmask) : -1, sm.f[i0 + r + u][warp]);
        }
      }
      __syncthreads();

      for (int i = threadIdx.x; i < n_rows * a.n_r; i += kThreads) {
        const int r = i / a.n_r;
        const int b = i - r * a.n_r;
        const int lo = bound(b), hi = bound(b + 1);
        const int s_lo = max(lo, seg0), s_hi = min(hi, seg1);
        float s = 0.0f;
        int n = 0;
        if (kTwo) {  // the entries of the threads whose runs touch the bin
          for (int t = (s_lo - seg0) / kVec; s_lo < s_hi && t <= (s_hi - 1 - seg0) / kVec; ++t) {
            const int slot = sm.b0[t] == b ? 0 : 1;
            s += sm.run.sum[r][slot][t];
            n += sm.run.cnt[r][slot][t];
          }
        } else {
          for (int k = s_lo; k < s_hi; ++k) {
            const float v = sm.lin[k - seg0];
            if (!(v < 0.0f)) {  // valid: lin >= 0, inf or NaN
              s += v;
              ++n;
            }
          }
        }
        put_partial(a, sm, (cp0 + p0 + r) * a.n_r + b, i0 + r, lo, hi, s, n, first, last);
      }
      __syncthreads();  // the next segment or batch overwrites the staging
      seg0 += kSegK4;
    } while (seg0 < a.R);
  }
}

template <bool kV4>
__global__ void __launch_bounds__(kThreads) mvbs_partials_kernel(const Args a) {
  __shared__ __align__(16) Shared sm;
  const int c = blockIdx.y;
  const int p_begin = blockIdx.x * kSlab;
  const int p_end = min(a.P, p_begin + kSlab);
  const int* bnd = a.bounds + static_cast<size_t>(c) * (a.n_r + 1);
  // One barrier stages the slab: its bounds, per-ping operands and F slots,
  // and decides the path.
  bool two = a.n_r < kMaxBounds;
  for (int b = threadIdx.x; b <= a.n_r; b += kThreads) {
    const int lo = clip_bound(bnd, b, a.R);
    if (b < kMaxBounds) sm.bnd[b] = lo;
    if (b < a.n_r) {
      const int w = clip_bound(bnd, b + 1, a.R) - lo;
      two &= w == 0 || w >= kVec;
    }
  }
  const int t = static_cast<int>(threadIdx.x);
  if (t < p_end - p_begin) {
    const size_t cp = static_cast<size_t>(c) * a.P + p_begin + t;
    sm.ping[t] = make_float4(__ldg(a.dr + cp), __ldg(a.tvg_shift + cp),
                             2.0f * __ldg(a.absorption + cp),  // exact
                             __ldg(a.offset + cp));
  }
  for (int i = t; i < kSlab * kWarps; i += kThreads) {
    sm.f[i / kWarps][i % kWarps][0] = INT_MAX;
    sm.f[i / kWarps][i % kWarps][1] = -1;
  }
  if (__syncthreads_and(two)) {
    run_slab<kV4, true>(a, sm, c, p_begin, p_end);
  } else {
    run_slab<kV4, false>(a, sm, c, p_begin, p_end);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Shapes: power / sv [C, P, R]; dr, tvg_shift, absorption, offset [C, P];
// bounds [C, n_r + 1] int32 sample bounds in [0, R]; s1, n1 [C, P, n_r].
extern "C" int ep_sv_bin_partials(const void* power, const void* dr, const void* tvg_shift,
                                  const void* absorption, const void* offset,
                                  const void* bounds, void* sv, void* s1, void* n1, int C,
                                  int P, int R, int n_r, void* stream) {
  if (C == 0 || P == 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid = static_cast<unsigned>(C) * static_cast<unsigned>(P);
  sv_bin_partials_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(power), static_cast<const float*>(dr),
      static_cast<const float*>(tvg_shift), static_cast<const float*>(absorption),
      static_cast<const float*>(offset), static_cast<const int*>(bounds),
      static_cast<float*>(sv), static_cast<float*>(s1), static_cast<float*>(n1), P, R, n_r);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ep_mvbs_partials(const void* power, const void* dr, const void* tvg_shift,
                                const void* absorption, const void* offset, const void* bounds,
                                void* s1, void* n1, int C, int P, int R, int n_r,
                                void* stream) {
  if (C == 0 || P == 0 || n_r == 0) return static_cast<int>(cudaGetLastError());
  const Args a{static_cast<const float*>(power), static_cast<const float*>(dr),
               static_cast<const float*>(tvg_shift), static_cast<const float*>(absorption),
               static_cast<const float*>(offset), static_cast<const int*>(bounds),
               static_cast<float*>(s1), static_cast<float*>(n1), P, R, n_r};
  const dim3 grid(static_cast<unsigned>((P + kSlab - 1) / kSlab), static_cast<unsigned>(C));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R % 4 == 0 && aligned16(power)) {
    mvbs_partials_kernel<true><<<grid, kThreads, 0, st>>>(a);
  } else {
    mvbs_partials_kernel<false><<<grid, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
