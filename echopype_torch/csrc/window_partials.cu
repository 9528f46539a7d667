// Fused survey step for Hopper: power -> Sv -> linear domain ->
// range-bin sums -> ping-window sums, in one pass over the power chunk.
//
// Replaces the TPU Pallas kernels in echopype_tpu/ops/pallas_window.py:
//   K1 ep_window_partials_uniform <- window_partials_pallas_uniform
//      (per-channel uniform dr: the spreading log is one [C, R] row)
//   K2 ep_window_partials         <- window_partials_pallas
//      (per-ping dr, TVG shift and first valid sample; one log10f per sample)
// Like the Pallas kernels, both take int16 sample indices (EK60/EK80 power,
// scaled by INDEX2POWER here) or float32 dB power (AZFP): the sample type is
// a template parameter of the row load and the per-sample arithmetic, and
// the *_f32 entry points are its float32 instances.  The int16 instances
// are the code they were before float32 was added.
//
// What bounds it on an H100: one read of the int16 power (2 bytes a sample,
// ~200 MB for a 5 x 5000 x 4000 chunk, 60 us at 3.35 TB/s) against the
// instructions a sample needs (the int16 conversion, the sonar equation,
// the library expf, and log10f in K2, one add), at 128 thread-instructions
// per clock per SM.  K1 is bound by bytes, K2 by its accurate log10f's
// instructions.  The outputs are tiny ([C, W, n_r]).
//
// Design: stream rows, accumulate per sample, reduce per bin once.
// * One block owns one (channel, ping slab): a run of at most ~32 pings of
//   one window bin (the host's slab plan, ops/window_partials.py::slab_plan,
//   says how many slabs each window has; the slab's pings follow from the
//   window's bounds in xb; a window of many pings has many slabs, so the
//   grid fills the card for any number of windows).
// * The threads span the range axis: each owns 8 consecutive samples of a
//   2,048-sample segment, loads them as one 16-byte vector per ping (scalar
//   loads where rows are not 16-byte aligned, R % 8 != 0), keeps kRowsK1 /
//   kRowsK2 rows in flight, and sums each sample's linear value over the
//   slab's pings in float32.  K1 holds its samples' spreading and 2r terms
//   in registers.  The 8 samples of a row are computed without branches
//   and masked when added, so the scheduler sees 8 independent chains a
//   thread (with a branch per sample the chains ran one after another).
// * At the end of a segment the per-sample sums go to shared memory and
//   one warp per range bin adds the bin's samples in a fixed order.
// * Where a window has several slabs, a second small kernel adds the slab
//   partials in slab order; a window of one slab is written directly.
// * Counts are closed form: sum over pings of
//   max(0, min(hi, valid_len) - max(lo, k0)), in int32, exact.
// No atomics anywhere, so a rerun is bit-identical.
//
// float32 dB power follows the XLA step the JAX survey runs for AZFP
// (echopype_tpu/parallel/pipeline.py::_closed_s1_n1), not the Pallas body,
// which would spread a NaN over its bins: a sample whose Sv is NaN adds 0
// to its bin, every non-NaN sample from k0 on is added whatever the valid
// length, and counts stay closed form from the valid length.  Its rows load
// as two 16-byte vectors of 4 samples a thread (scalar where R % 4 != 0).
//
// Numerics.  Bin bounds and first valid samples come from the host
// (closed_bounds_k0_np): nothing is divided on the device.  Every step of
// the sonar equation uses round-to-nearest intrinsics so that no FMA
// contraction moves the result away from the plain float32 version, and the
// library expf/log10f are used (no fast-math intrinsics).  Only the order of
// the float32 additions differs from the plain version.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr float kIndex2Power = 0.011758984205624481f;  // 10*log10(2)/256
constexpr float kLn10Over10 = 0.23025850929940458f;    // 10^(x/10) = exp(x*ln10/10)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                   // samples a thread owns in a segment
constexpr int kSeg = kThreads * kVec;     // samples a segment spans
constexpr int kCombineThreads = 256;
// rows a thread keeps in flight: K1 (<= 80 registers at 3 blocks an SM)
// has room for more than K2's longer chains.  A float32 row holds twice the
// registers of an int16 one, so K1's float32 instance keeps half the rows
// (the same 16 load registers a thread).
constexpr int kRowsK1 = 4;
constexpr int kRowsK1F32 = 2;
constexpr int kRowsK2 = 2;

template <typename T>
struct Args {
  const T* power;            // [C, P, R] int16 indices or float32 dB
  const float* sprd_row;     // K1: [C, R] 20 log10(k dr - shift), -inf below k0
  const float* rt2_row;      // K1: [C, R] 2 (k dr - shift)
  const float* dr;           // K2: [C, P]
  const float* tvg_shift;    // K2: [C, P]
  const float* absorption;   // [C, P]
  const float* offset;       // [C, P]
  const int* k0;             // K2: [C, P] first valid sample
  const int* valid_len;      // [C, P]
  const int* xb;             // [W + 1]: window w is pings [xb[w], xb[w+1])
  const int* slab_window;    // [n_slabs]: the window of slab s
  const int* win_first;      // [W + 1]: window w owns slabs [wf[w], wf[w+1])
  const int* bounds;         // [C, n_r + 1] range-bin sample bounds
  float* sums;               // [C, n_slabs, n_r]
  float* counts;             // [C, n_slabs, n_r] or null
  int P, R, n_slabs, n_r;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Two int16 samples packed in one 32-bit word -> two exact floats.
__device__ __forceinline__ void unpack2(uint32_t w, float& lo, float& hi) {
  lo = static_cast<float>(static_cast<int16_t>(w & 0xffffu));
  hi = static_cast<float>(static_cast<int32_t>(w) >> 16);
}

// The thread's 8 samples of one row: int16 packed two to a word as in
// memory, float32 as they are.
template <typename T>
struct Row8;
template <>
struct Row8<int16_t> {
  uint32_t w[kVec / 2];
};
template <>
struct Row8<float> {
  float v[kVec];
};

// kVec16: one 16-byte load (row and k 16-byte aligned); else scalar loads,
// zero past R.
template <bool kVec16>
__device__ __forceinline__ Row8<int16_t> load_row(const int16_t* row, int k, int R) {
  Row8<int16_t> r;
  if (kVec16) {
    const int4 raw = __ldcs(reinterpret_cast<const int4*>(row + k));
    r.w[0] = static_cast<uint32_t>(raw.x);
    r.w[1] = static_cast<uint32_t>(raw.y);
    r.w[2] = static_cast<uint32_t>(raw.z);
    r.w[3] = static_cast<uint32_t>(raw.w);
  } else {
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const int j = k + 2 * i;
      const uint32_t lo = j < R ? static_cast<uint16_t>(__ldcs(row + j)) : 0u;
      const uint32_t hi = j + 1 < R ? static_cast<uint16_t>(__ldcs(row + j + 1)) : 0u;
      r.w[i] = lo | (hi << 16);
    }
  }
  return r;
}

// kVec16: two 16-byte loads (R % 4 == 0, row 16-byte aligned; the second
// only where it lies inside the row); else scalar loads, zero past R.
// Samples past R lie in no bin.
template <bool kVec16>
__device__ __forceinline__ Row8<float> load_row(const float* row, int k, int R) {
  Row8<float> r;
  if (kVec16) {
    const float4* p = reinterpret_cast<const float4*>(row + k);
    const float4 u = __ldcs(p);
    const float4 v = k + 4 < R ? __ldcs(p + 1) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    r.v[0] = u.x, r.v[1] = u.y, r.v[2] = u.z, r.v[3] = u.w;
    r.v[4] = v.x, r.v[5] = v.y, r.v[6] = v.z, r.v[7] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) r.v[j] = k + j < R ? __ldcs(row + k + j) : 0.0f;
  }
  return r;
}

__device__ __forceinline__ void unpack(const Row8<int16_t>& r, float (&x)[kVec]) {
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) unpack2(r.w[i], x[2 * i], x[2 * i + 1]);
}

__device__ __forceinline__ void unpack(const Row8<float>& r, float (&x)[kVec]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) x[j] = r.v[j];
}

// Per-ping scalars of one row.
struct Ping {
  float ab, off, d, sh;
  int k0, vl;
};

template <bool kUniform, typename T>
__device__ __forceinline__ Ping load_ping(const Args<T>& a, size_t cp) {
  Ping q;
  q.ab = __ldg(a.absorption + cp);
  q.off = __ldg(a.offset + cp);
  q.vl = __ldg(a.valid_len + cp);
  if (kUniform) {
    q.d = q.sh = 0.0f;
    q.k0 = 0;  // bounds are pre-clipped to [k0, R]; sprd_row is -inf below k0
  } else {
    q.d = __ldg(a.dr + cp);
    q.sh = __ldg(a.tvg_shift + cp);
    q.ab = 2.0f * q.ab;  // exact
    q.k0 = __ldg(a.k0 + cp);
  }
  return q;
}

// acc[j] += 10^(Sv/10) of sample k + j of one row, for k0 <= k + j < vl
// (int16), or for k0 <= k + j where Sv is not NaN (float32 dB).
// K1: c1 = spreading row, c2 = 2r row; K2: c1 = float(k + j).  The 8
// samples are computed without branches (8 independent chains for the
// scheduler) and masked when added; a masked sample's value is never added.
template <bool kUniform, typename T>
__device__ __forceinline__ void add_row(const Row8<T>& r, const Ping& q, int k,
                                        const float (&c1)[kVec], const float (&c2)[kVec],
                                        float (&acc)[kVec]) {
  constexpr bool kDb = std::is_same<T, float>::value;
  if (k + kVec <= q.k0 || (!kDb && k >= q.vl)) return;  // no valid sample here
  float x[kVec];
  unpack(r, x);
  float e[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float p = kDb ? x[j] : __fmul_rn(x[j], kIndex2Power);
    float sv;
    if (kUniform) {
      sv = __fadd_rn(p, c1[j]);
      sv = __fadd_rn(sv, __fmul_rn(q.ab, c2[j]));
    } else {
      const float r_tvg = __fsub_rn(__fmul_rn(c1[j], q.d), q.sh);
      const float spread = __fmul_rn(20.0f, log10f(fmaxf(r_tvg, 1e-20f)));
      sv = __fadd_rn(p, spread);
      sv = __fadd_rn(sv, __fmul_rn(q.ab, r_tvg));
    }
    sv = __fadd_rn(sv, q.off);
    e[j] = expf(__fmul_rn(sv, kLn10Over10));
  }
  if constexpr (kDb) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] += (k + j >= q.k0 && !isnan(e[j])) ? e[j] : 0.0f;
  } else if (k >= q.k0 && k + kVec <= q.vl) {  // the common case: all 8 valid
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] += e[j];
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] += (k + j >= q.k0 && k + j < q.vl) ? e[j] : 0.0f;
  }
}

// kRows rows starting at ping p: all loads first, then the arithmetic.
template <typename T, bool kUniform, bool kVec16, int kRows>
__device__ __forceinline__ void add_rows(const Args<T>& a, const T* base, size_t cp, int k,
                                         const float (&c1)[kVec], const float (&c2)[kVec],
                                         float (&acc)[kVec]) {
  Row8<T> r[kRows];
  Ping q[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    r[u] = load_row<kVec16>(base + static_cast<size_t>(u) * a.R, k, a.R);
    q[u] = load_ping<kUniform>(a, cp + u);
  }
#pragma unroll
  for (int u = 0; u < kRows; ++u) add_row<kUniform>(r[u], q[u], k, c1, c2, acc);
}

// Blocks per SM the register budget must allow: K1 <= 80 registers, K2 up
// to 128.
template <typename T, bool kUniform, bool kVec16>
__global__ void __launch_bounds__(kThreads, kUniform ? 3 : 2)
slab_partials_kernel(const Args<T> a) {
  constexpr bool kDb = std::is_same<T, float>::value;
  constexpr int kRows = kUniform ? (kDb ? kRowsK1F32 : kRowsK1) : kRowsK2;
  __shared__ __align__(16) float s_lin[kSeg];
  const int s = blockIdx.x;
  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // slab i of the n of window w: pings [x0 + i len / n, x0 + (i+1) len / n)
  const int w = a.slab_window[s];
  const int i = s - a.win_first[w];
  const int n = a.win_first[w + 1] - a.win_first[w];
  const int x0 = a.xb[w];
  const long long len = a.xb[w + 1] - x0;
  const int p0 = x0 + static_cast<int>(i * len / n);
  const int p1 = x0 + static_cast<int>((i + 1) * len / n);
  const int* bnd = a.bounds + static_cast<size_t>(c) * (a.n_r + 1);
  const int k_lo = bnd[0];
  const int k_hi = bnd[a.n_r];  // samples outside [k_lo, k_hi) lie in no bin
  const size_t out0 = (static_cast<size_t>(c) * a.n_slabs + s) * a.n_r;

  // each bin belongs to one warp, whose lane 0 alone writes it
  if (lane == 0) {
    for (int b = warp; b < a.n_r; b += kWarps) a.sums[out0 + b] = 0.0f;
  }

  for (int seg0 = (k_lo / kSeg) * kSeg; seg0 < k_hi; seg0 += kSeg) {
    const int k = seg0 + threadIdx.x * kVec;
    float acc[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
    if (k < k_hi && k + kVec > k_lo && p1 > p0) {
      float c1[kVec], c2[kVec];
      if (kUniform) {
        const float* sprd = a.sprd_row + static_cast<size_t>(c) * a.R;
        const float* rt2 = a.rt2_row + static_cast<size_t>(c) * a.R;
        if (kVec16) {  // rows of R % 8 == 0 (float32 power: R % 4 == 0) floats
          const float4* s4 = reinterpret_cast<const float4*>(sprd + k);
          const float4* r4 = reinterpret_cast<const float4*>(rt2 + k);
#pragma unroll
          for (int i = 0; i < kVec / 4; ++i) {
            const bool in = !kDb || k + 4 * i < a.R;  // float32: the row may end mid-thread
            const float4 u = in ? __ldg(s4 + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            const float4 v = in ? __ldg(r4 + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            c1[4 * i] = u.x, c1[4 * i + 1] = u.y, c1[4 * i + 2] = u.z, c1[4 * i + 3] = u.w;
            c2[4 * i] = v.x, c2[4 * i + 1] = v.y, c2[4 * i + 2] = v.z, c2[4 * i + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const bool in = k + j < a.R;
            c1[j] = in ? __ldg(sprd + k + j) : 0.0f;
            c2[j] = in ? __ldg(rt2 + k + j) : 0.0f;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          c1[j] = static_cast<float>(k + j);
          c2[j] = 0.0f;
        }
      }
      const size_t cp0 = static_cast<size_t>(c) * a.P;
      int p = p0;
      for (; p + kRows <= p1; p += kRows) {
        add_rows<T, kUniform, kVec16, kRows>(a, a.power + (cp0 + p) * a.R, cp0 + p, k, c1, c2,
                                             acc);
      }
      for (; p < p1; ++p) {
        add_rows<T, kUniform, kVec16, 1>(a, a.power + (cp0 + p) * a.R, cp0 + p, k, c1, c2, acc);
      }
    }
    float4* dst = reinterpret_cast<float4*>(s_lin + threadIdx.x * kVec);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    __syncthreads();
    const int seg1 = min(seg0 + kSeg, a.R);
    for (int b = warp; b < a.n_r; b += kWarps) {
      const int lo = max(bnd[b], seg0);
      const int hi = min(bnd[b + 1], seg1);
      if (lo >= hi) continue;
      float v = 0.0f;
      for (int i = lo + lane; i < hi; i += 32) v += s_lin[i - seg0];
      v = warp_sum(v);
      if (lane == 0) a.sums[out0 + b] += v;
    }
    __syncthreads();
  }

  if (a.counts != nullptr) {
    const size_t cp0 = static_cast<size_t>(c) * a.P;
    for (int b = threadIdx.x; b < a.n_r; b += kThreads) {
      const int lo = bnd[b];
      const int hi = bnd[b + 1];
      int n = 0;
      for (int p = p0; p < p1; ++p) {
        const int start = kUniform ? lo : max(lo, __ldg(a.k0 + cp0 + p));
        n += max(0, min(hi, __ldg(a.valid_len + cp0 + p)) - start);
      }
      a.counts[out0 + b] = static_cast<float>(n);
    }
  }
}

// sums[c, w, b] = sum of the partials of window w's slabs, in slab order.
__global__ void __launch_bounds__(kCombineThreads)
combine_slabs_kernel(const float* __restrict__ psums, const float* __restrict__ pcounts,
                     const int* __restrict__ win_first, float* __restrict__ sums,
                     float* __restrict__ counts, int C, int W, int n_r, int n_slabs) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kCombineThreads + threadIdx.x;
  if (i >= static_cast<size_t>(C) * W * n_r) return;
  const int b = static_cast<int>(i % n_r);
  const int w = static_cast<int>((i / n_r) % W);
  const int c = static_cast<int>(i / (static_cast<size_t>(n_r) * W));
  float acc = 0.0f;
  int n = 0;
  for (int s = win_first[w]; s < win_first[w + 1]; ++s) {
    const size_t j = (static_cast<size_t>(c) * n_slabs + s) * n_r + b;
    acc += psums[j];
    if (counts != nullptr) n += static_cast<int>(pcounts[j]);  // exact integers
  }
  sums[i] = acc;
  if (counts != nullptr) counts[i] = static_cast<float>(n);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Slab kernel, then (unless every window is one slab) the combine kernel.
template <typename T, bool kUniform>
int launch(Args<T> a, float* partial_sums, float* partial_counts, float* sums, float* counts,
           int C, int W, cudaStream_t stream) {
  const bool direct = partial_sums == nullptr;  // n_slabs == W: slab s is window s
  a.sums = direct ? sums : partial_sums;
  a.counts = counts == nullptr ? nullptr : (direct ? counts : partial_counts);
  // rows of whole 16-byte vectors: 8 int16 or 4 float32 samples
  const bool vec16 = a.R % (16 / static_cast<int>(sizeof(T))) == 0 && aligned16(a.power) &&
                     (!kUniform || (aligned16(a.sprd_row) && aligned16(a.rt2_row)));
  const dim3 grid(static_cast<unsigned>(a.n_slabs), static_cast<unsigned>(C));
  if (vec16) {
    slab_partials_kernel<T, kUniform, true><<<grid, kThreads, 0, stream>>>(a);
  } else {
    slab_partials_kernel<T, kUniform, false><<<grid, kThreads, 0, stream>>>(a);
  }
  if (!direct) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t n = static_cast<size_t>(C) * W * a.n_r;
    const unsigned blocks = static_cast<unsigned>((n + kCombineThreads - 1) / kCombineThreads);
    combine_slabs_kernel<<<blocks, kCombineThreads, 0, stream>>>(
        partial_sums, a.counts, a.win_first, sums, counts, C, W, a.n_r, a.n_slabs);
  }
  return static_cast<int>(cudaGetLastError());
}

// Entry-point bodies, shared by the int16 and float32 instances.
template <typename T>
int window_partials_uniform(const void* power, const void* sprd_row, const void* rt2_row,
                            const void* absorption, const void* offset, const void* valid_len,
                            const void* xb, const void* plan, const void* bounds,
                            void* partial_sums, void* partial_counts, void* sums, void* counts,
                            int C, int P, int R, int W, int n_r, int n_slabs, void* stream) {
  if (C == 0 || W == 0 || n_r == 0) return static_cast<int>(cudaGetLastError());
  Args<T> a{};
  a.power = static_cast<const T*>(power);
  a.sprd_row = static_cast<const float*>(sprd_row);
  a.rt2_row = static_cast<const float*>(rt2_row);
  a.absorption = static_cast<const float*>(absorption);
  a.offset = static_cast<const float*>(offset);
  a.valid_len = static_cast<const int*>(valid_len);
  a.xb = static_cast<const int*>(xb);
  a.slab_window = static_cast<const int*>(plan);
  a.win_first = a.slab_window + n_slabs;
  a.bounds = static_cast<const int*>(bounds);
  a.P = P;
  a.R = R;
  a.n_slabs = n_slabs;
  a.n_r = n_r;
  return launch<T, true>(a, static_cast<float*>(partial_sums),
                         static_cast<float*>(partial_counts), static_cast<float*>(sums),
                         static_cast<float*>(counts), C, W, static_cast<cudaStream_t>(stream));
}

template <typename T>
int window_partials(const void* power, const void* dr, const void* tvg_shift,
                    const void* absorption, const void* offset, const void* k0,
                    const void* valid_len, const void* xb, const void* plan, const void* bounds,
                    void* partial_sums, void* partial_counts, void* sums, void* counts, int C,
                    int P, int R, int W, int n_r, int n_slabs, void* stream) {
  if (C == 0 || W == 0 || n_r == 0) return static_cast<int>(cudaGetLastError());
  Args<T> a{};
  a.power = static_cast<const T*>(power);
  a.dr = static_cast<const float*>(dr);
  a.tvg_shift = static_cast<const float*>(tvg_shift);
  a.absorption = static_cast<const float*>(absorption);
  a.offset = static_cast<const float*>(offset);
  a.k0 = static_cast<const int*>(k0);
  a.valid_len = static_cast<const int*>(valid_len);
  a.xb = static_cast<const int*>(xb);
  a.slab_window = static_cast<const int*>(plan);
  a.win_first = a.slab_window + n_slabs;
  a.bounds = static_cast<const int*>(bounds);
  a.P = P;
  a.R = R;
  a.n_slabs = n_slabs;
  a.n_r = n_r;
  return launch<T, false>(a, static_cast<float*>(partial_sums),
                          static_cast<float*>(partial_counts), static_cast<float*>(sums),
                          static_cast<float*>(counts), C, W, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Shapes: power [C, P, R] int16 (the *_f32 entry points: float32 dB);
// rows [C, R]; per-ping [C, P]; xb int32
// [W + 1]; plan int32 [n_slabs + W + 1] (each slab's window, then each
// window's first slab); bounds [C, n_r + 1]; sums/counts [C, W, n_r] f32,
// counts may be null (sums only).  partial_sums/partial_counts
// [C, n_slabs, n_r] f32 scratch, null when n_slabs == W (every window
// exactly one slab, written directly).
#define EP_UNIFORM_ARGS                                                                    \
  const void *power, const void *sprd_row, const void *rt2_row, const void *absorption,    \
      const void *offset, const void *valid_len, const void *xb, const void *plan,         \
      const void *bounds, void *partial_sums, void *partial_counts, void *sums,            \
      void *counts, int C, int P, int R, int W, int n_r, int n_slabs, void *stream
#define EP_UNIFORM_PASS                                                                    \
  power, sprd_row, rt2_row, absorption, offset, valid_len, xb, plan, bounds, partial_sums, \
      partial_counts, sums, counts, C, P, R, W, n_r, n_slabs, stream
#define EP_ARGS                                                                            \
  const void *power, const void *dr, const void *tvg_shift, const void *absorption,        \
      const void *offset, const void *k0, const void *valid_len, const void *xb,           \
      const void *plan, const void *bounds, void *partial_sums, void *partial_counts,      \
      void *sums, void *counts, int C, int P, int R, int W, int n_r, int n_slabs,          \
      void *stream
#define EP_PASS                                                                            \
  power, dr, tvg_shift, absorption, offset, k0, valid_len, xb, plan, bounds, partial_sums, \
      partial_counts, sums, counts, C, P, R, W, n_r, n_slabs, stream

extern "C" int ep_window_partials_uniform(EP_UNIFORM_ARGS) {
  return window_partials_uniform<int16_t>(EP_UNIFORM_PASS);
}

extern "C" int ep_window_partials_uniform_f32(EP_UNIFORM_ARGS) {
  return window_partials_uniform<float>(EP_UNIFORM_PASS);
}

extern "C" int ep_window_partials(EP_ARGS) { return window_partials<int16_t>(EP_PASS); }

extern "C" int ep_window_partials_f32(EP_ARGS) { return window_partials<float>(EP_PASS); }
