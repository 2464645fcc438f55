// Negative-tracer mass borrowing (fillz), a block of columns of one tracer
// staged through shared memory.
//
// Replaces pace_tpu/ops/pallas/fillz_pallas.py:fix_tracer_pallas (its body
// _kernel).  Per column of each stacked tracer it computes, operation for
// operation as the scan form pace_torch.ops.fillz.fix_tracer_plain:
//   1. fix_top: level 0 gives its deficit to level 1;
//   2. a forward borrow over k = 1..nz-2, from the level above first and
//      then from the original level below;
//   3. the accounting of the upward borrows (level k-1 pays what level k
//      took from it);
//   4. fix_bottom;
//   5. when any level was negative, a positive-definite rescale of levels
//      k >= 1 by sum(dm) / sum(max(dm, 0)) (with the sum1 == 0 guard);
//      level 0 passes through unchanged.
//
// What bounds it on the card: memory, then the latency of the recurrence.
// A call must read the tracer stack and dp and write the stack: at
// (9, 6, 56, 56, 79) float32 113 MB, 34 us at 3.35 TB/s.  Steps 1-4 are a
// recurrence in k with up to four IEEE divisions a level (each a
// reciprocal, five dependent multiply-adds and a range check on this
// card), which cannot be split across threads without changing the order
// of the arithmetic, so the parallelism is tracers x columns (9 x 18,816
// at C48), and only the columns that hold a negative value need it at all
// (3 in 10,000 in a baroclinic step).
//
// The design:
//   - In the k-last layout kCols consecutive columns of one tracer are one
//     contiguous chunk of kCols * nz values.  A block stages its chunk of q
//     and of dp into shared memory with every thread, as 16-byte cp.async
//     copies, all in flight at once.  Where the chunk does not start on a
//     16-byte boundary (odd nz makes that depend on the column and the
//     tracer) the shared copy is shifted by the same misalignment, the few
//     leading and trailing values go as single-value copies and the rest
//     still as 16-byte ones.  With an odd nz the chunk lies in shared
//     memory as in device memory and column strides hit distinct banks;
//     an even nz is padded to an odd column stride and copied value by
//     value.
//   - Blocks of one column range are neighbours (the tracer index runs
//     fastest in blockIdx), so dp comes from device memory once and from L2
//     for the other tracers.  A block that owned all tracers of its columns
//     would stage dp once, but its shared memory would grow with the number
//     of tracers (10 chunks at T = 9: 50 KB for 16 columns at float32, 101
//     KB at float64); one tracer per block takes 2 chunks for any T (20 KB
//     for 32 columns at float32, 40 KB at float64, nz = 79), so 10 or 5
//     blocks share an SM.  Shared memory is what bounds the columns in
//     flight, and with them how much of the recurrence's latency is hidden.
//   - Every thread then helps decide, per column, whether the recurrence is
//     needed.  A column is left as a copy (level 0 clamped at 0) only when
//     no q is negative and every dp is finite and non-zero: the plain
//     version divides a zero borrow by dp at every level, so a zero or
//     non-finite dp makes a NaN even in a column without negatives, and
//     such a column takes the full path with that division kept.  A NaN q
//     compares false and passes through both paths alike.
//   - The recurrence runs one thread per column (one full warp at kCols =
//     32), in place in shared memory; the same thread takes the rescale
//     sums over k in ascending order, as the one-column-per-thread kernel
//     before it did.  The rescale itself and the only write of the output
//     are one coalesced pass of all threads out of shared memory.  The
//     kernel allocates nothing.
//   - 32 columns and 128 threads a block were the fastest of the sizes
//     tried on an H100 (16 to 128 columns, 32 to 512 threads).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;      // columns per block
constexpr int kThreads = 128;  // threads per block
constexpr int kWarps = kThreads / 32;
static_assert(kThreads % 32 == 0 && kThreads >= kCols, "one thread a column");

// minimum/maximum that propagate NaN like torch.minimum/torch.clamp
template <typename R>
__device__ __forceinline__ R pmin(R a, R b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
template <typename R>
__device__ __forceinline__ R pmax(R a, R b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
#ifdef __CUDA_ARCH__
// float32: one instruction each (sm_80 and later)
template <>
__device__ __forceinline__ float pmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
template <>
__device__ __forceinline__ float pmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
#endif

// a column stride padded to an odd element count
__host__ __device__ __forceinline__ int odd(int s) { return s | 1; }

// elements of one staged array: kCols columns, room for the shift that
// matches the device chunk's misalignment, a multiple of 16 bytes
template <typename R>
__host__ __device__ __forceinline__ int array_elems(int nz) {
  constexpr int V = 16 / sizeof(R);
  return (kCols * odd(nz) + V - 1) / V * V + V;
}
template <typename R>
__host__ __device__ __forceinline__ size_t smem_bytes(int nz) {
  return sizeof(R) * (2 * array_elems<R>(nz) + kCols) + sizeof(int) * kCols;
}

// asynchronous copies from device to shared memory (cp.async: no register
// staging, so all of a thread's copies are in flight at once)
template <typename R>
__device__ __forceinline__ void copy_async(R* s, const R* g) {
#ifdef __CUDA_ARCH__
  const unsigned dst = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(g), "n"(sizeof(R)));
#else
  *s = *g;
#endif
}
// 16 bytes; both addresses 16-byte aligned
template <typename R>
__device__ __forceinline__ void copy_async16(R* s, const R* g) {
#ifdef __CUDA_ARCH__
  const unsigned dst = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(g));
#else
  for (int i = 0; i < (int)(16 / sizeof(R)); ++i) s[i] = g[i];
#endif
}
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Start the copy of ncb columns of nz values, contiguous at g, into the
// shared array at s_base (16-byte aligned); returns where column 0 lies.
// Column c starts S values after column c - 1.
template <typename R>
__device__ __forceinline__ R* stage_in(R* s_base, const R* g, int ncb, int nz,
                                       int S) {
  constexpr int V = 16 / sizeof(R);
  if (S != nz) {  // padded columns: a warp per column, lanes along k
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int c = warp; c < ncb; c += kWarps)
      for (int k = lane; k < nz; k += 32)
        copy_async(s_base + c * S + k, g + (long)c * nz + k);
    return s_base;
  }
  // one flat chunk: shift the shared copy by the chunk's misalignment, so
  // that all but a few values at its ends move as aligned 16-byte copies
  const int n = ncb * nz;
  const int mis = (int)((reinterpret_cast<uintptr_t>(g) / sizeof(R)) % V);
  R* s = s_base + mis;
  const int head = min((V - mis) % V, n);
  const int nvec = (n - head) / V;
  if ((int)threadIdx.x < head) copy_async(s + threadIdx.x, g + threadIdx.x);
  for (int v = threadIdx.x; v < nvec; v += kThreads)
    copy_async16(s + head + v * V, g + head + v * V);
  for (int i = head + nvec * V + threadIdx.x; i < n; i += kThreads)
    copy_async(s + i, g + i);
  return s;
}

// Steps 1-4 on one column, in place (level k - 1 is written after levels k
// and k + 1 were read), then the rescale sums.  Returns the rescale factor
// where the column is to be rescaled, else 0.
//
// A level holds four divisions, each used only where the level borrows.
// They stand in two branches of two independent divisions each, so that a
// warp none of whose columns borrows at a level passes it without a
// division, and one that does runs two divisions side by side twice
// instead of four one after the other: with the borrow from above, the
// accounting's share of it; with the borrow from below, the share that
// the next level subtracts (over the next dp).  The quotients are the
// plain version's, bit for bit.
// kDpOk: every dp of the column is finite and non-zero, so a zero borrow
// divided by dp is a zero and the accounting leaves that division out
// (most levels borrow nothing); otherwise it is the plain version's
// 0 / dp, NaN for a zero or NaN dp.
template <typename R, bool kDpOk>
__device__ __forceinline__ R fix_column(R* qc, const R* d, int nz) {
  // 1. fix_top
  const R qc0 = qc[0], d0 = d[0];
  R dp_k = d[1];
  R q_in = (qc0 < R(0)) ? qc[1] + qc0 * d0 / dp_k : qc[1];

  // 2. forward borrow k = 1..nz-2; q_prev is q_new[k-1], still owed the
  //    accounting of level k; low_q is lower_fix[k-1] / dp[k] where
  //    lower_fix[k-1] != 0 (low_prev)
  R q_prev = pmax(qc0, R(0)), dp_prev = d0, low_q = R(0);
  bool low_prev = false, zfix = false;
  for (int k = 1; k <= nz - 2; ++k) {
    const R q_next_orig = qc[k + 1];
    const R dp_next = d[k + 1];
    const R q_k = low_prev ? q_in - low_q : q_in;
    const bool neg0 = q_k < R(0);
    const bool can_up = neg0 && q_prev > R(0);
    R q_k1 = q_k;
    // 3. accounting: q_new[k-1] -= upper_fix[k] / dp[k-1]
    R q_acc = kDpOk ? q_prev : q_prev - R(0) / dp_prev;
    if (can_up) {
      const R dq_up = pmin(q_prev * dp_prev, -(q_k * dp_k));
      q_k1 = q_k + dq_up / dp_k;
      q_acc = q_prev - dq_up / dp_prev;
    }
    qc[k - 1] = q_acc;
    R q_k2 = q_k1;
    low_prev = false;
    if (q_k1 < R(0) && q_next_orig > R(0)) {
      const R dq_lo = pmin(q_next_orig * dp_next, -(q_k1 * dp_k));
      q_k2 = q_k1 + dq_lo / dp_k;
      low_q = dq_lo / dp_next;
      low_prev = dq_lo != R(0);
    }
    zfix = zfix || neg0;
    q_prev = q_k2;
    dp_prev = dp_k;
    q_in = q_next_orig;
    dp_k = dp_next;
  }
  // level nz-2 owes upper_fix[nz-1] = 0: the division stays, a zero or
  // non-finite dp makes a NaN of it as in the plain version
  if (!kDpOk) q_prev = q_prev - R(0) / dp_prev;

  // 4. fix_bottom (low_q is lower_fix[nz-2] / dp[nz-1], dp_k is dp[nz-1])
  R q_bot = low_prev ? q_in - low_q : q_in;
  const R qup = q_prev * dp_prev;
  const R qly = -q_bot * dp_k;
  const R dup = pmin(qup, qly);
  const bool bot_fix = q_bot < R(0) && q_prev > R(0);
  q_bot = bot_fix ? q_bot + dup / dp_k : q_bot;
  qc[nz - 2] = bot_fix ? q_prev - dup / dp_prev : q_prev;
  qc[nz - 1] = q_bot;
  zfix = zfix || bot_fix;

  // 5. the sums of the positive-definite rescale of levels 1..nz-1
  R sum0 = R(0), sum1 = R(0);
  for (int k = 1; k < nz; ++k) {
    const R dm = qc[k] * d[k];
    sum0 = sum0 + dm;
    sum1 = sum1 + pmax(dm, R(0));
  }
  const R fac = (sum0 > R(0)) ? sum0 / ((sum1 == R(0)) ? R(1) : sum1) : R(0);
  return (zfix && fac > R(0)) ? fac : R(0);
}

template <typename R>
__global__ void __launch_bounds__(kThreads)
    fillz_kernel(const R* __restrict__ q, const R* __restrict__ dp,
                 R* __restrict__ out, int ntracer, int ncol, int nz) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  R* smem = reinterpret_cast<R*>(smem_raw);
  const int S = odd(nz);
  const int arr = array_elems<R>(nz);
  R* s_fac = smem + 2 * arr;  // per column: the rescale factor, or 0
  int* s_need = reinterpret_cast<int*>(s_fac + kCols);

  // the tracer index runs fastest: the blocks that share dp are neighbours
  const int t = blockIdx.x % ntracer;
  const int c0 = (blockIdx.x / ntracer) * kCols;
  const int ncb = min(kCols, ncol - c0);
  const long D0 = (long)c0 * nz;
  const long Q0 = (long)t * ncol * nz + D0;
  R* s_q = stage_in(smem, q + Q0, ncb, nz, S);
  const R* s_dp = stage_in(smem + arr, dp + D0, ncb, nz, S);
  if (threadIdx.x < kCols) s_need[threadIdx.x] = 0;
  copy_wait();
  __syncthreads();

  // which columns need the recurrence: any negative q (bit 0), or any dp
  // that is zero or not finite (bit 1; dp - dp is 0 only for a finite dp)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = warp; c < ncb; c += kWarps) {
    int need = 0;
    for (int k = lane; k < nz; k += 32) {
      const R qv = s_q[c * S + k], dv = s_dp[c * S + k];
      need |= (qv < R(0) ? 1 : 0) |
              ((!(dv - dv == R(0)) || dv == R(0)) ? 2 : 0);
    }
    if (need) atomicOr(&s_need[c], need);
  }
  __syncthreads();

  if ((int)threadIdx.x < ncb) {
    const int c = threadIdx.x;
    R* qc = s_q + c * S;
    R fac = R(0);
    const int need = s_need[c];
    if (need & 2)
      fac = fix_column<R, false>(qc, s_dp + c * S, nz);
    else if (need)
      fac = fix_column<R, true>(qc, s_dp + c * S, nz);
    else
      qc[0] = pmax(qc[0], R(0));
    s_fac[c] = fac;
  }
  __syncthreads();

  // the rescale where a column takes one, and the only write of the output
  for (int c = warp; c < ncb; c += kWarps) {
    const R fac = s_fac[c];
    R* o = out + Q0 + (long)c * nz;
    for (int k = lane; k < nz; k += 32) {
      R v = s_q[c * S + k];
      if (fac > R(0) && k >= 1) {
        const R dv = s_dp[c * S + k];
        v = pmax(fac * (v * dv) / dv, R(0));
      }
      o[k] = v;
    }
  }
}

template <typename R>
int launch(const void* q, const void* dp, void* out, int ntracer, int ncol,
           int nz, void* stream) {
  const long blocks = (long)((ncol + kCols - 1) / kCols) * ntracer;
  if (blocks <= 0 || blocks > 0x7fffffffL)
    return (int)cudaErrorInvalidConfiguration;
  const size_t bytes = smem_bytes<R>(nz);
  // above 48 KB a block's dynamic shared memory must be allowed first
  static size_t allowed = 48 * 1024;
  if (bytes > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        fillz_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    allowed = bytes;
  }
  fillz_kernel<R><<<(unsigned)blocks, kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const R*>(q), static_cast<const R*>(dp),
      static_cast<R*>(out), ntracer, ncol, nz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pace_fillz_f32(const void* q, const void* dp, void* out,
                              int ntracer, int ncol, int nz, void* stream) {
  return launch<float>(q, dp, out, ntracer, ncol, nz, stream);
}
extern "C" int pace_fillz_f64(const void* q, const void* dp, void* out,
                              int ntracer, int ncol, int nz, void* stream) {
  return launch<double>(q, dp, out, ntracer, ncol, nz, stream);
}
