// Negative-tracer mass borrowing (fillz), one thread per (tracer, column).
//
// Replaces pace_tpu/ops/pallas/fillz_pallas.py:fix_tracer_pallas (its body
// _kernel).  Per column of each stacked tracer it runs, operation for
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
// What bounds it on the card: memory latency.  The borrow pass is a
// sequential recurrence in k, so the parallelism is tracers x columns
// (9 x 18,816 at C48).  The tracer stack stays in the model's k-last
// layout, so neighbouring threads read addresses nz elements apart and
// every load is uncoalesced; dp is shared by the tracers and read from
// L2.  No scratch is needed: the upward-borrow accounting of level k-1 is
// applied as soon as level k is known, and the staged values live in the
// output column.

#include <cuda_runtime.h>

namespace {

template <typename R>
__device__ __forceinline__ R pmin(R a, R b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
template <typename R>
__device__ __forceinline__ R pmax(R a, R b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

template <typename R>
__global__ void fillz_kernel(const R* __restrict__ q, const R* __restrict__ dp,
                             R* out, int ntracer, int ncol, int nz) {
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long)ntracer * ncol) return;
  const long col = tid % ncol;
  const R* qc = q + tid * nz;   // this tracer's column
  const R* d = dp + col * nz;   // the shared pressure thickness column
  R* o = out + tid * nz;

  // 1. fix_top
  const R q1 = (qc[0] < R(0)) ? qc[1] + qc[0] * d[0] / d[1] : qc[1];
  const R q0 = pmax(qc[0], R(0));

  // 2. forward borrow k = 1..nz-2; carry (q_prev, dp_prev, low_prev)
  R q_prev = q0, dp_prev = d[0], low_prev = R(0);
  R pending = q0;  // q_new[k-1], still owed the accounting of level k
  bool zfix = false;
  for (int k = 1; k <= nz - 2; ++k) {
    R q_k = (k == 1) ? q1 : qc[k];
    const R dp_k = d[k];
    const R q_next_orig = qc[k + 1];
    const R dp_next = d[k + 1];
    q_k = (low_prev != R(0)) ? q_k - low_prev / dp_k : q_k;
    const bool neg0 = q_k < R(0);
    const bool can_up = neg0 && q_prev > R(0);
    const R dq_up = pmin(q_prev * dp_prev, -(q_k * dp_k));
    const R q_k1 = can_up ? q_k + dq_up / dp_k : q_k;
    const R upper_fix = can_up ? dq_up : R(0);
    const bool still_neg = q_k1 < R(0) && q_next_orig > R(0);
    const R dq_lo = pmin(q_next_orig * dp_next, -(q_k1 * dp_k));
    const R q_k2 = still_neg ? q_k1 + dq_lo / dp_k : q_k1;
    const R lower_fix = still_neg ? dq_lo : R(0);
    zfix = zfix || neg0;
    // 3. accounting: q_new[k-1] -= upper_fix[k] / dp[k-1]
    o[k - 1] = pending - upper_fix / d[k - 1];
    pending = q_k2;
    q_prev = q_k2;
    dp_prev = dp_k;
    low_prev = lower_fix;
  }
  // level nz-2 owes upper_fix[nz-1] = 0; level nz-1 is the original value

  // 4. fix_bottom (low_prev is lower_fix[nz-2])
  R q_bot = qc[nz - 1];
  q_bot = (low_prev != R(0)) ? q_bot - low_prev / d[nz - 1] : q_bot;
  const R qup = pending * d[nz - 2];
  const R qly = -q_bot * d[nz - 1];
  const R dup = pmin(qup, qly);
  const bool bot_fix = q_bot < R(0) && pending > R(0);
  q_bot = bot_fix ? q_bot + dup / d[nz - 1] : q_bot;
  o[nz - 2] = bot_fix ? pending - dup / d[nz - 2] : pending;
  o[nz - 1] = q_bot;
  zfix = zfix || bot_fix;

  // 5. positive-definite rescale of levels 1..nz-1
  R sum0 = R(0), sum1 = R(0);
  for (int k = 1; k < nz; ++k) {
    const R dm = o[k] * d[k];
    sum0 = sum0 + dm;
    sum1 = sum1 + pmax(dm, R(0));
  }
  const R fac = (sum0 > R(0)) ? sum0 / ((sum1 == R(0)) ? R(1) : sum1) : R(0);
  if (zfix && fac > R(0)) {
    for (int k = 1; k < nz; ++k) {
      o[k] = pmax(fac * (o[k] * d[k]) / d[k], R(0));
    }
  }
}

template <typename R>
int launch(const void* q, const void* dp, void* out, int ntracer, int ncol,
           int nz, void* stream) {
  const int threads = 128;
  const long total = (long)ntracer * ncol;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  fillz_kernel<R><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
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
