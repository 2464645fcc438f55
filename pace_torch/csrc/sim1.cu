// SIM1 semi-implicit nonhydrostatic vertical solve, one column per thread.
//
// Replaces pace_tpu/ops/pallas/sim1_pallas.py:sim1_pallas (its body
// _kernel).  Per column it computes, in the order of the scan form
// pace_torch.ops.riemann.sim1_solver_plain:
//   1. the perturbation pressure from the equation of state,
//   2. a Thomas forward/backward solve for pp,
//   3. a tridiagonal w solve with the surface coupling ws,
//   4. the interface pe as the running sum of dm * (w_new - w) / dt,
//   5. a backward p1 recurrence, then dz from the equation of state.
//
// What bounds it on the card: memory latency.  The arithmetic is ~60 flops
// and two transcendentals per level, but each k recurrence is sequential,
// so the parallelism is the 6 * Ni * Nj columns (18,816 at C48), about 140
// threads per SM.  The inputs stay in the model's k-last layout, so one
// thread's consecutive levels are adjacent and neighbouring threads read
// addresses nz elements apart: every input load is uncoalesced.  That
// layout is the first thing to change (stage a tile of columns through
// shared memory, or keep the solver's fields k-first).  The scratch the
// recurrences need is a wrapper-allocated buffer laid out [slot][k][column],
// so scratch traffic coalesces; the kernel allocates nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr double kRdgas = 287.05;
constexpr int kSlots = 9;  // scratch rows PP .. P1 in sim1_kernel

template <typename R>
__global__ void sim1_kernel(const R* __restrict__ w1, const R* __restrict__ dm,
                            const R* __restrict__ gm, const R* __restrict__ dz,
                            const R* __restrict__ pt, const R* __restrict__ pm,
                            const R* __restrict__ pem,
                            const R* __restrict__ ws, R* w_out, R* dz_out,
                            R* pe_out, R* scratch, int ncol, int nz, R dt,
                            R t1g, R rdt, R p_fac) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncol) return;
  const long L = (long)c * nz;        // layer fields of this column
  const long I = (long)c * (nz + 1);  // interface fields of this column
  const long rows = (long)(nz + 1) * ncol;
  // scratch slot s, level k of this column
  auto S = [&](int s, int k) -> R& {
    return scratch[s * rows + (long)k * ncol + c];
  };
  const int PP = 0, GAM = 1, GRAT = 2, BB = 3, DD = 4, AA = 5, W = 6,
            GAM2 = 7, P1 = 8;

  // 1. perturbation pressure (staged in DD) and the tridiagonal setup
  for (int k = 0; k < nz; ++k) {
    S(DD, k) = exp(gm[L + k] * log(-dm[L + k] / dz[L + k] * R(kRdgas) *
                                   pt[L + k])) - pm[L + k];
  }
  for (int k = 0; k < nz - 1; ++k) {
    R g = dm[L + k] / dm[L + k + 1];
    S(GRAT, k) = g;
    S(BB, k) = R(2) * (R(1) + g);
    S(DD, k) = R(3) * (S(DD, k) + g * S(DD, k + 1));
  }
  S(GRAT, nz - 1) = R(0);
  S(BB, nz - 1) = R(2);
  S(DD, nz - 1) = R(3) * S(DD, nz - 1);

  // 2. Thomas solve for pp (k = 0..nz)
  R bet = S(BB, 0);
  S(PP, 0) = R(0);
  S(GAM, 0) = R(0);
  for (int k = 1; k <= nz; ++k) {
    R gam_k = S(GRAT, k - 1) / bet;
    R pp_k = (S(DD, k - 1) - S(PP, k - 1)) / bet;
    bet = S(BB, k < nz ? k : nz - 1) - gam_k;
    S(PP, k) = pp_k;
    S(GAM, k) = gam_k;
  }
  for (int k = nz - 1; k >= 1; --k) {
    S(PP, k) = S(PP, k) - S(GAM, k) * S(PP, k + 1);
  }

  // 3. w solve with surface coupling
  S(AA, 0) = R(0);
  for (int k = 1; k < nz; ++k) {
    S(AA, k) = t1g * R(0.5) * (gm[L + k - 1] + gm[L + k]) /
               (dz[L + k - 1] + dz[L + k]) * (pem[I + k] + S(PP, k));
  }
  const R p1_last = t1g * gm[L + nz - 1] / dz[L + nz - 1] *
                    (pem[I + nz] + S(PP, nz));
  bet = dm[L] - S(AA, 1);
  S(W, 0) = (dm[L] * w1[L] + dt * S(PP, 1)) / bet;
  S(GAM2, 0) = R(0);
  for (int k = 1; k < nz; ++k) {
    const bool last = (k == nz - 1);
    const R aak = S(AA, k);
    const R aak1 = last ? p1_last : S(AA, k + 1);
    const R extra = last ? p1_last * ws[c] : R(0);
    const R gam2_k = aak / bet;
    const R bet_k = dm[L + k] - (aak + aak1 + aak * gam2_k);
    S(W, k) = (dm[L + k] * w1[L + k] + dt * (S(PP, k + 1) - S(PP, k)) -
               extra - aak * S(W, k - 1)) / bet_k;
    S(GAM2, k) = gam2_k;
    bet = bet_k;
  }
  for (int k = nz - 2; k >= 0; --k) {
    S(W, k) = S(W, k) - S(GAM2, k + 1) * S(W, k + 1);
  }

  // 4. interface pe: running sum of the mass-weighted w increments
  R pe = R(0);
  pe_out[I] = pe;
  for (int k = 0; k < nz; ++k) {
    const R wk = S(W, k);
    w_out[L + k] = wk;
    pe = pe + dm[L + k] * (wk - w1[L + k]) * rdt;
    pe_out[I + k + 1] = pe;
  }

  // 5. p1 backward recurrence, then dz from the equation of state
  S(P1, nz - 1) = (pe_out[I + nz - 1] + R(2) * pe_out[I + nz]) / R(3);
  for (int k = nz - 2; k >= 0; --k) {
    S(P1, k) = (pe_out[I + k] + S(BB, k) * pe_out[I + k + 1] +
                S(GRAT, k) * pe_out[I + k + 2]) / R(3) -
               S(GRAT, k) * S(P1, k + 1);
  }
  for (int k = 0; k < nz; ++k) {
    const R g = gm[L + k];
    const R cp3 = R(1) - R(1) / g;
    const R p1pm = S(P1, k) + pm[L + k];
    const R maxp = (p_fac * dm[L + k] > p1pm) ? p_fac * pm[L + k] : p1pm;
    dz_out[L + k] = -dm[L + k] * R(kRdgas) * pt[L + k] *
                    exp((cp3 - R(1)) * log(maxp));
  }
}

template <typename R>
int launch(const void* w, const void* dm, const void* gm, const void* dz,
           const void* pt, const void* pm, const void* pem, const void* ws,
           void* w_out, void* dz_out, void* pe_out, void* scratch, int ncol,
           int nz, double dt, double p_fac, void* stream) {
  auto c = [](const void* p) { return static_cast<const R*>(p); };
  auto m = [](void* p) { return static_cast<R*>(p); };
  const int threads = 128;
  const int blocks = (ncol + threads - 1) / threads;
  sim1_kernel<R><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      c(w), c(dm), c(gm), c(dz), c(pt), c(pm), c(pem), c(ws), m(w_out),
      m(dz_out), m(pe_out), m(scratch), ncol, nz, R(dt), R(2.0 * dt * dt),
      R(1.0 / dt), R(p_fac));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pace_sim1_scratch_slots() { return kSlots; }

#define SIM1_ARGS                                                           \
  const void *w, const void *dm, const void *gm, const void *dz,            \
      const void *pt, const void *pm, const void *pem, const void *ws,      \
      void *w_out, void *dz_out, void *pe_out, void *scratch, int ncol,     \
      int nz, double dt, double p_fac, void *stream
#define SIM1_PASS                                                           \
  w, dm, gm, dz, pt, pm, pem, ws, w_out, dz_out, pe_out, scratch, ncol, nz, \
      dt, p_fac, stream

extern "C" int pace_sim1_f32(SIM1_ARGS) { return launch<float>(SIM1_PASS); }
extern "C" int pace_sim1_f64(SIM1_ARGS) { return launch<double>(SIM1_PASS); }
