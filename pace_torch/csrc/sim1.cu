// SIM1 semi-implicit nonhydrostatic vertical solve, a block of columns
// staged through shared memory.
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
// What bounds it on the card: memory, then latency.  A call must read
// six layer fields, one interface field and ws, and write two layer fields
// and one interface field: at (6, 56, 56, 79) float32 about 60 MB, 18 us
// at 3.35 TB/s.  The recurrences in k are sequential, so the parallelism
// is the 6 * Ni * Nj columns (18,816 at C48, about 143 per SM).
//
// The design: in the k-last layout a block of C consecutive columns owns
// one contiguous chunk of C * nz values of each layer field (C * (nz+1)
// of pem).  The fields the recurrences read (w, dm, pem) are staged into
// shared memory with cp.async copies (a warp per column, lanes along k,
// every copy in flight at once); the fields only the equation of state
// reads (gm, dz, pt, pm) are read straight from device memory by the two
// passes that run over all (column, level) pairs with every thread of the
// block: step 1, which also forms the w-solve factor
// ac(k) = 2 dt^2 * 0.5 * (gm(k-1) + gm(k)) / (dz(k-1) + dz(k)) (the first
// product of aa(k), so aa keeps its rounding), and step 5's dz.  The
// recurrences run one thread per column out of shared memory, with
// column strides padded to an odd number of elements so the C threads hit
// distinct banks.  Scratch stays on chip: grat, bb and dd are recomputed
// inline (the same expressions, so the same roundings), and four column
// arrays (pe_l then the new w, pp then p1, gam then gam2, ac) live in
// shared memory beside the staged inputs; pe overwrites pem once the w
// solve is done.  w and pe leave through shared memory and dz straight
// from the last pass, all as coalesced stores.  The kernel allocates
// nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr double kRdgas = 287.05;
constexpr int kCols = 16;      // columns per block
constexpr int kThreads = 128;  // threads per block
constexpr int kWarps = kThreads / 32;

// a column stride padded to an odd element count
__host__ __device__ __forceinline__ int odd(int s) { return s | 1; }

template <typename R>
__host__ __device__ __forceinline__ size_t smem_bytes(int nz) {
  return sizeof(R) * kCols * (3 * odd(nz) + 4 * odd(nz + 1));
}

// an asynchronous copy of one value from device to shared memory
// (cp.async: no register staging, so a warp's copies are all in flight)
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
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// ncb columns of len values: k-last device array <-> column-strided
// shared array, a warp per column, lanes along k
template <typename R>
__device__ __forceinline__ void stage_in(R* s, const R* g, int ncb, int len,
                                         int stride) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = warp; c < ncb; c += kWarps)
    for (int k = lane; k < len; k += 32)
      copy_async(s + c * stride + k, g + (long)c * len + k);
}
template <typename R>
__device__ __forceinline__ void stage_out(R* g, const R* s, int ncb, int len,
                                          int stride) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = warp; c < ncb; c += kWarps)
    for (int k = lane; k < len; k += 32)
      g[(long)c * len + k] = s[c * stride + k];
}

template <typename R>
__global__ void __launch_bounds__(kThreads)
    sim1_kernel(const R* __restrict__ w1g, const R* __restrict__ dmg,
                const R* __restrict__ gmg, const R* __restrict__ dzg,
                const R* __restrict__ ptg, const R* __restrict__ pmg,
                const R* __restrict__ pemg, const R* __restrict__ ws,
                R* __restrict__ w_out, R* __restrict__ dz_out,
                R* __restrict__ pe_out, int ncol, int nz, R dt, R t1g, R rdt,
                R p_fac) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  R* smem = reinterpret_cast<R*>(smem_raw);
  const int SL = odd(nz), SI = odd(nz + 1);
  R* s_w1 = smem;
  R* s_dm = s_w1 + kCols * SL;
  R* s_w = s_dm + kCols * SL;    // pe_l (step 1), then the new w
  R* s_pe = s_w + kCols * SL;    // pem, then pe
  R* s_pp = s_pe + kCols * SI;   // pp, then p1
  R* s_gam = s_pp + kCols * SI;  // gam, then gam2
  R* s_ac = s_gam + kCols * SI;  // the w-solve coefficients (step 1)

  const int c0 = blockIdx.x * kCols;
  const int ncb = min(kCols, ncol - c0);
  const long L0 = (long)c0 * nz, I0 = (long)c0 * (nz + 1);
  stage_in(s_w1, w1g + L0, ncb, nz, SL);
  stage_in(s_dm, dmg + L0, ncb, nz, SL);
  stage_in(s_pe, pemg + I0, ncb, nz + 1, SI);
  copy_wait();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // 1. perturbation pressure from the equation of state, and the factors
  //    of the w solve that do not depend on pp:
  //    aa(k) = ac(k) * (pem(k) + pp(k)), k = 1..nz (ac(nz): p1_last),
  //    the same products in the same order as sim1_solver_plain
  for (int c = warp; c < ncb; c += kWarps) {
    const long g = L0 + (long)c * nz;
    for (int k = lane; k < nz; k += 32) {
      const int e = c * SL + k;
      const R gm = gmg[g + k], dz = dzg[g + k];
      s_w[e] = exp(gm * log(-s_dm[e] / dz * R(kRdgas) * ptg[g + k])) -
               pmg[g + k];
      if (k > 0)
        s_ac[c * SI + k] =
            t1g * R(0.5) * (gmg[g + k - 1] + gm) / (dzg[g + k - 1] + dz);
      if (k == nz - 1) s_ac[c * SI + nz] = t1g * gm / dz;
    }
  }
  __syncthreads();

  if (threadIdx.x < ncb) {
    const int c = threadIdx.x;
    const R* DM = s_dm + c * SL;
    const R* W1 = s_w1 + c * SL;
    const R* AC = s_ac + c * SI;
    R* W = s_w + c * SL;
    R* PE = s_pe + c * SI;
    R* PP = s_pp + c * SI;
    R* GAM = s_gam + c * SI;
    auto grat = [&](int k) { return k < nz - 1 ? DM[k] / DM[k + 1] : R(0); };
    auto bb = [&](int k, R g) {
      return k < nz - 1 ? R(2) * (R(1) + g) : R(2);
    };

    // 2. Thomas solve for pp (k = 0..nz); dd(k-1) from pe_l in W
    R g_prev = grat(0);
    R bet = bb(0, g_prev);
    R pp_prev = R(0);
    PP[0] = R(0);
    GAM[0] = R(0);
    for (int k = 1; k <= nz; ++k) {
      const R dd = (k - 1 < nz - 1) ? R(3) * (W[k - 1] + g_prev * W[k])
                                    : R(3) * W[nz - 1];
      const R gam_k = g_prev / bet;
      const R pp_k = (dd - pp_prev) / bet;
      const int kb = k < nz ? k : nz - 1;
      const R g_k = grat(kb);
      bet = bb(kb, g_k) - gam_k;
      PP[k] = pp_k;
      GAM[k] = gam_k;
      pp_prev = pp_k;
      g_prev = g_k;
    }
    R pp_next = PP[nz];
    for (int k = nz - 1; k >= 1; --k) {
      pp_next = PP[k] - GAM[k] * pp_next;
      PP[k] = pp_next;
    }

    // 3. w solve with surface coupling; gam2 overwrites gam
    const R p1_last = AC[nz] * (PE[nz] + PP[nz]);
    R aak = AC[1] * (PE[1] + PP[1]);
    bet = DM[0] - aak;
    R w_prev = (DM[0] * W1[0] + dt * PP[1]) / bet;
    W[0] = w_prev;
    GAM[0] = R(0);
    const R wsc = ws[c0 + c];
    for (int k = 1; k < nz; ++k) {
      const bool last = (k == nz - 1);
      const R aak1 = last ? p1_last : AC[k + 1] * (PE[k + 1] + PP[k + 1]);
      const R extra = last ? p1_last * wsc : R(0);
      const R gam2_k = aak / bet;
      const R bet_k = DM[k] - (aak + aak1 + aak * gam2_k);
      w_prev = (DM[k] * W1[k] + dt * (PP[k + 1] - PP[k]) - extra -
                aak * w_prev) / bet_k;
      W[k] = w_prev;
      GAM[k] = gam2_k;
      bet = bet_k;
      aak = aak1;
    }
    R w_next = W[nz - 1];
    for (int k = nz - 2; k >= 0; --k) {
      w_next = W[k] - GAM[k + 1] * w_next;
      W[k] = w_next;
    }

    // 4. interface pe: running sum of the mass-weighted w increments
    R pe = R(0);
    PE[0] = pe;
    for (int k = 0; k < nz; ++k) {
      pe = pe + DM[k] * (W[k] - W1[k]) * rdt;
      PE[k + 1] = pe;
    }

    // 5a. p1 backward recurrence into PP
    R p1 = (PE[nz - 1] + R(2) * PE[nz]) / R(3);
    PP[nz - 1] = p1;
    for (int k = nz - 2; k >= 0; --k) {
      const R g = grat(k);
      p1 = (PE[k] + bb(k, g) * PE[k + 1] + g * PE[k + 2]) / R(3) - g * p1;
      PP[k] = p1;
    }
  }
  __syncthreads();

  // 5b. dz from the equation of state, every thread, stored directly
  for (int c = warp; c < ncb; c += kWarps) {
    const long g = L0 + (long)c * nz;
    for (int k = lane; k < nz; k += 32) {
      const int e = c * SL + k;
      const R gm = gmg[g + k], pm = pmg[g + k];
      const R cp3 = R(1) - R(1) / gm;
      const R p1pm = s_pp[c * SI + k] + pm;
      const R maxp = (p_fac * s_dm[e] > p1pm) ? p_fac * pm : p1pm;
      dz_out[g + k] =
          -s_dm[e] * R(kRdgas) * ptg[g + k] * exp((cp3 - R(1)) * log(maxp));
    }
  }
  stage_out(w_out + L0, s_w, ncb, nz, SL);
  stage_out(pe_out + I0, s_pe, ncb, nz + 1, SI);
}

template <typename R>
int launch(const void* w, const void* dm, const void* gm, const void* dz,
           const void* pt, const void* pm, const void* pem, const void* ws,
           void* w_out, void* dz_out, void* pe_out, int ncol, int nz,
           double dt, double p_fac, void* stream) {
  auto c = [](const void* p) { return static_cast<const R*>(p); };
  auto m = [](void* p) { return static_cast<R*>(p); };
  const size_t bytes = smem_bytes<R>(nz);
  // above 48 KB a block's dynamic shared memory must be allowed first
  static size_t allowed = 48 * 1024;
  if (bytes > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        sim1_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    allowed = bytes;
  }
  const int blocks = (ncol + kCols - 1) / kCols;
  sim1_kernel<R><<<blocks, kThreads, bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      c(w), c(dm), c(gm), c(dz), c(pt), c(pm), c(pem), c(ws), m(w_out),
      m(dz_out), m(pe_out), ncol, nz, R(dt), R(2.0 * dt * dt), R(1.0 / dt),
      R(p_fac));
  return (int)cudaGetLastError();
}

}  // namespace

#define SIM1_ARGS                                                          \
  const void *w, const void *dm, const void *gm, const void *dz,           \
      const void *pt, const void *pm, const void *pem, const void *ws,     \
      void *w_out, void *dz_out, void *pe_out, int ncol, int nz, double dt, \
      double p_fac, void *stream
#define SIM1_PASS                                                        \
  w, dm, gm, dz, pt, pm, pem, ws, w_out, dz_out, pe_out, ncol, nz, dt, p_fac, \
      stream

extern "C" int pace_sim1_f32(SIM1_ARGS) { return launch<float>(SIM1_PASS); }
extern "C" int pace_sim1_f64(SIM1_ARGS) { return launch<double>(SIM1_PASS); }
