// Batched finite-volume 2-D transport (fv_tp_2d without del-n damping).
//
// Replaces pace_tpu/ops/pallas/fvtp2d_pallas.py:transport_batched (its
// bodies _k1_inner_y, _k2_x_passes and _k3_outer_y).  For T stacked fields
// sharing Courant numbers, area fluxes, unit fluxes and metrics it returns
//   fx = 0.5 * (xppm(qay) + xppm(q_x)) * xmf
//   fy = 0.5 * (yppm(qax) + yppm(q_y)) * ymf
// with qay / qax the fields advected by the inner y / x PPM pass, exactly
// as pace_torch.ops.fvtp2d.transport_batched_plain computes them.
//
// What bounds it on the card: memory traffic and launch count, not
// arithmetic.  Each output point needs q along one horizontal line only
// (seven neighbours for the inner PPM, the advected field's neighbours for
// the outer one), so the work splits into two launches with one thread per
// (field, tile, i, j, k) point:
//   launch 1: inner y-PPM on q_y -> fy_in and qay; inner x-PPM on q_x ->
//             fx_in and qax (each needs neighbours along one axis only);
//   launch 2: outer x-PPM on qay and outer y-PPM on qax, combined with
//             fx_in / fy_in and the unit fluxes.
// Threads run fastest along k, the contiguous axis, so every load of a
// neighbour along i or j is a coalesced row of nz values.  Each thread
// recomputes the PPM intermediates it needs (interface values, slopes,
// limiter) from the line of q instead of staging them: this is the simple
// first form; a shared-memory (i, j) tile with the PPM halo, which would
// cut the redundant loads, is left for later work.
//
// Whole-array semantics: the reference evaluates every intermediate over
// the whole padded array with zero-filled shifts at the array bounds and
// overwrites six static tile-edge lines.  Every accessor below returns 0
// for an index outside [0, N) at each nesting level, and the edge lines are
// matched by index, so the kernel agrees with the plain version over the
// whole array and not only on the compute domain.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr double kC1 = -2.0 / 14.0;
constexpr double kC2 = 11.0 / 14.0;
constexpr double kC3 = 5.0 / 14.0;
constexpr double kP1 = 7.0 / 12.0;
constexpr double kP2 = -1.0 / 12.0;
constexpr double kS11 = 11.0 / 14.0;
constexpr double kS14 = 4.0 / 7.0;
constexpr double kS15 = 3.0 / 14.0;

// maximum/minimum that propagate NaN like torch.maximum/torch.minimum
template <typename R>
__device__ __forceinline__ R pmax(R a, R b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename R>
__device__ __forceinline__ R pmin(R a, R b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
// |a| with the sign of b (b == 0 counts as negative)
template <typename R>
__device__ __forceinline__ R fsign(R a, R b) {
  return b > R(0) ? fabs(a) : -fabs(a);
}

// One line of an array along the PPM axis, zero outside [0, N).
template <typename R>
struct Line {
  const R* p;
  long stride;
  int N;
  __device__ __forceinline__ R operator()(int m) const {
    return (m >= 0 && m < N) ? p[(long)m * stride] : R(0);
  }
};

// A line shifted by s: g(m) = line(m + s) inside [0, N), 0 outside
// (the reference's shift of an already shifted array).
template <typename R>
struct Shifted {
  Line<R> base;
  int s;
  __device__ __forceinline__ R operator()(int m) const {
    return (m >= 0 && m < base.N) ? base(m + s) : R(0);
  }
};

template <typename R>
struct Ppm {
  Line<R> q;    // advected field along the axis
  Line<R> d;    // dxa / dya along the axis
  int N, n, h;

  __device__ __forceinline__ bool in(int m) const { return m >= 0 && m < N; }

  // ---- ord < 8: interface value al and the smt5 mask (xppm compute_al)
  __device__ R al6(int m) const {
    if (m == h + 1 || m == h + n + 1)
      return R(kC3) * q(m - 1) + R(kC2) * q(m) + R(kC1) * q(m + 1);
    if (m == h || m == h + n)
      return R(0.5) * (((R(2) * d(m - 1) + d(m - 2)) * q(m - 1) -
                        d(m - 1) * q(m - 2)) / (d(m - 2) + d(m - 1)) +
                       ((R(2) * d(m) + d(m + 1)) * q(m) - d(m) * q(m + 1)) /
                           (d(m) + d(m + 1)));
    if (m == h - 1 || m == h + n - 1)
      return R(kC1) * q(m - 2) + R(kC2) * q(m - 1) + R(kC3) * q(m);
    return R(kP1) * (q(m - 1) + q(m)) + R(kP2) * (q(m - 2) + q(m + 1));
  }
  __device__ R al6_at(int m) const { return in(m) ? al6(m) : R(0); }

  // bl, br at an in-bounds m
  __device__ void blbr6(int m, R& bl, R& br) const {
    bl = al6(m) - q(m);
    br = al6_at(m + 1) - q(m);
  }
  __device__ R smt5(int m) const {
    R bl, br;
    blbr6(m, bl, br);
    R b0 = bl + br;
    return (R(3) * fabs(b0) < fabs(bl - br)) ? R(1) : R(0);
  }

  // ---- ord >= 8: slopes, interface values and the edge constraint
  template <typename G>
  __device__ R dm_of(const G& g, int m) const {
    R xt = R(0.25) * (g(m + 1) - g(m - 1));
    R dqr = pmax(pmax(g(m), g(m - 1)), g(m + 1)) - g(m);
    R dql = g(m) - pmin(pmin(g(m), g(m - 1)), g(m + 1));
    return fsign(pmin(pmin(R(fabs(xt)), dqr), dql), xt);
  }
  __device__ R dm(int m) const { return dm_of(q, m); }
  __device__ R dm_at(int m) const { return in(m) ? dm(m) : R(0); }
  __device__ R dm_left(int m) const { return dm_of(Shifted<R>{q, -1}, m); }
  __device__ R dm_right(int m) const { return dm_of(Shifted<R>{q, 1}, m); }
  __device__ R al8(int m) const {
    return R(0.5) * (q(m - 1) + q(m)) + R(1.0 / 3.0) * (dm_at(m - 1) - dm(m));
  }
  __device__ R al8_at(int m) const { return in(m) ? al8(m) : R(0); }

  __device__ R xt_edge_0(int m) const {
    R xt = R(0.5) * (((R(2) * d(m) + d(m - 1)) * q(m) - d(m) * q(m - 1)) /
                         (d(m - 1) + d(m)) +
                     ((R(2) * d(m + 1) + d(m + 2)) * q(m + 1) -
                      d(m + 1) * q(m + 2)) / (d(m + 1) + d(m + 2)));
    R minq = pmin(pmin(pmin(q(m - 1), q(m)), q(m + 1)), q(m + 2));
    R maxq = pmax(pmax(pmax(q(m - 1), q(m)), q(m + 1)), q(m + 2));
    return pmin(pmax(xt, minq), maxq);
  }
  __device__ R xt_edge_1(int m) const {
    R xt = R(0.5) * (((R(2) * d(m - 1) + d(m - 2)) * q(m - 1) -
                      d(m - 1) * q(m - 2)) / (d(m - 2) + d(m - 1)) +
                     ((R(2) * d(m) + d(m + 1)) * q(m) - d(m) * q(m + 1)) /
                         (d(m) + d(m + 1)));
    R minq = pmin(pmin(pmin(q(m - 2), q(m - 1)), q(m)), q(m + 1));
    R maxq = pmax(pmax(pmax(q(m - 2), q(m - 1)), q(m)), q(m + 1));
    return pmin(pmax(xt, minq), maxq);
  }

  // bl, br at an in-bounds m (xppm _compute_blbr_ord8plus)
  __device__ void blbr8(int m, R& bl, R& br) const {
    const R qm = q(m);
    const bool edge = (m == h - 1 || m == h || m == h + 1 ||
                       m == h + n - 2 || m == h + n - 1 || m == h + n);
    if (!edge) {
      R dmm = dm(m);
      R xt2 = R(2) * dmm;
      bl = R(-1) * fsign(pmin(R(fabs(xt2)), R(fabs(al8(m) - qm))), xt2);
      br = fsign(pmin(R(fabs(xt2)), R(fabs(al8_at(m + 1) - qm))), xt2);
      return;
    }
    // the reference applies the line updates in this order; a later line
    // wins where two coincide (a tile of fewer than four cells)
    R xbl, xbr;
    if (m == h + n) {
      xbl = xt_edge_1(m);
      xbr = R(kS11) * (q(m + 1) - qm) - R(kS14) * dm_right(m) + qm;
    } else if (m == h + n - 1) {
      xbl = R(kS15) * qm + R(kS11) * q(m - 1) + R(kS14) * dm_left(m);
      xbr = xt_edge_0(m);
    } else if (m == h + n - 2) {
      xbl = al8(m);
      xbr = R(kS15) * q(m + 1) + R(kS11) * qm + R(kS14) * dm(m);
    } else if (m == h + 1) {
      xbl = R(kS15) * q(m - 1) + R(kS11) * qm - R(kS14) * dm(m);
      xbr = al8_at(m + 1);
    } else if (m == h) {
      xbl = xt_edge_1(m);
      xbr = R(kS15) * qm + R(kS11) * q(m + 1) - R(kS14) * dm_right(m);
    } else {  // h - 1
      xbl = R(kS14) * dm_left(m) + R(kS11) * (q(m - 1) - qm) + qm;
      xbr = xt_edge_0(m);
    }
    R al = xbl - qm;
    R ar = xbr - qm;
    // pert_ppm_standard_constraint
    R da1 = al - ar;
    R da2 = da1 * da1;
    R a6da = R(3) * (al + ar) * da1;
    R ar_new = (a6da < -da2) ? R(-2) * al : ar;
    R al_new = (a6da > da2) ? R(-2) * ar : al;
    bool cross = al * ar < R(0);
    bl = cross ? al_new : R(0);
    br = cross ? ar_new : R(0);
  }

  template <int ORD>
  __device__ void blbr(int m, R& bl, R& br) const {
    if (ORD < 8) blbr6(m, bl, br); else blbr8(m, bl, br);
  }

  // PPM flux across interface m with Courant number c (xppm _flux_core)
  template <int ORD>
  __device__ R flux(int m, R c) const {
    R fx1, mask = R(1);
    if (c > R(0)) {
      R blm1 = R(0), brm1 = R(0);
      if (in(m - 1)) this->template blbr<ORD>(m - 1, blm1, brm1);
      R b0m1 = in(m - 1) ? blm1 + brm1 : R(0);
      brm1 = in(m - 1) ? brm1 : R(0);
      fx1 = (R(1) - c) * (brm1 - c * b0m1);
    } else {
      R bl, br;
      this->template blbr<ORD>(m, bl, br);
      fx1 = (R(1) + c) * (bl + c * (bl + br));
    }
    if (ORD < 8) {
      R s0 = smt5(m);
      R sm1 = in(m - 1) ? smt5(m - 1) : R(0);
      mask = pmax(sm1, s0);
      return (c > R(0)) ? q(m - 1) + fx1 * mask : q(m) + fx1 * mask;
    }
    return (c > R(0)) ? q(m - 1) + fx1 : q(m) + fx1;
  }
};

struct Index {
  int t, tile, i, j, k;
};

__device__ __forceinline__ Index unravel(long idx, int N, int nz) {
  Index r;
  r.k = (int)(idx % nz);
  idx /= nz;
  r.j = (int)(idx % N);
  idx /= N;
  r.i = (int)(idx % N);
  idx /= N;
  r.tile = (int)(idx % 6);
  r.t = (int)(idx / 6);
  return r;
}

// launch 1: inner PPM passes -> fy_in, qay (along j) and fx_in, qax (along i)
template <typename R, int ORD>
__global__ void inner_pass(const R* __restrict__ q_y, const R* __restrict__ q_x,
                           const R* __restrict__ crx, const R* __restrict__ cry,
                           const R* __restrict__ xfx, const R* __restrict__ yfx,
                           const R* __restrict__ dxa, const R* __restrict__ dya,
                           const R* __restrict__ area, R* fy_in, R* fx_in,
                           R* qay, R* qax, int T, int N, int nz, int n, int h) {
  long total = (long)T * 6 * N * N * nz;
  long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  Index p = unravel(idx, N, nz);
  const long sx = (long)N * nz;        // stride along i of 4-D/5-D fields
  const long tile_off = (long)p.tile * N * N * nz;
  const long field_off = ((long)p.t * 6) * N * N * nz + tile_off;
  const long met = ((long)p.tile * N + p.i) * N + p.j;

  // y direction: line along j at fixed (i, k)
  {
    const long row = (long)p.i * sx + p.k;
    Ppm<R> ppm{Line<R>{q_y + field_off + row, nz, N},
               Line<R>{dya + met - p.j, 1, N}, N, n, h};
    Line<R> c{cry + tile_off + row, nz, N};
    Line<R> a{yfx + tile_off + row, nz, N};
    R f0 = ppm.template flux<ORD>(p.j, c(p.j));
    R f1 = (p.j + 1 < N) ? ppm.template flux<ORD>(p.j + 1, c(p.j + 1)) : R(0);
    R fyy0 = a(p.j) * f0;
    R fyy1 = (p.j + 1 < N) ? a(p.j + 1) * f1 : R(0);
    R ar = area[met];
    fy_in[idx] = f0;
    qay[idx] = (ppm.q(p.j) * ar + fyy0 - fyy1) / (ar + a(p.j) - a(p.j + 1));
  }
  // x direction: line along i at fixed (j, k)
  {
    const long col = (long)p.j * nz + p.k;
    Ppm<R> ppm{Line<R>{q_x + field_off + col, sx, N},
               Line<R>{dxa + (long)p.tile * N * N + p.j, N, N}, N, n, h};
    Line<R> c{crx + tile_off + col, sx, N};
    Line<R> a{xfx + tile_off + col, sx, N};
    R f0 = ppm.template flux<ORD>(p.i, c(p.i));
    R f1 = (p.i + 1 < N) ? ppm.template flux<ORD>(p.i + 1, c(p.i + 1)) : R(0);
    R fx0 = a(p.i) * f0;
    R fx1 = (p.i + 1 < N) ? a(p.i + 1) * f1 : R(0);
    R ar = area[met];
    fx_in[idx] = f0;
    qax[idx] = (ppm.q(p.i) * ar + fx0 - fx1) / (ar + a(p.i) - a(p.i + 1));
  }
}

// launch 2: outer PPM passes and the flux combination
template <typename R, int ORD>
__global__ void outer_pass(const R* __restrict__ qay, const R* __restrict__ qax,
                           const R* __restrict__ fy_in,
                           const R* __restrict__ fx_in,
                           const R* __restrict__ crx, const R* __restrict__ cry,
                           const R* __restrict__ xmf, const R* __restrict__ ymf,
                           const R* __restrict__ dxa, const R* __restrict__ dya,
                           R* fx, R* fy, int T, int N, int nz, int n, int h) {
  long total = (long)T * 6 * N * N * nz;
  long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  Index p = unravel(idx, N, nz);
  const long sx = (long)N * nz;
  const long tile_off = (long)p.tile * N * N * nz;
  const long field_off = ((long)p.t * 6) * N * N * nz + tile_off;
  const long pt = tile_off + (long)p.i * sx + (long)p.j * nz + p.k;
  {
    const long col = (long)p.j * nz + p.k;
    Ppm<R> ppm{Line<R>{qay + field_off + col, sx, N},
               Line<R>{dxa + (long)p.tile * N * N + p.j, N, N}, N, n, h};
    R mean1 = ppm.template flux<ORD>(p.i, crx[pt]);
    fx[idx] = R(0.5) * (mean1 + fx_in[idx]) * xmf[pt];
  }
  {
    const long row = (long)p.i * sx + p.k;
    const long met = ((long)p.tile * N + p.i) * N;
    Ppm<R> ppm{Line<R>{qax + field_off + row, nz, N},
               Line<R>{dya + met, 1, N}, N, n, h};
    R mean2 = ppm.template flux<ORD>(p.j, cry[pt]);
    fy[idx] = R(0.5) * (mean2 + fy_in[idx]) * ymf[pt];
  }
}

template <typename R, int ORD>
int launch(const R* q_y, const R* q_x, const R* crx, const R* cry,
           const R* xfx, const R* yfx, const R* xmf, const R* ymf,
           const R* dxa, const R* dya, const R* area, R* fy_in, R* fx_in,
           R* qay, R* qax, R* fx, R* fy, int T, int N, int nz, int n, int h,
           cudaStream_t stream) {
  const long total = (long)T * 6 * N * N * nz;
  const int threads = 128;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  inner_pass<R, ORD><<<blocks, threads, 0, stream>>>(
      q_y, q_x, crx, cry, xfx, yfx, dxa, dya, area, fy_in, fx_in, qay, qax,
      T, N, nz, n, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  outer_pass<R, ORD><<<blocks, threads, 0, stream>>>(
      qay, qax, fy_in, fx_in, crx, cry, xmf, ymf, dxa, dya, fx, fy, T, N, nz,
      n, h);
  return (int)cudaGetLastError();
}

template <typename R>
int dispatch(const void* q_y, const void* q_x, const void* crx,
             const void* cry, const void* xfx, const void* yfx,
             const void* xmf, const void* ymf, const void* dxa,
             const void* dya, const void* area, void* fy_in, void* fx_in,
             void* qay, void* qax, void* fx, void* fy, int T, int N, int nz,
             int n, int h, int hord, void* stream) {
  auto c = [](const void* p) { return static_cast<const R*>(p); };
  auto m = [](void* p) { return static_cast<R*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hord == 6)
    return launch<R, 6>(c(q_y), c(q_x), c(crx), c(cry), c(xfx), c(yfx),
                        c(xmf), c(ymf), c(dxa), c(dya), c(area), m(fy_in),
                        m(fx_in), m(qay), m(qax), m(fx), m(fy), T, N, nz, n,
                        h, s);
  if (hord == 8)
    return launch<R, 8>(c(q_y), c(q_x), c(crx), c(cry), c(xfx), c(yfx),
                        c(xmf), c(ymf), c(dxa), c(dya), c(area), m(fy_in),
                        m(fx_in), m(qay), m(qax), m(fx), m(fy), T, N, nz, n,
                        h, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#define FVTP2D_ARGS                                                          \
  const void *q_y, const void *q_x, const void *crx, const void *cry,        \
      const void *xfx, const void *yfx, const void *xmf, const void *ymf,    \
      const void *dxa, const void *dya, const void *area, void *fy_in,       \
      void *fx_in, void *qay, void *qax, void *fx, void *fy, int T, int N,   \
      int nz, int n, int h, int hord, void *stream
#define FVTP2D_PASS                                                         \
  q_y, q_x, crx, cry, xfx, yfx, xmf, ymf, dxa, dya, area, fy_in, fx_in, qay, \
      qax, fx, fy, T, N, nz, n, h, hord, stream

extern "C" int pace_fvtp2d_f32(FVTP2D_ARGS) {
  return dispatch<float>(FVTP2D_PASS);
}
extern "C" int pace_fvtp2d_f64(FVTP2D_ARGS) {
  return dispatch<double>(FVTP2D_PASS);
}
