// Batched finite-volume 2-D transport (fv_tp_2d without del-n damping).
//
// Replaces pace_tpu/ops/pallas/fvtp2d_pallas.py:transport_batched (its
// bodies _k1_inner_y, _k2_x_passes and _k3_outer_y).  For T stacked fields
// of `tiles` tiles (6 for the whole cube, 6 / t for a rank of a (t, x, y)
// layout), each a block of Ni x Nj storage points (the whole N x N tile,
// or the part of it a rank holds), sharing Courant numbers, area fluxes,
// unit fluxes and metrics it returns
//   fx = 0.5 * (xppm(qay) + xppm(q_x)) * xmf
//   fy = 0.5 * (yppm(qax) + yppm(q_y)) * ymf
// with qay / qax the fields advected by the inner y / x PPM pass, exactly
// as pace_torch.ops.fvtp2d.transport_batched_plain computes them, for
// every PPM order the plain version takes: |ord| < 8 with the smt5 mask
// (its bl * br < 0 form at |ord| == 5) and |ord| >= 8 (9 and 10 run the
// ord-8 limiter, as the reference package does).
//
// What bounds it on the card: memory.  Each call must read q_y, q_x
// (T fields each) and six shared (6, N, N, nz) fields and write fx, fy
// (T fields each): at T=8, C48/79 float32 that is 226 MB, 67 us at
// 3.35 TB/s; the arithmetic (four PPM cells, four fluxes and two advected
// values per output point, about 160 operations) would take less at the
// float32 peak.  On an H100 the kernel reaches a few percent of that
// bound (PERF.md): instruction issue on the per-cell arithmetic, including
// the halo lines each block sweeps again, sets its time.  The design keeps
// everything but those bytes on chip:
//   - one launch; a block owns BI x BJ (i, j) points x KC contiguous
//     levels of one (field, tile), 8 x 8 x 16.  Threads run along k, so
//     every load and store of a row is a coalesced run of KC values;
//   - each thread sweeps one line of the tile and its halo (the PPM flux
//     at interface m needs q at m-3 .. m+2): the inner y pass on q_y over
//     (BI+5) lines, the inner x pass on q_x over (BJ+5) lines, writing the
//     advected fields qay / qax and the inner fluxes into shared memory;
//     after one barrier the outer x pass sweeps qay and the outer y pass
//     sweeps qax, and the outputs go straight to device memory;
//   - along a line every per-cell PPM intermediate (slope dm, interface
//     value al, limited edge values bl / br, the smt5 mask) is computed
//     once, in registers, and each flux is a selection on the sign of the
//     Courant number plus a few flops: no thread recomputes a neighbour's
//     cell and no warp diverges on that sign;
//   - the block's 16 x 13 threads sweep the 26 inner lines in two rounds
//     and the 16 outer lines in two, with registers capped so that three
//     blocks share an SM at float32 (the fastest of the lane counts and
//     caps tried on an H100), and the float32 NaN-propagating min/max are
//     single instructions;
//   - offsets come from blockIdx and strides, in 32-bit arithmetic past
//     the block's base pointers; no 64-bit division.
//
// Whole-array semantics: the reference evaluates every intermediate over
// the whole padded array with zero-filled shifts at the array bounds and
// overwrites six static tile-edge lines.  Every per-cell value is 0 for an
// index outside the block ([0, Ni) along i, [0, Nj) along j), the slopes
// of the shifted lines (dm_left, dm_right) are evaluated on the
// zero-filled shifted line and not taken from a neighbour's dm, and the
// edge lines are matched by index in the reference's precedence, so the
// kernel agrees with the plain version over the whole block and not only
// on the compute domain.  Along each axis the tile's two edge lines are
// given as local indices lo (the tile's h) and hi (its h + n); a block
// that does not hold an edge gets an index outside its extent, which no
// line matches.

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

// tile: BI x BJ points, KC levels, LANES lines swept at a time; at least
// MINB blocks per SM at float32, which caps a thread's registers
constexpr int BI = 8, BJ = 8, KC = 16, LANES = 13, MINB = 3;
constexpr int XI = BI + 5;  // qay lines along i (i0-3 .. i0+BI+1)
constexpr int XJ = BJ + 5;  // qax lines along j (j0-3 .. j0+BJ+1)

// maximum/minimum that propagate NaN like torch.maximum/torch.minimum
// (the sign of a zero result may differ from torch's; no output of the
// kernel depends on it: every use feeds a magnitude, a difference taken
// again from q, or a product tested against 0)
template <typename R>
__device__ __forceinline__ R pmax(R a, R b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename R>
__device__ __forceinline__ R pmin(R a, R b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
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
// |a| with the sign of b (b == 0 counts as negative)
template <typename R>
__device__ __forceinline__ R fsign(R a, R b) {
  return b > R(0) ? fabs(a) : -fabs(a);
}

__device__ __forceinline__ bool inside(int m, int N) {
  return m >= 0 && m < N;
}

// A metric line along the PPM axis (dxa or dya), zero outside [0, N) (N
// the block's extent along that axis).
template <typename R>
struct Line {
  const R* p;
  int stride;
  int N;
  __device__ __forceinline__ R operator()(int m) const {
    return inside(m, N) ? p[m * stride] : R(0);
  }
};

// the monotone slope of g at the middle of (g(m-1), g(m), g(m+1))
template <typename R>
__device__ __forceinline__ R slope(R gm1, R g0, R gp1) {
  R xt = R(0.25) * (gp1 - gm1);
  R dqr = pmax(pmax(g0, gm1), gp1) - g0;
  R dql = g0 - pmin(pmin(g0, gm1), gp1);
  return fsign(pmin(pmin(R(fabs(xt)), dqr), dql), xt);
}

// The tile-edge interface value al (xppm compute_al) at an edge line m;
// q(m+o) = qo for o = -2 .. 1; lo and hi are the tile's edge lines.
template <typename R>
__device__ R al_edge(int m, R qm2, R qm1, R q0, R qp1, const Line<R>& d,
                     int lo, int hi) {
  if (m == lo + 1 || m == hi + 1)
    return R(kC3) * qm1 + R(kC2) * q0 + R(kC1) * qp1;
  if (m == lo || m == hi)
    return R(0.5) * (((R(2) * d(m - 1) + d(m - 2)) * qm1 - d(m - 1) * qm2) /
                         (d(m - 2) + d(m - 1)) +
                     ((R(2) * d(m) + d(m + 1)) * q0 - d(m) * qp1) /
                         (d(m) + d(m + 1)));
  return R(kC1) * qm2 + R(kC2) * qm1 + R(kC3) * q0;
}

// bl, br at an edge line m of the ord >= 8 limiter (xppm bl_br_edges and
// the standard constraint); q(m+o) = qo for o = -2 .. 2, dm0 = dm(m),
// al0 = al(m), al1 = al(m+1).
template <typename R>
__device__ void blbr_edge(int m, R qm2, R qm1, R q0, R qp1, R qp2, R dm0,
                          R al0, R al1, const Line<R>& d, int N, int lo,
                          int hi, R& bl, R& br) {
  // the slopes of the zero-filled lines shifted by -1 (left) and +1 (right)
  auto dm_left = [&]() {
    return slope(inside(m - 1, N) ? qm2 : R(0), qm1,
                 inside(m + 1, N) ? q0 : R(0));
  };
  auto dm_right = [&]() {
    return slope(inside(m - 1, N) ? q0 : R(0), qp1,
                 inside(m + 1, N) ? qp2 : R(0));
  };
  auto xt_edge_0 = [&]() {
    R xt = R(0.5) * (((R(2) * d(m) + d(m - 1)) * q0 - d(m) * qm1) /
                         (d(m - 1) + d(m)) +
                     ((R(2) * d(m + 1) + d(m + 2)) * qp1 - d(m + 1) * qp2) /
                         (d(m + 1) + d(m + 2)));
    R minq = pmin(pmin(pmin(qm1, q0), qp1), qp2);
    R maxq = pmax(pmax(pmax(qm1, q0), qp1), qp2);
    return pmin(pmax(xt, minq), maxq);
  };
  auto xt_edge_1 = [&]() {
    R xt = R(0.5) * (((R(2) * d(m - 1) + d(m - 2)) * qm1 - d(m - 1) * qm2) /
                         (d(m - 2) + d(m - 1)) +
                     ((R(2) * d(m) + d(m + 1)) * q0 - d(m) * qp1) /
                         (d(m) + d(m + 1)));
    R minq = pmin(pmin(pmin(qm2, qm1), q0), qp1);
    R maxq = pmax(pmax(pmax(qm2, qm1), q0), qp1);
    return pmin(pmax(xt, minq), maxq);
  };
  // the reference applies the line updates in this order; a later line
  // wins where two coincide (a tile of fewer than four cells)
  R xbl, xbr;
  if (m == hi) {
    xbl = xt_edge_1();
    xbr = R(kS11) * (qp1 - q0) - R(kS14) * dm_right() + q0;
  } else if (m == hi - 1) {
    xbl = R(kS15) * q0 + R(kS11) * qm1 + R(kS14) * dm_left();
    xbr = xt_edge_0();
  } else if (m == hi - 2) {
    xbl = al0;
    xbr = R(kS15) * qp1 + R(kS11) * q0 + R(kS14) * dm0;
  } else if (m == lo + 1) {
    xbl = R(kS15) * qm1 + R(kS11) * q0 - R(kS14) * dm0;
    xbr = al1;
  } else if (m == lo) {
    xbl = xt_edge_1();
    xbr = R(kS15) * q0 + R(kS11) * qp1 - R(kS14) * dm_right();
  } else {  // lo - 1
    xbl = R(kS14) * dm_left() + R(kS11) * (qm1 - q0) + q0;
    xbr = xt_edge_0();
  }
  R al = xbl - q0;
  R ar = xbr - q0;
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

// PPM fluxes (xppm _flux_core) across the NF interfaces m0 .. m0+NF-1 of
// one line, streamed: emit(f, flux) is called for interface m0 + f in
// order.  q[p] is the line at index m0 - 3 + p (zero outside [0, N)), c[f]
// the Courant number at interface m0 + f; lo and hi are the tile's edge
// lines along the line.  CLS is the limiter class: 5
// and 6 for |ord| < 8 (smt5 as bl * br < 0 at 5), 8 for |ord| >= 8.  Each
// per-cell value (dm, al, bl, br, smt5) is computed once, for the cells
// m0-1 .. m0+NF-1, and only the last two cells' values are kept.
template <typename R, int CLS, int NF, typename Emit>
__device__ __forceinline__ void ppm_line(const R (&q)[NF + 5],
                                         const R (&c)[NF], const Line<R>& d,
                                         int m0, int N, int lo, int hi,
                                         Emit&& emit) {
  // the slope at m0 - 3 + p (p >= 1), 0 outside [0, N)
  auto dm_at = [&](int p) {
    return inside(m0 - 3 + p, N) ? slope(q[p - 1], q[p], q[p + 1]) : R(0);
  };
  // the ord < 8 interface value at m0 - 3 + p (p >= 2), 0 outside [0, N)
  auto al6_at = [&](int p) {
    const int m = m0 - 3 + p;
    if (!inside(m, N)) return R(0);
    if (m == lo - 1 || m == lo || m == lo + 1 || m == hi - 1 || m == hi ||
        m == hi + 1)
      return al_edge(m, q[p - 2], q[p - 1], q[p], q[p + 1], d, lo, hi);
    return R(kP1) * (q[p - 1] + q[p]) + R(kP2) * (q[p - 2] + q[p + 1]);
  };
  // rolling state at cell m = m0 - 1 + p: dm(m-1), dm(m), al(m)
  R dm_l = R(0), dm_c = R(0), al_c;
  if (CLS == 8) {
    dm_l = dm_at(1);
    dm_c = dm_at(2);
    al_c = inside(m0 - 1, N) ? R(0.5) * (q[1] + q[2]) +
                                   R(1.0 / 3.0) * (dm_l - dm_c)
                             : R(0);
  } else {
    al_c = al6_at(2);
  }
  R bl_p = R(0), br_p = R(0), s5_p = R(0);  // the previous cell's values
#pragma unroll
  for (int p = 0; p <= NF; ++p) {
    const int m = m0 - 1 + p;
    const R q0 = q[p + 2];
    R bl = R(0), br = R(0), s5 = R(0), al_n;
    if (CLS == 8) {
      const R dm_n = dm_at(p + 3);
      al_n = inside(m + 1, N) ? R(0.5) * (q[p + 2] + q[p + 3]) +
                                    R(1.0 / 3.0) * (dm_c - dm_n)
                              : R(0);
      if (inside(m, N)) {
        if (m == lo - 1 || m == lo || m == lo + 1 || m == hi - 2 ||
            m == hi - 1 || m == hi) {
          blbr_edge(m, q[p], q[p + 1], q0, q[p + 3], q[p + 4], dm_c, al_c,
                    al_n, d, N, lo, hi, bl, br);
        } else {
          const R xt2 = R(2) * dm_c;
          bl = R(-1) * fsign(pmin(R(fabs(xt2)), R(fabs(al_c - q0))), xt2);
          br = fsign(pmin(R(fabs(xt2)), R(fabs(al_n - q0))), xt2);
        }
      }
      dm_l = dm_c;
      dm_c = dm_n;
    } else {
      al_n = al6_at(p + 3);
      if (inside(m, N)) {
        bl = al_c - q0;
        br = al_n - q0;
        if (CLS == 5)
          s5 = (bl * br < R(0)) ? R(1) : R(0);
        else
          s5 = (R(3) * fabs(bl + br) < fabs(bl - br)) ? R(1) : R(0);
      }
    }
    al_c = al_n;
    if (p > 0) {
      // interface m between the previous cell (m-1) and this one
      const R cf = c[p - 1];
      const R fpos = (R(1) - cf) * (br_p - cf * (bl_p + br_p));
      const R fneg = (R(1) + cf) * (bl + cf * (bl + br));
      const R fx1 = cf > R(0) ? fpos : fneg;
      R v;
      if (CLS == 8) {
        v = cf > R(0) ? q[p + 1] + fx1 : q0 + fx1;
      } else {
        const R mask = pmax(s5_p, s5);
        v = cf > R(0) ? q[p + 1] + fx1 * mask : q0 + fx1 * mask;
      }
      emit(p - 1, inside(m, N) ? v : R(0));
    }
    bl_p = bl;
    br_p = br;
    s5_p = s5;
  }
}

// Where a block's fields start, and the strides inside one (field, tile).
template <typename R>
struct Fields {
  const R *q_y, *q_x;                         // this field and tile, + k
  const R *crx, *cry, *xfx, *yfx, *xmf, *ymf;  // this tile, + k
  const R *dxa, *dya, *area;                   // this tile
  int Ni, Nj, nz;
  int lo_i, hi_i, lo_j, hi_j;                  // the tile's edge lines
  bool valid;                                  // k < nz
  __device__ int at(int i, int j) const { return (i * Nj + j) * nz; }
  __device__ R load(const R* p, int i, int j) const {
    return (valid && inside(i, Ni) && inside(j, Nj)) ? p[at(i, j)] : R(0);
  }
};

// Inner pass along one line: the flux of q across the interfaces
// m0 .. m0+B of the line at fixed `fixed` (j for DIR 0 = along i, i for
// DIR 1 = along j), and the advected field on m0 .. m0+B-1:
//   adv = (q * area + a(m) * flux(m) - a(m+1) * flux(m+1))
//         / (area + a(m) - a(m+1)),   a(m+1), flux(m+1) = 0 at m+1 = N;
// store(b, adv, flux) is called for b = 0 .. B-1.
template <typename R, int CLS, int B, int DIR, typename Store>
__device__ __forceinline__ void inner_line(const Fields<R>& F, const R* qf,
                                           const R* cf, const R* af,
                                           const R* dmet, int m0, int fixed,
                                           Store&& store) {
  const int N = DIR == 0 ? F.Ni : F.Nj;  // the line's extent
  auto ij_i = [&](int m) { return DIR == 0 ? m : fixed; };
  auto ij_j = [&](int m) { return DIR == 0 ? fixed : m; };
  R q[B + 6], c[B + 1], a[B + 1];
#pragma unroll
  for (int p = 0; p < B + 6; ++p)
    q[p] = F.load(qf, ij_i(m0 - 3 + p), ij_j(m0 - 3 + p));
#pragma unroll
  for (int f = 0; f < B + 1; ++f) {
    c[f] = F.load(cf, ij_i(m0 + f), ij_j(m0 + f));
    a[f] = F.load(af, ij_i(m0 + f), ij_j(m0 + f));
  }
  const Line<R> d = DIR == 0 ? Line<R>{dmet + fixed, F.Nj, N}
                             : Line<R>{dmet + fixed * F.Nj, 1, N};
  const int lo = DIR == 0 ? F.lo_i : F.lo_j;
  const int hi = DIR == 0 ? F.hi_i : F.hi_j;
  R prev = R(0);
  ppm_line<R, CLS, B + 1>(q, c, d, m0, N, lo, hi, [&](int f, R v) {
    if (f > 0) {
      const int b = f - 1, m = m0 + b;
      R adv = R(0);
      if (inside(m, N)) {
        const R ar = F.area[ij_i(m) * F.Nj + ij_j(m)];
        const bool next = m + 1 < N;
        const R f1 = next ? a[b + 1] * v : R(0);
        adv = (q[b + 3] * ar + a[b] * prev - f1) /
              (ar + a[b] - (next ? a[b + 1] : R(0)));
      }
      store(b, adv, prev);
    }
    prev = v;
  });
}

template <typename R, int CLS>
__global__ void __launch_bounds__(KC * LANES, sizeof(R) == 4 ? MINB : 1)
    transport_kernel(const R* __restrict__ q_y, const R* __restrict__ q_x,
                     const R* __restrict__ crx, const R* __restrict__ cry,
                     const R* __restrict__ xfx, const R* __restrict__ yfx,
                     const R* __restrict__ xmf, const R* __restrict__ ymf,
                     const R* __restrict__ dxa, const R* __restrict__ dya,
                     const R* __restrict__ area, R* __restrict__ fx,
                     R* __restrict__ fy, int tiles, int Ni, int Nj, int nz,
                     int lo_i, int hi_i, int lo_j, int hi_j, int tiles_j) {
  __shared__ R qay_s[XI][BJ][KC];   // qay on i0-3 .. i0+BI+1, own j
  __shared__ R qax_s[BI][XJ][KC];   // qax on own i, j0-3 .. j0+BJ+1
  __shared__ R fyin_s[BI][BJ][KC];  // inner y flux on own points
  __shared__ R fxin_s[BI][BJ][KC];  // inner x flux on own points

  const int tk = threadIdx.x, lane = threadIdx.y;
  const int ti = blockIdx.x / tiles_j;
  const int i0 = ti * BI, j0 = (blockIdx.x - ti * tiles_j) * BJ;
  const int k = blockIdx.y * KC + tk;
  const int tile = blockIdx.z % tiles;
  const long plane = (long)Ni * Nj * nz;
  const long field_off = (long)blockIdx.z * plane + k;
  const long tile_off = (long)tile * plane + k;
  const long met_off = (long)tile * Ni * Nj;

  Fields<R> F{q_y + field_off, q_x + field_off, crx + tile_off,
              cry + tile_off,  xfx + tile_off,  yfx + tile_off,
              xmf + tile_off,  ymf + tile_off,  dxa + met_off,
              dya + met_off,   area + met_off,  Ni,
              Nj,              nz,              lo_i,
              hi_i,            lo_j,            hi_j,
              k < nz};

  // inner passes: y lines i0-3 .. i0+BI+1 on q_y, x lines j0-3 .. j0+BJ+1
  // on q_x; a line outside the block advects to 0 (the zero-filled shift)
  for (int task = lane; task < XI + XJ; task += LANES) {
    if (task < XI) {
      const int i = i0 - 3 + task;
      const bool own = task >= 3 && task < 3 + BI;
      auto store = [&](int b, R adv, R flux) {
        qay_s[task][b][tk] = adv;
        if (own) fyin_s[task - 3][b][tk] = flux;
      };
      if (inside(i, Ni)) {
        inner_line<R, CLS, BJ, 1>(F, F.q_y, F.cry, F.yfx, F.dya, j0, i,
                                  store);
      } else {
#pragma unroll
        for (int b = 0; b < BJ; ++b) store(b, R(0), R(0));
      }
    } else {
      const int l = task - XI;
      const int j = j0 - 3 + l;
      const bool own = l >= 3 && l < 3 + BJ;
      auto store = [&](int b, R adv, R flux) {
        qax_s[b][l][tk] = adv;
        if (own) fxin_s[b][l - 3][tk] = flux;
      };
      if (inside(j, Nj)) {
        inner_line<R, CLS, BI, 0>(F, F.q_x, F.crx, F.xfx, F.dxa, i0, j,
                                  store);
      } else {
#pragma unroll
        for (int b = 0; b < BI; ++b) store(b, R(0), R(0));
      }
    }
  }
  __syncthreads();

  // outer passes on own points: x lines (fixed j) over qay, y lines
  // (fixed i) over qax
  const long out_off = (long)blockIdx.z * plane + k;
  for (int task = lane; task < BI + BJ; task += LANES) {
    if (task < BJ) {
      const int j = j0 + task;
      if (!inside(j, Nj)) continue;
      R q[BI + 5], c[BI];
#pragma unroll
      for (int p = 0; p < BI + 5; ++p) q[p] = qay_s[p][task][tk];
#pragma unroll
      for (int f = 0; f < BI; ++f) c[f] = F.load(F.crx, i0 + f, j);
      ppm_line<R, CLS, BI>(q, c, Line<R>{F.dxa + j, Nj, Ni}, i0, Ni, lo_i,
                           hi_i, [&](int b, R mean) {
        const int i = i0 + b;
        if (F.valid && inside(i, Ni))
          fx[out_off + F.at(i, j)] =
              R(0.5) * (mean + fxin_s[b][task][tk]) * F.xmf[F.at(i, j)];
      });
    } else {
      const int l = task - BJ;
      const int i = i0 + l;
      if (!inside(i, Ni)) continue;
      R q[BJ + 5], c[BJ];
#pragma unroll
      for (int p = 0; p < BJ + 5; ++p) q[p] = qax_s[l][p][tk];
#pragma unroll
      for (int f = 0; f < BJ; ++f) c[f] = F.load(F.cry, i, j0 + f);
      ppm_line<R, CLS, BJ>(q, c, Line<R>{F.dya + i * Nj, 1, Nj}, j0, Nj,
                           lo_j, hi_j, [&](int b, R mean) {
        const int j = j0 + b;
        if (F.valid && inside(j, Nj))
          fy[out_off + F.at(i, j)] =
              R(0.5) * (mean + fyin_s[l][b][tk]) * F.ymf[F.at(i, j)];
      });
    }
  }
}

template <typename R>
int dispatch(const void* q_y, const void* q_x, const void* crx,
             const void* cry, const void* xfx, const void* yfx,
             const void* xmf, const void* ymf, const void* dxa,
             const void* dya, const void* area, void* fx, void* fy, int T,
             int tiles, int Ni, int Nj, int nz, int lo_i, int hi_i,
             int lo_j, int hi_j, int hord, void* stream) {
  auto c = [](const void* p) { return static_cast<const R*>(p); };
  auto m = [](void* p) { return static_cast<R*>(p); };
  const int tiles_i = (Ni + BI - 1) / BI, tiles_j = (Nj + BJ - 1) / BJ;
  const dim3 grid(tiles_i * tiles_j, (nz + KC - 1) / KC, T * tiles);
  const dim3 block(KC, LANES);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // ord_inner = 8 at hord 10 and hord otherwise: the same class either way
  const int mord = hord < 0 ? -hord : hord;
#define PACE_LAUNCH(CLS)                                                    \
  transport_kernel<R, CLS><<<grid, block, 0, s>>>(                          \
      c(q_y), c(q_x), c(crx), c(cry), c(xfx), c(yfx), c(xmf), c(ymf),       \
      c(dxa), c(dya), c(area), m(fx), m(fy), tiles, Ni, Nj, nz, lo_i, hi_i, \
      lo_j, hi_j, tiles_j)
  if (mord >= 8)
    PACE_LAUNCH(8);
  else if (mord == 5)
    PACE_LAUNCH(5);
  else
    PACE_LAUNCH(6);
#undef PACE_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

#define FVTP2D_ARGS                                                        \
  const void *q_y, const void *q_x, const void *crx, const void *cry,      \
      const void *xfx, const void *yfx, const void *xmf, const void *ymf,  \
      const void *dxa, const void *dya, const void *area, void *fx,        \
      void *fy, int T, int tiles, int Ni, int Nj, int nz, int lo_i,      \
      int hi_i, int lo_j, int hi_j, int hord, void *stream
#define FVTP2D_PASS                                                       \
  q_y, q_x, crx, cry, xfx, yfx, xmf, ymf, dxa, dya, area, fx, fy, T, tiles, \
      Ni, Nj, nz, lo_i, hi_i, lo_j, hi_j, hord, stream

extern "C" int pace_fvtp2d_f32(FVTP2D_ARGS) {
  return dispatch<float>(FVTP2D_PASS);
}
extern "C" int pace_fvtp2d_f64(FVTP2D_ARGS) {
  return dispatch<double>(FVTP2D_PASS);
}
