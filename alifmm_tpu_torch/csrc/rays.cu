// K2 and K3: the ray march, and the Fermat relaxation with the ray times,
// as CUDA kernels for sm_90a, in float and double.
//
// Neither has a Pallas counterpart: each replaces loops that the JAX
// package leaves to XLA, and whose plain PyTorch twins in
// alifmm_tpu_torch/rays.py are chains of small launches.
//
//   K2  march_kernel        replaces trace_rays' jax.lax.while_loop
//                           (alifmm_tpu/rays.py:728-964; twin march_plain)
//   K3  relax_times_kernel  replaces relax_rays' wave scan and ray_times
//                           (alifmm_tpu/rays.py:445-476 and 333-367; twin
//                           relax_wave_plain waves, then ray_times_plain)
//   segments_kernel         runs the four segment integrators below on a
//                           list of segments, so that each can be held
//                           against its twin (segment_time_quad3,
//                           segment_time_quad, _segment_time_walk,
//                           segment_time); no entry point launches it
//
// What bounds them.  Both do little arithmetic (the weld's 961 rays of
// about 110 steps and 15 candidates are some 10^8 operations, microseconds
// at the card's rate) and move little (the fields and the material rows
// they touch stay in L2).  K2 is bound by latency: a ray is a chain of up
// to max_steps dependent steps, and a step is a chain of its own (plane
// geometry, then per candidate a bilinear field sample and 3 to 16
// material samples with an arctan, divides and floor-mods, then the
// minimum search).  K3 is a few waves over a ray's vertices, then a sum
// over its segments, each a few material samples deep.
//
// What the design does about it.
// * K2: one launch marches every ray from its source to its end.  A ray
//   gets 32 lanes, or 64 (two warps) when its step has more than 32
//   independent pieces of work: the K candidates for the walk scorer, the
//   K x N (candidate, sample) pairs for Simpson N.  The lanes of a ray
//   share TT and the plane in shared memory, double-buffered by step, so
//   one barrier (a warp's, or a named barrier for the pair) separates
//   writing from reading; Simpson's samples go through shared memory to
//   their candidate's owner, which adds them in sample order behind a
//   second barrier.  Every warp of a ray finds the refined interior
//   minimum over all columns with a shuffle reduction ordered on (value,
//   column), which keeps the first of equal values as the twin does, and
//   carries the ray's state in registers, so nothing is broadcast.  A ray
//   leaves its loop when it is done: nothing goes to the host.
// * Each material sample is one aligned load of its (veln, vel_map,
//   column, pad) row (16 bytes, two in double) and two reads of the curve
//   table, which a block copies into shared memory when it fits.  The
//   walk computes the cells of up to kWalkChunk crossings first (they are
//   arithmetic only), then issues all of their row loads, then adds the
//   terms in step order.  Floor-mod by 180 takes one compare and one add
//   for |x| < 360, where fmod is exact (mod180).
// * K3: one launch per trace, one block per ray.  A wave moves vertices of
//   one parity using their neighbours, which are of the other parity and
//   do not move in it, so the block runs every wave in place (in shared
//   memory when the polyline fits, else in the output buffers) with a
//   barrier between waves and gets the bits of the twin's map.  Then the
//   ray's segments are added per thread in segment order, across the
//   block in a fixed tree: no atomics, so a ray's time is the same from
//   run to run.  Without waves it computes only the times.
// * The exact integrator merges the two monotone crossing sequences with
//   two pointers instead of sorting them, and skips intervals of zero
//   length (their terms are exact zeros in the twin).
// * Two compile-time choices leave the paths above as they were.  The
//   material path MK: MAT_CURVES reads the 4-column rows and the unified
//   curve table; MAT_STIFFNESS (exact_materials, or a model without curve
//   indices) reads 8-column rows (veln, velpn, vel_map, c22, c23, c33,
//   c44, rho; two aligned loads of 4) and per cell either the group table
//   (velpn != 0) or the closed-form Christoffel group velocity
//   (christoffel_group: tan, atan, cos, sin, square roots and divides; a
//   sample costs some four times a table sample).  The field tap TAP of
//   K2: TAP_BILINEAR samples a field on the model grid at x / s, as
//   above; TAP_NEAREST (trace_rays(mode="grid"), fields on the refined
//   grid) reads the nearest fine point, one load.  The fast-stride mask
//   (fast_step_scale) is one byte a step, read only when it is given.
//
// The device functions K4 (descent.cu) shares with these kernels -- the
// material rows, the group velocity of a row, Simpson's integrator and the
// field taps -- are in ray_device.cuh.
//
// Arithmetic follows the twins operation for operation (build with
// -fmad=false): rint for round-half-even, truncation for float -> int,
// floor-mod as torch.remainder, true divisions, sums in the twins' stated
// order (Simpson samples in sample order, crossing intervals in sorted
// order, walk steps in step order), strict comparisons as written there.
// Only the sum over a ray's segments has another order than the twin's
// torch.sum and is held to a tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ray_device.cuh"

namespace {

constexpr double kBIG = 1.0e30;
constexpr double kSqrt2 = 1.4142135623730951;
constexpr int kThreads = 128;
// dynamic shared memory a block may use on sm_90 after the opt-in
constexpr size_t kMaxSmem = 232448;
// crossings of the walk whose row loads go out together (4 for the
// 8-column rows, whose round holds twice the registers)
constexpr int kWalkChunk = 8;

// Crossing parameter k of one axis in segment_time's axis_ts.
template <typename T>
struct Axis {
  T p1, d, rp, sgn;
  bool zero;
  __device__ __forceinline__ Axis(T p1_, T d_)
      : p1(p1_), d(d_), rp(m_rint(p1_)), sgn(d_ < T(0) ? T(-1) : T(1)),
        zero(d_ == T(0)) {}
  __device__ __forceinline__ T at(int k) const {
    if (zero) return T(1);
    T t = (rp + sgn * (T(k) + T(0.5)) - p1) / d;
    return vclamp(t, T(0), T(1));
  }
};

// segment_time: the crossings of both axes merged with two pointers (each
// sequence is monotone in k), the last breakpoint 1, intervals added in
// sorted order; zero-length intervals add exact zeros and are skipped.
template <typename T, int MK>
__device__ T seg_exact(const Mat<T>& m, T x1, T y1, T x2, T y2, int max_cross) {
  x1 = x1 / m.s;
  x2 = x2 / m.s;
  y1 = y1 / m.s;
  y2 = y2 / m.s;
  T dx = x2 - x1;
  T dy = y2 - y1;
  T angle = angle_deg(dx, dy);
  T length = m_sqrt(dx * dx + dy * dy);
  T scale = m.dnx * length;
  Axis<T> ax(x1, dx), ay(y1, dy);
  int i = 0, j = 0;
  T a = ax.at(0), b = ay.at(0);
  T t0 = T(0), acc = T(0);
  bool first = true;
  for (int n = 0; n < 2 * max_cross + 1; ++n) {
    T t;
    if (i < max_cross && (j >= max_cross || a <= b)) {
      t = a;
      ++i;
      a = i < max_cross ? ax.at(i) : T(1);
    } else if (j < max_cross) {
      t = b;
      ++j;
      b = j < max_cross ? ay.at(j) : T(1);
    } else {
      t = T(1);
    }
    if (t != t0) {
      T tm = T(0.5) * (t0 + t);
      int xi = cell_of(x1 + tm * dx, m.X);
      int yi = cell_of(y1 + tm * dy, m.Z);
      T term = scale * (t - t0) / cell_velocity<T, MK>(m, yi, xi, angle);
      acc = first ? term : acc + term;
      first = false;
    }
    t0 = t;
    if (t0 == T(1)) break;  // every later breakpoint is 1 too
  }
  return acc;
}

// _segment_time_walk: one crossing per step, in_cross steps in all, terms
// added in step order; the steps after the end add exact zeros.  In
// rounds of kWalkChunk steps (half that for 8-column rows): the crossings
// first, then their row loads all at once, then the terms.  The round's
// length orders only the loads: the terms are the same for any length.
template <typename T, int MK>
__device__ T seg_walk(const Mat<T>& m, T x1, T y1, T x2, T y2, int in_cross) {
  constexpr int CH = MK == MAT_CURVES ? kWalkChunk : kWalkChunk / 2;
  x1 = x1 / m.s;
  x2 = x2 / m.s;
  y1 = y1 / m.s;
  y2 = y2 / m.s;
  bool dxz = x2 == x1;
  T slope = (y2 - y1) / (dxz ? T(1) : x2 - x1);
  T angle = dxz ? T(0) : m_atan(slope) * T(kRad2Deg);
  T mm = dxz ? T(0) : slope;
  T c = y1 - mm * x1;
  T dir_x = x1 < x2 ? T(1) : T(-1);
  T dir_y = y1 < y2 ? T(1) : T(-1);
  bool mz = mm == T(0);
  T m_safe = mz ? T(1) : mm;
  T px = x1, py = y1;
  T nx = m_rint(x1) + dir_x * T(0.5);
  T ny = m_rint(y1) + dir_y * T(0.5);
  bool fin_x = false, fin_y = false;
  T acc = T(0);
  for (int k0 = 0; k0 < in_cross && !(fin_x && fin_y); k0 += CH) {
    int cell[CH];
    T dist[CH];
    bool live[CH];
#pragma unroll
    for (int q = 0; q < CH; ++q) {
      live[q] = k0 + q < in_cross && !(fin_x && fin_y);
      cell[q] = 0;
      dist[q] = T(0);
      if (!live[q]) continue;
      bool past_x = (((nx > x2) && dir_x == T(1)) || ((nx < x2) && dir_x == T(-1))) && !fin_x;
      if (past_x) nx = x2;
      bool past_y = (((ny > y2) && dir_y == T(1)) || ((ny < y2) && dir_y == T(-1))) && !fin_y;
      if (past_y) ny = y2;
      T nx_y = mm * nx + c;
      T ny_x = (ny - c) / m_safe;
      T ex = x1 - nx, ey = y1 - nx_y;
      T d_x = ex * ex + ey * ey;
      T fx = x1 - ny_x, fy = y1 - ny;
      T d_y = fx * fx + fy * fy;
      bool take_x = !dxz && (mz || d_x < d_y);
      T nxv = dxz ? x1 : (take_x ? nx : ny_x);
      T nyv = dxz ? ny : (take_x ? nx_y : ny);
      if (take_x) nx = nx + dir_x; else ny = ny + dir_y;
      int xi = cell_of((px + nxv) * T(0.5), m.X);
      int yi = cell_of((py + nyv) * T(0.5), m.Z);
      T gx = px - nxv, gy = py - nyv;
      cell[q] = yi * m.X + xi;
      dist[q] = m.dnx * m_sqrt(gx * gx + gy * gy);
      px = nxv;
      py = nyv;
      fin_x = fin_x || past_x;
      fin_y = fin_y || past_y;
    }
    Row<T> row[CH];
#pragma unroll
    for (int q = 0; q < CH; ++q)
      if (live[q]) row[q] = load_row<MK>(m, cell[q]);
#pragma unroll
    for (int q = 0; q < CH; ++q) {
      if (!live[q]) continue;
      T term = dist[q] / row_velocity<T, MK>(m, row[q], angle);
      acc = k0 + q == 0 ? term : acc + term;
    }
  }
  return acc;
}

template <typename T, int SCORER, int MK>
__device__ __forceinline__ T seg_score(const Mat<T>& m, T x1, T y1, T x2, T y2, int cross) {
  if (SCORER == SIMPSON3) return seg_simpson<T, 3, MK>(m, x1, y1, x2, y2);
  if (SCORER == SIMPSON5) return seg_simpson<T, 5, MK>(m, x1, y1, x2, y2);
  if (SCORER == WALK) return seg_walk<T, MK>(m, x1, y1, x2, y2, cross);
  return seg_exact<T, MK>(m, x1, y1, x2, y2, cross);
}

template <typename T>
__device__ __forceinline__ T pick4(int d, T v0, T v1, T v2, T v3) {
  return d == 0 ? v0 : (d == 1 ? v1 : (d == 2 ? v2 : v3));
}

// One interior column j of the plane's minimum search: is it a local
// minimum, and the value and position of its parabola's vertex.
template <typename T>
__device__ __forceinline__ bool interior(const T* TT, int j, int n_k, T& val, T& pos) {
  T t1 = TT[j], t2 = TT[j + 1], t3 = TT[j + 2];
  T d1 = t1 - t2;
  T d3 = t3 - t2;
  T ssum = d1 + d3;
  bool flat = ssum <= T(0);
  T ssafe = flat ? T(1) : ssum;
  T o = vclamp((d1 - d3) / (T(2) * ssafe), T(-0.5), T(0.5));
  if (flat) o = T(0);
  val = t2 + (T(0.5) * ssum) * o * o + (T(0.5) * (d3 - d1)) * o;
  pos = o + T(j + 1);
  return (t1 >= t2) && (t2 <= t3) && (j + 2 < n_k);
}

// The lanes of one ray: a warp, or a pair of warps that meet at named
// barrier 1 + slot (barrier 0 is __syncthreads).  The strided loops
// before it leave a warp diverged, so it reconverges first and the pair
// meets at the non-aligned barrier.sync (bar.sync is the aligned form,
// undefined for a diverged warp).
__device__ __forceinline__ void ray_sync(int lanes, int slot) {
  __syncwarp();
  if (lanes == 64) {
    asm volatile("barrier.sync %0, %1;" ::"r"(1 + slot), "r"(lanes) : "memory");
  }
}

template <typename T>
struct MarchArgs {
  Mat<T> m;
  const T* fields;        // (T, TZ, TX) or (TZ, TX)
  long long field_stride;  // TZ * TX, or 0 for one shared field
  int TZ, TX;
  const long long* ttf_index;  // (R,)
  const T* src;                // (R, 2)
  const T* rec;                // (R, 2)
  T* bx;                       // (R, P), zeroed
  T* by;
  long long* length;  // (R,)
  long long* reason;
  long long* steps;
  long long* prof;  // (R, 3) cycles in scoring, reduction, the rest; or null
  int R, P, max_steps, K, k_step, in_cross, rows, cols, sd, sd2;
  int lanes;        // 32 or 64 per ray
  int curves_smem;  // copy the curve table into shared memory
  T off_far, off_near, stride, snap2, near2, arrive2;
  // fast_step_scale: per model cell 1 where the medium is uniform around
  // it (rays._uniform_mask), or null; the stride there when far enough
  const uint8_t* fast;
  T off_fast, fast_far2;
};

// Candidates' values per ray in shared memory: TT and the plane, each
// double-buffered by step, and for Simpson N the K x N sample terms and
// each candidate's dnx * length.  For Simpson a step's work items are
// the K x N (candidate, sample) terms, then the K field samples.
template <int N>
__host__ __device__ __forceinline__ int march_slot_len(int K) {
  // TT and plane twice, then (Simpson) K x N terms and K lengths
  return 4 * K + (N > 1 ? K * N + K : 0);
}

// K2.  32 or 64 lanes per ray; see the note at the top.  MK is the
// material path, TAP the field tap.  With PROF each ray's lane 0 adds up
// clock64 cycles by part of the step.
template <typename T, int SCORER, int MK, int TAP, bool PROF>
__global__ void __launch_bounds__(kThreads, 4)
march_kernel(MarchArgs<T> a) {
  extern __shared__ __align__(16) unsigned char raw[];
  constexpr int N = SCORER == SIMPSON3 ? 3 : (SCORER == SIMPSON5 ? 5 : 1);
  T* smem = reinterpret_cast<T*>(raw);
  Mat<T> m = loaded(a.m);
  stage_curves(m, smem, a.curves_smem != 0);
  const int L = a.lanes;
  const int slot = threadIdx.x / L;
  const int tir = threadIdx.x % L;  // thread in ray
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kThreads / L) + slot;
  if (r >= a.R) return;
  const int K = a.K;
  T* base = smem + (a.curves_smem ? kCurveRows * m.M : 0) + slot * march_slot_len<N>(K);
  T* terms = base + 4 * K;  // Simpson only
  T* segd = terms + K * N;
  const T s = m.s;
  const T* field = a.fields + a.ttf_index[r] * a.field_stride;
  const T rec_x = a.rec[2 * r], rec_y = a.rec[2 * r + 1];
  const T rows1 = T(a.rows - 1), cols1 = T(a.cols - 1);
  const T sd = T(a.sd), sd2 = T(a.sd2);
  T* bx = a.bx + (size_t)r * a.P;
  T* by = a.by + (size_t)r * a.P;

  T last_x = a.src[2 * r], last_y = a.src[2 * r + 1];
  T vec_x = rec_x - last_x, vec_y = rec_y - last_y;
  int len = 1, reason = 0, steps = 0;
  if (tir == 0) {
    bx[0] = last_x;
    by[0] = last_y;
  }
  bool done;
  {
    T ex = last_x - rec_x, ey = last_y - rec_y;
    done = ex * ex + ey * ey <= a.arrive2;
  }
  T tt_last_pt = sample_field<T, TAP>(field, a.TZ, a.TX, s, m_rint(last_x), m_rint(last_y));
  long long c_score = 0, c_reduce = 0, c_rest = 0, t0 = 0;

  for (int k = 0; k < a.max_steps && !done; ++k) {
    if (PROF) t0 = clock64();
    T* TT = base + (k & 1) * K;
    T* plane = base + 2 * K + (k & 1) * K;
    ++steps;
    T ex = last_x - rec_x, ey = last_y - rec_y;
    T near2 = ex * ex + ey * ey;
    if (near2 < a.snap2) {
      vec_x = rec_x - last_x;
      vec_y = rec_y - last_y;
    }
    T off_far = a.off_far;
    if (a.fast != nullptr) {
      // the long stride where the medium is uniform around the point and
      // the receiver is beyond its reach
      bool fast_here = a.fast[cell_of(last_y / s, m.Z) * m.X + cell_of(last_x / s, m.X)] != 0;
      if (fast_here && near2 >= a.fast_far2) off_far = a.off_fast;
    }
    T off = near2 < a.near2 ? a.off_near : off_far;

    // plane orientation: the largest score, the first of equal ones
    int dir = 0;
    {
      T best = m_abs(vec_x);
      T sc = m_abs(vec_x + vec_y) / T(kSqrt2);
      if (sc > best) { best = sc; dir = 1; }
      sc = m_abs(vec_y);
      if (sc > best) { best = sc; dir = 2; }
      sc = m_abs(vec_x - vec_y) / T(kSqrt2);
      if (sc > best) { best = sc; dir = 3; }
    }

    T rl_x = m_rint(last_x), rl_y = m_rint(last_y);
    T offx = vec_x > T(0) ? off : -off;
    T c0 = rl_x + offx;
    bool oob0 = (c0 < T(0)) || (c0 >= T(a.cols));
    T c1 = rl_x + rl_y + offx;
    T c2 = rl_y + (vec_y > T(0) ? off : -off);
    bool oob2 = (c2 < T(0)) || (c2 >= T(a.rows));
    T c3 = rl_y - rl_x + (vec_x < T(0) ? off : -off);
    T lo, hi;
    if (dir == 0) {
      lo = vmax(rl_y - sd, T(0));
      hi = vmin(rl_y + sd, rows1);
    } else if (dir == 1) {
      T base1 = vmax(c1 - rows1, T(0));
      T top1 = vmin(c1, cols1);
      lo = vec_x > T(0) ? vmax(base1, rl_x - sd2) : vmax(base1, c1 - rl_y - sd2);
      hi = vec_x > T(0) ? vmin(top1, c1 - rl_y + sd2) : vmin(top1, rl_x + sd2);
    } else if (dir == 2) {
      lo = vmax(rl_x - sd, T(0));
      hi = vmin(rl_x + sd, cols1);
    } else {
      T base3 = vmax(-c3, T(0));
      T top3 = vmin(rows1 - c3, cols1);
      lo = vec_x < T(0) ? vmax(base3, rl_y - c3 - sd2) : vmax(base3, rl_x - sd2);
      hi = vec_x < T(0) ? vmin(top3, rl_x + sd2) : vmin(top3, rl_y - c3 + sd2);
    }
    int n_k = (int)vclamp<long long>((long long)((hi - lo) / a.stride) + 1, 1, K);
    long long t1 = 0;
    if (PROF) {
      t1 = clock64();
      c_rest += t1 - t0;
    }

    // candidates: field sample plus scored segment
    if constexpr (N == 1) {
      for (int kk = tir; kk < K; kk += L) {
        T tt = T(kBIG);
        if (kk < n_k) {
          T w = vmin(lo + a.stride * T(kk), hi);
          T px = pick4(dir, c0, w, w, w);
          T py = pick4(dir, w, c1 - w, c2, w + c3);
          Tap<T> tap = field_tap<T, TAP>(field, a.TZ, a.TX, s, px, py);  // in flight
          T walk = seg_walk<T, MK>(m, last_x, last_y, px, py, a.in_cross);
          T tp = tap_value<T, TAP>(tap);
          plane[kk] = tp;
          tt = tp + walk;
        }
        TT[kk] = tt;
      }
      ray_sync(L, slot);
    } else {
      // lanes over the (candidate, sample) terms, then over the
      // candidates' field samples and dnx * length
      for (int it = tir; it < K * (N + 1); it += L) {
        int kk = it < K * N ? it / N : it - K * N;
        if (kk >= n_k) continue;
        T w = vmin(lo + a.stride * T(kk), hi);
        T px = pick4(dir, c0, w, w, w);
        T py = pick4(dir, w, c1 - w, c2, w + c3);
        T ddx = px - last_x;
        T ddy = py - last_y;
        if (it < K * N) {
          T angle = angle_deg(ddx, ddy);
          terms[it] = simpson_term<T, N, MK>(m, last_x, last_y, ddx, ddy, angle, it - kk * N);
        } else {
          Tap<T> tap = field_tap<T, TAP>(field, a.TZ, a.TX, s, px, py);
          segd[kk] = m.dnx * (m_sqrt(ddx * ddx + ddy * ddy) / s);
          plane[kk] = tap_value<T, TAP>(tap);
        }
      }
      ray_sync(L, slot);
      for (int kk = tir; kk < K; kk += L) {
        T tt = T(kBIG);
        if (kk < n_k) {
          T acc = terms[kk * N];
#pragma unroll
          for (int i = 1; i < N; ++i) acc = acc + terms[kk * N + i];
          tt = plane[kk] + segd[kk] * acc;
        }
        TT[kk] = tt;
      }
      ray_sync(L, slot);
    }
    long long t2 = 0;
    if (PROF) {
      t2 = clock64();
      c_score += t2 - t1;
    }

    // end points, then interior minima with quadratic refinement; every
    // warp of the ray searches all columns
    int last_col = n_k - 1;
    T tt_first = TT[0], tt_last = TT[last_col];
    bool first_wins = tt_first < tt_last;
    T best_val = first_wins ? tt_first : tt_last;
    T best_pos = first_wins ? T(0) : T(last_col);
    T bv = T(kBIG), bp = T(0);
    int bj = 0x7fffffff;
    for (int j = lane; j < K - 2; j += 32) {
      T val, pos;
      if (interior(TT, j, n_k, val, pos) && val < bv) {
        bv = val;
        bj = j;
        bp = pos;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      T ov = __shfl_xor_sync(kFull, bv, o);
      int oj = __shfl_xor_sync(kFull, bj, o);
      T op = __shfl_xor_sync(kFull, bp, o);
      if (ov < bv || (ov == bv && oj < bj)) {
        bv = ov;
        bj = oj;
        bp = op;
      }
    }
    if (bv < best_val) best_pos = bp;
    long long t3 = 0;
    if (PROF) {
      t3 = clock64();
      c_reduce += t3 - t2;
    }

    T wq = lo + vmin(best_pos * a.stride, hi - lo);
    T new_x = pick4(dir, c0, wq, wq, wq);
    T new_y = pick4(dir, wq, c1 - wq, c2, wq + c3);
    bool plane_oob = (dir == 0 && oob0) || (dir == 2 && oob2);
    T tt_new_pt;
    if (a.k_step == 1) {
      tt_new_pt = sample_field<T, TAP>(field, a.TZ, a.TX, s, m_rint(new_x), m_rint(new_y));
    } else {
      int col_b = (int)vclamp<long long>((long long)m_rint(best_pos), 0, K - 1);
      tt_new_pt = plane[col_b];
    }
    bool increasing = tt_last_pt < tt_new_pt;
    if (plane_oob) reason = 1;
    else if (increasing) reason = 2;
    bool stop = plane_oob || increasing;
    if (!stop) {
      if (tir == 0) {
        bx[len] = new_x;
        by[len] = new_y;
      }
      vec_x = new_x - last_x;
      vec_y = new_y - last_y;
      last_x = new_x;
      last_y = new_y;
      ++len;
      tt_last_pt = tt_new_pt;
    }
    T fx = last_x - rec_x, fy = last_y - rec_y;
    done = stop || (fx * fx + fy * fy <= a.arrive2);
    if (PROF) c_rest += clock64() - t3;
    // no barrier here: the next step writes the other TT and plane buffer
  }

  if (tir == 0) {
    bx[len] = rec_x;  // append the receiver
    by[len] = rec_y;
    a.length[r] = len + 1;
    a.reason[r] = reason;
    a.steps[r] = steps;
    if (PROF) {
      a.prof[3 * r] = c_score;
      a.prof[3 * r + 1] = c_reduce;
      a.prof[3 * r + 2] = c_rest;
    }
  }
}

template <typename T>
struct RelaxArgs {
  Mat<T> m;
  const T* xs;  // (R, P) polylines in
  const T* ys;
  const long long* lengths;  // (R,)
  T* ox;                     // (R, P) polylines out, or null without waves
  T* oy;
  T* times;  // (R,), or null
  int R, P;
  int n_waves, parity0;  // wave w moves the vertices of parity (parity0 + w) % 2
  T h;
  int relax_cross, times_cross;
  int curves_smem, poly_smem;
};

// One relaxation move of vertex v, in place: v - 1 and v + 1 are of the
// other parity and do not move in this wave.
template <typename T, int SCORER, int MK>
__device__ __forceinline__ void relax_vertex(const Mat<T>& m, T* x, T* y, int v, T h,
                                             int max_cross) {
  T px = x[v - 1], py = y[v - 1];
  T cx = x[v], cy = y[v];
  T nx = x[v + 1], ny = y[v + 1];
  T tx = nx - px;
  T ty = ny - py;
  T nrm = m_sqrt(tx * tx + ty * ty);
  if (nrm == T(0)) nrm = T(1);
  T ux = -ty / nrm;
  T uy = tx / nrm;
  T c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T qx = i == 0 ? cx : (i == 1 ? cx - ux * h : cx + ux * h);
    T qy = i == 0 ? cy : (i == 1 ? cy - uy * h : cy + uy * h);
    c[i] = seg_score<T, SCORER, MK>(m, px, py, qx, qy, max_cross) +
           seg_score<T, SCORER, MK>(m, qx, qy, nx, ny, max_cross);
  }
  T c0 = c[0], cm = c[1], cp = c[2];
  T d1 = cm - c0;
  T d3 = cp - c0;
  T ssum = d1 + d3;
  T off;
  if (ssum > T(0)) {
    off = vclamp((d1 - d3) / (T(2) * ssum), T(-1), T(1)) * h;
  } else {
    bool better = vmin(cm, cp) < c0;
    off = better ? (cm < cp ? -h : h) : T(0);
  }
  x[v] = cx + ux * off;
  y[v] = cy + uy * off;
}

// K3.  One block per ray: the waves in place, then the ray's time.  MK
// is the material path.
template <typename T, int SCORER, int MK>
__global__ void __launch_bounds__(kThreads)
relax_times_kernel(RelaxArgs<T> a) {
  extern __shared__ __align__(16) unsigned char raw[];
  __shared__ T part[kThreads / 32];
  T* smem = reinterpret_cast<T*>(raw);
  Mat<T> m = loaded(a.m);
  stage_curves(m, smem, a.curves_smem != 0);
  const int r = blockIdx.x;
  const int P = a.P;
  const long long n = a.lengths[r];
  const T* x = a.xs + (size_t)r * P;
  const T* y = a.ys + (size_t)r * P;
  if (a.n_waves > 0) {
    T* wx = a.ox + (size_t)r * P;
    T* wy = a.oy + (size_t)r * P;
    if (a.poly_smem) {
      wx = smem + (a.curves_smem ? kCurveRows * m.M : 0);
      wy = wx + P;
    }
    for (int i = threadIdx.x; i < P; i += kThreads) {
      wx[i] = x[i];
      wy[i] = y[i];
    }
    __syncthreads();
    for (int w = 0; w < a.n_waves; ++w) {
      int parity = (a.parity0 + w) & 1;
      // the vertices of this parity in [1, P - 2] below n - 1
      for (long long v = 2 - parity + 2 * threadIdx.x; v <= P - 2 && v < n - 1;
           v += 2 * kThreads) {
        relax_vertex<T, SCORER, MK>(m, wx, wy, (int)v, a.h, a.relax_cross);
      }
      __syncthreads();
    }
    if (a.poly_smem) {
      T* ox = a.ox + (size_t)r * P;
      T* oy = a.oy + (size_t)r * P;
      for (int i = threadIdx.x; i < P; i += kThreads) {
        ox[i] = wx[i];
        oy[i] = wy[i];
      }
    }
    x = wx;
    y = wy;
  }
  if (a.times == nullptr) return;
  // segments per thread in segment order, then a fixed tree
  T acc = T(0);
  for (int i = threadIdx.x; i < P - 1; i += kThreads) {
    if (i + 1 < n) acc = acc + seg_exact<T, MK>(m, x[i], y[i], x[i + 1], y[i + 1], a.times_cross);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc = acc + __shfl_down_sync(kFull, acc, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T total = part[0];
    for (int w = 1; w < kThreads / 32; ++w) total = total + part[w];
    a.times[r] = total;
  }
}

// The four integrators on n segments, one thread each.
template <typename T, int MK>
__global__ void __launch_bounds__(kThreads)
segments_kernel(Mat<T> m_in, int kind, const T* x1, const T* y1, const T* x2,
                const T* y2, T* out, long long n, int cross) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Mat<T> m = loaded(m_in);
  T v;
  if (kind == SIMPSON3) v = seg_simpson<T, 3, MK>(m, x1[i], y1[i], x2[i], y2[i]);
  else if (kind == SIMPSON5) v = seg_simpson<T, 5, MK>(m, x1[i], y1[i], x2[i], y2[i]);
  else if (kind == WALK) v = seg_walk<T, MK>(m, x1[i], y1[i], x2[i], y2[i], cross);
  else v = seg_exact<T, MK>(m, x1[i], y1[i], x2[i], y2[i], cross);
  out[i] = v;
}

template <typename T>
Mat<T> make_mat(const void* flat, const void* curves, int M, int Z, int X,
                const void* dnx, int s, int has_stif) {
  Mat<T> m;
  m.flat = static_cast<const T*>(flat);
  m.curves = static_cast<const T*>(curves);
  m.dnx_ptr = static_cast<const T*>(dnx);
  m.M = M;
  m.Z = Z;
  m.X = X;
  m.has_stif = has_stif;
  m.dnx = T(0);
  m.s = T(s);
  return m;
}

// Launch `kernel` after lifting its dynamic shared memory cap where
// `smem` needs it; returns the launch's error.
template <typename A>
int launch(void (*kernel)(A), unsigned blocks, size_t smem, void* stream, const A& a) {
  if (kernel == nullptr || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(blocks), dim3(kThreads), smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int MK, int TAP, bool PROF>
void (*march_for_scorer(int scorer))(MarchArgs<T>) {
  if (scorer == SIMPSON3) return march_kernel<T, SIMPSON3, MK, TAP, PROF>;
  if (scorer == SIMPSON5) return march_kernel<T, SIMPSON5, MK, TAP, PROF>;
  if (scorer == WALK) return march_kernel<T, WALK, MK, TAP, PROF>;
  return nullptr;
}

// The march for (scorer, material path, tap); the PROF build exists for
// float with the unified curves and the bilinear tap only.
template <typename T, bool PROF>
void (*march_fn(int scorer, int mk, int tap))(MarchArgs<T>) {
  if constexpr (PROF) {
    if constexpr (std::is_same<T, float>::value) {
      if (mk == MAT_CURVES && tap == TAP_BILINEAR)
        return march_for_scorer<T, MAT_CURVES, TAP_BILINEAR, true>(scorer);
    }
    return nullptr;
  } else {
    if (mk == MAT_CURVES)
      return tap == TAP_NEAREST ? march_for_scorer<T, MAT_CURVES, TAP_NEAREST, false>(scorer)
                                : march_for_scorer<T, MAT_CURVES, TAP_BILINEAR, false>(scorer);
    return tap == TAP_NEAREST ? march_for_scorer<T, MAT_STIFFNESS, TAP_NEAREST, false>(scorer)
                              : march_for_scorer<T, MAT_STIFFNESS, TAP_BILINEAR, false>(scorer);
  }
}

template <typename T, int MK>
void (*relax_for_scorer(int scorer))(RelaxArgs<T>) {
  if (scorer == SIMPSON3) return relax_times_kernel<T, SIMPSON3, MK>;
  if (scorer == SIMPSON5) return relax_times_kernel<T, SIMPSON5, MK>;
  if (scorer == EXACT) return relax_times_kernel<T, EXACT, MK>;
  return nullptr;
}

template <typename T>
void (*relax_times_fn(int scorer, int mk))(RelaxArgs<T>) {
  return mk == MAT_CURVES ? relax_for_scorer<T, MAT_CURVES>(scorer)
                          : relax_for_scorer<T, MAT_STIFFNESS>(scorer);
}

size_t march_smem(int scorer, int K, int lanes, int curves_smem, int M, size_t item) {
  int slot = scorer == SIMPSON3 ? march_slot_len<3>(K)
                                : (scorer == SIMPSON5 ? march_slot_len<5>(K) : march_slot_len<1>(K));
  return ((curves_smem ? (size_t)kCurveRows * M : 0) + (size_t)(kThreads / lanes) * slot) * item;
}

size_t relax_times_smem(int P, int curves_smem, int poly_smem, int M, size_t item) {
  return ((curves_smem ? (size_t)kCurveRows * M : 0) + (poly_smem ? 2 * (size_t)P : 0)) * item;
}

template <typename T>
int launch_march(const void* flat, const void* curves, int M, int Z, int X,
                 const void* dnx, int s, int mat_kind, int has_stif, const void* fields,
                 long long field_stride, int TZ, int TX, const void* ttf_index,
                 const void* src, const void* rec, void* bx, void* by, void* length,
                 void* reason, void* steps, int R, int P, int max_steps, int K,
                 int k_step, int in_cross, int plane_dist, double off_far,
                 double off_near, double stride, double snap2, double near2,
                 double arrive2, int scorer, int lanes, int curves_smem, void* prof,
                 int tap, const void* fast, double off_fast, double fast_far2,
                 void* stream) {
  if (lanes != 32 && lanes != 64) return (int)cudaErrorInvalidValue;
  MarchArgs<T> a;
  a.m = make_mat<T>(flat, curves, M, Z, X, dnx, s, has_stif);
  a.fields = static_cast<const T*>(fields);
  a.field_stride = field_stride;
  a.TZ = TZ;
  a.TX = TX;
  a.ttf_index = static_cast<const long long*>(ttf_index);
  a.src = static_cast<const T*>(src);
  a.rec = static_cast<const T*>(rec);
  a.bx = static_cast<T*>(bx);
  a.by = static_cast<T*>(by);
  a.length = static_cast<long long*>(length);
  a.reason = static_cast<long long*>(reason);
  a.steps = static_cast<long long*>(steps);
  a.prof = static_cast<long long*>(prof);
  a.R = R;
  a.P = P;
  a.max_steps = max_steps;
  a.K = K;
  a.k_step = k_step;
  a.in_cross = in_cross;
  // the plane's range: the refined grid of the model, or (the nearest
  // tap) the fields' own
  a.rows = tap == TAP_NEAREST ? TZ : (Z - 1) * s + 1;
  a.cols = tap == TAP_NEAREST ? TX : (X - 1) * s + 1;
  a.sd = plane_dist * s + 1;
  a.sd2 = (plane_dist - 1) * s + 1;
  a.lanes = lanes;
  a.curves_smem = curves_smem;
  a.off_far = T(off_far);
  a.off_near = T(off_near);
  a.stride = T(stride);
  a.snap2 = T(snap2);
  a.near2 = T(near2);
  a.arrive2 = T(arrive2);
  a.fast = static_cast<const uint8_t*>(fast);
  a.off_fast = T(off_fast);
  a.fast_far2 = T(fast_far2);
  const int per_block = kThreads / lanes;
  unsigned blocks = (unsigned)((R + per_block - 1) / per_block);
  size_t smem = march_smem(scorer, K, lanes, curves_smem, M, sizeof(T));
  void (*kernel)(MarchArgs<T>) = prof != nullptr ? march_fn<T, true>(scorer, mat_kind, tap)
                                                 : march_fn<T, false>(scorer, mat_kind, tap);
  return launch(kernel, blocks, smem, stream, a);
}

template <typename T>
int launch_relax_times(const void* flat, const void* curves, int M, int Z, int X,
                       const void* dnx, int s, int mat_kind, int has_stif, const void* xs,
                       const void* ys, const void* lengths, void* ox, void* oy, void* times,
                       int R, int P, int n_waves, int parity0, double h, int relax_cross,
                       int relax_scorer, int times_cross, int curves_smem,
                       int poly_smem, void* stream) {
  RelaxArgs<T> a;
  a.m = make_mat<T>(flat, curves, M, Z, X, dnx, s, has_stif);
  a.xs = static_cast<const T*>(xs);
  a.ys = static_cast<const T*>(ys);
  a.lengths = static_cast<const long long*>(lengths);
  a.ox = static_cast<T*>(ox);
  a.oy = static_cast<T*>(oy);
  a.times = static_cast<T*>(times);
  a.R = R;
  a.P = P;
  a.n_waves = n_waves;
  a.parity0 = parity0 & 1;
  a.h = T(h);
  a.relax_cross = relax_cross;
  a.times_cross = times_cross;
  a.curves_smem = curves_smem;
  a.poly_smem = n_waves > 0 && poly_smem;
  if (n_waves > 0 && (ox == nullptr || oy == nullptr)) return (int)cudaErrorInvalidValue;
  size_t smem = relax_times_smem(P, curves_smem, a.poly_smem, M, sizeof(T));
  return launch(relax_times_fn<T>(relax_scorer, mat_kind), (unsigned)R, smem, stream, a);
}

template <typename T>
int launch_segments(const void* flat, const void* curves, int M, int Z, int X,
                    const void* dnx, int s, int mat_kind, int has_stif, int kind,
                    const void* x1, const void* y1, const void* x2, const void* y2,
                    void* out, long long n, int cross, void* stream) {
  Mat<T> m = make_mat<T>(flat, curves, M, Z, X, dnx, s, has_stif);
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads)), block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T *p1 = static_cast<const T*>(x1), *q1 = static_cast<const T*>(y1);
  const T *p2 = static_cast<const T*>(x2), *q2 = static_cast<const T*>(y2);
  if (mat_kind == MAT_CURVES)
    segments_kernel<T, MAT_CURVES><<<grid, block, 0, st>>>(m, kind, p1, q1, p2, q2,
                                                           static_cast<T*>(out), n, cross);
  else
    segments_kernel<T, MAT_STIFFNESS><<<grid, block, 0, st>>>(m, kind, p1, q1, p2, q2,
                                                              static_cast<T*>(out), n, cross);
  return (int)cudaGetLastError();
}

// Blocks of a kernel resident per SM at this shared memory: which = 0 the
// march (with PROF if prof), 1 K3.
template <typename T>
int occupancy(int which, int scorer, int mk, int tap, int prof, size_t smem) {
  int blocks = -1;
  cudaError_t e;
  if (which == 0) {
    void (*k)(MarchArgs<T>) = prof ? march_fn<T, true>(scorer, mk, tap)
                                   : march_fn<T, false>(scorer, mk, tap);
    if (k == nullptr) return -1;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, smem);
  } else {
    void (*k)(RelaxArgs<T>) = relax_times_fn<T>(scorer, mk);
    if (k == nullptr) return -1;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, smem);
  }
  return e == cudaSuccess ? blocks : -1;
}

}  // namespace

#define ALIFMM_MAT_PARAMS                                                      \
  const void *flat, const void *curves, int M, int Z, int X, const void *dnx, \
      int s, int mat_kind, int has_stif
#define ALIFMM_MAT_ARGS flat, curves, M, Z, X, dnx, s, mat_kind, has_stif

#define ALIFMM_MARCH_PARAMS                                                     \
  ALIFMM_MAT_PARAMS, const void *fields, long long field_stride, int TZ, int TX, \
      const void *ttf_index, const void *src, const void *rec, void *bx,        \
      void *by, void *length, void *reason, void *steps, int R, int P,          \
      int max_steps, int K, int k_step, int in_cross, int plane_dist,           \
      double off_far, double off_near, double stride, double snap2,             \
      double near2, double arrive2, int scorer, int lanes, int curves_smem,     \
      void *prof, int tap, const void *fast, double off_fast, double fast_far2, \
      void *stream
#define ALIFMM_MARCH_ARGS                                                        \
  ALIFMM_MAT_ARGS, fields, field_stride, TZ, TX, ttf_index, src, rec, bx, by,    \
      length, reason, steps, R, P, max_steps, K, k_step, in_cross, plane_dist,   \
      off_far, off_near, stride, snap2, near2, arrive2, scorer, lanes,           \
      curves_smem, prof, tap, fast, off_fast, fast_far2, stream

#define ALIFMM_RELAX_PARAMS                                                      \
  ALIFMM_MAT_PARAMS, const void *xs, const void *ys, const void *lengths,       \
      void *ox, void *oy, void *times, int R, int P, int n_waves, int parity0,   \
      double h, int relax_cross, int relax_scorer, int times_cross,              \
      int curves_smem, int poly_smem, void *stream
#define ALIFMM_RELAX_ARGS                                                        \
  ALIFMM_MAT_ARGS, xs, ys, lengths, ox, oy, times, R, P, n_waves, parity0, h,    \
      relax_cross, relax_scorer, times_cross, curves_smem, poly_smem, stream

#define ALIFMM_SEG_PARAMS                                                        \
  ALIFMM_MAT_PARAMS, int kind, const void *x1, const void *y1, const void *x2,  \
      const void *y2, void *out, long long n, int cross, void *stream
#define ALIFMM_SEG_ARGS \
  ALIFMM_MAT_ARGS, kind, x1, y1, x2, y2, out, n, cross, stream

// Plain C interface (ops/cuda_rays.py binds it with ctypes).  Every
// launching function launches on `stream` and returns cudaGetLastError().
extern "C" {
int alifmm_march_f32(ALIFMM_MARCH_PARAMS) { return launch_march<float>(ALIFMM_MARCH_ARGS); }
int alifmm_march_f64(ALIFMM_MARCH_PARAMS) { return launch_march<double>(ALIFMM_MARCH_ARGS); }
int alifmm_relax_times_f32(ALIFMM_RELAX_PARAMS) { return launch_relax_times<float>(ALIFMM_RELAX_ARGS); }
int alifmm_relax_times_f64(ALIFMM_RELAX_PARAMS) { return launch_relax_times<double>(ALIFMM_RELAX_ARGS); }
int alifmm_segments_f32(ALIFMM_SEG_PARAMS) { return launch_segments<float>(ALIFMM_SEG_ARGS); }
int alifmm_segments_f64(ALIFMM_SEG_PARAMS) { return launch_segments<double>(ALIFMM_SEG_ARGS); }
// dynamic shared memory of a launch, in bytes
long long alifmm_march_smem(int scorer, int K, int lanes, int curves_smem, int M, int item) {
  return (long long)march_smem(scorer, K, lanes, curves_smem, M, (size_t)item);
}
long long alifmm_relax_times_smem(int P, int curves_smem, int poly_smem, int M, int item) {
  return (long long)relax_times_smem(P, curves_smem, poly_smem, M, (size_t)item);
}
// blocks resident per SM, or -1
int alifmm_occupancy_f32(int which, int scorer, int mat_kind, int tap, int prof, long long smem) {
  return occupancy<float>(which, scorer, mat_kind, tap, prof, (size_t)smem);
}
int alifmm_occupancy_f64(int which, int scorer, int mat_kind, int tap, int prof, long long smem) {
  return occupancy<double>(which, scorer, mat_kind, tap, 0, (size_t)smem);
}
}
