// K2 and K3: the ray march, the Fermat relaxation wave and the ray times
// as CUDA kernels for sm_90a, in float and double.
//
// None of the three has a Pallas counterpart: each replaces a loop that the
// JAX package leaves to XLA, and whose plain PyTorch twin in
// alifmm_tpu_torch/rays.py is a chain of small launches.
//
//   K2  march_kernel        replaces trace_rays' jax.lax.while_loop
//                           (alifmm_tpu/rays.py:728-964; twin march_plain)
//   K3a relax_wave_kernel   replaces one wave of relax_rays' lax.scan
//                           (alifmm_tpu/rays.py:445-476; twin relax_wave_plain)
//   K3b ray_times_kernel    replaces ray_times
//                           (alifmm_tpu/rays.py:333-367; twin ray_times_plain)
//   segments_kernel         runs the four segment integrators below on a
//                           list of segments, so that each can be held
//                           against its twin (segment_time_quad3,
//                           segment_time_quad, _segment_time_walk,
//                           segment_time); no entry point launches it
//
// What bounds them.  All three do little arithmetic (the weld's 961 rays of
// about 110 steps and 15 candidates are some 10^8 operations, microseconds
// at the card's rate) and move little (the fields and the material rows
// they touch stay in L2).  K2 is bound by latency: a step is a chain of
// dependent work (plane geometry, then per candidate a bilinear field
// sample and 3 to 16 material gathers with an arctan, divides and
// floor-mods, then the minimum search), and a ray is a chain of up to
// max_steps such steps.  K3a and K3b are maps over vertices and segments
// and are bound by the same gathers and divides, a few deep.
//
// What the design does about it.
// * K2: one launch marches every ray from its source to its end, one warp
//   per ray.  The lanes take the plane's K candidates in a strided loop
//   (K is 15 with the weld's knobs, 57 with the facade's defaults), put
//   their travel times into shared memory, and find the refined interior
//   minimum with a shuffle reduction ordered on (value, column), which
//   keeps the first of equal values as the twin's selection does.  All
//   lanes carry the ray's state in registers and repeat the step's scalar
//   part, so nothing is broadcast.  A ray leaves its loop when it is done:
//   no ray waits for the slowest, and nothing goes to the host.
// * K3a: one launch per wave, one thread per (ray, vertex); a wave reads
//   one polyline buffer and writes another, so it is a pure map.  Vertices
//   that do not move copy through without scoring anything.
// * K3b: one block per ray, one thread per segment in a strided loop, then
//   a reduction in a fixed order within the block: no atomics, so a ray's
//   time is the same from run to run.
// * The exact integrator merges the two monotone crossing sequences with
//   two pointers instead of sorting them, and skips intervals of zero
//   length (their terms are exact zeros in the twin).
//
// Arithmetic follows the twins operation for operation (build with
// -fmad=false): rint for round-half-even, truncation for float -> int,
// floor-mod built on fmod, true divisions, sums in the twins' stated order
// (Simpson samples in sample order, crossing intervals in sorted order,
// walk steps in step order), strict comparisons as written there.  Only
// K3b's sum over a ray's segments has another order than the twin's
// torch.sum and is held to a tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr double kBIG = 1.0e30;
constexpr double kRad2Deg = 57.29577951308232;  // 180 / pi
constexpr double kSqrt2 = 1.4142135623730951;
constexpr int kThreads = 128;

enum Scorer { SIMPSON3 = 0, SIMPSON5 = 1, WALK = 2, EXACT = 3 };

__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_atan(float x) { return atanf(x); }
__device__ __forceinline__ double m_atan(double x) { return atan(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }
__device__ __forceinline__ float m_floor(float x) { return floorf(x); }
__device__ __forceinline__ double m_floor(double x) { return floor(x); }
__device__ __forceinline__ float m_rint(float x) { return rintf(x); }
__device__ __forceinline__ double m_rint(double x) { return rint(x); }
__device__ __forceinline__ float m_fmod(float x, float y) { return fmodf(x, y); }
__device__ __forceinline__ double m_fmod(double x, double y) { return fmod(x, y); }

template <typename T> __device__ __forceinline__ T vmin(T a, T b) { return b < a ? b : a; }
template <typename T> __device__ __forceinline__ T vmax(T a, T b) { return b > a ? b : a; }
template <typename T> __device__ __forceinline__ T vclamp(T x, T lo, T hi) {
  return vmin(vmax(x, lo), hi);
}

// Floor-mod by 180 (jnp.mod / torch.remainder): fmod, then shift a
// negative remainder into [0, 180).
template <typename T>
__device__ __forceinline__ T mod180(T x) {
  T r = m_fmod(x, T(180));
  if (r != T(0) && r < T(0)) r = r + T(180);
  return r;
}

// round-half-even to a cell index, clamped to [0, n - 1]
template <typename T>
__device__ __forceinline__ int cell_of(T v, int n) {
  long long i = (long long)m_rint(v);
  return (int)vclamp<long long>(i, 0, n - 1);
}

// The model as the integrators read it: per-cell rows (veln, vel_map,
// curve index), the unified group-velocity curves (A, M), the grid.
template <typename T>
struct Mat {
  const T* flat;
  const T* curves;
  const T* dnx_ptr;  // the grid spacing stays on the device: no host read
  int M, Z, X;
  T dnx;  // *dnx_ptr, loaded by each kernel (see loaded())
  T s;    // fine cells per model cell
};

template <typename T>
__device__ __forceinline__ Mat<T> loaded(Mat<T> m) {
  m.dnx = *m.dnx_ptr;
  return m;
}

// atan with a guarded divisor, in degrees
template <typename T>
__device__ __forceinline__ T angle_deg(T dx, T dy) {
  if (dx == T(0)) return T(0);
  return m_atan(dy / dx) * T(kRad2Deg);
}

// Group velocity of cell (yi, xi) for a segment at `angle`: the row gather
// from mat_flat and interp_table_gather on the unified curves.
template <typename T>
__device__ __forceinline__ T cell_velocity(const Mat<T>& m, int yi, int xi, T angle) {
  const T* row = m.flat + 3 * (size_t)(yi * m.X + xi);
  T eff = mod180(mod180(row[0] - angle));
  int a1 = (int)vclamp<long long>((long long)m_floor(eff), 0, 179);
  int a2 = (a1 + 1) % 180;
  T w = eff - T(a1);
  int col = (int)row[2];
  T v1 = m.curves[(size_t)a1 * m.M + col];
  T v2 = m.curves[(size_t)a2 * m.M + col];
  return row[1] * ((T(1) - w) * v1 + w * v2);
}

template <int N> __device__ __forceinline__ double simpson_weight(int i) {
  if (N == 3) return i == 1 ? 4.0 / 6.0 : 1.0 / 6.0;
  return (i == 0 || i == 4) ? 1.0 / 12.0 : (i == 2 ? 2.0 / 12.0 : 4.0 / 12.0);
}

// _simpson_time with N = 3 or 5 samples, added in sample order
template <typename T, int N>
__device__ __forceinline__ T seg_simpson(const Mat<T>& m, T x1, T y1, T x2, T y2) {
  T ddx = x2 - x1;
  T ddy = y2 - y1;
  T angle = angle_deg(ddx, ddy);
  T dist = m_sqrt(ddx * ddx + ddy * ddy) / m.s;
  T acc = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T fr = T(double(i) / double(N - 1));
    T xm = x1 + ddx * fr;
    T ym = y1 + ddy * fr;
    int xi = cell_of(xm / m.s, m.X);
    int yi = cell_of(ym / m.s, m.Z);
    T term = T(simpson_weight<N>(i)) * (T(1) / cell_velocity(m, yi, xi, angle));
    acc = i == 0 ? term : acc + term;
  }
  return m.dnx * dist * acc;
}

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
template <typename T>
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
      T term = scale * (t - t0) / cell_velocity(m, yi, xi, angle);
      acc = first ? term : acc + term;
      first = false;
    }
    t0 = t;
    if (t0 == T(1)) break;  // every later breakpoint is 1 too
  }
  return acc;
}

// _segment_time_walk: one crossing per step, in_cross steps in all, terms
// added in step order; the steps after the end add exact zeros.
template <typename T>
__device__ T seg_walk(const Mat<T>& m, T x1, T y1, T x2, T y2, int in_cross) {
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
  for (int k = 0; k < in_cross; ++k) {
    if (fin_x && fin_y) break;
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
    T dist = m.dnx * m_sqrt(gx * gx + gy * gy);
    T term = dist / cell_velocity(m, yi, xi, angle);
    acc = k == 0 ? term : acc + term;
    px = nxv;
    py = nyv;
    fin_x = fin_x || past_x;
    fin_y = fin_y || past_y;
  }
  return acc;
}

template <typename T, int SCORER>
__device__ __forceinline__ T seg_score(const Mat<T>& m, T x1, T y1, T x2, T y2, int cross) {
  if (SCORER == SIMPSON3) return seg_simpson<T, 3>(m, x1, y1, x2, y2);
  if (SCORER == SIMPSON5) return seg_simpson<T, 5>(m, x1, y1, x2, y2);
  if (SCORER == WALK) return seg_walk<T>(m, x1, y1, x2, y2, cross);
  return seg_exact<T>(m, x1, y1, x2, y2, cross);
}

// Bilinear sample of one (TZ, TX) field at fine coordinates (x, y).
template <typename T>
__device__ __forceinline__ T sample_field(const T* f, int TZ, int TX, T s, T x, T y) {
  T cx = vclamp(x / s, T(0), T(TX - 1));
  T cy = vclamp(y / s, T(0), T(TZ - 1));
  int x0 = (int)vclamp<long long>((long long)m_floor(cx), 0, TX - 2);
  int y0 = (int)vclamp<long long>((long long)m_floor(cy), 0, TZ - 2);
  T fx = cx - T(x0);
  T fy = cy - T(y0);
  const T* p = f + (size_t)y0 * TX + x0;
  T v0 = p[0], v1 = p[1], v2 = p[TX], v3 = p[TX + 1];
  return v0 * (T(1) - fy) * (T(1) - fx) + v1 * (T(1) - fy) * fx +
         v2 * fy * (T(1) - fx) + v3 * fy * fx;
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
  int R, P, max_steps, K, k_step, in_cross, rows, cols, sd, sd2;
  T off_far, off_near, stride, snap2, near2, arrive2;
};

// K2.  One warp per ray; see the note at the top.
template <typename T, int SCORER>
__global__ void __launch_bounds__(kThreads)
march_kernel(MarchArgs<T> a) {
  extern __shared__ __align__(16) unsigned char raw[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int r = blockIdx.x * (kThreads / 32) + wib;
  if (r >= a.R) return;
  const int K = a.K;
  T* TT = reinterpret_cast<T*>(raw) + (size_t)wib * 2 * K;
  T* plane = TT + K;
  const Mat<T> m = loaded(a.m);
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
  if (lane == 0) {
    bx[0] = last_x;
    by[0] = last_y;
  }
  bool done;
  {
    T ex = last_x - rec_x, ey = last_y - rec_y;
    done = ex * ex + ey * ey <= a.arrive2;
  }
  T tt_last_pt = sample_field(field, a.TZ, a.TX, s, m_rint(last_x), m_rint(last_y));

  for (int k = 0; k < a.max_steps && !done; ++k) {
    ++steps;
    T ex = last_x - rec_x, ey = last_y - rec_y;
    T near2 = ex * ex + ey * ey;
    if (near2 < a.snap2) {
      vec_x = rec_x - last_x;
      vec_y = rec_y - last_y;
    }
    T off = near2 < a.near2 ? a.off_near : a.off_far;

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

    // candidates: field sample plus scored segment, lanes strided over K
    for (int kk = lane; kk < K; kk += 32) {
      T tt = T(kBIG);
      if (kk < n_k) {
        T w = vmin(lo + a.stride * T(kk), hi);
        T px = pick4(dir, c0, w, w, w);
        T py = pick4(dir, w, c1 - w, c2, w + c3);
        T tp = sample_field(field, a.TZ, a.TX, s, px, py);
        plane[kk] = tp;
        tt = tp + seg_score<T, SCORER>(m, last_x, last_y, px, py, a.in_cross);
      }
      TT[kk] = tt;
    }
    __syncwarp();

    // end points, then interior minima with quadratic refinement
    int last_col = n_k - 1;
    T tt_first = TT[0], tt_last = TT[last_col];
    bool first_wins = tt_first < tt_last;
    T best_val = first_wins ? tt_first : tt_last;
    T best_pos = first_wins ? T(0) : T(last_col);
    T bv = T(kBIG);
    int bj = 0x7fffffff;
    for (int j = lane; j < K - 2; j += 32) {
      T val, pos;
      if (interior(TT, j, n_k, val, pos) && val < bv) {
        bv = val;
        bj = j;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      T ov = __shfl_xor_sync(kFull, bv, o);
      int oj = __shfl_xor_sync(kFull, bj, o);
      if (ov < bv || (ov == bv && oj < bj)) {
        bv = ov;
        bj = oj;
      }
    }
    if (bv < best_val) {
      T val, pos;
      interior(TT, bj, n_k, val, pos);
      best_pos = pos;
    }

    T wq = lo + vmin(best_pos * a.stride, hi - lo);
    T new_x = pick4(dir, c0, wq, wq, wq);
    T new_y = pick4(dir, wq, c1 - wq, c2, wq + c3);
    bool plane_oob = (dir == 0 && oob0) || (dir == 2 && oob2);
    T tt_new_pt;
    if (a.k_step == 1) {
      tt_new_pt = sample_field(field, a.TZ, a.TX, s, m_rint(new_x), m_rint(new_y));
    } else {
      int col_b = (int)vclamp<long long>((long long)m_rint(best_pos), 0, K - 1);
      tt_new_pt = plane[col_b];
    }
    bool increasing = tt_last_pt < tt_new_pt;
    if (plane_oob) reason = 1;
    else if (increasing) reason = 2;
    bool stop = plane_oob || increasing;
    if (!stop) {
      if (lane == 0) {
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
    __syncwarp();  // the next step overwrites TT and plane
  }

  if (lane == 0) {
    bx[len] = rec_x;  // append the receiver
    by[len] = rec_y;
    a.length[r] = len + 1;
    a.reason[r] = reason;
    a.steps[r] = steps;
  }
}

// K3a.  One thread per (ray, vertex).
template <typename T, int SCORER>
__global__ void __launch_bounds__(kThreads)
relax_wave_kernel(Mat<T> m_in, const T* xs, const T* ys, const long long* lengths,
                  T* ox, T* oy, int R, int P, int parity, T h, int max_cross) {
  size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (size_t)R * P) return;
  const Mat<T> m = loaded(m_in);
  int r = (int)(idx / P), v = (int)(idx % P);
  T cx = xs[idx], cy = ys[idx];
  bool move = v >= 1 && v <= P - 2 && (v % 2) == parity && v < lengths[r] - 1;
  if (!move) {
    ox[idx] = cx;
    oy[idx] = cy;
    return;
  }
  T px = xs[idx - 1], py = ys[idx - 1];
  T nx = xs[idx + 1], ny = ys[idx + 1];
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
    c[i] = seg_score<T, SCORER>(m, px, py, qx, qy, max_cross) +
           seg_score<T, SCORER>(m, qx, qy, nx, ny, max_cross);
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
  ox[idx] = cx + ux * off;
  oy[idx] = cy + uy * off;
}

// K3b.  One block per ray; the segments' times are added per thread in
// segment order, then across the block in a fixed tree.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ray_times_kernel(Mat<T> m_in, const T* xs, const T* ys, const long long* lengths,
                 T* out, int R, int P, int max_cross) {
  __shared__ T part[kThreads / 32];
  const Mat<T> m = loaded(m_in);
  int r = blockIdx.x;
  const T* x = xs + (size_t)r * P;
  const T* y = ys + (size_t)r * P;
  long long n = lengths[r];
  T acc = T(0);
  for (int i = threadIdx.x; i < P - 1; i += kThreads) {
    if (i + 1 < n) acc = acc + seg_exact<T>(m, x[i], y[i], x[i + 1], y[i + 1], max_cross);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc = acc + __shfl_down_sync(kFull, acc, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T total = part[0];
    for (int w = 1; w < kThreads / 32; ++w) total = total + part[w];
    out[r] = total;
  }
}

// The four integrators on n segments, one thread each.
template <typename T>
__global__ void __launch_bounds__(kThreads)
segments_kernel(Mat<T> m_in, int kind, const T* x1, const T* y1, const T* x2,
                const T* y2, T* out, long long n, int cross) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Mat<T> m = loaded(m_in);
  T v;
  if (kind == SIMPSON3) v = seg_simpson<T, 3>(m, x1[i], y1[i], x2[i], y2[i]);
  else if (kind == SIMPSON5) v = seg_simpson<T, 5>(m, x1[i], y1[i], x2[i], y2[i]);
  else if (kind == WALK) v = seg_walk<T>(m, x1[i], y1[i], x2[i], y2[i], cross);
  else v = seg_exact<T>(m, x1[i], y1[i], x2[i], y2[i], cross);
  out[i] = v;
}

template <typename T>
Mat<T> make_mat(const void* flat, const void* curves, int M, int Z, int X,
                const void* dnx, int s) {
  Mat<T> m;
  m.flat = static_cast<const T*>(flat);
  m.curves = static_cast<const T*>(curves);
  m.dnx_ptr = static_cast<const T*>(dnx);
  m.M = M;
  m.Z = Z;
  m.X = X;
  m.dnx = T(0);
  m.s = T(s);
  return m;
}

template <typename T>
int launch_march(const void* flat, const void* curves, int M, int Z, int X,
                 const void* dnx, int s, const void* fields, long long field_stride,
                 int TZ, int TX, const void* ttf_index, const void* src,
                 const void* rec, void* bx, void* by, void* length,
                 void* reason, void* steps, int R, int P, int max_steps, int K,
                 int k_step, int in_cross, int plane_dist, double off_far,
                 double off_near, double stride, double snap2, double near2,
                 double arrive2, int scorer, void* stream) {
  MarchArgs<T> a;
  a.m = make_mat<T>(flat, curves, M, Z, X, dnx, s);
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
  a.R = R;
  a.P = P;
  a.max_steps = max_steps;
  a.K = K;
  a.k_step = k_step;
  a.in_cross = in_cross;
  a.rows = (Z - 1) * s + 1;
  a.cols = (X - 1) * s + 1;
  a.sd = plane_dist * s + 1;
  a.sd2 = (plane_dist - 1) * s + 1;
  a.off_far = T(off_far);
  a.off_near = T(off_near);
  a.stride = T(stride);
  a.snap2 = T(snap2);
  a.near2 = T(near2);
  a.arrive2 = T(arrive2);
  const int warps = kThreads / 32;
  dim3 grid((R + warps - 1) / warps), block(kThreads);
  size_t smem = (size_t)warps * 2 * K * sizeof(T);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scorer == SIMPSON3) march_kernel<T, SIMPSON3><<<grid, block, smem, st>>>(a);
  else if (scorer == SIMPSON5) march_kernel<T, SIMPSON5><<<grid, block, smem, st>>>(a);
  else if (scorer == WALK) march_kernel<T, WALK><<<grid, block, smem, st>>>(a);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_relax_wave(const void* flat, const void* curves, int M, int Z, int X,
                      const void* dnx, int s, const void* xs, const void* ys,
                      const void* lengths, void* ox, void* oy, int R, int P,
                      int parity, double h, int max_cross, int scorer,
                      void* stream) {
  Mat<T> m = make_mat<T>(flat, curves, M, Z, X, dnx, s);
  size_t n = (size_t)R * P;
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads)), block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(xs);
  const T* y = static_cast<const T*>(ys);
  const long long* len = static_cast<const long long*>(lengths);
  T* px = static_cast<T*>(ox);
  T* py = static_cast<T*>(oy);
  if (scorer == SIMPSON3)
    relax_wave_kernel<T, SIMPSON3><<<grid, block, 0, st>>>(m, x, y, len, px, py, R, P, parity, T(h), max_cross);
  else if (scorer == SIMPSON5)
    relax_wave_kernel<T, SIMPSON5><<<grid, block, 0, st>>>(m, x, y, len, px, py, R, P, parity, T(h), max_cross);
  else if (scorer == EXACT)
    relax_wave_kernel<T, EXACT><<<grid, block, 0, st>>>(m, x, y, len, px, py, R, P, parity, T(h), max_cross);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ray_times(const void* flat, const void* curves, int M, int Z, int X,
                     const void* dnx, int s, const void* xs, const void* ys,
                     const void* lengths, void* out, int R, int P,
                     int max_cross, void* stream) {
  Mat<T> m = make_mat<T>(flat, curves, M, Z, X, dnx, s);
  ray_times_kernel<T><<<dim3(R), dim3(kThreads), 0, static_cast<cudaStream_t>(stream)>>>(
      m, static_cast<const T*>(xs), static_cast<const T*>(ys),
      static_cast<const long long*>(lengths), static_cast<T*>(out), R, P, max_cross);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_segments(const void* flat, const void* curves, int M, int Z, int X,
                    const void* dnx, int s, int kind, const void* x1, const void* y1,
                    const void* x2, const void* y2, void* out, long long n,
                    int cross, void* stream) {
  Mat<T> m = make_mat<T>(flat, curves, M, Z, X, dnx, s);
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads)), block(kThreads);
  segments_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      m, kind, static_cast<const T*>(x1), static_cast<const T*>(y1),
      static_cast<const T*>(x2), static_cast<const T*>(y2), static_cast<T*>(out), n, cross);
  return (int)cudaGetLastError();
}

}  // namespace

#define ALIFMM_MARCH_PARAMS                                                     \
  const void *flat, const void *curves, int M, int Z, int X, const void* dnx, int s, \
      const void *fields, long long field_stride, int TZ, int TX,               \
      const void *ttf_index, const void *src, const void *rec, void *bx,        \
      void *by, void *length, void *reason, void *steps, int R, int P,          \
      int max_steps, int K, int k_step, int in_cross, int plane_dist,           \
      double off_far, double off_near, double stride, double snap2,             \
      double near2, double arrive2, int scorer, void *stream
#define ALIFMM_MARCH_ARGS                                                      \
  flat, curves, M, Z, X, dnx, s, fields, field_stride, TZ, TX, ttf_index, src, \
      rec, bx, by, length, reason, steps, R, P, max_steps, K, k_step,          \
      in_cross, plane_dist, off_far, off_near, stride, snap2, near2, arrive2,  \
      scorer, stream

#define ALIFMM_RELAX_PARAMS                                                     \
  const void *flat, const void *curves, int M, int Z, int X, const void* dnx, int s, \
      const void *xs, const void *ys, const void *lengths, void *ox, void *oy,  \
      int R, int P, int parity, double h, int max_cross, int scorer,            \
      void *stream
#define ALIFMM_RELAX_ARGS                                                    \
  flat, curves, M, Z, X, dnx, s, xs, ys, lengths, ox, oy, R, P, parity, h,   \
      max_cross, scorer, stream

#define ALIFMM_TIMES_PARAMS                                                     \
  const void *flat, const void *curves, int M, int Z, int X, const void* dnx, int s, \
      const void *xs, const void *ys, const void *lengths, void *out, int R,    \
      int P, int max_cross, void *stream
#define ALIFMM_TIMES_ARGS \
  flat, curves, M, Z, X, dnx, s, xs, ys, lengths, out, R, P, max_cross, stream

#define ALIFMM_SEG_PARAMS                                                       \
  const void *flat, const void *curves, int M, int Z, int X, const void* dnx, int s, \
      int kind, const void *x1, const void *y1, const void *x2, const void *y2, \
      void *out, long long n, int cross, void *stream
#define ALIFMM_SEG_ARGS \
  flat, curves, M, Z, X, dnx, s, kind, x1, y1, x2, y2, out, n, cross, stream

// Plain C interface (ops/cuda_rays.py binds it with ctypes).  Every
// function launches on `stream` and returns cudaGetLastError().
extern "C" {
int alifmm_march_f32(ALIFMM_MARCH_PARAMS) { return launch_march<float>(ALIFMM_MARCH_ARGS); }
int alifmm_march_f64(ALIFMM_MARCH_PARAMS) { return launch_march<double>(ALIFMM_MARCH_ARGS); }
int alifmm_relax_wave_f32(ALIFMM_RELAX_PARAMS) { return launch_relax_wave<float>(ALIFMM_RELAX_ARGS); }
int alifmm_relax_wave_f64(ALIFMM_RELAX_PARAMS) { return launch_relax_wave<double>(ALIFMM_RELAX_ARGS); }
int alifmm_ray_times_f32(ALIFMM_TIMES_PARAMS) { return launch_ray_times<float>(ALIFMM_TIMES_ARGS); }
int alifmm_ray_times_f64(ALIFMM_TIMES_PARAMS) { return launch_ray_times<double>(ALIFMM_TIMES_ARGS); }
int alifmm_segments_f32(ALIFMM_SEG_PARAMS) { return launch_segments<float>(ALIFMM_SEG_ARGS); }
int alifmm_segments_f64(ALIFMM_SEG_PARAMS) { return launch_segments<double>(ALIFMM_SEG_ARGS); }
}
