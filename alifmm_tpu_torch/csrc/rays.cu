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

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr double kBIG = 1.0e30;
constexpr double kRad2Deg = 57.29577951308232;  // 180 / pi
constexpr double kSqrt2 = 1.4142135623730951;
constexpr int kThreads = 128;
// dynamic shared memory a block may use on sm_90 after the opt-in
constexpr size_t kMaxSmem = 232448;
// crossings of the walk whose row loads go out together
constexpr int kWalkChunk = 8;
// rows of the curve table the integrators read (angles 0..179)
constexpr int kCurveRows = 180;

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
__device__ __forceinline__ float m_copysign(float x, float y) { return copysignf(x, y); }
__device__ __forceinline__ double m_copysign(double x, double y) { return copysign(x, y); }

template <typename T> __device__ __forceinline__ T vmin(T a, T b) { return b < a ? b : a; }
template <typename T> __device__ __forceinline__ T vmax(T a, T b) { return b > a ? b : a; }
template <typename T> __device__ __forceinline__ T vclamp(T x, T lo, T hi) {
  return vmin(vmax(x, lo), hi);
}

// Floor-mod by 180 (torch.remainder: fmod, then a negative remainder
// shifted into [0, 180)).  For |x| < 360, fmod(x, 180) is x, or x -+ 180
// with the sign of x on a zero; |x| - 180 is exact there (Sterbenz), so
// this gives fmod's bits without its loop.  rays.mod180 is its twin.
template <typename T>
__device__ __forceinline__ T mod180(T x) {
  T ax = m_abs(x);
  T r;
  if (ax < T(360)) r = ax < T(180) ? x : m_copysign(ax - T(180), x);
  else r = m_fmod(x, T(180));
  return r < T(0) ? r + T(180) : r;
}

// round-half-even to a cell index, clamped to [0, n - 1]
template <typename T>
__device__ __forceinline__ int cell_of(T v, int n) {
  long long i = (long long)m_rint(v);
  return (int)vclamp<long long>(i, 0, n - 1);
}

// The model as the integrators read it: per-cell rows (veln, vel_map,
// curve index, pad), the unified group-velocity curves (A, M) in device
// or shared memory, the grid.
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

// Copy the curve table's rows 0..179 into shared memory and read it there
// from now on.  Every thread of the block must call it (it ends in a
// block barrier).
template <typename T>
__device__ __forceinline__ void stage_curves(Mat<T>& m, T* buf, bool use) {
  if (use) {
    for (int i = threadIdx.x; i < kCurveRows * m.M; i += blockDim.x) buf[i] = m.curves[i];
    m.curves = buf;
  }
  __syncthreads();
}

template <typename T>
struct Row {
  T veln, scale;
  int col;
};

__device__ __forceinline__ Row<float> load_row(const Mat<float>& m, int cell) {
  float4 v = __ldg(reinterpret_cast<const float4*>(m.flat) + cell);
  return Row<float>{v.x, v.y, (int)v.z};
}

__device__ __forceinline__ Row<double> load_row(const Mat<double>& m, int cell) {
  const double2* p = reinterpret_cast<const double2*>(m.flat) + 2 * (size_t)cell;
  double2 u = __ldg(p), w = __ldg(p + 1);
  return Row<double>{u.x, u.y, (int)w.x};
}

// interp_table_gather on the unified curves for one gathered row
template <typename T>
__device__ __forceinline__ T row_velocity(const Mat<T>& m, const Row<T>& row, T angle) {
  T eff = mod180(mod180(row.veln - angle));
  int a1 = (int)vclamp<long long>((long long)m_floor(eff), 0, 179);
  int a2 = a1 == 179 ? 0 : a1 + 1;
  T w = eff - T(a1);
  T v1 = m.curves[a1 * m.M + row.col];
  T v2 = m.curves[a2 * m.M + row.col];
  return row.scale * ((T(1) - w) * v1 + w * v2);
}

// Group velocity of cell (yi, xi) for a segment at `angle`.
template <typename T>
__device__ __forceinline__ T cell_velocity(const Mat<T>& m, int yi, int xi, T angle) {
  return row_velocity(m, load_row(m, yi * m.X + xi), angle);
}

// atan with a guarded divisor, in degrees
template <typename T>
__device__ __forceinline__ T angle_deg(T dx, T dy) {
  if (dx == T(0)) return T(0);
  return m_atan(dy / dx) * T(kRad2Deg);
}

template <int N> __device__ __forceinline__ double simpson_weight(int i) {
  if (N == 3) return i == 1 ? 4.0 / 6.0 : 1.0 / 6.0;
  return (i == 0 || i == 4) ? 1.0 / 12.0 : (i == 2 ? 2.0 / 12.0 : 4.0 / 12.0);
}

// Sample i of _simpson_time with N samples: weight x slowness at the
// fraction i / (N - 1) of the segment from (x1, y1) by (ddx, ddy).
template <typename T, int N>
__device__ __forceinline__ T simpson_term(const Mat<T>& m, T x1, T y1, T ddx, T ddy,
                                          T angle, int i) {
  T fr = T(i) * T(1.0 / (N - 1));  // 0, 1/2, 1 or 0, 1/4, ..., 1: exact
  T xm = x1 + ddx * fr;
  T ym = y1 + ddy * fr;
  int xi = cell_of(xm / m.s, m.X);
  int yi = cell_of(ym / m.s, m.Z);
  return T(simpson_weight<N>(i)) * (T(1) / cell_velocity(m, yi, xi, angle));
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
    T term = simpson_term<T, N>(m, x1, y1, ddx, ddy, angle, i);
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
// added in step order; the steps after the end add exact zeros.  In
// rounds of kWalkChunk steps: the crossings first, then their row loads
// all at once, then the terms.
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
  for (int k0 = 0; k0 < in_cross && !(fin_x && fin_y); k0 += kWalkChunk) {
    int cell[kWalkChunk];
    T dist[kWalkChunk];
    bool live[kWalkChunk];
#pragma unroll
    for (int q = 0; q < kWalkChunk; ++q) {
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
    Row<T> row[kWalkChunk];
#pragma unroll
    for (int q = 0; q < kWalkChunk; ++q)
      if (live[q]) row[q] = load_row(m, cell[q]);
#pragma unroll
    for (int q = 0; q < kWalkChunk; ++q) {
      if (!live[q]) continue;
      T term = dist[q] / row_velocity(m, row[q], angle);
      acc = k0 + q == 0 ? term : acc + term;
    }
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

// Bilinear sample of one (TZ, TX) field at fine coordinates (x, y), in
// two halves: field_tap issues the four loads, tap_value uses them, so
// that other work can go between the two.
template <typename T>
struct Tap {
  T v0, v1, v2, v3, fx, fy;
};

template <typename T>
__device__ __forceinline__ Tap<T> field_tap(const T* f, int TZ, int TX, T s, T x, T y) {
  T cx = vclamp(x / s, T(0), T(TX - 1));
  T cy = vclamp(y / s, T(0), T(TZ - 1));
  int x0 = (int)vclamp<long long>((long long)m_floor(cx), 0, TX - 2);
  int y0 = (int)vclamp<long long>((long long)m_floor(cy), 0, TZ - 2);
  const T* p = f + (size_t)y0 * TX + x0;
  return Tap<T>{p[0], p[1], p[TX], p[TX + 1], cx - T(x0), cy - T(y0)};
}

template <typename T>
__device__ __forceinline__ T tap_value(const Tap<T>& t) {
  return t.v0 * (T(1) - t.fy) * (T(1) - t.fx) + t.v1 * (T(1) - t.fy) * t.fx +
         t.v2 * t.fy * (T(1) - t.fx) + t.v3 * t.fy * t.fx;
}

template <typename T>
__device__ __forceinline__ T sample_field(const T* f, int TZ, int TX, T s, T x, T y) {
  return tap_value(field_tap(f, TZ, TX, s, x, y));
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

// K2.  32 or 64 lanes per ray; see the note at the top.  With PROF each
// ray's lane 0 adds up clock64 cycles by part of the step.
template <typename T, int SCORER, bool PROF>
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
  T tt_last_pt = sample_field(field, a.TZ, a.TX, s, m_rint(last_x), m_rint(last_y));
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
          Tap<T> tap = field_tap(field, a.TZ, a.TX, s, px, py);  // in flight
          T walk = seg_walk<T>(m, last_x, last_y, px, py, a.in_cross);
          T tp = tap_value(tap);
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
          terms[it] = simpson_term<T, N>(m, last_x, last_y, ddx, ddy, angle, it - kk * N);
        } else {
          Tap<T> tap = field_tap(field, a.TZ, a.TX, s, px, py);
          segd[kk] = m.dnx * (m_sqrt(ddx * ddx + ddy * ddy) / s);
          plane[kk] = tap_value(tap);
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
template <typename T, int SCORER>
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
  x[v] = cx + ux * off;
  y[v] = cy + uy * off;
}

// K3.  One block per ray: the waves in place, then the ray's time.
template <typename T, int SCORER>
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
        relax_vertex<T, SCORER>(m, wx, wy, (int)v, a.h, a.relax_cross);
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
    if (i + 1 < n) acc = acc + seg_exact<T>(m, x[i], y[i], x[i + 1], y[i + 1], a.times_cross);
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

template <typename T, bool PROF>
void (*march_fn(int scorer))(MarchArgs<T>) {
  if (scorer == SIMPSON3) return march_kernel<T, SIMPSON3, PROF>;
  if (scorer == SIMPSON5) return march_kernel<T, SIMPSON5, PROF>;
  if (scorer == WALK) return march_kernel<T, WALK, PROF>;
  return nullptr;
}

template <typename T>
void (*relax_times_fn(int scorer))(RelaxArgs<T>) {
  if (scorer == SIMPSON3) return relax_times_kernel<T, SIMPSON3>;
  if (scorer == SIMPSON5) return relax_times_kernel<T, SIMPSON5>;
  if (scorer == EXACT) return relax_times_kernel<T, EXACT>;
  return nullptr;
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
                 const void* dnx, int s, const void* fields, long long field_stride,
                 int TZ, int TX, const void* ttf_index, const void* src,
                 const void* rec, void* bx, void* by, void* length,
                 void* reason, void* steps, int R, int P, int max_steps, int K,
                 int k_step, int in_cross, int plane_dist, double off_far,
                 double off_near, double stride, double snap2, double near2,
                 double arrive2, int scorer, int lanes, int curves_smem, void* prof,
                 void* stream) {
  if (lanes != 32 && lanes != 64) return (int)cudaErrorInvalidValue;
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
  a.prof = static_cast<long long*>(prof);
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
  a.lanes = lanes;
  a.curves_smem = curves_smem;
  a.off_far = T(off_far);
  a.off_near = T(off_near);
  a.stride = T(stride);
  a.snap2 = T(snap2);
  a.near2 = T(near2);
  a.arrive2 = T(arrive2);
  const int per_block = kThreads / lanes;
  unsigned blocks = (unsigned)((R + per_block - 1) / per_block);
  size_t smem = march_smem(scorer, K, lanes, curves_smem, M, sizeof(T));
  void (*kernel)(MarchArgs<T>) = march_fn<T, false>(scorer);
  if constexpr (std::is_same<T, float>::value) {
    if (prof != nullptr) kernel = march_fn<T, true>(scorer);
  } else {
    if (prof != nullptr) kernel = nullptr;  // PROF is built for float only
  }
  return launch(kernel, blocks, smem, stream, a);
}

template <typename T>
int launch_relax_times(const void* flat, const void* curves, int M, int Z, int X,
                       const void* dnx, int s, const void* xs, const void* ys,
                       const void* lengths, void* ox, void* oy, void* times, int R,
                       int P, int n_waves, int parity0, double h, int relax_cross,
                       int relax_scorer, int times_cross, int curves_smem,
                       int poly_smem, void* stream) {
  RelaxArgs<T> a;
  a.m = make_mat<T>(flat, curves, M, Z, X, dnx, s);
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
  return launch(relax_times_fn<T>(relax_scorer), (unsigned)R, smem, stream, a);
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

// Blocks of a kernel resident per SM at this shared memory: which = 0 the
// march (with PROF if prof), 1 K3.
template <typename T>
int occupancy(int which, int scorer, int prof, size_t smem) {
  int blocks = -1;
  cudaError_t e;
  if (which == 0) {
    void (*k)(MarchArgs<T>) = march_fn<T, false>(scorer);
    if constexpr (std::is_same<T, float>::value) {
      if (prof) k = march_fn<T, true>(scorer);
    }
    if (k == nullptr) return -1;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, smem);
  } else {
    void (*k)(RelaxArgs<T>) = relax_times_fn<T>(scorer);
    if (k == nullptr) return -1;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, smem);
  }
  return e == cudaSuccess ? blocks : -1;
}

}  // namespace

#define ALIFMM_MAT_PARAMS \
  const void *flat, const void *curves, int M, int Z, int X, const void *dnx, int s
#define ALIFMM_MAT_ARGS flat, curves, M, Z, X, dnx, s

#define ALIFMM_MARCH_PARAMS                                                     \
  ALIFMM_MAT_PARAMS, const void *fields, long long field_stride, int TZ, int TX, \
      const void *ttf_index, const void *src, const void *rec, void *bx,        \
      void *by, void *length, void *reason, void *steps, int R, int P,          \
      int max_steps, int K, int k_step, int in_cross, int plane_dist,           \
      double off_far, double off_near, double stride, double snap2,             \
      double near2, double arrive2, int scorer, int lanes, int curves_smem,     \
      void *prof, void *stream
#define ALIFMM_MARCH_ARGS                                                        \
  ALIFMM_MAT_ARGS, fields, field_stride, TZ, TX, ttf_index, src, rec, bx, by,    \
      length, reason, steps, R, P, max_steps, K, k_step, in_cross, plane_dist,   \
      off_far, off_near, stride, snap2, near2, arrive2, scorer, lanes,           \
      curves_smem, prof, stream

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
int alifmm_occupancy_f32(int which, int scorer, int prof, long long smem) {
  return occupancy<float>(which, scorer, prof, (size_t)smem);
}
int alifmm_occupancy_f64(int which, int scorer, int prof, long long smem) {
  return occupancy<double>(which, scorer, 0, (size_t)smem);
}
}
