// Device functions shared by the ray kernels: K2 and K3 (rays.cu) and K4
// (descent.cu).  Each source includes this header into its own anonymous
// namespace, so every library keeps its own copy.
//
// The model's material rows and velocity tables as the integrators read
// them (Mat, Row, load_row), the group velocity of a row at an angle
// (row_velocity: the curve table, or the Christoffel solve), the Simpson
// segment integrator (seg_simpson), and the field taps (field_tap,
// tap_value).  Arithmetic follows the twins in alifmm_tpu_torch/rays.py
// operation for operation (build with -fmad=false): rint for
// round-half-even, truncation for float -> int, floor-mod as
// torch.remainder, true divisions, and compare-and-select for min, max
// and clamps, which keep a NaN as torch.clamp does.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr double kRad2Deg = 57.29577951308232;  // 180 / pi
// rows of the curve table the integrators read (angles 0..179)
constexpr int kCurveRows = 180;
// math.pi and math.pi / 180 of the twins, as doubles
constexpr double kPi = 3.141592653589793;
constexpr double kDeg2Rad = kPi / 180.0;


enum Scorer { SIMPSON3 = 0, SIMPSON5 = 1, WALK = 2, EXACT = 3 };
// material path: unified curve rows, or stiffness rows with the
// per-sample Christoffel solve (exact_materials)
enum MatKind { MAT_CURVES = 0, MAT_STIFFNESS = 1 };
// K2's field tap: bilinear on the model grid, or the nearest fine point
enum TapKind { TAP_BILINEAR = 0, TAP_NEAREST = 1 };

__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_atan(float x) { return atanf(x); }
__device__ __forceinline__ double m_atan(double x) { return atan(x); }
__device__ __forceinline__ float m_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double m_atan2(double y, double x) { return atan2(y, x); }
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
__device__ __forceinline__ float m_tan(float x) { return tanf(x); }
__device__ __forceinline__ double m_tan(double x) { return tan(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_sin(float x) { return sinf(x); }
__device__ __forceinline__ double m_sin(double x) { return sin(x); }
__device__ __forceinline__ float m_tiny(float) { return 1.17549435082228751e-38f; }  // FLT_MIN
__device__ __forceinline__ double m_tiny(double) { return 2.2250738585072014e-308; }  // DBL_MIN

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

// The model as the integrators read it: per-cell rows (MAT_CURVES:
// veln, vel_map, curve index, pad; MAT_STIFFNESS: veln, velpn, vel_map,
// c22, c23, c33, c44, rho), the velocity table (the unified group curves,
// or the group table) (A, M) in device or shared memory, the grid.
template <typename T>
struct Mat {
  const T* flat;
  const T* curves;
  const T* dnx_ptr;  // the grid spacing stays on the device: no host read
  int M, Z, X;
  int has_stif;  // MAT_STIFFNESS: velpn == 0 cells take the Christoffel solve
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

// One gathered row: the table column and scale, and (MAT_STIFFNESS) the
// stiffness and density; MAT_CURVES leaves those unset.
template <typename T>
struct Row {
  T veln, scale;
  int col;
  T c22, c23, c33, c44, rho;
};

template <int MK>
__device__ __forceinline__ Row<float> load_row(const Mat<float>& m, int cell) {
  Row<float> r;
  if constexpr (MK == MAT_CURVES) {
    float4 v = __ldg(reinterpret_cast<const float4*>(m.flat) + cell);
    r.veln = v.x;
    r.scale = v.y;
    r.col = (int)v.z;
  } else {
    const float4* p = reinterpret_cast<const float4*>(m.flat) + 2 * (size_t)cell;
    float4 u = __ldg(p), w = __ldg(p + 1);
    r.veln = u.x;
    r.col = (int)u.y;
    r.scale = u.z;
    r.c22 = u.w;
    r.c23 = w.x;
    r.c33 = w.y;
    r.c44 = w.z;
    r.rho = w.w;
  }
  return r;
}

template <int MK>
__device__ __forceinline__ Row<double> load_row(const Mat<double>& m, int cell) {
  Row<double> r;
  if constexpr (MK == MAT_CURVES) {
    const double2* p = reinterpret_cast<const double2*>(m.flat) + 2 * (size_t)cell;
    double2 u = __ldg(p), w = __ldg(p + 1);
    r.veln = u.x;
    r.scale = u.y;
    r.col = (int)w.x;
  } else {
    const double2* p = reinterpret_cast<const double2*>(m.flat) + 4 * (size_t)cell;
    double2 u0 = __ldg(p), u1 = __ldg(p + 1), w0 = __ldg(p + 2), w1 = __ldg(p + 3);
    r.veln = u0.x;
    r.col = (int)u0.y;
    r.scale = u1.x;
    r.c22 = u1.y;
    r.c23 = w0.x;
    r.c33 = w0.y;
    r.c44 = w1.x;
    r.rho = w1.y;
  }
  return r;
}

// torch.remainder(x, b) for b > 0: fmod, then a negative remainder
// shifted by b
template <typename T>
__device__ __forceinline__ T floor_mod(T x, T b) {
  T r = m_fmod(x, b);
  return (r != T(0) && r < T(0)) ? r + b : r;
}

// materials.group_velocity_christoffel at `angle` (already in [0, 180]
// as the twin's torch.remainder(angle_deg, 180) leaves it), operation for
// operation, computing only the branch the twin's final where selects.
template <typename T>
__device__ T christoffel_group(T angle, T c22, T c23, T c33, T c44, T rho, T vel_scale) {
  T m90 = floor_mod(angle, T(90));
  bool near_axis = (m90 < T(0.01)) || (m90 > T(90.0 - 0.01));
  if (near_axis) {
    bool near_90 = m_abs(angle - T(90)) < T(1);
    T lam_axis = near_90 ? c33 : c22;
    return T(1000) * vel_scale * m_sqrt(lam_axis / rho);
  }
  T tan_ang = m_tan(angle * T(kDeg2Rad));
  T A = c22 + c33 - T(2) * c44;
  T B = (c23 + c44) * (tan_ang - T(1) / tan_ang);
  T C = c22 - c33;
  T disc = m_sqrt(vmax(B * B + A * A - C * C, T(0)));
  T denom = C - A;
  if (denom == T(0)) denom = m_tiny(denom);
  T sign = angle < T(90) ? T(-1) : T(1);
  T phase = floor_mod(m_atan((-B + sign * disc) / denom), T(kPi));
  T lam = T(0.5) * (m_cos(T(2) * phase) * (c22 - c44) +
                    m_sin(T(2) * phase) * (c23 + c44) * tan_ang + c22 + c44);
  return T(1000) * vel_scale * m_sqrt(vmax(lam, T(0)) / rho) /
         m_cos(angle * T(kDeg2Rad) - phase);
}

// _group_velocity_cell for one gathered row: interp_table_gather on the
// table column, or (MAT_STIFFNESS, velpn == 0, a model with stiffness)
// the Christoffel solve
template <typename T, int MK>
__device__ __forceinline__ T row_velocity(const Mat<T>& m, const Row<T>& row, T angle) {
  T eff = mod180(mod180(row.veln - angle));
  if constexpr (MK == MAT_STIFFNESS) {
    if (row.col == 0 && m.has_stif)
      return christoffel_group(eff, row.c22, row.c23, row.c33, row.c44, row.rho, row.scale);
  }
  int a1 = (int)vclamp<long long>((long long)m_floor(eff), 0, 179);
  int a2 = a1 == 179 ? 0 : a1 + 1;
  T w = eff - T(a1);
  T v1 = m.curves[a1 * m.M + row.col];
  T v2 = m.curves[a2 * m.M + row.col];
  return row.scale * ((T(1) - w) * v1 + w * v2);
}

// Group velocity of cell (yi, xi) for a segment at `angle`.
template <typename T, int MK>
__device__ __forceinline__ T cell_velocity(const Mat<T>& m, int yi, int xi, T angle) {
  return row_velocity<T, MK>(m, load_row<MK>(m, yi * m.X + xi), angle);
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
template <typename T, int N, int MK>
__device__ __forceinline__ T simpson_term(const Mat<T>& m, T x1, T y1, T ddx, T ddy,
                                          T angle, int i) {
  T fr = T(i) * T(1.0 / (N - 1));  // 0, 1/2, 1 or 0, 1/4, ..., 1: exact
  T xm = x1 + ddx * fr;
  T ym = y1 + ddy * fr;
  int xi = cell_of(xm / m.s, m.X);
  int yi = cell_of(ym / m.s, m.Z);
  return T(simpson_weight<N>(i)) * (T(1) / cell_velocity<T, MK>(m, yi, xi, angle));
}

// _simpson_time with N = 3 or 5 samples, added in sample order
template <typename T, int N, int MK>
__device__ __forceinline__ T seg_simpson(const Mat<T>& m, T x1, T y1, T x2, T y2) {
  T ddx = x2 - x1;
  T ddy = y2 - y1;
  T angle = angle_deg(ddx, ddy);
  T dist = m_sqrt(ddx * ddx + ddy * ddy) / m.s;
  T acc = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T term = simpson_term<T, N, MK>(m, x1, y1, ddx, ddy, angle, i);
    acc = i == 0 ? term : acc + term;
  }
  return m.dnx * dist * acc;
}

// Sample of one (TZ, TX) field at fine coordinates (x, y), in two
// halves: field_tap issues the loads, tap_value uses them, so that other
// work can go between the two.  TAP_BILINEAR: the field lies on the model
// grid, bilinear at (x / s, y / s), four loads.  TAP_NEAREST: the field
// lies on the refined grid, the point (rint(x), rint(y)) clipped to the
// field, one load (rint rounds half to even, as torch.round does; fine
// coordinates sit on half-integers often).
template <typename T>
struct Tap {
  T v0, v1, v2, v3, fx, fy;
};

template <typename T, int TAP>
__device__ __forceinline__ Tap<T> field_tap(const T* f, int TZ, int TX, T s, T x, T y) {
  Tap<T> t;
  if constexpr (TAP == TAP_NEAREST) {
    t.v0 = f[(size_t)cell_of(y, TZ) * TX + cell_of(x, TX)];
  } else {
    T cx = vclamp(x / s, T(0), T(TX - 1));
    T cy = vclamp(y / s, T(0), T(TZ - 1));
    int x0 = (int)vclamp<long long>((long long)m_floor(cx), 0, TX - 2);
    int y0 = (int)vclamp<long long>((long long)m_floor(cy), 0, TZ - 2);
    const T* p = f + (size_t)y0 * TX + x0;
    t = Tap<T>{p[0], p[1], p[TX], p[TX + 1], cx - T(x0), cy - T(y0)};
  }
  return t;
}

template <typename T, int TAP>
__device__ __forceinline__ T tap_value(const Tap<T>& t) {
  if constexpr (TAP == TAP_NEAREST) return t.v0;
  return t.v0 * (T(1) - t.fy) * (T(1) - t.fx) + t.v1 * (T(1) - t.fy) * t.fx +
         t.v2 * t.fy * (T(1) - t.fx) + t.v3 * t.fy * t.fx;
}

template <typename T, int TAP>
__device__ __forceinline__ T sample_field(const T* f, int TZ, int TX, T s, T x, T y) {
  return tap_value<T, TAP>(field_tap<T, TAP>(f, TZ, TX, s, x, y));
}

}  // namespace
