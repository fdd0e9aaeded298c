// K1's per-point device functions: the stencil tables, the candidates of
// one point (G lanes a point) and the finish of its update.  Shared by
// K1 and K5 (sweep.cu) and by K1's other forms (sweep_forms.cu), so
// that every form takes the same operations as the plain twin
// (alifmm_tpu_torch/ops/stencils.py::local_update); see sweep.cu for
// the design.

#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr double kINF = 1.0e9;
constexpr double kBIG = 1.0e30;
constexpr double kPi = 3.141592653589793;
constexpr double kSqrt2 = 1.4142135623730951;
constexpr double kSqrt5 = 2.23606797749979;

// Material planes per cell, in this order (see ops/cuda_sweep.py).
enum Plane { P_VELN, P_VELPN, P_VELMAP, P_C22, P_C23, P_C33, P_C44, P_RHO,
             P_FB0, P_FB1, P_FB2, P_FB3, N_PLANES };

// Stencil offsets, (dz, dx) pairs, in the plain twin's order.  Copied to
// shared memory at the start, so that lanes reading different stencils
// hit different banks instead of serialising on the constant cache.
// Square: apex A, then the pair P, Q.
__constant__ int kSquare[8][6] = {
    {-2, 0, -1, -1, -1, 1}, {0, 2, -1, 1, 1, 1}, {2, 0, 1, -1, 1, 1},
    {0, -2, -1, -1, 1, -1}, {-1, -1, 0, -1, -1, 0}, {-1, 1, -1, 0, 0, 1},
    {1, 1, 1, 0, 0, 1}, {1, -1, 0, -1, 1, 0}};
// Triangular: far F, middle M, diagonal D; edge 0 left 1 right 2 top 3 bottom.
__constant__ int kTri[8][6] = {
    {2, 0, 1, 0, 1, 1}, {-2, 0, -1, 0, -1, 1}, {-2, 0, -1, 0, -1, -1},
    {2, 0, 1, 0, 1, -1}, {0, -2, 0, -1, 1, -1}, {0, 2, 0, 1, 1, 1},
    {0, 2, 0, 1, -1, 1}, {0, -2, 0, -1, -1, -1}};
__constant__ int kTriEdge[8] = {0, 0, 1, 1, 2, 2, 3, 3};
// FD quadrants J, K: 0-3 the axis family, 4-7 the diagonal family.
__constant__ int kQuad[8][4] = {
    {0, -1, -1, 0}, {0, -1, 1, 0}, {0, 1, -1, 0}, {0, 1, 1, 0},
    {1, -1, -1, -1}, {1, -1, 1, 1}, {-1, 1, -1, -1}, {-1, 1, 1, 1}};
// Knight pairs p, q: 0-3 family A, 4-7 family B.
__constant__ int kKnight[8][4] = {
    {-2, -1, -1, 2}, {-1, 2, 2, 1}, {2, 1, 1, -2}, {1, -2, -2, -1},
    {-2, 1, 1, 2}, {1, 2, 2, -1}, {2, -1, -1, -2}, {-1, -2, -2, 1}};
constexpr int kTabInts = 8 * 6 + 8 * 6 + 8 + 8 * 4 + 8 * 4;

__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_atan(float x) { return atanf(x); }
__device__ __forceinline__ double m_atan(double x) { return atan(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_sin(float x) { return sinf(x); }
__device__ __forceinline__ double m_sin(double x) { return sin(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }
__device__ __forceinline__ float m_floor(float x) { return floorf(x); }
__device__ __forceinline__ double m_floor(double x) { return floor(x); }
__device__ __forceinline__ float m_fmod(float x, float y) { return fmodf(x, y); }
__device__ __forceinline__ double m_fmod(double x, double y) { return fmod(x, y); }

template <typename T> __device__ __forceinline__ T vmin(T a, T b) { return b < a ? b : a; }
template <typename T> __device__ __forceinline__ T vmax(T a, T b) { return b > a ? b : a; }

// Floor-mod by 180 (jnp.mod / torch.remainder): fmod, then shift a
// negative remainder into [0, 180).
template <typename T>
__device__ __forceinline__ T mod180(T x) {
  T r = m_fmod(x, T(180));
  if (r != T(0) && r < T(0)) r = r + T(180);
  return r;
}

// The 5x5 neighbourhood of one point, read from the band in shared memory
// (5 rows of bw values, row 2 the current line, INF outside the grid).
// Offsets are (dz, dx) in grid terms; in an x-sweep the band's rows run
// along x and its columns along z.
template <typename T>
struct Nb {
  const T* band;
  int bw, c;
  bool xs;
  int z, x, Z, X;
  T tc;
  __device__ __forceinline__ T t(int dz, int dx) const {
    int db = xs ? dx : dz, dw = xs ? dz : dx;
    return band[(2 + db) * bw + c + dw];
  }
  // usable: known and strictly earlier than the centre
  __device__ __forceinline__ bool kn(int dz, int dx) const {
    T v = t(dz, dx);
    return (v < T(kINF * 0.5)) && (v < tc);
  }
  __device__ __forceinline__ bool ok(int dz, int dx) const {
    int zz = z + dz, xx = x + dx;
    return zz >= 0 && zz < Z && xx >= 0 && xx < X;
  }
};

// Wavefront geometry with the target at the origin, arctan deferred.
template <typename T>
__device__ __forceinline__ void wavefront(T xA, T zA, T xB, T zB, T xC, T zC,
                                          T yA, T yB, T yC, T& dx, T& dz,
                                          bool& zero, T& dist) {
  T denom = yC - yA;
  bool degen = denom == T(0);
  T denom_safe = degen ? T(1) : denom;
  T a = (yB - yA) / denom_safe;
  T xpos = (T(1) - a) * xA + a * xC;
  T zpos = (T(1) - a) * zA + a * zC;
  dx = xB - xpos;
  dz = zB - zpos;
  zero = degen || (dx == T(0));
  T norm = m_sqrt(dx * dx + dz * dz);
  T norm_safe = norm == T(0) ? T(1) : norm;
  dist = m_abs(dz * xB - dx * zB) / norm_safe;
  if (degen || norm == T(0)) dist = T(-1);
}

template <typename T>
struct Sel {
  T diff, dx, dz, dist, wt, mx, oang;
  bool zero, ovr;
};

// A stencil whose points are not all usable: its diff is kBIG, so it is
// selected only when no stencil of its family is usable, and then the
// update takes the FD fallback without reading its geometry.  Skipping
// the geometry changes no result.
template <typename T>
__device__ __forceinline__ Sel<T> unusable(Sel<T> s) {
  s.dx = s.dz = s.dist = s.wt = s.mx = s.oang = T(0);
  s.zero = true;
  s.ovr = false;
  return s;
}

template <typename T>
__device__ __forceinline__ Sel<T> square_stencil(const Nb<T>& n, const int* o) {
  const int Az = o[0], Ax = o[1], Pz = o[2], Px = o[3], Qz = o[4], Qx = o[5];
  Sel<T> s;
  T tA = n.t(Az, Ax), tP = n.t(Pz, Px), tQ = n.t(Qz, Qx);
  bool valid = n.kn(Az, Ax) && n.kn(Pz, Px) && n.kn(Qz, Qx);
  s.diff = valid ? m_abs(tP - tQ) : T(kBIG);
  if (!valid) return unusable(s);
  bool swap = tP < tQ;  // B = the smaller of P, Q; ties -> Q
  T xB = swap ? T(Px) : T(Qx);
  T zB = swap ? T(Pz) : T(Qz);
  T xC = swap ? T(Qx) : T(Px);
  T zC = swap ? T(Qz) : T(Pz);
  T yB = swap ? tP : tQ;
  T yC = swap ? tQ : tP;
  wavefront(T(Ax), T(Az), xB, zB, xC, zC, tA, yB, yC, s.dx, s.dz, s.zero,
            s.dist);
  s.wt = yB;
  s.mx = vmax(tA, vmax(tP, tQ));
  s.oang = T(0);
  s.ovr = false;
  return s;
}

template <typename T>
__device__ __forceinline__ Sel<T> tri_stencil(const Nb<T>& n, const int* o,
                                              bool edge, T eang, bool wt_d) {
  const int Fz = o[0], Fx = o[1], Mz = o[2], Mx = o[3], Dz = o[4], Dx = o[5];
  const T c1 = T(kSqrt2 - 1.0);
  const T c2 = T(2.0 - kSqrt2);
  Sel<T> s;
  T tF = n.t(Fz, Fx), tM = n.t(Mz, Mx), tD = n.t(Dz, Dx);
  bool valid = n.kn(Fz, Fx) && n.kn(Mz, Mx) && n.kn(Dz, Dx) && (tF < vmin(tM, tD));
  s.diff = valid ? m_abs(c1 * tF + c2 * tM - tD) : T(kBIG);
  if (!valid) return unusable(s);
  bool mb = tM < tD;
  T xB = mb ? T(Mx) : T(Dx);
  T zB = mb ? T(Mz) : T(Dz);
  T xC = mb ? T(Dx) : T(Mx);
  T zC = mb ? T(Dz) : T(Mz);
  T yB = mb ? tM : tD;
  T yC = mb ? tD : tM;
  wavefront(T(Fx), T(Fz), xB, zB, xC, zC, tF, yB, yC, s.dx, s.dz, s.zero,
            s.dist);
  s.ovr = mb && edge;
  s.oang = s.ovr ? eang : T(0);
  if (s.ovr) s.dist = T(1);
  s.wt = wt_d ? tD : yB;
  s.mx = vmax(tM, tD);
  return s;
}

// One FD quadrant of the axis (axis=true, h = dnx) or diagonal family.
template <typename T>
__device__ __forceinline__ T fd_quadrant(const Nb<T>& n, const int* o, T hs,
                                         bool axis) {
  const int Jz = o[0], Jx = o[1], Kz = o[2], Kx = o[3];
  const T ninf = T(-kINF);
  bool quad_inb = n.ok(Jz, Jx) && n.ok(Kz, Kx);
  T tJ = n.t(Jz, Jx), tJ2 = n.t(2 * Jz, 2 * Jx);
  T tK = n.t(Kz, Kx), tK2 = n.t(2 * Kz, 2 * Kx);
  bool kJ = n.kn(Jz, Jx), kJ2 = n.kn(2 * Jz, 2 * Jx);
  bool kK = n.kn(Kz, Kx), kK2 = n.kn(2 * Kz, 2 * Kx);
  bool swj = kJ2 && kJ && (tJ >= tJ2);
  bool swk = kK2 && kK && (tK >= tK2);
  T e1 = T(4) * tJ - tJ2;
  T e2 = T(4) * tK - tK2;
  T h2s = T(2) * hs;
  bool b1 = swj && swk;
  bool b2 = swj && !swk && kK;
  bool b3 = swj && !swk && !kK;
  bool b4 = !swj && kJ && swk;
  bool b5 = !swj && kJ && !swk && kK;
  bool b6 = !swj && kJ && !swk && !kK;
  bool b7 = !swj && !kJ && swk;
  bool b8 = !swj && !kJ && !swk && kK;
  bool any_b = b1 || b2 || b3 || b4 || b5 || b6 || b7 || b8;
  if (!(any_b && quad_inb)) return T(kINF);
  T a = (b1 || b2 || b4) ? T(18) : (b5 ? T(2) : T(1));
  T b;
  if (b1) b = T(-6) * (e1 + e2);
  else if (b2) b = T(-6) * (T(3) * tK + e1);
  else if (b4) b = T(-6) * (T(3) * tJ + e2);
  else if (b5) b = T(-2) * (tK + tJ);
  else b = T(0);
  T c;
  if (b1) {
    c = e1 * e1 + e2 * e2 - T(4) * (h2s * h2s);
  } else if (b2) {
    T t3 = T(3) * tK;
    c = t3 * t3 + e1 * e1 - T(4) * (h2s * h2s);
  } else if (b3) {
    c = -(h2s * h2s);
  } else if (b4) {
    T t3 = T(3) * tJ;
    c = t3 * t3 + e2 * e2 - T(12) * hs * hs;
  } else if (b5) {
    T q = axis ? hs * hs : T(4.0 / 9.0) * hs * hs;
    c = tK * tK + tJ * tJ - q;
  } else if (b6) {
    T u = tJ + hs;
    c = -(u * u);
  } else if (b7) {
    c = -(h2s * h2s);
  } else {
    T u = tK + hs;
    c = -(u * u);
  }
  T tref = b3 ? e1 : (b7 ? e2 : T(0));
  T tdiv = axis ? (b7 ? T(3) : T(1)) : ((b3 || b7) ? T(3) : T(1));
  T rd1 = b * b - T(4) * a * c;
  bool ok = axis ? true : (rd1 > T(0));
  rd1 = vmax(rd1, T(0));
  T t = (tref + (-b + m_sqrt(rd1)) / (T(2) * a)) / tdiv;
  bool uses_j = b1 || b2 || b3 || b4 || b5 || b6;
  bool uses_k = b1 || b2 || b4 || b5 || b7 || b8;
  T imax = vmax(uses_j ? tJ : ninf, uses_k ? tK : ninf);
  ok = ok && (t >= imax);
  return (any_b && ok && quad_inb) ? t : T(kINF);
}

template <typename T>
__device__ __forceinline__ T fd_knight(const Nb<T>& n, const int* o, T us) {
  const int pz = o[0], px = o[1], qz = o[2], qx = o[3];
  const T ninf = T(-kINF);
  T tp = n.t(pz, px), tq = n.t(qz, qx);
  bool pair_inb = n.ok(pz, px) && n.ok(qz, qx);
  bool kp = n.kn(pz, px) && pair_inb;
  bool kq = n.kn(qz, qx) && pair_inb;
  bool both = kp && kq;
  if (!(kp || kq)) return T(kINF);
  T a = both ? T(2) : T(1);
  T b = both ? T(-2) * (tq + tp) : T(0);
  T c = both ? tq * tq + tp * tp - T(2) * us * us : -(us * us);
  T tref = both ? T(0) : (kp ? tp : tq);
  T rd1 = vmax(b * b - T(4) * a * c, T(0));
  T t = tref + (-b + m_sqrt(rd1)) / (T(2) * a);
  bool ok = (kp || kq) && (t >= vmax(kp ? tp : ninf, kq ? tq : ninf));
  return ok ? t : T(kINF);
}

struct Tables {
  const void* tab;       // (A, M) phase table, row-major
  int M;
  const int* col_mode;   // 0: yields 1, 1: constant column, 2: interpolate
  const void* col_const;
  int has_stif;
};

template <typename T>
__device__ __forceinline__ T phase_velocity(T eff_in, const T* mat,
                                            const Tables& tb) {
  T eff = mod180(eff_in);
  T velpn = mat[P_VELPN];
  T vel_map = mat[P_VELMAP];
  int m = int(velpn);
  int mode = (m >= 0 && m < tb.M) ? tb.col_mode[m] : 0;
  T vt;
  if (mode == 2) {
    const T* tab = static_cast<const T*>(tb.tab);
    T e = mod180(eff);
    int a1 = int(m_floor(e));
    a1 = a1 < 0 ? 0 : (a1 > 179 ? 179 : a1);
    int a2 = (a1 + 1) % 180;
    T w = e - T(a1);
    vt = (T(1) - w) * tab[a1 * tb.M + m] + w * tab[a2 * tb.M + m];
  } else if (mode == 1) {
    vt = static_cast<const T*>(tb.col_const)[m];
  } else {
    vt = T(1);
  }
  T v_tab = vel_map * vt;
  if (!tb.has_stif || velpn != T(0)) return v_tab;
  const T d2r = T(kPi / 180.0);
  T ca = m_cos(eff * d2r);
  T sa = m_sin(eff * d2r);
  T c22 = mat[P_C22], c23 = mat[P_C23], c33 = mat[P_C33], c44 = mat[P_C44];
  T A = ca * ca * c22 + sa * sa * c44;
  T B = ca * sa * (c23 + c44);
  T C = ca * ca * c44 + sa * sa * c33;
  T AmC = A - C;
  T lam = T(0.5) * (A + C + m_sqrt(AmC * AmC + T(4) * B * B));
  return T(1000) * vel_map * m_sqrt(lam / mat[P_RHO]);
}

// First-wins selection across the G lanes of a group: the least diff, and
// on equal diffs the lowest stencil index (the strict '<' scan's winner).
template <typename T, int G>
__device__ __forceinline__ void argmin_first(T& d, int& i) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    T od = __shfl_xor_sync(kFull, d, off, G);
    int oi = __shfl_xor_sync(kFull, i, off, G);
    if (od < d || (od == d && oi < i)) { d = od; i = oi; }
  }
}

// The winning stencil's geometry, fetched from the lane that holds it.
template <typename T, int G>
__device__ __forceinline__ void fetch(Sel<T>& s, int src) {
  s.dx = __shfl_sync(kFull, s.dx, src, G);
  s.dz = __shfl_sync(kFull, s.dz, src, G);
  s.dist = __shfl_sync(kFull, s.dist, src, G);
  s.wt = __shfl_sync(kFull, s.wt, src, G);
  s.mx = __shfl_sync(kFull, s.mx, src, G);
  s.oang = __shfl_sync(kFull, s.oang, src, G);
  s.zero = __shfl_sync(kFull, int(s.zero), src, G) != 0;
  s.ovr = __shfl_sync(kFull, int(s.ovr), src, G) != 0;
}

// Offset tables in shared memory (see kSquare ...).
struct Tabs {
  const int* sq;    // [8][6]
  const int* tr;    // [8][6]
  const int* edge;  // [8]
  const int* quad;  // [8][4]
  const int* kni;   // [8][4]
};

// What the finish of a point needs from its candidates: the selected
// ALI stencil's geometry and times, and the FD fallback.
template <typename T>
struct Rec {
  T dx, dz, oang, dist, wt, mx, fouds;
  int flags;  // 1: wavefront direction degenerate, 2: edge override angle
};

// The operator of a pass (a template parameter of the forms): the ALI
// update with the FD fallback (K1's), the FD fallback alone (use_ali =
// false), or the ALI update with INF for the fallback (use_fd = false).
constexpr int kOpFull = 0;
constexpr int kOpFdOnly = 1;
constexpr int kOpFdFree = 2;

// Candidates of one point, shared by the G lanes of its group: each lane
// evaluates its share, the group reduces, and every lane returns the
// same record.  OP drops the families its operator does not take (only
// fouds is read with kOpFdOnly).
template <typename T, int G, int OP = kOpFull>
__device__ __forceinline__ Rec<T> candidates(const Nb<T>& n, int lane,
                                             const T* mat, const Tabs& tb_o,
                                             T dnx) {
  const bool top = n.z == 0, bottom = n.z == n.Z - 1;
  const bool left = n.x == 0, right = n.x == n.X - 1;

  // FD fallback: this lane's quadrants and knight pairs, then vmin.
  const T hs = dnx * mat[0];
  const T hd = (T(kSqrt2) * dnx) * mat[1];
  const T u = T(kSqrt5) * dnx;
  const T usA = u * mat[2];
  const T usB = u * mat[3];
  T fd = T(kBIG);
  // square / triangular: this lane's first-wins choice
  Sel<T> sq, tr;
  int sq_i = 0, tr_i = 0;
#pragma unroll
  for (int j = 0; j < 8 / G; ++j) {
    const int k = lane + j * G;
    if constexpr (OP != kOpFdFree) {
      fd = vmin(fd, fd_quadrant(n, tb_o.quad + 4 * k, k < 4 ? hs : hd, k < 4));
      fd = vmin(fd, fd_knight(n, tb_o.kni + 4 * k, k < 4 ? usA : usB));
    }
    if constexpr (OP != kOpFdOnly) {
      Sel<T> s = square_stencil(n, tb_o.sq + 6 * k);
      if (j == 0 || s.diff < sq.diff) { sq = s; sq_i = k; }
      const int e = tb_o.edge[k];
      const bool edge = e == 0 ? left : (e == 1 ? right : (e == 2 ? top : bottom));
      Sel<T> t = tri_stencil(n, tb_o.tr + 6 * k, edge, k < 4 ? T(90) : T(0),
                             k == 0);
      if (j == 0 || t.diff < tr.diff) { tr = t; tr_i = k; }
    }
  }
  if constexpr (OP != kOpFdFree) {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      fd = vmin(fd, __shfl_xor_sync(kFull, fd, off, G));
  }
  if constexpr (OP == kOpFdOnly) {
    Rec<T> r{};
    r.fouds = vmin(fd, n.tc);
    return r;
  } else {
    T sq_d = sq.diff, tr_d = tr.diff;
    argmin_first<T, G>(sq_d, sq_i);
    argmin_first<T, G>(tr_d, tr_i);
    fetch<T, G>(sq, sq_i % G);
    fetch<T, G>(tr, tr_i % G);
    const bool sq_any = sq_d < T(kBIG);
    const bool tri_any = tr_d < T(kBIG);

    bool on_boundary = left || right || top || bottom;
    bool try_tri = !sq_any || on_boundary;
    T carry = sq_any ? sq_d : T(1.0e6);
    bool use_tri = try_tri && tri_any && (tr_d < carry);
    Rec<T> r;
    r.dx = use_tri ? tr.dx : sq.dx;
    r.dz = use_tri ? tr.dz : sq.dz;
    r.flags = int(use_tri ? tr.zero : sq.zero) | (int(use_tri && tr.ovr) << 1);
    r.oang = use_tri ? tr.oang : T(0);
    r.dist = use_tri ? tr.dist : (sq_any ? sq.dist : T(-1));
    r.wt = use_tri ? tr.wt : sq.wt;
    r.mx = use_tri ? tr.mx : sq.mx;
    if constexpr (OP == kOpFdFree) r.fouds = T(kINF);
    else r.fouds = vmin(fd, n.tc);
    return r;
  }
}

// The finish of one point's update, by one thread: wavefront angle, phase
// velocity, the ALI time, else the FD fallback.
template <typename T>
__device__ __forceinline__ T finish(const Rec<T>& r, const T* mat,
                                    const Tables& tb, T dnx) {
  const bool sel_zero = (r.flags & 1) != 0;
  const bool sel_ovr = (r.flags & 2) != 0;
  T dx_safe = sel_zero ? T(1) : r.dx;
  T angle = mod180(m_atan(r.dz / dx_safe) * T(180.0 / kPi) + T(90));
  if (sel_zero) angle = T(0);
  if (sel_ovr) angle = r.oang;
  T eff = mod180(mat[P_VELN] - angle);
  T vel = phase_velocity(eff, mat, tb);
  T ali = r.wt + r.dist * dnx / vel;
  bool ali_ok = r.dist >= T(0) && ali >= r.mx;
  return ali_ok ? ali : r.fouds;
}

}  // namespace
