// K1: one Gauss-Seidel pass of the eikonal line sweeps, written for Hopper.
//
// Replaces the TPU kernel alifmm_tpu/ops/pallas_sweep.py::_sweep_kernel
// (launched by _sweep_pair) and the XLA sweep it mirrors,
// alifmm_tpu/ops/sweep.py::_sweep_axis / gs_pass.  One pass is four
// directional sweeps: z-forward, z-reverse, x-forward, x-reverse.  Each
// sweep updates one grid line at a time with the causal local update of
// alifmm_tpu_torch/ops/stencils.py::local_update (the plain twin this
// kernel is tested against): ALI wavefront interpolation over 8 square and
// 8 triangular stencils, else the multi-stencil FD fallback.  Phase 1
// min-accumulates, the polish replaces, fixed points keep their value.
//
// Layout: one CTA per source, threads across the line width, a loop over
// lines inside the CTA.  A line is computed completely into shared memory
// before it is written back, so same-line neighbours are read from the
// line's old values; the lines behind hold this sweep's values and the
// lines ahead the old ones (the in-place form of the XLA band semantics).
// The field stays in global memory: the 31 final-stage fields of the weld
// (26 MB in float) sit in the 50 MB L2.
//
// What bounds it on the H100: the sequential dependency from line to line
// (two barriers per line, 4 * (Z + X) lines per pass) and the 24 band
// reads per point, not arithmetic.  One CTA per source also leaves most of
// the 132 SMs idle at 31 sources.  Shared-memory bands, width tiles and a
// persistent pass loop are the known next steps.
//
// Arithmetic follows the plain twin operation for operation (build with
// -fmad=false so no multiply-add is contracted): INF is 1e9, not IEEE
// infinity; mod is floor-mod built on fmod; the one arctan per point runs
// on the selected stencil; strict '<' keeps the first stencil on ties.
// Phase velocity is the table lookup (velpn != 0) or the closed-form
// Christoffel solve (velpn == 0), as grid.phase_velocity_at evaluates it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr double kINF = 1.0e9;
constexpr double kBIG = 1.0e30;
constexpr double kPi = 3.141592653589793;
constexpr double kSqrt2 = 1.4142135623730951;
constexpr double kSqrt5 = 2.23606797749979;

// Material planes per cell, in this order (see ops/cuda_sweep.py).
enum Plane { P_VELN, P_VELPN, P_VELMAP, P_C22, P_C23, P_C33, P_C44, P_RHO,
             P_FB0, P_FB1, P_FB2, P_FB3, N_PLANES };

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

// 5x5 neighbourhood of one point: values (INF outside the grid), the
// usable set (known and strictly earlier than the centre) and the in-grid
// flags.  Indexed with compile-time offsets after inlining.
template <typename T>
struct Nb {
  T v[5][5];
  bool k[5][5];
  bool in[5][5];
  __device__ __forceinline__ T t(int dz, int dx) const { return v[dz + 2][dx + 2]; }
  __device__ __forceinline__ bool kn(int dz, int dx) const { return k[dz + 2][dx + 2]; }
  __device__ __forceinline__ bool ok(int dz, int dx) const { return in[dz + 2][dx + 2]; }
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

template <typename T>
__device__ __forceinline__ void square_stencil(const Nb<T>& n, int Az, int Ax,
                                               int Pz, int Px, int Qz, int Qx,
                                               bool first, Sel<T>& s) {
  T tA = n.t(Az, Ax), tP = n.t(Pz, Px), tQ = n.t(Qz, Qx);
  bool valid = n.kn(Az, Ax) && n.kn(Pz, Px) && n.kn(Qz, Qx);
  T diff = valid ? m_abs(tP - tQ) : T(kBIG);
  bool swap = tP < tQ;  // B = the smaller of P, Q; ties -> Q
  T xB = swap ? T(Px) : T(Qx);
  T zB = swap ? T(Pz) : T(Qz);
  T xC = swap ? T(Qx) : T(Px);
  T zC = swap ? T(Qz) : T(Pz);
  T yB = swap ? tP : tQ;
  T yC = swap ? tQ : tP;
  T dx, dz, dist;
  bool zero;
  wavefront(T(Ax), T(Az), xB, zB, xC, zC, tA, yB, yC, dx, dz, zero, dist);
  T mx = vmax(tA, vmax(tP, tQ));
  if (first || diff < s.diff) {
    s.diff = diff; s.dx = dx; s.dz = dz; s.zero = zero; s.dist = dist;
    s.wt = yB; s.mx = mx;
  }
}

template <typename T>
__device__ __forceinline__ void tri_stencil(const Nb<T>& n, int Fz, int Fx,
                                            int Mz, int Mx, int Dz, int Dx,
                                            bool edge, T eang, bool wt_d,
                                            bool first, Sel<T>& s) {
  const T c1 = T(kSqrt2 - 1.0);
  const T c2 = T(2.0 - kSqrt2);
  T tF = n.t(Fz, Fx), tM = n.t(Mz, Mx), tD = n.t(Dz, Dx);
  bool valid = n.kn(Fz, Fx) && n.kn(Mz, Mx) && n.kn(Dz, Dx) && (tF < vmin(tM, tD));
  T diff = valid ? m_abs(c1 * tF + c2 * tM - tD) : T(kBIG);
  bool mb = tM < tD;
  T xB = mb ? T(Mx) : T(Dx);
  T zB = mb ? T(Mz) : T(Dz);
  T xC = mb ? T(Dx) : T(Mx);
  T zC = mb ? T(Dz) : T(Mz);
  T yB = mb ? tM : tD;
  T yC = mb ? tD : tM;
  T dx, dz, dist;
  bool zero;
  wavefront(T(Fx), T(Fz), xB, zB, xC, zC, tF, yB, yC, dx, dz, zero, dist);
  bool on_edge = mb && edge;
  T oang = on_edge ? eang : T(0);
  if (on_edge) dist = T(1);
  T wt = wt_d ? tD : yB;
  T mx = vmax(tM, tD);
  if (first || diff < s.diff) {
    s.diff = diff; s.dx = dx; s.dz = dz; s.zero = zero; s.ovr = on_edge;
    s.oang = oang; s.dist = dist; s.wt = wt; s.mx = mx;
  }
}

// One FD quadrant of the axis (axis=true, h = dnx) or diagonal family.
template <typename T>
__device__ __forceinline__ T fd_quadrant(const Nb<T>& n, int Jz, int Jx, int Kz,
                                         int Kx, T hs, bool axis) {
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
__device__ __forceinline__ T fd_knight(const Nb<T>& n, int pz, int px, int qz,
                                       int qx, T us) {
  const T ninf = T(-kINF);
  T tp = n.t(pz, px), tq = n.t(qz, qx);
  bool pair_inb = n.ok(pz, px) && n.ok(qz, qx);
  bool kp = n.kn(pz, px) && pair_inb;
  bool kq = n.kn(qz, qx) && pair_inb;
  bool both = kp && kq;
  T a = both ? T(2) : T(1);
  T b = both ? T(-2) * (tq + tp) : T(0);
  T c = both ? tq * tq + tp * tp - T(2) * us * us : -(us * us);
  T tref = both ? T(0) : (kp ? tp : tq);
  T rd1 = vmax(b * b - T(4) * a * c, T(0));
  T t = tref + (-b + m_sqrt(rd1)) / (T(2) * a);
  bool ok = (kp || kq) && (t >= vmax(kp ? tp : ninf, kq ? tq : ninf));
  return ok ? t : T(kINF);
}

template <typename T>
__device__ __forceinline__ T fd_candidate(const Nb<T>& n, T tc, T dnx,
                                          const T* fb) {
  T hs = dnx * fb[0];
  T best = fd_quadrant(n, 0, -1, -1, 0, hs, true);
  best = vmin(best, fd_quadrant(n, 0, -1, 1, 0, hs, true));
  best = vmin(best, fd_quadrant(n, 0, 1, -1, 0, hs, true));
  best = vmin(best, fd_quadrant(n, 0, 1, 1, 0, hs, true));
  T hd = (T(kSqrt2) * dnx) * fb[1];
  T diag = fd_quadrant(n, 1, -1, -1, -1, hd, false);
  diag = vmin(diag, fd_quadrant(n, 1, -1, 1, 1, hd, false));
  diag = vmin(diag, fd_quadrant(n, -1, 1, -1, -1, hd, false));
  diag = vmin(diag, fd_quadrant(n, -1, 1, 1, 1, hd, false));
  T out = vmin(best, diag);
  T u = T(kSqrt5) * dnx;
  T usA = u * fb[2];
  T ka = fd_knight(n, -2, -1, -1, 2, usA);
  ka = vmin(ka, fd_knight(n, -1, 2, 2, 1, usA));
  ka = vmin(ka, fd_knight(n, 2, 1, 1, -2, usA));
  ka = vmin(ka, fd_knight(n, 1, -2, -2, -1, usA));
  out = vmin(out, ka);
  T usB = u * fb[3];
  T kb = fd_knight(n, -2, 1, 1, 2, usB);
  kb = vmin(kb, fd_knight(n, 1, 2, 2, -1, usB));
  kb = vmin(kb, fd_knight(n, 2, -1, -1, -2, usB));
  kb = vmin(kb, fd_knight(n, -1, -2, -2, 1, usB));
  out = vmin(out, kb);
  return vmin(out, tc);
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

// Causal local update at grid point (z, x) of field f (Z, X).
template <typename T>
__device__ T local_update(const T* __restrict__ f, int Z, int X, int z, int x,
                          T tc, const T* mat, const Tables& tb, T dnx) {
  const T half_inf = T(kINF * 0.5);
  Nb<T> n;
#pragma unroll
  for (int a = 0; a < 5; ++a) {
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      int zz = z + a - 2, xx = x + c - 2;
      bool in = zz >= 0 && zz < Z && xx >= 0 && xx < X;
      T v = in ? f[zz * X + xx] : T(kINF);
      n.v[a][c] = v;
      n.in[a][c] = in;
      n.k[a][c] = (v < half_inf) && (v < tc);
    }
  }
  bool top = z == 0, bottom = z == Z - 1, left = x == 0, right = x == X - 1;

  T fb[4] = {mat[P_FB0], mat[P_FB1], mat[P_FB2], mat[P_FB3]};
  T fouds = fd_candidate(n, tc, dnx, fb);

  Sel<T> sq;
  square_stencil(n, -2, 0, -1, -1, -1, 1, true, sq);
  square_stencil(n, 0, 2, -1, 1, 1, 1, false, sq);
  square_stencil(n, 2, 0, 1, -1, 1, 1, false, sq);
  square_stencil(n, 0, -2, -1, -1, 1, -1, false, sq);
  square_stencil(n, -1, -1, 0, -1, -1, 0, false, sq);
  square_stencil(n, -1, 1, -1, 0, 0, 1, false, sq);
  square_stencil(n, 1, 1, 1, 0, 0, 1, false, sq);
  square_stencil(n, 1, -1, 0, -1, 1, 0, false, sq);
  bool sq_any = sq.diff < T(kBIG);

  Sel<T> tr;
  tri_stencil(n, 2, 0, 1, 0, 1, 1, left, T(90), true, true, tr);
  tri_stencil(n, -2, 0, -1, 0, -1, 1, left, T(90), false, false, tr);
  tri_stencil(n, -2, 0, -1, 0, -1, -1, right, T(90), false, false, tr);
  tri_stencil(n, 2, 0, 1, 0, 1, -1, right, T(90), false, false, tr);
  tri_stencil(n, 0, -2, 0, -1, 1, -1, top, T(0), false, false, tr);
  tri_stencil(n, 0, 2, 0, 1, 1, 1, top, T(0), false, false, tr);
  tri_stencil(n, 0, 2, 0, 1, -1, 1, bottom, T(0), false, false, tr);
  tri_stencil(n, 0, -2, 0, -1, -1, -1, bottom, T(0), false, false, tr);
  bool tri_any = tr.diff < T(kBIG);

  bool on_boundary = left || right || top || bottom;
  bool try_tri = !sq_any || on_boundary;
  T carry = sq_any ? sq.diff : T(1.0e6);
  bool use_tri = try_tri && tri_any && (tr.diff < carry);
  T sel_dx = use_tri ? tr.dx : sq.dx;
  T sel_dz = use_tri ? tr.dz : sq.dz;
  bool sel_zero = use_tri ? tr.zero : sq.zero;
  bool sel_ovr = use_tri && tr.ovr;
  T sel_oang = use_tri ? tr.oang : T(0);
  T dx_safe = sel_zero ? T(1) : sel_dx;
  T angle = mod180(m_atan(sel_dz / dx_safe) * T(180.0 / kPi) + T(90));
  if (sel_zero) angle = T(0);
  if (sel_ovr) angle = sel_oang;
  T dist = use_tri ? tr.dist : (sq_any ? sq.dist : T(-1));
  T wtime = use_tri ? tr.wt : sq.wt;
  T imax = use_tri ? tr.mx : sq.mx;

  T eff = mod180(mat[P_VELN] - angle);
  T vel = phase_velocity(eff, mat, tb);
  T ali = wtime + dist * dnx / vel;
  bool ali_ok = dist >= T(0) && ali >= imax;
  return ali_ok ? ali : fouds;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sweep_pass_kernel(const T* __restrict__ tt_in, T* __restrict__ tt_out,
                  const uint8_t* __restrict__ fixed, const T* __restrict__ mats,
                  long long mats_bstride, Tables tb, T dnx,
                  const int* __restrict__ replace, const int* __restrict__ active,
                  T* __restrict__ delta_out, T* __restrict__ scale_out,
                  int Z, int X) {
  extern __shared__ unsigned char smem_raw[];
  T* line = reinterpret_cast<T*>(smem_raw);
  __shared__ T red_d[kThreads / 32];
  __shared__ T red_s[kThreads / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long plane = (long long)Z * X;
  const T* src = tt_in + b * plane;
  T* f = tt_out + b * plane;
  for (long long i = tid; i < plane; i += kThreads) f[i] = src[i];
  __syncthreads();
  if (!active[b]) {
    if (tid == 0) { delta_out[b] = T(0); scale_out[b] = T(0); }
    return;
  }
  const uint8_t* fx = fixed + b * plane;
  const T* mb = mats + b * mats_bstride;
  const bool rep = replace[b] != 0;
  const T half_inf = T(kINF * 0.5);

  for (int dir = 0; dir < 4; ++dir) {
    const bool along_x = dir >= 2;
    const bool rev = (dir & 1) != 0;
    const int L = along_x ? X : Z;
    const int W = along_x ? Z : X;
    for (int s = 0; s < L; ++s) {
      const int i = rev ? L - 1 - s : s;
      for (int w = tid; w < W; w += kThreads) {
        const int z = along_x ? w : i;
        const int x = along_x ? i : w;
        const long long p = (long long)z * X + x;
        const T tc = f[p];
        T out = tc;
        if (!fx[p]) {
          T mat[N_PLANES];
#pragma unroll
          for (int q = 0; q < N_PLANES; ++q) mat[q] = mb[q * plane + p];
          T nv = local_update(f, Z, X, z, x, tc, mat, tb, dnx);
          T acc_min = vmin(tc, nv);
          T acc_rep = nv < half_inf ? nv : tc;
          out = rep ? acc_rep : acc_min;
        }
        line[w] = out;
      }
      __syncthreads();
      for (int w = tid; w < W; w += kThreads) {
        const int z = along_x ? w : i;
        const int x = along_x ? i : w;
        f[(long long)z * X + x] = line[w];
      }
      __syncthreads();
    }
  }

  // per-source pass-to-pass delta and scale (the two-phase stop test)
  T d = T(0), sc = T(0);
  for (long long i = tid; i < plane; i += kThreads) {
    T nv = f[i], ov = src[i];
    bool kn = nv < half_inf;
    if (kn || ov < half_inf) d = vmax(d, m_abs(nv - ov));
    if (kn) sc = vmax(sc, nv);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    d = vmax(d, __shfl_down_sync(0xffffffffu, d, o));
    sc = vmax(sc, __shfl_down_sync(0xffffffffu, sc, o));
  }
  if ((tid & 31) == 0) { red_d[tid >> 5] = d; red_s[tid >> 5] = sc; }
  __syncthreads();
  if (tid == 0) {
    for (int wi = 1; wi < kThreads / 32; ++wi) {
      d = vmax(d, red_d[wi]);
      sc = vmax(sc, red_s[wi]);
    }
    delta_out[b] = d;
    scale_out[b] = sc;
  }
}

template <typename T>
int launch(const void* tt_in, void* tt_out, const void* fixed, const void* mats,
           long long mats_bstride, const void* tab, int M, const void* col_mode,
           const void* col_const, int has_stif, double dnx, const void* replace,
           const void* active, void* delta, void* scale, int B, int Z, int X,
           void* stream) {
  size_t smem = (size_t)(Z > X ? Z : X) * sizeof(T);
  if (B <= 0 || Z <= 0 || X <= 0 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  Tables tb{tab, M, static_cast<const int*>(col_mode), col_const, has_stif};
  sweep_pass_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tt_in), static_cast<T*>(tt_out),
      static_cast<const uint8_t*>(fixed), static_cast<const T*>(mats),
      mats_bstride, tb, T(dnx), static_cast<const int*>(replace),
      static_cast<const int*>(active), static_cast<T*>(delta),
      static_cast<T*>(scale), Z, X);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One sweep pass for B sources; returns cudaGetLastError() of the launch.
int alifmm_sweep_pass_f32(const void* tt_in, void* tt_out, const void* fixed,
                          const void* mats, long long mats_bstride,
                          const void* tab, int M, const void* col_mode,
                          const void* col_const, int has_stif, double dnx,
                          const void* replace, const void* active, void* delta,
                          void* scale, int B, int Z, int X, void* stream) {
  return launch<float>(tt_in, tt_out, fixed, mats, mats_bstride, tab, M,
                       col_mode, col_const, has_stif, dnx, replace, active,
                       delta, scale, B, Z, X, stream);
}

int alifmm_sweep_pass_f64(const void* tt_in, void* tt_out, const void* fixed,
                          const void* mats, long long mats_bstride,
                          const void* tab, int M, const void* col_mode,
                          const void* col_const, int has_stif, double dnx,
                          const void* replace, const void* active, void* delta,
                          void* scale, int B, int Z, int X, void* stream) {
  return launch<double>(tt_in, tt_out, fixed, mats, mats_bstride, tab, M,
                        col_mode, col_const, has_stif, dnx, replace, active,
                        delta, scale, B, Z, X, stream);
}

}  // extern "C"
