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
// What bounds it on the H100.  The local update is about 1,000 fp
// operations per point: 8 square stencils at ~31, 8 triangular at ~35, 8
// FD quadrants at ~30, 8 knight pairs at ~20, then one atan, two floor-mods
// and the phase velocity.  One pass at 31 x 424 x 500 is 4 x 6.57 M = 26.3 M
// updates, ~26 GFLOP: ~0.4 ms at 67 TFLOP/s (fp32, no tensor cores).  It
// moves ~69 MB (field in and out, fixed mask, 12 material planes), ~21 us
// at 3.35 TB/s.  So the bound is compute.  But a pass is a chain of
// 4 x (Z + X) dependent line steps, and IEEE divides and square roots
// (needed for bit-equality) make each candidate a long instruction chain:
// the first layout (one thread per point, one CTA of 256 threads per
// source, 25 neighbour loads from L2 per point, strided x-sweeps) paid
// 8-19 us per line step, 35 ms per pass.  A line step now costs either the
// latency of one update chain (the patches: about 30 points per SM) or the
// SM's issue rate (the final stage: about 120 points per SM).
//
// What this design does about it:
// - Lanes per point.  The 32 candidates of a point are independent, so a
//   group of G lanes (G = 4 or 8, a template parameter) shares them:
//   lane l takes stencils l, l + G, ... of each family.  Square and
//   triangular selections reduce with warp shuffles on the pair (diff,
//   stencil index), which keeps the first-wins order of strict '<'
//   exactly; the FD candidates reduce with vmin, exact in any order.  A
//   stencil whose points are not all usable skips its geometry (see
//   unusable()).  The group's lane 0 stores a record of the selection; after
//   a block barrier one thread per point finishes it (atan, phase velocity),
//   so the finish is not repeated on G lanes.  G = 8 shortens the chain
//   where the step is latency-bound, G = 4 (64 registers, two CTAs an SM)
//   issues less where it is issue-bound; ops/cuda_sweep.launch_config
//   chooses.
// - The band in shared memory.  A ring of the 5 lines around the current
//   one over the CTA's width tile plus 2-column halos (each line stored
//   twice, so the 5 rows are contiguous for any position of the ring), so
//   the 25 neighbour reads hit shared memory.  Only one line enters per
//   step: the line three ahead, read from the sweep's source into
//   registers a step early, with the next line's fixed mask; the next
//   line's 12 material values come by cp.async into a second buffer.  The
//   warps with no point to finish issue these while the finish runs.
// - Coalesced x-sweeps.  The material planes are also packed transposed,
//   once per model (ops/cuda_sweep.pack_model), so a line's materials are
//   contiguous in both directions.  The field is not transposed: an
//   x-sweep reads one new column per step, off the critical path, and
//   writes its new column to L2.
// - A cluster per source.  C CTAs (a thread-block cluster, C <= 8) split
//   every line's width into C tiles; with C = 8 the final stage's 31
//   sources run as 248 CTAs, two on each SM.  The new values of a line
//   stay in the CTA's ring; the two halo columns on each side are pushed
//   into the neighbours' shared memory (distributed shared memory), so a
//   line step reads nothing from global memory on its critical path, and
//   one cluster barrier per line (release/acquire at cluster scope)
//   replaces the two __syncthreads of the first layout.  The new line
//   also goes to global memory, into a second buffer: a sweep reads from
//   its source and writes to its destination (the output and a scratch
//   field in turn), so the next sweep reads complete lines.
//   ops/cuda_sweep.launch_config picks C: the largest of 8, 4, 2, 1 with
//   the B x C CTAs resident at two an SM and tiles of at least 8 points,
//   C = 8 for the weld's patches (109 and 79 wide) as for its final stage.
//
// Arithmetic follows the plain twin operation for operation (build with
// -fmad=false so no multiply-add is contracted): INF is 1e9, not IEEE
// infinity; mod is floor-mod built on fmod; the one arctan per point runs
// on the selected stencil; strict '<' keeps the first stencil on ties.
// Phase velocity is the table lookup (velpn != 0) or the closed-form
// Christoffel solve (velpn == 0), as grid.phase_velocity_at evaluates it.
//
// K5, the slab sweep of the halo solves, follows K1 in this file and
// shares its per-point device functions and its line step (see its own
// note below).

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

// Candidates of one point, shared by the G lanes of its group: each lane
// evaluates its share, the group reduces, and every lane returns the
// same record.
template <typename T, int G>
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
    fd = vmin(fd, fd_quadrant(n, tb_o.quad + 4 * k, k < 4 ? hs : hd, k < 4));
    fd = vmin(fd, fd_knight(n, tb_o.kni + 4 * k, k < 4 ? usA : usB));
    Sel<T> s = square_stencil(n, tb_o.sq + 6 * k);
    if (j == 0 || s.diff < sq.diff) { sq = s; sq_i = k; }
    const int e = tb_o.edge[k];
    const bool edge = e == 0 ? left : (e == 1 ? right : (e == 2 ? top : bottom));
    Sel<T> t = tri_stencil(n, tb_o.tr + 6 * k, edge, k < 4 ? T(90) : T(0),
                           k == 0);
    if (j == 0 || t.diff < tr.diff) { tr = t; tr_i = k; }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    fd = vmin(fd, __shfl_xor_sync(kFull, fd, off, G));

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
  r.fouds = vmin(fd, n.tc);
  return r;
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

template <typename T>
struct Args {
  const T* tt_in;
  T* tt_out;
  T* scratch;            // a second field, the ping-pong partner of tt_out
  const uint8_t* fixed;
  const T* mats;         // (Bm, 12, Z, X)
  const T* mats_t;       // (Bm, 12, X, Z)
  long long mats_bstride;
  Tables tb;
  T dnx;
  const int* replace;
  const int* active;
  T* delta;
  T* scale;
  int Z, X, C, tile_z, tile_x;
};

// Shared memory of one CTA for width tiles of up to tmax points.
template <typename T>
struct Smem {
  T* red;        // 64: per-warp delta and scale
  int* tabs;     // kTabInts: stencil offsets
  T* band;       // 10 rows of tmax + 4: the 5-line ring, each line twice
  T* halo;       // 2 x 4: halo columns of the last line, pushed by neighbours
  T* newl;       // tmax: the current line's new values
  T* rec;        // 7 x tmax: candidate records (Rec fields)
  int* flags;    // tmax
  T* mat;        // 2 x 12 x tmax: materials of this line and the next
  uint8_t* fix;  // 2 x tmax: fixed mask of this line and the next
};

template <typename T>
__host__ __device__ inline size_t smem_bytes(int tmax) {
  return (64 + 10 * (size_t)(tmax + 4) + 8 + 8 * (size_t)tmax
          + 2 * N_PLANES * (size_t)tmax) * sizeof(T)
       + (kTabInts + (size_t)tmax) * sizeof(int) + 2 * (size_t)tmax;
}

template <typename T>
__device__ __forceinline__ Smem<T> carve(unsigned char* raw, int tmax) {
  Smem<T> m;
  T* t = reinterpret_cast<T*>(raw);
  m.red = t;
  m.band = m.red + 64;
  m.halo = m.band + 10 * (tmax + 4);
  m.newl = m.halo + 8;
  m.rec = m.newl + tmax;
  m.mat = m.rec + 7 * tmax;
  int* ip = reinterpret_cast<int*>(m.mat + 2 * N_PLANES * tmax);
  m.tabs = ip;
  m.flags = ip + kTabInts;
  m.fix = reinterpret_cast<uint8_t*>(m.flags + tmax);
  return m;
}

__device__ __forceinline__ int mod5(int l) { return ((l % 5) + 5) % 5; }

// Lanes per point G = 4 is the width-bound layout (the final stage):
// 64 registers, so two CTAs of up to 512 threads share an SM.  G = 8 is
// the latency-bound one (the patches): fewer points, a shorter chain.
template <typename T, int G>
__global__ void __launch_bounds__(kMaxThreads, G == 4 ? 2 : 1)
sweep_pass_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.C;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Z = a.Z, X = a.X;
  const long long plane = (long long)Z * X;
  const T* in = a.tt_in + b * plane;
  T* out = a.tt_out + b * plane;
  T* scr = a.scratch + b * plane;
  const long long beg = plane * rank / C, end = plane * (rank + 1) / C;
  const T half_inf = T(kINF * 0.5);

  if (!a.active[b]) {
    for (long long i = beg + tid; i < end; i += nt) out[i] = __ldcg(in + i);
    if (rank == 0 && tid == 0) { a.delta[b] = T(0); a.scale[b] = T(0); }
    return;
  }

  const int tmax = a.tile_z > a.tile_x ? a.tile_z : a.tile_x;
  const int bw = tmax + 4;
  const Smem<T> sm = carve<T>(smem_raw, tmax);
  for (int k = tid; k < kTabInts; k += nt) {
    int v;
    if (k < 48) v = (&kSquare[0][0])[k];
    else if (k < 96) v = (&kTri[0][0])[k - 48];
    else if (k < 104) v = kTriEdge[k - 96];
    else if (k < 136) v = (&kQuad[0][0])[k - 104];
    else v = (&kKnight[0][0])[k - 136];
    sm.tabs[k] = v;
  }
  const Tabs tb_o{sm.tabs, sm.tabs + 48, sm.tabs + 96, sm.tabs + 104,
                  sm.tabs + 136};

  const uint8_t* fx = a.fixed + b * plane;
  const bool rep = a.replace[b] != 0;
  const int lane = tid % G, group = tid / G, ngroups = nt / G;

  for (int dir = 0; dir < 4; ++dir) {
    const bool xs = dir >= 2;
    const int step = (dir & 1) ? -1 : 1;
    const T* src = dir == 0 ? in : (dir == 2 ? out : scr);
    T* dst = (dir & 1) ? out : scr;
    const int L = xs ? X : Z, W = xs ? Z : X;
    const int tile = xs ? a.tile_x : a.tile_z;
    const int w0 = rank * tile;
    const int nw = W - w0 < tile ? (W - w0 > 0 ? W - w0 : 0) : tile;
    const int bwt = nw + 4;
    // the finish takes the warps of the first nw threads; the others, if
    // there are enough of them, prefetch meanwhile (pre_v holds 2 values
    // a thread)
    const int fin = (nw + 31) / 32 * 32;
    const bool split = nt - fin >= 32 && bwt <= 2 * (nt - fin);
    const int pf_lo = split ? fin : 0, npf = nt - pf_lo;
    // a line's materials are contiguous along the width in both layouts
    const T* mline = (xs ? a.mats_t : a.mats) + b * a.mats_bstride;
    auto fidx = [&](int l, int w) -> long long {
      return xs ? (long long)w * X + l : (long long)l * X + w;
    };
    // line l at band column j (width w0 - 2 + j) of the sweep's source
    auto src_at = [&](int l, int j) -> T {
      const int w = w0 - 2 + j;
      return (l >= 0 && l < L && w >= 0 && w < W) ? __ldcg(src + fidx(l, w))
                                                   : T(kINF);
    };
    auto put_row = [&](int l, int j, T v) {
      const int m = mod5(l);
      sm.band[m * bw + j] = v;
      sm.band[(m + 5) * bw + j] = v;
    };
    auto prefetch_mats = [&](int l, int buf, int t0, int nth) {
      T* ms = sm.mat + buf * N_PLANES * tmax;
      for (int k = t0; k < N_PLANES * nw; k += nth) {
        int q = k / nw, p = k % nw;
        __pipeline_memcpy_async(ms + q * tmax + p,
                                mline + q * plane + (long long)l * W + w0 + p,
                                sizeof(T));
      }
      __pipeline_commit();
    };

    // the first line's band, fixed mask and materials
    const int i0 = step > 0 ? 0 : L - 1;
    for (int k = tid; k < 5 * bwt; k += nt) {
      int r, j;
      if (xs) { j = k / 5; r = k % 5; } else { r = k / bwt; j = k % bwt; }
      put_row(i0 - 2 + r, j, src_at(i0 - 2 + r, j));
    }
    for (int p = tid; p < nw; p += nt) sm.fix[p] = fx[fidx(i0, w0 + p)];
    prefetch_mats(i0, 0, tid, nt);
    __pipeline_wait_prior(0);
    __syncthreads();

    for (int s = 0; s < L; ++s) {
      const int i = i0 + s * step;
      const int cur = s & 1;
      const bool more = s + 1 < L;
      // candidates: G lanes per point, records to shared memory
      const T* band = sm.band + mod5(i - 2) * bw;
      const T* ms = sm.mat + cur * N_PLANES * tmax;
      for (int p0 = 0; p0 < nw; p0 += ngroups) {
        const int p = p0 + group;
        const bool valid = p < nw;
        const int pc = valid ? p : nw - 1;
        const int w = w0 + pc;
        Nb<T> n{band, bw, pc + 2, xs, xs ? w : i, xs ? i : w, Z, X,
                band[2 * bw + pc + 2]};
        T fb[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) fb[q] = ms[(P_FB0 + q) * tmax + pc];
        const Rec<T> r = candidates<T, G>(n, lane, fb, tb_o, a.dnx);
        if (valid && lane == 0) {
          sm.rec[0 * tmax + pc] = r.dx;
          sm.rec[1 * tmax + pc] = r.dz;
          sm.rec[2 * tmax + pc] = r.oang;
          sm.rec[3 * tmax + pc] = r.dist;
          sm.rec[4 * tmax + pc] = r.wt;
          sm.rec[5 * tmax + pc] = r.mx;
          sm.rec[6 * tmax + pc] = r.fouds;
          sm.flags[pc] = r.flags;
        }
      }
      __syncthreads();

      // finish: one thread per point; write back, push halo columns.  The
      // warps with no point to finish meanwhile prefetch the next line:
      // its materials (cp.async), the line three ahead and the next
      // line's fixed mask (registers, stored after the barrier).
      const int par = s & 1;
      T pre_v[2];
      uint8_t pre_f[2];
      const bool fin_thread = !split || tid < fin;
      if (more && (!split || !fin_thread)) {
        const int ptid = tid - pf_lo;
        prefetch_mats(i + step, cur ^ 1, ptid, npf);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = ptid + u * npf;
          pre_v[u] = j < bwt ? src_at(i + 3 * step, j) : T(kINF);
          pre_f[u] = j < nw ? fx[fidx(i + step, w0 + j)] : 0;
        }
      }
      if (fin_thread) for (int p = tid; p < nw; p += split ? fin : nt) {
        Rec<T> r;
        r.dx = sm.rec[0 * tmax + p];
        r.dz = sm.rec[1 * tmax + p];
        r.oang = sm.rec[2 * tmax + p];
        r.dist = sm.rec[3 * tmax + p];
        r.wt = sm.rec[4 * tmax + p];
        r.mx = sm.rec[5 * tmax + p];
        r.fouds = sm.rec[6 * tmax + p];
        r.flags = sm.flags[p];
        T mat[N_PLANES];
#pragma unroll
        for (int q = 0; q < N_PLANES; ++q) mat[q] = ms[q * tmax + p];
        const T tc = band[2 * bw + p + 2];
        T o = tc;
        if (!sm.fix[cur * tmax + p]) {
          const T nv = finish(r, mat, a.tb, a.dnx);
          T acc_min = vmin(tc, nv);
          T acc_rep = nv < half_inf ? nv : tc;
          o = rep ? acc_rep : acc_min;
        }
        sm.newl[p] = o;
        const int w = w0 + p;
        __stcg(dst + fidx(i, w), o);
        if (more && (p < 2 || p >= nw - 2)) {
          // band column j of CTA r2 holds width r2 * tile - 2 + j; its
          // halo columns are 0, 1 and nw2 + 2, nw2 + 3
          for (int dr = -2; dr <= 2; ++dr) {
            const int r2 = rank + dr;
            if (dr == 0 || r2 < 0 || r2 >= C) continue;
            const int wr = r2 * tile;
            const int nw2 = W - wr < tile ? (W - wr > 0 ? W - wr : 0) : tile;
            const int j = w - wr + 2;
            int h = -1;
            if (j == 0 || j == 1) h = j;
            else if (j == nw2 + 2 || j == nw2 + 3) h = j - nw2;
            if (nw2 > 0 && h >= 0)
              cluster.map_shared_rank(sm.halo, r2)[par * 4 + h] = o;
          }
        }
      }
      cluster.sync();
      if (!more) break;

      // the finished line and the new line ahead into the ring
      for (int j = tid; j < bwt; j += nt) {
        T v;
        if (j >= 2 && j < nw + 2) {
          v = sm.newl[j - 2];
        } else {
          const int w = w0 - 2 + j;
          v = (w >= 0 && w < W) ? sm.halo[par * 4 + (j < 2 ? j : j - nw)]
                                : T(kINF);
        }
        put_row(i, j, v);
      }
      if (!split || !fin_thread) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = tid - pf_lo + u * npf;
          if (j < bwt) put_row(i + 3 * step, j, pre_v[u]);
          if (j < nw) sm.fix[(cur ^ 1) * tmax + j] = pre_f[u];
        }
      }
      __pipeline_wait_prior(0);
      __syncthreads();
    }
  }

  // per-source pass-to-pass delta and scale (the two-phase stop test)
  T d = T(0), sc = T(0);
  for (long long k = beg + tid; k < end; k += nt) {
    T nv = __ldcg(out + k), ov = __ldcg(in + k);
    bool kn = nv < half_inf;
    if (kn || ov < half_inf) d = vmax(d, m_abs(nv - ov));
    if (kn) sc = vmax(sc, nv);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    d = vmax(d, __shfl_down_sync(kFull, d, o));
    sc = vmax(sc, __shfl_down_sync(kFull, sc, o));
  }
  if ((tid & 31) == 0) { sm.red[tid >> 5] = d; sm.red[32 + (tid >> 5)] = sc; }
  __syncthreads();
  if (tid == 0) {
    for (int wi = 1; wi < nt / 32; ++wi) {
      d = vmax(d, sm.red[wi]);
      sc = vmax(sc, sm.red[32 + wi]);
    }
    sm.red[0] = d;
    sm.red[32] = sc;
  }
  cluster.sync();
  if (rank == 0 && tid == 0) {
    for (int r = 1; r < C; ++r) {
      const T* rr = cluster.map_shared_rank(sm.red, r);
      d = vmax(d, rr[0]);
      sc = vmax(sc, rr[32]);
    }
    a.delta[b] = d;
    a.scale[b] = sc;
  }
  cluster.sync();  // keep every CTA's shared memory alive until it is read
}

template <typename T, int G>
int launch_g(const Args<T>& a, int B, int nt, size_t smem, cudaStream_t st) {
  auto kern = sweep_pass_kernel<T, G>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.C);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* tt_in, void* tt_out, void* scratch, const void* fixed,
           const void* mats, const void* mats_t, long long mats_bstride,
           const void* tab, int M, const void* col_mode, const void* col_const,
           int has_stif, double dnx, const void* replace, const void* active,
           void* delta, void* scale, int B, int Z, int X, int C, int G,
           void* stream) {
  if (B <= 0 || Z <= 0 || X <= 0 || C < 1 || C > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  Args<T> a;
  a.tt_in = static_cast<const T*>(tt_in);
  a.tt_out = static_cast<T*>(tt_out);
  a.scratch = static_cast<T*>(scratch);
  a.fixed = static_cast<const uint8_t*>(fixed);
  a.mats = static_cast<const T*>(mats);
  a.mats_t = static_cast<const T*>(mats_t);
  a.mats_bstride = mats_bstride;
  a.tb = Tables{tab, M, static_cast<const int*>(col_mode), col_const, has_stif};
  a.dnx = T(dnx);
  a.replace = static_cast<const int*>(replace);
  a.active = static_cast<const int*>(active);
  a.delta = static_cast<T*>(delta);
  a.scale = static_cast<T*>(scale);
  a.Z = Z;
  a.X = X;
  a.C = C;
  a.tile_z = (X + C - 1) / C;
  a.tile_x = (Z + C - 1) / C;
  const int tmax = a.tile_z > a.tile_x ? a.tile_z : a.tile_x;
  int nt = ((tmax * G + 31) / 32) * 32;
  nt = nt > kMaxThreads ? kMaxThreads : nt;
  if (tmax + 4 > 2 * nt) return (int)cudaErrorInvalidValue;  // see pre_v
  const size_t smem = smem_bytes<T>(tmax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G == 4) return launch_g<T, 4>(a, B, nt, smem, st);
  if (G == 8) return launch_g<T, 8>(a, B, nt, smem, st);
  return (int)cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------
// K5: one directional sweep over the slabs of a decomposed grid.
//
// Ports alifmm_tpu/ops/sweep.py::_sweep_axis with its slab arguments
// (scan_off / scan_total, width_off / width_total) and its per-line carry
// refresh (halo_axis, refresh_carry), which the halo solves of
// alifmm_tpu/parallel/shard.py (_halo_jacobi_block, _halo_block2d) run
// between their halo exchanges.  That is XLA code, not a Pallas kernel.
// The plain twin is alifmm_tpu_torch/ops/sweep.py::slab_sweep.
//
// A slab is a (B, Zm, Xm) block of the grid with two halo rows (and, on a
// 2D mesh, two halo columns) on each side, marked fixed: the halos are
// read as data and never updated.  One launch runs one direction (z or x,
// forward or reverse, min or replace) over a range of lines of every slab
// in its table (up to kMaxSlabs; the slabs of one device).  A point's
// in-bounds masks and edge flags come from its global coordinates (the
// slab's offsets) against the true grid's extents, so INF lies only
// beyond the true grid and past the slab's own ends.  Each point goes
// through K1's device functions (candidates<T, G>, with the first-wins
// selections, and finish), so it takes the same operations as in K1 and
// in the twin.
//
// The line step is K1's: a ring of the five lines around the current one
// in shared memory, one new line entering a step (read a step ahead, with
// the next line's fixed mask; its materials by cp.async), the tile-edge
// columns of each new line pushed into the neighbouring tiles through
// distributed shared memory, one cluster barrier a line.  The field is
// updated in place: the line read ahead has not been written in this
// sweep, and one barrier after the first band's load keeps every CTA's
// copy of the first line old.
//
// A cluster covers a line of `nb` blocks across the width, `c` CTAs (width
// tiles) a block: CTA rank r takes block r / c and tile r % c.  With
// `link` the blocks are neighbours, and a block's halo slots across the
// width (points 0, 1 and W-2, W-1 of each line) hold the block before's
// points W-4, W-3 and the block after's 2, 3 (INF at the grid's edge), as
// the twin's refresh splices them after every line: once a line is
// finished, the CTAs holding those points push them into the slot
// buffers (and tile halos) of the neighbouring block's CTAs, and the
// slots' owners also store them to global memory, line by line, so that
// the blocks equal the twin's point for point, halos included.  So one
// launch sweeps every line of a refreshed sweep whose blocks share one
// device and fit one cluster (nb x c <= kMaxCluster).  Where they do not
// (blocks on several cards, more than 8 on one), `refresh` >= 0 keeps the
// per-line schedule: a launch a line, each first splicing the previous
// line's slots from the neighbouring slabs' memory through the table's
// pointers, and a last launch (n_lines = 0) that splices the last line.
//
// What bounds it: the same local update as K1's (about 1,000 operations a
// point), so operations, and like K1 the chain of dependent line steps
// (about 5.5 us a line at the weld's final stage on the H100, as K1's);
// a sweep is one launch of L line steps, one cluster barrier each,
// except in the per-line schedule, where the host's launch (about 13 us)
// is the step.  No delta or scale here: a round's delta and scale are
// one reduction over the slab interiors (ops/cuda_sweep.py).

constexpr int kMaxSlabs = 16;

// One slab of a launch, as the host packs it (ops/cuda_sweep.py).
struct SlabEntry {
  void* field;         // (B, Zm, Xm), updated in place
  const void* fixed;   // (B, Zm, Xm) uint8
  const void* mats;    // (12, Zm, Xm) material planes
  const void* mats_t;  // (12, Xm, Zm), the same for the x-sweeps
  const void* before;  // the slab before this one across the width, or null
  const void* after;   // the slab after it, or null
  int scan_off, width_off;  // global index of local line 0 and width 0
};

template <typename T>
struct SlabArgs {
  SlabEntry slab[kMaxSlabs];
  Tables tb;
  T dnx;
  int n_slabs, B, Zm, Xm, xs, l0, n_lines, step, refresh, replace;
  int scan_total, width_total, nb, link, C, tile;
};

// Shared memory of one K5 CTA: K1's, less the reduction, plus the slots.
template <typename T>
__host__ __device__ inline size_t slab_smem_bytes(int tile) {
  return (10 * (size_t)(tile + 4) + 16 + 8 * (size_t)tile
          + 2 * N_PLANES * (size_t)tile) * sizeof(T)
       + (kTabInts + (size_t)tile) * sizeof(int) + 2 * (size_t)tile;
}

template <typename T, int G>
__global__ void __launch_bounds__(kMaxThreads, G == 4 ? 2 : 1)
slab_sweep_kernel(const SlabArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = a.C, nb = a.nb;
  const int q = blockIdx.x / (nb * C);
  const int b = q % a.B;
  const int kb = rank / C, t = rank % C;  // block in the cluster, tile
  const SlabEntry& e = a.slab[(q / a.B) * nb + kb];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Xm = a.Xm;
  const long long plane = (long long)a.Zm * Xm;
  T* fld = static_cast<T*>(e.field) + b * plane;
  const uint8_t* fx = static_cast<const uint8_t*>(e.fixed) + b * plane;
  const bool xs = a.xs != 0;
  const int L = xs ? Xm : a.Zm, W = xs ? a.Zm : Xm;
  const int Zg = xs ? a.width_total : a.scan_total;
  const int Xg = xs ? a.scan_total : a.width_total;
  const int tile = a.tile, bw = tile + 4;
  const int w0 = t * tile;
  const int nw = W - w0 < tile ? (W - w0 > 0 ? W - w0 : 0) : tile;
  const int bwt = nw + 4;
  const T half_inf = T(kINF * 0.5);
  auto fidx = [&](int l, int w) -> long long {
    return xs ? (long long)w * Xm + l : (long long)l * Xm + w;
  };

  if (a.refresh >= 0) {
    // the per-line schedule: slots 0, 1 from the slab before (its W-4,
    // W-3), slots W-2, W-1 from the slab after (its 2, 3), INF at the
    // grid's edge
    if (rank == 0 && tid < 4) {
      const T* nbr = static_cast<const T*>(tid < 2 ? e.before : e.after);
      const int from = tid < 2 ? W - 4 + tid : tid;
      const int to = tid < 2 ? tid : W - 4 + tid;
      const T v = nbr ? __ldcg(nbr + b * plane + fidx(a.refresh, from))
                      : T(kINF);
      __stcg(fld + fidx(a.refresh, to), v);
    }
    cluster.sync();
  }
  if (a.n_lines == 0) return;

  // K1's layout without the reduction; slot: 2 x 4 halo slots of the
  // last line, pushed by the neighbouring block
  T* band = reinterpret_cast<T*>(smem_raw);  // 10 rows of bw
  T* halo = band + 10 * bw;                   // 2 x 4
  T* slot = halo + 8;                         // 2 x 4
  T* newl = slot + 8;                         // tile
  T* rec = newl + tile;                       // 7 x tile
  T* mat = rec + 7 * tile;                    // 2 x 12 x tile
  int* tabs = reinterpret_cast<int*>(mat + 2 * N_PLANES * tile);
  int* flg = tabs + kTabInts;                 // tile
  uint8_t* fix = reinterpret_cast<uint8_t*>(flg + tile);  // 2 x tile
  for (int k = tid; k < kTabInts; k += nt) {
    int v;
    if (k < 48) v = (&kSquare[0][0])[k];
    else if (k < 96) v = (&kTri[0][0])[k - 48];
    else if (k < 104) v = kTriEdge[k - 96];
    else if (k < 136) v = (&kQuad[0][0])[k - 104];
    else v = (&kKnight[0][0])[k - 136];
    tabs[k] = v;
  }
  const Tabs tb_o{tabs, tabs + 48, tabs + 96, tabs + 104, tabs + 136};

  const bool rep = a.replace != 0;
  const bool link = a.link != 0;
  const int step = a.step;
  const int lane = tid % G, group = tid / G, ngroups = nt / G;
  // the finish takes the warps of the first nw threads; the others, if
  // there are enough of them, prefetch meanwhile (as in K1)
  const int fin = (nw + 31) / 32 * 32;
  const bool split = nt - fin >= 32 && bwt <= 2 * (nt - fin);
  const int pf_lo = split ? fin : 0, npf = nt - pf_lo;
  const T* mline = static_cast<const T*>(xs ? e.mats_t : e.mats);
  // a halo slot whose value comes from the neighbouring block
  auto linked = [&](int w) -> bool {
    return link && ((w < 2 && kb > 0) || (w >= W - 2 && kb < nb - 1));
  };
  auto slot_of = [&](int w) -> int { return w < 2 ? w : w - (W - 4); };
  // line l at band column j (width w0 - 2 + j), from the field itself
  auto src_at = [&](int l, int j) -> T {
    const int w = w0 - 2 + j;
    return (l >= 0 && l < L && w >= 0 && w < W) ? __ldcg(fld + fidx(l, w))
                                                 : T(kINF);
  };
  auto put_row = [&](int l, int j, T v) {
    const int m = mod5(l);
    band[m * bw + j] = v;
    band[(m + 5) * bw + j] = v;
  };
  auto prefetch_mats = [&](int l, int buf, int t0, int nth) {
    T* ms = mat + buf * N_PLANES * tile;
    for (int k = t0; k < N_PLANES * nw; k += nth) {
      int qq = k / nw, p = k % nw;
      __pipeline_memcpy_async(ms + qq * tile + p,
                              mline + qq * plane + (long long)l * W + w0 + p,
                              sizeof(T));
    }
    __pipeline_commit();
  };
  // width w2 of block kb2 with value v into every other CTA of that block
  // whose band holds it: a tile-edge halo column, or (from the
  // neighbouring block) the owner's slot
  auto push = [&](int kb2, int w2, T v, int par, bool own) {
    for (int t2 = 0; t2 < C; ++t2) {
      if (own && t2 == t) continue;
      const int wr = t2 * tile;
      const int nw2 = W - wr < tile ? (W - wr > 0 ? W - wr : 0) : tile;
      const int j = w2 - wr + 2;
      if (nw2 == 0 || j < 0 || j > nw2 + 3) continue;
      T* buf = halo;
      int h;
      if (j < 2) h = j;
      else if (j >= nw2 + 2) h = j - nw2;
      else if (own) continue;
      else { buf = slot; h = slot_of(w2); }
      cluster.map_shared_rank(buf, kb2 * C + t2)[par * 4 + h] = v;
    }
  };

  // the first line's band, fixed mask and materials
  const int i0 = a.l0;
  for (int k = tid; k < 5 * bwt; k += nt) {
    int r, j;
    if (xs) { j = k / 5; r = k % 5; } else { r = k / bwt; j = k % bwt; }
    put_row(i0 - 2 + r, j, src_at(i0 - 2 + r, j));
  }
  for (int p = tid; p < nw; p += nt) fix[p] = fx[fidx(i0, w0 + p)];
  prefetch_mats(i0, 0, tid, nt);
  __pipeline_wait_prior(0);
  cluster.sync();  // every CTA holds the first line's old values

  for (int s = 0; s < a.n_lines; ++s) {
    const int i = i0 + s * step;
    const int cur = s & 1;
    const bool more = s + 1 < a.n_lines;
    const int gl = i + e.scan_off;
    // candidates: G lanes per point, records to shared memory
    const T* bnd = band + mod5(i - 2) * bw;
    const T* ms = mat + cur * N_PLANES * tile;
    for (int p0 = 0; p0 < nw; p0 += ngroups) {
      const int p = p0 + group;
      const bool valid = p < nw;
      const int pc = valid ? p : nw - 1;
      const int gw = w0 + pc + e.width_off;
      Nb<T> n{bnd, bw, pc + 2, xs, xs ? gw : gl, xs ? gl : gw, Zg, Xg,
              bnd[2 * bw + pc + 2]};
      T fb[4];
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) fb[qq] = ms[(P_FB0 + qq) * tile + pc];
      const Rec<T> r = candidates<T, G>(n, lane, fb, tb_o, a.dnx);
      if (valid && lane == 0) {
        rec[0 * tile + pc] = r.dx;
        rec[1 * tile + pc] = r.dz;
        rec[2 * tile + pc] = r.oang;
        rec[3 * tile + pc] = r.dist;
        rec[4 * tile + pc] = r.wt;
        rec[5 * tile + pc] = r.mx;
        rec[6 * tile + pc] = r.fouds;
        flg[pc] = r.flags;
      }
    }
    __syncthreads();

    // finish: one thread per point; write back, push the tile-edge
    // columns and the neighbouring blocks' slots.  The warps with no
    // point to finish meanwhile prefetch the next line.
    const int par = s & 1;
    T pre_v[2];
    uint8_t pre_f[2];
    const bool fin_thread = !split || tid < fin;
    if (more && (!split || !fin_thread)) {
      const int ptid = tid - pf_lo;
      prefetch_mats(i + step, cur ^ 1, ptid, npf);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = ptid + u * npf;
        pre_v[u] = j < bwt ? src_at(i + 3 * step, j) : T(kINF);
        pre_f[u] = j < nw ? fx[fidx(i + step, w0 + j)] : 0;
      }
    }
    if (fin_thread) for (int p = tid; p < nw; p += split ? fin : nt) {
      const int w = w0 + p;
      if (linked(w)) continue;  // the neighbouring block pushes it
      const T tc = bnd[2 * bw + p + 2];
      T o = tc;
      if (link && (w < 2 || w >= W - 2)) {
        o = T(kINF);  // a slot at the grid's edge
      } else if (!fix[cur * tile + p]) {
        Rec<T> r;
        r.dx = rec[0 * tile + p];
        r.dz = rec[1 * tile + p];
        r.oang = rec[2 * tile + p];
        r.dist = rec[3 * tile + p];
        r.wt = rec[4 * tile + p];
        r.mx = rec[5 * tile + p];
        r.fouds = rec[6 * tile + p];
        r.flags = flg[p];
        T m[N_PLANES];
#pragma unroll
        for (int qq = 0; qq < N_PLANES; ++qq) m[qq] = ms[qq * tile + p];
        const T nv = finish(r, m, a.tb, a.dnx);
        const T acc_min = vmin(tc, nv);
        const T acc_rep = nv < half_inf ? nv : tc;
        o = rep ? acc_rep : acc_min;
      }
      newl[p] = o;
      __stcg(fld + fidx(i, w), o);
      if (p < 2 || p >= nw - 2) push(kb, w, o, par, true);
      if (link && (w == W - 4 || w == W - 3) && kb < nb - 1)
        push(kb + 1, w - (W - 4), o, par, false);
      if (link && (w == 2 || w == 3) && kb > 0)
        push(kb - 1, w + W - 4, o, par, false);
    }
    cluster.sync();

    // the finished line into the ring (its linked slots also to global
    // memory), and the new line ahead
    for (int j = tid; j < bwt; j += nt) {
      const int w = w0 - 2 + j;
      T v;
      if (w < 0 || w >= W) {
        v = T(kINF);
      } else if (j >= 2 && j < nw + 2) {
        if (linked(w)) {
          v = slot[par * 4 + slot_of(w)];
          __stcg(fld + fidx(i, w), v);
        } else {
          v = newl[j - 2];
        }
      } else {
        v = halo[par * 4 + (j < 2 ? j : j - nw)];
      }
      if (more) put_row(i, j, v);
    }
    if (!more) break;
    if (!split || !fin_thread) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = tid - pf_lo + u * npf;
        if (j < bwt) put_row(i + 3 * step, j, pre_v[u]);
        if (j < nw) fix[(cur ^ 1) * tile + j] = pre_f[u];
      }
    }
    __pipeline_wait_prior(0);
    __syncthreads();
  }
}

template <typename T, int G>
int launch_slab_g(const SlabArgs<T>& a, int nt, size_t smem,
                  cudaStream_t st) {
  auto kern = slab_sweep_kernel<T, G>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_slabs * a.B * a.C);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.nb * a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_slab(const void* table, int n_slabs, int B, int Zm, int Xm,
                int xs, int l0, int n_lines, int step, int refresh,
                int replace, int scan_total, int width_total, const void* tab,
                int M, const void* col_mode, const void* col_const,
                int has_stif, double dnx, int nb, int link, int C, int G,
                void* stream) {
  const int L = xs ? Xm : Zm, W = xs ? Zm : Xm;
  const int last = l0 + (n_lines - 1) * step;
  if (n_slabs < 1 || n_slabs > kMaxSlabs || B <= 0 || Zm <= 0 || Xm <= 0
      || W < 6 || C < 1 || nb < 1 || n_slabs % nb || nb * C > kMaxCluster
      || (link && refresh >= 0) || (step != 1 && step != -1)
      || n_lines < 0 || refresh < -1 || refresh >= L
      || (n_lines > 0 && (l0 < 0 || l0 >= L || last < 0 || last >= L)))
    return (int)cudaErrorInvalidValue;
  SlabArgs<T> a;
  const SlabEntry* entries = static_cast<const SlabEntry*>(table);
  for (int k = 0; k < n_slabs; ++k) a.slab[k] = entries[k];
  a.tb = Tables{tab, M, static_cast<const int*>(col_mode), col_const,
                has_stif};
  a.dnx = T(dnx);
  a.n_slabs = n_slabs;
  a.B = B;
  a.Zm = Zm;
  a.Xm = Xm;
  a.xs = xs;
  a.l0 = l0;
  a.n_lines = n_lines;
  a.step = step;
  a.refresh = refresh;
  a.replace = replace;
  a.scan_total = scan_total;
  a.width_total = width_total;
  a.nb = nb;
  a.link = link;
  a.C = C;
  a.tile = (W + C - 1) / C;
  int nt = ((a.tile * G + 31) / 32) * 32;
  nt = nt > kMaxThreads ? kMaxThreads : nt;
  if (a.tile + 4 > 2 * nt) return (int)cudaErrorInvalidValue;  // see pre_v
  const size_t smem = slab_smem_bytes<T>(a.tile);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G == 4) return launch_slab_g<T, 4>(a, nt, smem, st);
  if (G == 8) return launch_slab_g<T, 8>(a, nt, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One sweep pass for B sources with clusters of C CTAs and G lanes per
// point; returns the CUDA error of the attribute set or the launch.
int alifmm_sweep_pass_f32(const void* tt_in, void* tt_out, void* scratch,
                          const void* fixed, const void* mats,
                          const void* mats_t, long long mats_bstride,
                          const void* tab, int M, const void* col_mode,
                          const void* col_const, int has_stif, double dnx,
                          const void* replace, const void* active, void* delta,
                          void* scale, int B, int Z, int X, int C, int G,
                          void* stream) {
  return launch<float>(tt_in, tt_out, scratch, fixed, mats, mats_t,
                       mats_bstride, tab, M, col_mode, col_const, has_stif,
                       dnx, replace, active, delta, scale, B, Z, X, C, G,
                       stream);
}

int alifmm_sweep_pass_f64(const void* tt_in, void* tt_out, void* scratch,
                          const void* fixed, const void* mats,
                          const void* mats_t, long long mats_bstride,
                          const void* tab, int M, const void* col_mode,
                          const void* col_const, int has_stif, double dnx,
                          const void* replace, const void* active, void* delta,
                          void* scale, int B, int Z, int X, int C, int G,
                          void* stream) {
  return launch<double>(tt_in, tt_out, scratch, fixed, mats, mats_t,
                        mats_bstride, tab, M, col_mode, col_const, has_stif,
                        dnx, replace, active, delta, scale, B, Z, X, C, G,
                        stream);
}

// K5: one directional sweep over the slabs of `table` (n_slabs SlabEntry
// records in host memory), lines l0, l0 + step, ... (n_lines of them), a
// cluster of nb x C CTAs over nb slabs (with `link`, neighbours across
// the width whose halo slots are passed in the cluster), after
// refreshing line `refresh`'s halo slots when it is >= 0; returns the
// CUDA error of the attribute set or the launch.
int alifmm_slab_sweep_f32(const void* table, int n_slabs, int B, int Zm,
                          int Xm, int xs, int l0, int n_lines, int step,
                          int refresh, int replace, int scan_total,
                          int width_total, const void* tab, int M,
                          const void* col_mode, const void* col_const,
                          int has_stif, double dnx, int nb, int link, int C,
                          int G, void* stream) {
  return launch_slab<float>(table, n_slabs, B, Zm, Xm, xs, l0, n_lines, step,
                            refresh, replace, scan_total, width_total, tab,
                            M, col_mode, col_const, has_stif, dnx, nb, link,
                            C, G, stream);
}

int alifmm_slab_sweep_f64(const void* table, int n_slabs, int B, int Zm,
                          int Xm, int xs, int l0, int n_lines, int step,
                          int refresh, int replace, int scan_total,
                          int width_total, const void* tab, int M,
                          const void* col_mode, const void* col_const,
                          int has_stif, double dnx, int nb, int link, int C,
                          int G, void* stream) {
  return launch_slab<double>(table, n_slabs, B, Zm, Xm, xs, l0, n_lines,
                             step, refresh, replace, scan_total, width_total,
                             tab, M, col_mode, col_const, has_stif, dnx, nb,
                             link, C, G, stream);
}

// Lets `device` read and write `peer`'s memory (K5's halo refresh reads
// the neighbouring slabs through their pointers); 0 when it already can.
int alifmm_enable_peer_access(int device, int peer) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    e = cudaSuccess;
  }
  cudaSetDevice(prev);
  return (int)e;
}

}  // extern "C"
