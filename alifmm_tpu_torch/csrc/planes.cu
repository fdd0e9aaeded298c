// K6: the model build's fallback slowness planes, written for Hopper.
//
// Replaces no TPU kernel: the JAX package computes these planes on the
// host, in numpy (alifmm_tpu/grid.py::_np_fallback_slowness_planes, called
// by make_model), and so did the port's make_model before this kernel.
// That host function, alifmm_tpu_torch/grid.py::_np_fallback_slowness_planes
// run in float64, is the twin this kernel is tested against.  For every
// point it gives the group slowness at the FD fallback's four fixed wave
// angles (effective angles -veln, round(45 - veln), -27 - veln and
// 27 - veln, all mod 180): the interpolated group table column
// (_np_interp_table) or, at a stiffness point (velpn == 0 in a model with
// stiffness), the closed-form Christoffel group velocity
// (_np_group_velocity_christoffel), then its reciprocal.
//
// What bounds it on the H100.  A point reads veln, velpn, vel_map and, at
// a stiffness point, its stiffness row, and writes four planes: in float32
// at most 48 B a point, 10.2 MB at 424 x 500, 3.0 us at 3.35 TB/s.  The
// arithmetic is float64, to follow the float64 twin: at a stiffness point
// each angle takes a tan, an atan, two cos, a sin, two square roots and
// five divides, about 280 float64 operations (chip_smoke.py's
// OPS_PLANES_CHRISTOFFEL), so four angles at the weld's 61 % stiffness
// points are some 0.16 G operations, 4.7 us at the card's 33.5 TFLOP/s:
// the larger of the two bounds in float32.  Either way one launch is over
// in microseconds; what it replaces is a host computation of about 0.2 s
// and a 3.4 MB copy to the card.
//
// What this design does about it: one thread a point computes all four
// planes from one read of the point's fields, in double registers, and
// stores each plane's slowness once, rounded to the output type; threads
// of a warp take neighbouring points, so every load and store is
// coalesced.  A table point reads no stiffness row.  No scratch memory.
//
// Arithmetic follows the numpy twin operation for operation (built with
// -fmad=false): np.mod is floor-mod built on fmod; np.round rounds half to
// even (rint); a zero denominator becomes np.finfo(float64).tiny; the
// near-axis and near-90 branches select as np.where does; the table's
// second row is (a1 + 1) mod 180.  Only tan, atan, cos and sin come from
// another library than numpy's, each within an ulp or two of float64.

#include "ray_device.cuh"

namespace {

constexpr int kThreads = 256;

// _np_interp_table at one point: the table column m at eff (already in
// [0, 180)), times the velocity scale
template <typename T>
__device__ __forceinline__ double table_velocity(const T* tab, int M, int m,
                                                 double eff, double scale) {
  int a1 = (int)vclamp<long long>((long long)m_floor(eff), 0, 179);
  int a2 = (a1 + 1) % 180;
  double w = eff - (double)a1;
  return scale * ((1.0 - w) * (double)tab[a1 * M + m] +
                  w * (double)tab[a2 * M + m]);
}

// One thread a point of the (Z, X) fields; writes the point's four
// planes of the (4, Z, X) output.
template <typename T>
__global__ void __launch_bounds__(kThreads)
planes_kernel(const T* __restrict__ veln, const int* __restrict__ velpn,
              const T* __restrict__ vel_map, const T* __restrict__ stif,
              const T* __restrict__ tab, int M, int has_stif, long long n,
              T* __restrict__ out) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  double vn = (double)veln[i];
  int m = velpn[i];
  double scale = (double)vel_map[i];
  bool chr = has_stif && m == 0;
  double c22 = 0.0, c23 = 0.0, c33 = 0.0, c44 = 0.0, rho = 0.0;
  if (chr) {
    const T* s = stif + i * 5;
    c22 = (double)s[0];
    c23 = (double)s[1];
    c33 = (double)s[2];
    c44 = (double)s[3];
    rho = (double)s[4];
  }
  const double effs[4] = {
      floor_mod(0.0 - vn, 180.0),
      m_rint(floor_mod(45.0 - vn, 180.0)),
      floor_mod(-27.0 - vn, 180.0),
      floor_mod(27.0 - vn, 180.0),
  };
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // the interpolation and the Christoffel solve each take mod 180 again
    double eff = floor_mod(effs[k], 180.0);
    double v = chr ? christoffel_group(eff, c22, c23, c33, c44, rho, scale)
                   : table_velocity(tab, M, m, eff, scale);
    out[k * n + i] = (T)(1.0 / v);
  }
}

template <typename T>
int launch(const void* veln, const void* velpn, const void* vel_map,
           const void* stif, const void* tab, int M, int has_stif,
           long long n, void* out, void* stream) {
  if (n == 0) return 0;
  unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  planes_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)veln, (const int*)velpn, (const T*)vel_map, (const T*)stif,
      (const T*)tab, M, has_stif, n, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The four fallback slowness planes of the n = Z x X points, as (4, Z, X);
// returns the CUDA error of the launch.
int alifmm_fallback_planes_f32(const void* veln, const void* velpn,
                               const void* vel_map, const void* stif,
                               const void* tab, int M, int has_stif,
                               long long n, void* out, void* stream) {
  return launch<float>(veln, velpn, vel_map, stif, tab, M, has_stif, n, out,
                       stream);
}

int alifmm_fallback_planes_f64(const void* veln, const void* velpn,
                               const void* vel_map, const void* stif,
                               const void* tab, int M, int has_stif,
                               long long n, void* out, void* stream) {
  return launch<double>(veln, velpn, vel_map, stif, tab, M, has_stif, n, out,
                        stream);
}

}  // extern "C"
