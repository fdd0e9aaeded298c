// K1's other forms: one sweep pass with the FD-only or the FD-free
// operator, or in the parallel-in-block order, written for Hopper.
//
// Ports the forms of the XLA sweep alifmm_tpu/ops/sweep.py::gs_pass that
// the Pallas kernel alifmm_tpu/ops/pallas_sweep.py::_sweep_kernel (K1's
// default form, sweep.cu) never had:
// - use_ali = false: the multi-stencil FD update alone (an FD envelope);
// - use_fd = false: the ALI update with INF for its fallback (the
//   polish's fast path: a replace keeps the old value where no ALI
//   stencil applies);
// - inner = J > 0 with block = B >= 2: J Jacobi iterations over blocks of
//   B lines, the blocks tiling the scan of the S x S padded square (S =
//   max(Z, X)), with the FD-only or the full operator.
// The plain twin is alifmm_tpu_torch/ops/sweep.py::gs_pass with the same
// arguments; every point goes through K1's device functions
// (sweep_device.cuh), so each form takes the twin's operations in order.
//
// The design keeps K1's layout where it carries over, and is simple
// otherwise:
// - a cluster of C CTAs per source, each a width tile of every line, G
//   lanes a point, chosen as for K1 (ops/cuda_sweep.launch_config); the
//   operator is a template parameter, so FD-only drops the stencil
//   selection and the finish, FD-free the quadrants and knight pairs;
// - a block of NB lines (NB = 1: the strict order of the operator forms)
//   with the two lines behind it and the two ahead in shared memory, a
//   ring of NB + 4 lines, each stored twice so that any five consecutive
//   lines are contiguous and K1's neighbourhood (Nb) reads them; a block
//   loads only its NB new lines from the sweep's source;
// - each iteration (one in the strict order) computes the candidates of
//   up to RL lines of the block at once (RL = NB where their records fit
//   in shared memory), then one thread a point finishes them into a
//   buffer of new values; the tile-edge columns go to the neighbouring
//   tiles through distributed shared memory, one cluster barrier, and
//   the new values replace the block's lines in the ring, so the next
//   iteration reads the previous iterate; the last iterate goes to the
//   destination field (K1's ping-pong between the output and a scratch
//   field);
// - the material planes are read from global memory (L1 and L2), not
//   staged, and nothing is prefetched.
// What bounds it: as K1, the update's operations (fewer for FD-only and
// FD-free) and the chain of dependent steps: a strict pass is 4 (Z + X)
// line steps, a parallel pass 4 J ceil(S / B) block steps.

#include "sweep_device.cuh"

namespace {

template <typename T>
struct FormArgs {
  const T* tt_in;
  T* tt_out;
  T* scratch;
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
  int nb;     // lines a block (1: the strict order)
  int iters;  // iterations a block (1: the strict order)
  int rl;     // lines whose candidates one round computes
};

// Shared memory of one CTA for width tiles of up to tmax points.
template <typename T>
struct FormSmem {
  T* red;        // 64: per-warp delta and scale
  T* band;       // 2 (nb + 4) rows of tmax + 4: the ring, each line twice
  T* halo;       // 2 x nb x 4: halo columns of the block's new lines
  T* newl;       // nb x tmax: the block's new values
  T* rec;        // 7 x rl x tmax: candidate records (Rec fields)
  int* tabs;     // kTabInts: stencil offsets
  int* flags;    // rl x tmax
  uint8_t* fix;  // nb x tmax: fixed mask of the block's lines
};

template <typename T>
__host__ __device__ inline size_t forms_smem_bytes(int tmax, int nb, int rl) {
  const size_t nr = (size_t)nb + 4;
  return (64 + 2 * nr * (tmax + 4) + 8 * (size_t)nb + (size_t)nb * tmax
          + 7 * (size_t)rl * tmax) * sizeof(T)
       + (kTabInts + (size_t)rl * tmax) * sizeof(int) + (size_t)nb * tmax;
}

template <typename T>
__device__ __forceinline__ FormSmem<T> carve_forms(unsigned char* raw,
                                                   int tmax, int nb, int rl) {
  FormSmem<T> m;
  m.red = reinterpret_cast<T*>(raw);
  m.band = m.red + 64;
  m.halo = m.band + 2 * (nb + 4) * (tmax + 4);
  m.newl = m.halo + 8 * nb;
  m.rec = m.newl + nb * tmax;
  m.tabs = reinterpret_cast<int*>(m.rec + 7 * rl * tmax);
  m.flags = m.tabs + kTabInts;
  m.fix = reinterpret_cast<uint8_t*>(m.flags + rl * tmax);
  return m;
}

template <typename T, int G, int OP>
__global__ void __launch_bounds__(kMaxThreads, G == 4 ? 2 : 1)
sweep_forms_kernel(const FormArgs<T> a) {
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
  const int NB = a.nb, NR = a.nb + 4, J = a.iters, RL = a.rl;
  const int rslot = RL * tmax;
  const FormSmem<T> sm = carve_forms<T>(smem_raw, tmax, NB, RL);
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
  const int S = Z > X ? Z : X;
  const int nblk = (S + NB - 1) / NB;
  int par = 0;  // which half of the halo buffer the next exchange fills

  for (int dir = 0; dir < 4; ++dir) {
    const bool xs = dir >= 2;
    const bool fwd = (dir & 1) == 0;
    const T* src = dir == 0 ? in : (dir == 2 ? out : scr);
    T* dst = (dir & 1) ? out : scr;
    const int L = xs ? X : Z, W = xs ? Z : X;
    const int tile = xs ? a.tile_x : a.tile_z;
    const int w0 = rank * tile;
    const int nw = W - w0 < tile ? (W - w0 > 0 ? W - w0 : 0) : tile;
    const int bwt = nw + 4;
    // a line's materials are contiguous along the width in both layouts
    const T* mline = (xs ? a.mats_t : a.mats) + b * a.mats_bstride;
    auto fidx = [&](int l, int w) -> long long {
      return xs ? (long long)w * X + l : (long long)l * X + w;
    };
    auto mat_at = [&](int q, int l, int p) -> T {
      return __ldg(mline + q * plane + (long long)l * W + w0 + p);
    };
    auto ring = [&](int l) -> int { return ((l % NR) + NR) % NR; };
    auto put_row = [&](int l, int j, T v) {
      const int m = ring(l);
      sm.band[m * bw + j] = v;
      sm.band[(m + NR) * bw + j] = v;
    };
    // lines l0 .. l0 + n - 1 of the sweep's source into the ring, INF
    // outside the grid (the padding lines of the S x S square included)
    auto load_lines = [&](int l0, int n) {
      for (int k = tid; k < n * bwt; k += nt) {
        int r, j;
        if (xs) { j = k / n; r = k % n; } else { r = k / bwt; j = k % bwt; }
        const int l = l0 + r, w = w0 - 2 + j;
        put_row(l, j, (l >= 0 && l < L && w >= 0 && w < W)
                          ? __ldcg(src + fidx(l, w)) : T(kINF));
      }
    };

    for (int blk = 0; blk < nblk; ++blk) {
      // the block's lines g .. g + NB - 1; a reverse sweep's blocks count
      // from line S - 1, so its padding lines come first
      const int g = fwd ? blk * NB : S - (blk + 1) * NB;
      if (blk == 0) load_lines(g - 2, NB + 4);
      else if (fwd) load_lines(g + 2, NB);
      else load_lines(g - 2, NB);
      const int lo = g < 0 ? -g : 0;  // the block's lines inside the grid
      const int hi = g + NB > L ? L - g : NB;
      for (int k = tid; k < NB * nw; k += nt) {
        const int r = k / nw, p = k % nw;
        sm.fix[r * tmax + p] =
            (r >= lo && r < hi) ? fx[fidx(g + r, w0 + p)] : uint8_t(1);
      }
      __syncthreads();
      if (hi <= lo) continue;  // padding lines only (the same on every CTA)
      const int nl = hi - lo;

      for (int it = 0; it < J; ++it) {
        for (int r0 = lo; r0 < hi; r0 += RL) {
          const int nr = hi - r0 < RL ? hi - r0 : RL;
          const int items = nr * nw;
          // candidates: G lanes per point, records to shared memory
          for (int q0 = 0; q0 < items; q0 += ngroups) {
            const int q = q0 + group;
            const bool valid = q < items;
            const int qc = valid ? q : items - 1;
            const int rr = qc / nw, pc = qc % nw;
            const int r = r0 + rr, l = g + r, w = w0 + pc;
            const T* band = sm.band + ring(l - 2) * bw;
            Nb<T> n{band, bw, pc + 2, xs, xs ? w : l, xs ? l : w, Z, X,
                    band[2 * bw + pc + 2]};
            T fb[4];
#pragma unroll
            for (int f = 0; f < 4; ++f) fb[f] = mat_at(P_FB0 + f, l, pc);
            const Rec<T> rc = candidates<T, G, OP>(n, lane, fb, tb_o, a.dnx);
            if (valid && lane == 0) {
              if constexpr (OP == kOpFdOnly) {
                const T tc = n.tc;
                T o = tc;
                if (!sm.fix[r * tmax + pc]) {
                  const T nv = rc.fouds;
                  o = rep ? (nv < half_inf ? nv : tc) : vmin(tc, nv);
                }
                sm.newl[r * tmax + pc] = o;
              } else {
                const int s = rr * tmax + pc;
                sm.rec[0 * rslot + s] = rc.dx;
                sm.rec[1 * rslot + s] = rc.dz;
                sm.rec[2 * rslot + s] = rc.oang;
                sm.rec[3 * rslot + s] = rc.dist;
                sm.rec[4 * rslot + s] = rc.wt;
                sm.rec[5 * rslot + s] = rc.mx;
                sm.rec[6 * rslot + s] = rc.fouds;
                sm.flags[s] = rc.flags;
              }
            }
          }
          __syncthreads();
          if constexpr (OP != kOpFdOnly) {
            // finish: one thread per point
            for (int q = tid; q < items; q += nt) {
              const int rr = q / nw, p = q % nw;
              const int r = r0 + rr, l = g + r, s = rr * tmax + p;
              Rec<T> rc;
              rc.dx = sm.rec[0 * rslot + s];
              rc.dz = sm.rec[1 * rslot + s];
              rc.oang = sm.rec[2 * rslot + s];
              rc.dist = sm.rec[3 * rslot + s];
              rc.wt = sm.rec[4 * rslot + s];
              rc.mx = sm.rec[5 * rslot + s];
              rc.fouds = sm.rec[6 * rslot + s];
              rc.flags = sm.flags[s];
              const T tc = sm.band[ring(l) * bw + p + 2];
              T o = tc;
              if (!sm.fix[r * tmax + p]) {
                T mat[N_PLANES];
#pragma unroll
                for (int f = 0; f < N_PLANES; ++f) mat[f] = mat_at(f, l, p);
                const T nv = finish(rc, mat, a.tb, a.dnx);
                o = rep ? (nv < half_inf ? nv : tc) : vmin(tc, nv);
              }
              sm.newl[r * tmax + p] = o;
            }
            __syncthreads();
          }
        }

        // the last iterate to the destination; the tile-edge columns into
        // the neighbouring tiles' halo buffers (K1's push)
        const bool last = it == J - 1;
        for (int q = tid; q < nl * nw; q += nt) {
          const int r = lo + q / nw, p = q % nw, w = w0 + p;
          const T o = sm.newl[r * tmax + p];
          if (last) __stcg(dst + fidx(g + r, w), o);
          if (p < 2 || p >= nw - 2) {
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
                cluster.map_shared_rank(sm.halo, r2)[(par * NB + r) * 4 + h] = o;
            }
          }
        }
        cluster.sync();

        // the new iterate into the ring: this tile's points and the
        // neighbours' tile-edge columns
        for (int k = tid; k < nl * bwt; k += nt) {
          const int r = lo + k / bwt, j = k % bwt;
          T v;
          if (j >= 2 && j < nw + 2) {
            v = sm.newl[r * tmax + j - 2];
          } else {
            const int w = w0 - 2 + j;
            v = (w >= 0 && w < W)
                    ? sm.halo[(par * NB + r) * 4 + (j < 2 ? j : j - nw)]
                    : T(kINF);
          }
          put_row(g + r, j, v);
        }
        par ^= 1;
        __syncthreads();
      }
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

template <typename T, int G, int OP>
int launch_forms_g(const FormArgs<T>& a, int B, int nt, size_t smem,
                   cudaStream_t st) {
  auto kern = sweep_forms_kernel<T, G, OP>;
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

template <typename T, int G>
int launch_forms_op(const FormArgs<T>& a, int op, int B, int nt, size_t smem,
                    cudaStream_t st) {
  if (op == kOpFull) return launch_forms_g<T, G, kOpFull>(a, B, nt, smem, st);
  if (op == kOpFdOnly)
    return launch_forms_g<T, G, kOpFdOnly>(a, B, nt, smem, st);
  if (op == kOpFdFree)
    return launch_forms_g<T, G, kOpFdFree>(a, B, nt, smem, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_forms(const void* tt_in, void* tt_out, void* scratch,
                 const void* fixed, const void* mats, const void* mats_t,
                 long long mats_bstride, const void* tab, int M,
                 const void* col_mode, const void* col_const, int has_stif,
                 double dnx, const void* replace, const void* active,
                 void* delta, void* scale, int B, int Z, int X, int C, int G,
                 int op, int nb, int iters, void* stream) {
  if (B <= 0 || Z <= 0 || X <= 0 || C < 1 || C > kMaxCluster || nb < 1
      || iters < 1)
    return (int)cudaErrorInvalidValue;
  FormArgs<T> a;
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
  a.nb = nb;
  a.iters = iters;
  const int tmax = a.tile_z > a.tile_x ? a.tile_z : a.tile_x;
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  // as many of the block's lines a candidate round as fit
  int rl = nb;
  while (rl > 1 && forms_smem_bytes<T>(tmax, nb, rl) > (size_t)limit) --rl;
  const size_t smem = forms_smem_bytes<T>(tmax, nb, rl);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  a.rl = rl;
  int nt = ((rl * tmax * G + 31) / 32) * 32;
  nt = nt > kMaxThreads ? kMaxThreads : nt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G == 4) return launch_forms_op<T, 4>(a, op, B, nt, smem, st);
  if (G == 8) return launch_forms_op<T, 8>(a, op, B, nt, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One pass of a form for B sources with clusters of C CTAs and G lanes
// per point: op 0 the full operator, 1 FD-only, 2 FD-free; nb lines a
// block and iters iterations a block (1 and 1: the strict order).
// Returns the CUDA error of the attribute set or the launch.
int alifmm_sweep_forms_f32(const void* tt_in, void* tt_out, void* scratch,
                           const void* fixed, const void* mats,
                           const void* mats_t, long long mats_bstride,
                           const void* tab, int M, const void* col_mode,
                           const void* col_const, int has_stif, double dnx,
                           const void* replace, const void* active,
                           void* delta, void* scale, int B, int Z, int X,
                           int C, int G, int op, int nb, int iters,
                           void* stream) {
  return launch_forms<float>(tt_in, tt_out, scratch, fixed, mats, mats_t,
                             mats_bstride, tab, M, col_mode, col_const,
                             has_stif, dnx, replace, active, delta, scale, B,
                             Z, X, C, G, op, nb, iters, stream);
}

int alifmm_sweep_forms_f64(const void* tt_in, void* tt_out, void* scratch,
                           const void* fixed, const void* mats,
                           const void* mats_t, long long mats_bstride,
                           const void* tab, int M, const void* col_mode,
                           const void* col_const, int has_stif, double dnx,
                           const void* replace, const void* active,
                           void* delta, void* scale, int B, int Z, int X,
                           int C, int G, int op, int nb, int iters,
                           void* stream) {
  return launch_forms<double>(tt_in, tt_out, scratch, fixed, mats, mats_t,
                              mats_bstride, tab, M, col_mode, col_const,
                              has_stif, dnx, replace, active, delta, scale,
                              B, Z, X, C, G, op, nb, iters, stream);
}

}  // extern "C"
