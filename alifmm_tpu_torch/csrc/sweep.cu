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
// The per-point device functions (the stencil tables, candidates,
// finish) are in sweep_device.cuh, which K1's other forms
// (sweep_forms.cu: the FD-only and FD-free operators, the
// parallel-in-block sweeps) include too.  K5, the slab sweep of the halo
// solves, follows K1 in this file and shares those functions and K1's
// line step (see its own note below).

#include "sweep_device.cuh"

namespace {

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
