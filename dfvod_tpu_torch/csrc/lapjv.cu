// Exact linear sum assignment (shortest augmenting path, Jonker-Volgenant)
// for Hopper (sm_90a): the matcher of every train step.
//
// Replaces dfvod_tpu/models/matcher.py::hungarian_lapjv (line 79), the JAX
// package's default matcher. That is no Pallas kernel: it is XLA
// while_loops vmapped over the batch, one device program. Written as plain
// PyTorch on CUDA tensors, every loop condition would read a device scalar,
// one host sync per Dijkstra step; no PyTorch call computes an assignment.
// So on the card the function exists only as this kernel.
//
// What it computes: hungarian_lapjv phase for phase, so the result is the
// JAX function's index in every slot (ops/lapjv.py::lapjv_plain is the same
// algorithm in PyTorch). Problem p has Q columns (queries) and T rows
// (target slots); cost is (P, Q, T) f32 with NaN / inf already replaced,
// valid (P, T) bool. Row i's cost is cost[p, :, i] if valid[p, i], else 0.
// For each row cur in 0..T-1, invalid rows too:
// - Dijkstra from cur: with i = cur, min_val = 0, repeat: scan row i;
//   r = ((min_val + C[i][j]) - u[i]) - v[j] in f32, in that order, for each
//   unscanned column j; where r < shortest[j], shortest[j] = r and
//   pred[j] = i; j* = the unscanned column of least shortest, the lowest
//   index on ties (jnp.argmin; scanned columns count as +inf); min_val =
//   shortest[j*]; scan j*; if no row owns j*, it is the sink, else i = its
//   owner.
// - Dual updates: u[cur] += min_val; u[r] += min_val - shortest[col4row[r]]
//   for the other scanned rows; v[j] -= min_val - shortest[j] for the
//   scanned columns.
// - Augment from the sink back to cur along pred.
// Each step scans a new column and only the T rows own columns, so a phase
// ends within T + 1 steps whatever the rounding. The kernel stops a phase
// (and an augmentation) there and writes -1 into every slot of that
// problem, so the caller's gather fails and nothing loops forever.
//
// What bounds it: bytes give one read of the costs (P * Q * T * 4 bytes;
// 77 KB a problem at Q = 300, T = 64), microseconds at 3.35 TB/s. The
// serial floor is far above that: T phases of a few to T + 1 Dijkstra
// steps each (with T = 64 padded slots and a few valid ones, about T^2 / 2
// steps a problem, since the invalid rows' zero costs tie), each step an
// argmin over the problem's columns whose winner decides the next step's
// row. So the design cuts the latency of a step, and spreads a problem's
// columns over as many SMs as keep that latency down.
//
// Design. A problem spans C CTAs (a thread-block cluster) of W
// warps; thread t of CTA c owns K adjacent columns, j = (c 32 W + t) K + k,
// so lanes, warps and CTAs hold ascending columns, and of those that hold
// the least distance the first holds the lowest column (jnp.argmin's tie
// rule without a second reduction). The plan (lapjv_plan) picks (C, W)
// from Q:
// - C = W = 1, a warp per problem (Q <= 512: the decoder layers' 300
//   queries). A step has no barrier: the lane's pass over its columns, an
//   in-register tree argmin, one redux.sync of the ordered value, a
//   ballot for the first lane that holds it and four shuffles of the
//   winner's fields. Three more warps help load the costs, then exit.
// - C * W > 1 (the two-stage proposals): each warp reduces its columns the
//   same way; the winning lane's 16-byte record (key, column, its owner
//   row, that row's u and cost slot, the column's pred) goes to a
//   double-buffered slot in every CTA of the cluster with st.async, which
//   completes 16 bytes of that CTA's mbarrier (a cluster of one CTA where
//   C = 1); then one wait a step, on the CTA's own mbarrier; then every warp
//   reduces the C * W records itself from its own shared memory. No thread
//   walks the winners serially, there is no second barrier, and no
//   barrier.cluster in the loop (its release is a GPU-wide fence).
// - A column's v, shortest, pred and scanned flag live in its owner
//   thread's registers (K, the columns a thread, is a template parameter;
//   a step updates them with selects, not branches); row4col in the owning
//   CTA's shared memory. The T-long state (u,
//   col4row, each row's cost slot, the pred of the column a row owns, the
//   phase's list of scanned rows and their distances) is kept in identical
//   copies in every CTA: every CTA knows each step's winner, so each
//   updates the duals and walks the augmenting path itself (writing
//   row4col only for its own columns), with no remote read.
// - Costs on the chip: at the start, each CTA loads its columns of the
//   problem's valid rows, in valid order, from the (Q, T) input into shared
//   memory, column k of thread t at k 32 W + t (a warp's loads hit 32
//   banks; rows padded to an odd stride, so the transposing writes do
//   too). Invalid rows read no memory: a step on one adds + 0.0f. Valid
//   rows beyond what shared memory holds (all 64 valid at 26,150 queries)
//   go to the problem's slice of a global scratch in the same layout;
//   lapjv_plan sizes it (0 where every row fits).
//
// Plain C interface, loaded with ctypes; see dfvod_tpu_torch/ops/lapjv.py.

#include <cstdint>
#include <math_constants.h>

namespace {

constexpr int kMaxWarps = 8;        // warps a CTA solves with (C * W > 1)
constexpr int kLoadWarps = 4;       // warps a CTA loads with (C = W = 1)
constexpr int kMaxCluster = 16;

// the columns a thread that each instantiation takes (the plan rounds up)
constexpr int kWarpK[] = {1, 2, 4, 6, 8, 10, 12, 16};
constexpr int kMultiK[] = {2, 4, 6, 8, 12, 16, 24, 32};

// f32 to an unsigned key of the same order; -0 counts as +0, as < does
__device__ __forceinline__ uint32_t fkey(float f) {
  const uint32_t b = __float_as_uint(f + 0.0f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float fval(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

struct __align__(8) RowInfo {
  float u;
  int slot;     // the row's cost slot: -1 invalid, < rows in shared memory
};

struct Layout {   // byte offsets in dynamic shared memory, the same per CTA
  int mbar, rowinfo, col4row, prow, list_mv, list_owner, list_pred, flag,
      rec, r4c, costs, fixed;
};

__host__ __device__ inline int a16(int b) { return (b + 15) & ~15; }

// two mbarriers, T-long state, 2 * N records (a uint4 each), Lc local
// columns' row4col, then the cost rows
__host__ __device__ inline Layout layout(int T, int N, int Lc) {
  Layout L;
  int o = 0;
  L.mbar = o;       o = a16(o + 16);
  L.rowinfo = o;    o = a16(o + 8 * T);
  L.col4row = o;    o = a16(o + 4 * T);
  L.prow = o;       o = a16(o + 4 * T);
  L.list_mv = o;    o = a16(o + 4 * (T + 2));
  L.list_owner = o; o = a16(o + 4 * (T + 2));
  L.list_pred = o;  o = a16(o + 4 * (T + 2));
  L.flag = o;       o = a16(o + 4);
  L.rec = o;        o = a16(o + 2 * N * 16);
  L.r4c = o;        o = a16(o + 2 * Lc);
  L.costs = o;
  L.fixed = o;
  return L;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(mbar)
               : "memory");
}

// the one local arrival of a phase, expecting ``bytes`` of st.async
__device__ __forceinline__ void mbar_expect(uint32_t mbar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(mbar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t mbar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.b32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(mbar), "r"(parity) : "memory");
  }
}

// a 16-byte record into CTA ``rank``'s slot, completing 16 bytes of its
// mbarrier's phase
__device__ __forceinline__ void store_async(uint32_t slot, uint32_t mbar,
                                            int rank, uint4 a) {
  uint32_t rs, rm;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rs) : "r"(slot), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rm) : "r"(mbar), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];"
      :: "r"(rs), "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(rm)
      : "memory");
}

// Scan row i over the thread's columns (kSrc: 0 an invalid row, whose
// ((min_val + 0.0f) - u[i]) is the same for every column; 1 a row at crow
// in shared memory; 2 a row at crow in the scratch; both K * step long, so
// every load is issued before the first use), with selects only (a branch
// per column would diverge), then the tree argmin of the masked distances
// (scanned and padding columns +inf); returns the least, its k in *bk and
// its column's pred in *bp.
template <int K, int kSrc>
__device__ __forceinline__ float scan(const float* crow, int step,
                                      uint32_t scanned, float min_val,
                                      float ui, int i, float (&v)[K],
                                      float (&sh)[K], int (&pred)[K],
                                      int* bk, int* bp) {
  float c[K];
#pragma unroll
  for (int k = 0; k < K; ++k) c[k] = kSrc == 0 ? 0.0f : crow[k * step];
  const float a0 = (min_val + 0.0f) - ui;
  float x[K];
  int idx[K], pr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float r = kSrc == 0 ? a0 - v[k] : ((min_val + c[k]) - ui) - v[k];
    const bool done = (scanned >> k) & 1u;
    const bool upd = !done && r < sh[k];
    sh[k] = upd ? r : sh[k];
    pred[k] = upd ? i : pred[k];
    x[k] = done ? CUDART_INF_F : sh[k];
    idx[k] = k;
    pr[k] = pred[k];
  }
  // the lower k (the lower column) stays on the left: ties keep it
#pragma unroll
  for (int s = 1; s < K; s <<= 1) {
#pragma unroll
    for (int k = 0; k + s < K; k += 2 * s) {
      const bool right = x[k + s] < x[k];
      x[k] = right ? x[k + s] : x[k];
      idx[k] = right ? idx[k + s] : idx[k];
      pr[k] = right ? pr[k + s] : pr[k];
    }
  }
  *bk = idx[0];
  *bp = pr[0];
  return x[0];
}

// K: the columns a thread (registers); kMulti: C * W > 1 (records and a
// barrier a step) rather than a warp per problem.
template <int K, bool kMulti>
__global__ void __launch_bounds__(kMulti ? 32 * kMaxWarps : 32 * kLoadWarps)
lapjv_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ valid,
             float* __restrict__ scratch, int64_t* __restrict__ out, int Q,
             int T, int C, int lg_c, int W, int lg_nthr, int rows_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = 32 * W;        // the threads that own columns
  const int c = kMulti ? (int)(blockIdx.x & (C - 1)) : 0;
  const int p = kMulti ? (int)(blockIdx.x >> lg_c) : (int)blockIdx.x;
  const int N = C * W;
  const int Lc = K * nthr;
  const int stride = Lc + 1;      // odd: a column of rows spans 32 banks
  const Layout L = layout(T, N, Lc);
  RowInfo* rowinfo = reinterpret_cast<RowInfo*>(smem + L.rowinfo);
  int* col4row = reinterpret_cast<int*>(smem + L.col4row);
  int* prow = reinterpret_cast<int*>(smem + L.prow);
  float* list_mv = reinterpret_cast<float*>(smem + L.list_mv);
  int* list_owner = reinterpret_cast<int*>(smem + L.list_owner);
  int* list_pred = reinterpret_cast<int*>(smem + L.list_pred);
  int* flag = reinterpret_cast<int*>(smem + L.flag);
  uint4* rec = reinterpret_cast<uint4*>(smem + L.rec);   // [2][N]
  const uint32_t mbar0 = smem_addr(smem + L.mbar);      // + 8 * buffer
  int16_t* r4c = reinterpret_cast<int16_t*>(smem + L.r4c);
  float* costs = reinterpret_cast<float*>(smem + L.costs);
  const int rows_g = T - rows_s;
  float* gscr = scratch + ((size_t)p * C + c) * (size_t)(rows_g > 0 ? rows_g : 0)
                              * Lc;

  // each row's cost slot: its rank among the valid rows
  if (warp == 0) {
    int base = 0;
    for (int r0 = 0; r0 < T; r0 += 32) {
      const int r = r0 + lane;
      const bool ok = r < T && valid[(size_t)p * T + r];
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (r < T) {
        rowinfo[r].u = 0.f;
        rowinfo[r].slot = ok ? base + __popc(m & ((1u << lane) - 1u)) : -1;
        col4row[r] = -1;
      }
      base += __popc(m);
    }
  }
  for (int l = tid; l < Lc; l += blockDim.x) r4c[l] = -1;
  if (tid == 0) {
    *flag = 0;
    if (kMulti) {
      mbar_init(mbar0);
      mbar_init(mbar0 + 8);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      mbar_expect(mbar0, 16 * N);
      mbar_expect(mbar0 + 8, 16 * N);
    }
  }
  __syncthreads();

  // this CTA's columns of the valid rows, (Q, T) -> slot-major rows; kU
  // loads in flight a thread
  {
    constexpr int kU = 8;
    const float* cp = cost + (size_t)p * Q * T;
    const int n = Lc * T, bd = blockDim.x;
    for (int e0 = tid; e0 < n; e0 += kU * bd) {
      float x[kU];
      int l[kU], s[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = e0 + u * bd;
        const int le = e / T, t = e - le * T;   // le: the CTA's le-th column
        const int th = le / K;                   // the thread that owns it
        l[u] = (le - th * K) * nthr + th;
        s[u] = e < n ? rowinfo[t].slot : -1;
        const int j = c * Lc + le;
        x[u] = s[u] >= 0 && j < Q ? cp[(size_t)j * T + t] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (s[u] < 0) continue;
        if (s[u] < rows_s)
          costs[s[u] * stride + l[u]] = x[u];
        else
          gscr[(size_t)(s[u] - rows_s) * Lc + l[u]] = x[u];
      }
    }
  }
  __syncthreads();
  if (!kMulti && warp != 0) return;      // the loading warps are done
  // every CTA runs and its mbarriers are set: remote stores may start
  if (kMulti) cluster_sync();

  // this thread's columns: j = g K + k for its index g in the cluster,
  // at k nthr + tid in the CTA's rows and row4col; the padding columns
  // (j >= Q) count as scanned in every phase
  const int g = c * nthr + tid;
  uint32_t pad = 0;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (g * K + k >= Q) pad |= 1u << k;
  float v[K], sh[K];
  int pred[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = 0.f;

  bool failed = false;
  int buf = 0;
  uint32_t parity = 0;    // bit b: the phase parity of buffer b's mbarrier
  for (int cur = 0; cur < T && !failed; ++cur) {
    uint32_t scanned = pad;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      sh[k] = CUDART_INF_F;
      pred[k] = 0;
    }
    RowInfo ri = rowinfo[cur];
    int i = cur, n = 0, sink = -1;
    float min_val = 0.f;
    for (; n <= T; ++n) {
      int bk, bp;
      float best;
      if (ri.slot < 0) {
        best = scan<K, 0>(nullptr, nthr, scanned, min_val, ri.u, i, v, sh,
                          pred, &bk, &bp);
      } else if (ri.slot < rows_s) {
        best = scan<K, 1>(costs + ri.slot * stride + tid, nthr, scanned,
                          min_val, ri.u, i, v, sh, pred, &bk, &bp);
      } else {
        best = scan<K, 2>(gscr + (size_t)(ri.slot - rows_s) * Lc + tid, nthr,
                          scanned, min_val, ri.u, i, v, sh, pred, &bk, &bp);
      }
      // the lane's best column and, looked up while the warp reduces, its
      // (owner row, pred) and that row's u and slot
      const uint32_t bkey = fkey(best);
      const uint32_t bj = (uint32_t)(g * K + bk);
      const int bo = r4c[bk * nthr + tid];
      uint32_t bop = (uint32_t)(uint16_t)bo | ((uint32_t)bp << 16);
      RowInfo bri = rowinfo[max(bo, 0)];
      // lanes hold ascending columns, so of the lanes that hold the least
      // key the first holds the lowest column
      uint32_t kmin = __reduce_min_sync(0xffffffffu, bkey);
      int wl = __ffs(__ballot_sync(~0u, bkey == kmin)) - 1;
      uint32_t jmin = __shfl_sync(~0u, bj, wl);
      if (kMulti) {
        // this warp's winner as a 16-byte record (key, column | slot + 1
        // above bit 17, owner | pred << 16, u) in every CTA of the cluster
        const uint4 ra = make_uint4(
            kmin, jmin | ((uint32_t)(__shfl_sync(~0u, bri.slot, wl) + 1) << 17),
            __shfl_sync(~0u, bop, wl),
            __float_as_uint(__shfl_sync(~0u, bri.u, wl)));
        uint4* slot = rec + buf * N + c * W + warp;
        const uint32_t mbar = mbar0 + 8 * buf;
        if (lane < C) store_async(smem_addr(slot), mbar, lane, ra);
        mbar_wait(mbar, (parity >> buf) & 1u);
        parity ^= 1u << buf;
        // every warp reduces the C * W records itself, which hold
        // ascending columns: lane l the records l R .. l R + R - 1 (a
        // repeated last record changes no minimum), the first least key
        uint32_t mk = 0xffffffffu;
        uint4 mr = make_uint4(0u, 0u, 0u, 0u);
        const int R = (N + 31) >> 5;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q < R) {
            const uint4 xr = rec[buf * N + min(lane * R + q, N - 1)];
            const bool take = xr.x < mk;
            mk = take ? xr.x : mk;
            mr = take ? xr : mr;
          }
        }
        if (tid == 0) mbar_expect(mbar, 16 * N);   // the next phase
        buf ^= 1;
        kmin = __reduce_min_sync(0xffffffffu, mk);
        wl = __ffs(__ballot_sync(~0u, mk == kmin)) - 1;
        jmin = __shfl_sync(~0u, mr.y & 0x1ffffu, wl);
        bop = mr.z;
        bri.slot = (int)(mr.y >> 17) - 1;
        bri.u = __uint_as_float(mr.w);
      }
      const uint32_t op = __shfl_sync(~0u, bop, wl);
      const int owner = (int16_t)(op & 0xffffu);
      ri.slot = __shfl_sync(~0u, bri.slot, wl);
      ri.u = __shfl_sync(~0u, bri.u, wl);
      min_val = fval(kmin);
      // the owner of j* marks it scanned
      const int gj = (int)jmin / K;
      if (gj == g) scanned |= 1u << ((int)jmin - gj * K);
      if (tid == 0) {
        list_mv[n] = min_val;
        list_owner[n] = owner;
        list_pred[n] = (int16_t)(op >> 16);
      }
      if (owner < 0) {
        sink = (int)jmin;
        break;
      }
      i = owner;
    }
    if (sink < 0) {     // uniform: every thread saw the same winners
      failed = true;
      break;
    }
    if (kMulti) __syncthreads(); else __syncwarp();

    // dual updates: the scanned rows in step order (distinct rows)
    for (int m = tid; m <= n; m += nthr) {
      if (m == 0) {
        rowinfo[cur].u = rowinfo[cur].u + min_val;
      } else {
        const int r = list_owner[m - 1];
        rowinfo[r].u = rowinfo[r].u + (min_val - list_mv[m - 1]);
        prow[r] = list_pred[m - 1];    // pred of the column r owns
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (((scanned & ~pad) >> k) & 1u) v[k] = v[k] - (min_val - sh[k]);
    if (kMulti) __syncthreads(); else __syncwarp();

    // augment along the alternating path back from the sink: every CTA
    // walks it, writing row4col of its own columns
    if (tid == 0) {
      int j = sink, pj = list_pred[n], hops = 0;
      for (; hops <= T; ++hops) {
        const int r = pj;
        const int gj = j / K;
        if ((gj >> lg_nthr) == c)
          r4c[(j - gj * K) * nthr + (gj & (nthr - 1))] = (int16_t)r;
        const int next = col4row[r];
        col4row[r] = j;
        if (r == cur) break;
        pj = prow[r];
        j = next;
      }
      if (hops > T) *flag = 1;
    }
    if (kMulti) __syncthreads(); else __syncwarp();
    failed = *flag != 0;
  }
  if (kMulti) __syncthreads(); else __syncwarp();
  if (c == 0)
    for (int r = tid; r < T; r += nthr)
      out[(size_t)p * T + r] = failed ? -1 : col4row[r];
  if (kMulti) cluster_sync();   // no CTA leaves while others run
}

typedef void (*KernelFn)(const float*, const uint8_t*, float*, int64_t*, int,
                         int, int, int, int, int, int);

template <bool kMulti>
KernelFn kernel_for(int K) {
  switch (K) {
    case 1: return kMulti ? nullptr : lapjv_kernel<1, false>;
    case 2: return lapjv_kernel<2, kMulti>;
    case 4: return lapjv_kernel<4, kMulti>;
    case 6: return lapjv_kernel<6, kMulti>;
    case 8: return lapjv_kernel<8, kMulti>;
    case 10: return kMulti ? nullptr : lapjv_kernel<10, false>;
    case 12: return lapjv_kernel<12, kMulti>;
    case 16: return lapjv_kernel<16, kMulti>;
    case 24: return kMulti ? lapjv_kernel<24, true> : nullptr;
    case 32: return kMulti ? lapjv_kernel<32, true> : nullptr;
    default: return nullptr;
  }
}

int log2_exact(int x) {
  int lg = 0;
  while ((1 << lg) < x) ++lg;
  return (1 << lg) == x ? lg : -1;
}

struct Plan {
  int C, W, Kn, K, rows_s, smem, clusters;
  size_t scratch;
  KernelFn fn;
};

// The default (C, W) for Q queries, chosen from the times of every plan at
// the paths' shapes on an H100 (PERF.md §6, the LAPJV rows): a warp per
// problem up to 512 queries (every plan with a barrier a step was slower
// at 300), 8 CTAs of 4 warps up to 4,096 (a warp cannot hold 1,900 columns
// in registers), 16 CTAs of 4 warps beyond, and 16 of 8 past 65,536
// (untimed: 16 x 4 would need more than 32 columns a thread). To re-time
// every plan after a change to the kernel, call chip_smoke.lapjv_plan_sweep()
// on the card after chip_smoke.build_kernels(("lapjv",)).
void default_cw(int Q, int* C, int* W) {
  if (Q <= 512) {
    *C = 1; *W = 1;
  } else if (Q <= 4096) {
    *C = 8; *W = 4;
  } else if (Q <= 65536) {
    *C = 16; *W = 4;
  } else {
    *C = 16; *W = 8;
  }
}

// 0 and *pl, or a refusal: -1 a shape it does not take, -2 a T whose row
// state exceeds a CTA's shared memory, -3 a (C, W) it has no kernel for,
// -4 a cluster the card cannot place; > 0 a CUDA error.
int make_plan(int P, int Q, int T, int C, int W, Plan* pl) {
  if (P < 0 || Q < 1 || T < 0 || T > Q || T > 32767) return -1;
  if (C == 0 && W == 0) default_cw(Q, &C, &W);
  const int lg_c = log2_exact(C), lg_w = log2_exact(W);
  if (lg_c < 0 || lg_w < 0 || C > kMaxCluster || W > kMaxWarps) return -3;
  const bool multi = C * W > 1;
  const int nthr = 32 * W;
  const int Kn = (Q + nthr * C - 1) / (nthr * C);
  int K = 0;
  const int* ks = multi ? kMultiK : kWarpK;
  for (int a = 0; a < 8 && !K; ++a)
    if (ks[a] >= Kn) K = ks[a];
  if (!K) return Kn > 32 ? -1 : -3;
  pl->C = C;
  pl->W = W;
  pl->Kn = Kn;
  pl->K = K;
  pl->fn = multi ? kernel_for<true>(K) : kernel_for<false>(K);
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int Lc = K * nthr;   // a row's columns: the kernel reads K a thread
  const Layout L = layout(T, C * W, Lc);
  if (L.fixed > max_optin) return -2;
  const long row_bytes = 4L * (Lc + 1);
  long rows = (max_optin - L.fixed) / row_bytes;
  if (rows > T) rows = T;
  pl->rows_s = (int)rows;
  pl->smem = L.fixed + (int)(rows * row_bytes);
  pl->scratch = (size_t)P * C * (size_t)(T - rows) * Lc * sizeof(float);
  pl->clusters = 0;
  // the card's cap, not this plan's bytes: a plan made later for the same
  // kernel then never lowers what an earlier (cached) plan launches with
  err = cudaFuncSetAttribute(pl->fn,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_optin);
  if (err != cudaSuccess) return (int)err;
  if (multi) {
    if (C > 8) {
      err = cudaFuncSetAttribute(
          pl->fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
    }
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(nthr);
    cfg.dynamicSmemBytes = pl->smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&pl->clusters, pl->fn, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (pl->clusters < 1) return -4;
  }
  return 0;
}

}  // namespace

// The plan for P problems of Q queries and T slots; C = W = 0 asks for the
// default. plan[0..7]: C, W, the columns a thread (Kn) and the kernel's K,
// the rows held in shared memory, shared memory bytes a CTA, the clusters
// the card can hold at once (0 for a warp per problem) and the bytes of
// the global scratch that ``lapjv`` takes (the valid rows beyond those
// shared memory holds, for every CTA). Returns 0 or make_plan's code.
// It also sets the kernel's attributes on the current device, so a plan is
// made on the device it launches on, before its first launch.
extern "C" int lapjv_plan(int P, int Q, int T, int C, int W, int64_t* plan) {
  Plan pl;
  const int rc = make_plan(P, Q, T, C, W, &pl);
  if (rc != 0) return rc;
  plan[0] = pl.C;
  plan[1] = pl.W;
  plan[2] = pl.Kn;
  plan[3] = pl.K;
  plan[4] = pl.rows_s;
  plan[5] = pl.smem;
  plan[6] = pl.clusters;
  plan[7] = (int64_t)pl.scratch;
  return 0;
}

// cost (P, Q, T) f32 and valid (P, T) bool, contiguous; scratch of the
// plan's bytes, 16-aligned; out (P, T) int64; C, W, K, rows_s and smem as
// lapjv_plan gave them for this P, Q, T on this device. Returns 0, a CUDA
// error code (> 0) from the launch, or -3 for a K with no kernel.
extern "C" int lapjv(const void* cost, const void* valid, void* scratch,
                     void* out, int P, int Q, int T, int C, int W, int K,
                     int rows_s, int smem, void* stream) {
  const bool multi = C * W > 1;
  const KernelFn fn = multi ? kernel_for<true>(K) : kernel_for<false>(K);
  const int lg_c = log2_exact(C), lg_nthr = log2_exact(32 * W);
  if (!fn || lg_c < 0 || lg_nthr < 0) return -3;
  if (P == 0 || T == 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)P * C);
  cfg.blockDim = dim3(multi ? 32 * W : 32 * kLoadWarps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = multi ? 1 : 0;   // C * W > 1: a cluster, of 1 CTA too
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, fn, static_cast<const float*>(cost),
      static_cast<const uint8_t*>(valid), static_cast<float*>(scratch),
      static_cast<int64_t*>(out), Q, T, C, lg_c, W, lg_nthr, rows_s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* lapjv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
