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
// Design: one block per problem, up to 1024 threads, thread t owning the
// columns t, t + blockDim, ... The T-long state (u, col4row, the scanned
// rows) lives in shared memory. The Q-long state (v and shortest f32, pred
// and row4col int16, the scanned flags: 13 bytes a column) lives there too
// where it fits beside it (Q up to ~17,800 at T = 64 on an H100: 154 KB at
// the 4-level two-stage encoder's 11,875 proposals of a 608 x 800 batch),
// else in the problem's slice of a global scratch (the same kernel,
// instantiated with kGlobal: 26,150 proposals at 800 x 1333, the CLI's
// largest batch), where it is read mostly from L1. A column's state is
// read and written only by its owner thread, except row4col[j*] (read by
// all, written by the augmentation between barriers) and shortest at the
// scanned rows' columns (read by the dual update after a barrier);
// __syncthreads orders shared and global memory alike within the block. A
// step is the owner threads' pass over their columns, a warp-shuffle
// (value, index) argmin, one __syncthreads, and every thread reducing the
// warps' winners itself from a double-buffered slot; the augmentation is
// serial on thread 0.
// The block first transposes its problem into a (T, Q) scratch in global
// memory (32 x 33 tiles in shared memory, a tile per warp; invalid rows
// written as 0), so a step reads its row as Q contiguous floats, mostly
// from L2.
//
// What bounds it: bytes give one read of the costs (P * Q * T * 4 bytes;
// 55 KB per image at Q = 300, T = 64), microseconds at 3.35 TB/s. The
// serial floor is far above that: T phases of a few to T + 1 Dijkstra
// steps each (with T = 64 padded slots and a few valid ones, about T^2 / 2
// steps per problem, since the invalid rows' zero costs tie), each step a
// block-wide reduction and barrier. The problems run in parallel, one per
// SM. PERF.md has the measured times beside the bound.
//
// Plain C interface, loaded with ctypes; see dfvod_tpu_torch/ops/lapjv.py.

#include <cstdint>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kTile = 32;

struct State {
  // T-long, in shared memory
  float* u;
  int* col4row;
  float* red_val;    // [2][32]
  int* red_idx;      // [2][32]
  int* flag;
  uint8_t* scanned_row;
  // Q-long, in shared or in global memory
  float* v;
  float* shortest;
  int16_t* pred;
  int16_t* row4col;
  uint8_t* scanned_col;
};

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) / 16 * 16;
}

// bytes of the T-long state: u, col4row, the reduction's slots, the flag,
// the scanned rows
__host__ __device__ inline size_t rows_bytes(int T) {
  return align16(9 * (size_t)T + 2 * 32 * 8 + 4);
}

// bytes of the Q-long state: v, shortest, pred, row4col, the scanned
// columns
__host__ __device__ inline size_t cols_bytes(int Q) {
  return align16(13 * (size_t)Q);
}

__host__ __device__ inline size_t tile_bytes(int threads) {
  return (size_t)(threads / 32) * kTile * (kTile + 1) * sizeof(float);
}

// the transposed costs' bytes in the scratch; the Q-long states follow
__host__ __device__ inline size_t ct_bytes(int P, int Q, int T) {
  return align16((size_t)P * T * Q * sizeof(float));
}

__device__ inline State state_at(unsigned char* rows, unsigned char* cols,
                                 int Q, int T) {
  State s;
  s.u = reinterpret_cast<float*>(rows);
  s.col4row = reinterpret_cast<int*>(s.u + T);
  s.red_val = reinterpret_cast<float*>(s.col4row + T);
  s.red_idx = reinterpret_cast<int*>(s.red_val + 64);
  s.flag = s.red_idx + 64;
  s.scanned_row = reinterpret_cast<uint8_t*>(s.flag + 1);
  s.v = reinterpret_cast<float*>(cols);
  s.shortest = s.v + Q;
  s.pred = reinterpret_cast<int16_t*>(s.shortest + Q);
  s.row4col = s.pred + Q;
  s.scanned_col = reinterpret_cast<uint8_t*>(s.row4col + Q);
  return s;
}

// (value, index) that wins: the smaller value, the lower index on ties.
__device__ inline bool better(float a, int ai, float b, int bi) {
  return a < b || (a == b && ai < bi);
}

// kGlobal: the Q-long state in the problem's slice of ``cols`` (global)
// instead of shared memory after the T-long state.
template <bool kGlobal>
__global__ void __launch_bounds__(kMaxThreads)
lapjv_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ valid,
             float* ct, unsigned char* cols, int64_t* __restrict__ out, int Q,
             int T) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = blockIdx.x;
  const int tid = threadIdx.x, bd = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = bd >> 5;
  const float* cp = cost + (size_t)p * Q * T;
  const uint8_t* vp = valid + (size_t)p * T;
  float* ctp = ct + (size_t)p * T * Q;

  // transpose (Q, T) -> (T, Q), a 32 x 32 tile per warp at a time
  {
    float* tile = reinterpret_cast<float*>(smem) + warp * kTile * (kTile + 1);
    const int nq = (Q + kTile - 1) / kTile, nt = (T + kTile - 1) / kTile;
    for (int tt = warp; tt < nq * nt; tt += nwarps) {
      const int q0 = (tt / nt) * kTile, t0 = (tt % nt) * kTile;
      for (int k = 0; k < kTile; ++k) {
        const int q = q0 + k, t = t0 + lane;
        tile[k * (kTile + 1) + lane] =
            (q < Q && t < T) ? cp[(size_t)q * T + t] : 0.f;
      }
      __syncwarp();
      for (int k = 0; k < kTile; ++k) {
        const int t = t0 + k, q = q0 + lane;
        if (t < T && q < Q)
          ctp[(size_t)t * Q + q] = vp[t] ? tile[lane * (kTile + 1) + k] : 0.f;
      }
      __syncwarp();
    }
  }
  __syncthreads();   // the tiles are done with; ctp is visible to the block

  State s = state_at(
      smem, kGlobal ? cols + (size_t)p * cols_bytes(Q) : smem + rows_bytes(T),
      Q, T);
  for (int j = tid; j < Q; j += bd) {
    s.v[j] = 0.f;
    s.row4col[j] = -1;
  }
  for (int r = tid; r < T; r += bd) {
    s.u[r] = 0.f;
    s.col4row[r] = -1;
  }
  if (tid == 0) *s.flag = 0;

  bool failed = false;
  int buf = 0;
  for (int cur = 0; cur < T && !failed; ++cur) {
    for (int j = tid; j < Q; j += bd) {
      s.shortest[j] = CUDART_INF_F;
      s.pred[j] = 0;
      s.scanned_col[j] = 0;
    }
    for (int r = tid; r < T; r += bd) s.scanned_row[r] = 0;
    __syncthreads();

    int i = cur, sink = -1;
    float min_val = 0.f;
    for (int step = 0; step <= T; ++step) {
      if (tid == 0) s.scanned_row[i] = 1;
      const float* crow = ctp + (size_t)i * Q;
      const float ui = s.u[i];
      float best = CUDART_INF_F;
      int bidx = Q;
      for (int j = tid; j < Q; j += bd) {
        float cand = CUDART_INF_F;
        if (!s.scanned_col[j]) {
          const float r = ((min_val + crow[j]) - ui) - s.v[j];
          float sh = s.shortest[j];
          if (r < sh) {
            sh = r;
            s.shortest[j] = r;
            s.pred[j] = (int16_t)i;
          }
          cand = sh;
        }
        if (better(cand, j, best, bidx)) {
          best = cand;
          bidx = j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bidx, off);
        if (better(ov, oi, best, bidx)) {
          best = ov;
          bidx = oi;
        }
      }
      if (lane == 0) {
        s.red_val[buf * 32 + warp] = best;
        s.red_idx[buf * 32 + warp] = bidx;
      }
      __syncthreads();
      best = s.red_val[buf * 32];
      bidx = s.red_idx[buf * 32];
      for (int w = 1; w < nwarps; ++w) {
        const float ov = s.red_val[buf * 32 + w];
        const int oi = s.red_idx[buf * 32 + w];
        if (better(ov, oi, best, bidx)) {
          best = ov;
          bidx = oi;
        }
      }
      buf ^= 1;
      const int j = bidx;
      min_val = best;
      if (j % bd == tid) s.scanned_col[j] = 1;
      const int owner = s.row4col[j];
      if (owner < 0) {
        sink = j;
        break;
      }
      i = owner;
    }
    if (sink < 0) {     // uniform: every thread saw the same winners
      failed = true;
      break;
    }
    __syncthreads();

    // dual updates
    for (int r = tid; r < T; r += bd) {
      if (r == cur)
        s.u[r] = s.u[r] + min_val;
      else if (s.scanned_row[r])   // another scanned row owns a column
        s.u[r] = s.u[r] + (min_val - s.shortest[max(s.col4row[r], 0)]);
    }
    for (int j = tid; j < Q; j += bd)
      if (s.scanned_col[j]) s.v[j] = s.v[j] - (min_val - s.shortest[j]);
    __syncthreads();

    // augment along the alternating path back from the sink
    if (tid == 0) {
      int j = sink, n = 0;
      for (; n <= T; ++n) {
        const int r = s.pred[j];
        s.row4col[j] = (int16_t)r;
        const int next = s.col4row[r];
        s.col4row[r] = j;
        if (r == cur) break;
        j = next;
      }
      if (n > T) *s.flag = 1;
    }
    __syncthreads();
    failed = *s.flag != 0;
  }
  __syncthreads();
  for (int r = tid; r < T; r += bd)
    out[(size_t)p * T + r] = failed ? -1 : s.col4row[r];
}

}  // namespace

// Bytes of the global scratch that ``lapjv`` takes for P problems: the
// costs transposed to (P, T, Q) f32, then a Q-long state per problem.
extern "C" size_t lapjv_scratch_bytes(int P, int Q, int T) {
  if (P <= 0 || Q <= 0 || T <= 0) return 0;
  return ct_bytes(P, Q, T) + (size_t)P * cols_bytes(Q);
}

template <bool kGlobal>
static int launch(const void* cost, const void* valid, void* scratch,
                  void* out, int P, int Q, int T, int threads, size_t smem,
                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      lapjv_kernel<kGlobal>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  lapjv_kernel<kGlobal><<<P, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const uint8_t*>(valid),
      reinterpret_cast<float*>(base), base + ct_bytes(P, Q, T),
      static_cast<int64_t*>(out), Q, T);
  return (int)cudaGetLastError();
}

// cost (P, Q, T) f32 and valid (P, T) bool, contiguous; scratch
// lapjv_scratch_bytes(P, Q, T) bytes, 16-aligned; out (P, T) int64.
// Returns 0, a CUDA error code (> 0) from the launch, -1 for a shape the
// kernel does not take, -2 where the T-long state (or the transpose's
// tiles) exceeds the shared memory a block can opt in to. The Q-long state
// goes to shared memory where it fits beside the T-long state, else to the
// scratch.
extern "C" int lapjv(const void* cost, const void* valid, void* scratch,
                     void* out, int P, int Q, int T, void* stream) {
  if (P < 0 || Q < 1 || T < 0 || T > Q || T > 32767) return -1;
  if (P == 0 || T == 0) return 0;
  const int threads = Q >= kMaxThreads ? kMaxThreads : (Q + 31) / 32 * 32;
  const size_t tiles = tile_bytes(threads);
  int max_optin = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  size_t smem = rows_bytes(T) + cols_bytes(Q);
  if (tiles > smem) smem = tiles;
  if (smem <= (size_t)max_optin)
    return launch<false>(cost, valid, scratch, out, P, Q, T, threads, smem,
                         stream);
  smem = rows_bytes(T) > tiles ? rows_bytes(T) : tiles;
  if (smem > (size_t)max_optin) return -2;
  return launch<true>(cost, valid, scratch, out, P, Q, T, threads, smem,
                      stream);
}

extern "C" const char* lapjv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
