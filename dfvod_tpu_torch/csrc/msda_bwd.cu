// Multi-scale deformable attention (MSDA) backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of dfvod_tpu/ops/msda_pallas.py
// _msda_hat_bwd_mxu_kernel_factory (the default) and
// _msda_hat_bwd_kernel_factory (wrapper ms_deform_attn_pallas_hat_bwd):
// the VJP of msda_fwd.cu. For every sample point i = (b, q, m, l, p) at
// pixel coordinates px = loc_x * W_l - 0.5, py = loc_y * H_l - 0.5, with
// corners v00 v01 v10 v11 (zero outside the map), bilinear weights w_c and
// fx = px - floor(px), fy = py - floor(py):
//
//   grad_value[b, s_c, m, :] += attw_i * w_c * go[b, q, m, :]
//   grad_attw_i  = sum_d go_d * sum_c w_c * v_c,d
//   grad_loc_i.x = attw_i * W_l * sum_d go_d ((1-fy)(v01-v00) + fy(v11-v10))
//   grad_loc_i.y = attw_i * H_l * sum_d go_d ((1-fx)(v10-v00) + fx(v11-v01))
//
// The derivative at an integer px is therefore the one-sided difference
// [floor+1] - [floor], as in the TPU kernel (msda_pallas.py:754-757). A
// corner outside the map contributes nothing to any gradient, and a sample
// whose four corners all lie outside (a NaN or infinite coordinate
// included) gets exact zero gradients.
//
// The TPU kernel builds a dense (TQ, S) tent matrix and contracts it on the
// MXU because Mosaic had no fast gather or scatter. Hopper has both, so this
// kernel is the gather/scatter (col2im) form of the reference's CUDA
// extension instead.
//
// What bounds it. The least traffic is one read of value, go, loc and attw
// and one write of the three gradients: about 26 MB at the B=6 training
// encoder shape (Lq=S=1900, M=8, D=32, P=4, bf16 value and go, f32 loc and
// attw), about 8 us at 3.35 TB/s. The kernel moves far more: every sample
// point gathers 4 corner rows and adds 4 rows of f32 into grad_value by
// atomics (187 MB at that shape). A head's value and grad_value slabs
// (S x D) are shared by all queries of that head and stay in L2, where the
// atomics resolve, so the L2's rate of atomic sector requests sets the
// pace: grad_value alone takes most of the kernel's time.
//
// Design (the vector kernel; msda_common.cuh has the layout, Slots):
// - The warp layout of msda_fwd.cu: a slot of lanes, one 16-byte chunk of
//   the row each (4 lanes of 8 channels for bf16 at D = 32, 8 of 4 for
//   f32), holds one sample point; several points, and several queries of
//   one (b, m) where L * P is small, share a warp. Each lane loads its
//   chunk of the go row once, before the point loop; each slot computes its
//   corners once (msda_corners, the rounding of the plain version) and
//   gathers the 4 corner chunks together.
// - grad_value: 16-byte float4 atomicAdds (fire-and-forget REDs) into an
//   f32 buffer that the wrapper zeroes, then one cast pass when the value
//   is bf16; an f32 value accumulates in its gradient directly. For bf16 a
//   lane adds two 16-byte pieces laid so that the lanes of a slot cover
//   whole 32-byte sectors in each instruction: half the sector requests of
//   adding each lane's own 8 channels. The order of the additions changes
//   from run to run, so grad_value is not bitwise deterministic. A
//   deterministic reduction (a sort by token, or a segment pass per query)
//   costs an extra pass and is later work. Summing a (b, m) slab of 8
//   channels in shared memory first, then writing it once, was measured
//   and lost to the atomics (shared-memory f32 atomics, 192 blocks at the
//   encoder shape; PERF.md), and a TDAM or multi-level slab does not fit.
// - grad_attw and grad_loc: each lane sums over its chunk's channels, then
//   shuffles within its slot only (2 steps at 4 lanes); the slot's first
//   lane writes them in their input's dtype.
// - Which gradients are computed is a compile-time choice of the entry
//   (value only, points only, or all), so grad_value alone reads no value
//   row; a gradient whose pointer is null is not computed.
// - Warps find their (b, m) and queries in a 3-D grid, without a division.
// - The scalar kernel (one warp per (b, q, m), a channel per lane, f32
//   scalar atomics) takes rows that are no whole number of 16-byte chunks
//   or more than 32 of them, and base pointers that are not 16-byte
//   aligned; the entry chooses and counts each kernel's launches
//   (msda_bwd_vector_launches, msda_bwd_scalar_launches).
// Measured before this design: 0.1814-0.1823 ms at the B=6 encoder shape in
// the training mix, one warp per (b, q, m) with a channel per lane and
// scalar atomics (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W).
//
// Plain C interface, loaded with ctypes; see dfvod_tpu_torch/ops/msda.py.

#include <atomic>

#include "msda_common.cuh"

using namespace msda;

namespace {

// Launches of each kernel (vector, scalar) since the library was loaded,
// counted where the entry chooses.
std::atomic<long long> vector_launches{0}, scalar_launches{0};

// value (B, S, M, D); loc (B, Lq, M, L, P, 2) in (x, y) order;
// attw (B, Lq, M, L, P); go (B, Lq, M, D); grad_value (B, S, M, D) f32;
// grad_loc and grad_attw shaped as loc and attw. All contiguous; go, and
// value with kPointGrads, grad_value with kValueGrad, 16-byte aligned;
// D * sizeof(V) = 16 * sl.g.
template <typename V, typename C, typename A, bool kValueGrad,
          bool kPointGrads>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    msda_bwd_vec_kernel(const V* __restrict__ value, const C* __restrict__ loc,
                        const A* __restrict__ attw, const V* __restrict__ go,
                        float* __restrict__ grad_value,
                        C* __restrict__ grad_loc, A* __restrict__ grad_attw,
                        int S, int M, int D, int Lq, int P, Levels lv,
                        Slots sl) {
  constexpr int kN = kChunk<V>;
  const int lane = threadIdx.x & 31;
  // grid (q blocks / kWarpsPerBlock, M, B): a warp per block of queries
  const int qb = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int m = blockIdx.y, b = blockIdx.z;
  if ((qb << sl.lg_qw) >= Lq) return;
  const int lg = lane & ((1 << sl.lg_gp) - 1);  // chunk of the row
  const int slot = lane >> sl.lg_gp;
  const int s = slot & ((1 << sl.lg_spq) - 1);  // slot within its query
  const int q = (qb << sl.lg_qw) + (slot >> sl.lg_spq);
  const bool has_q = q < Lq;
  const bool active = has_q && lg < sl.g;

  const int np = lv.n * P;
  const long long row = (long long)M * D;  // token stride inside value
  const long long pt0 = (((long long)b * Lq + q) * M + m) * np;
  const long long vb = (long long)b * S * row + (long long)m * D;

  // The go row, loaded once. g: this lane's chunk, channels lg * kN.., for
  // the point gradients and, in f32, for the atomics. ga (bf16): the 4 + 4
  // channels this lane adds into the f32 grad_value row, its 16-byte chunks
  // lg and sl.g + lg, so the lanes of a slot cover whole 32-byte sectors in
  // each atomic instruction; 8 channels lg * 8.. would half-cover every
  // sector twice, and the atomics run at the L2's rate of sector requests.
  float g[kN], ga[8];
#pragma unroll
  for (int j = 0; j < kN; ++j) g[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) ga[j] = 0.f;
  if (active) {
    const V* grow = go + (((long long)b * Lq + q) * M + m) * D;
    widen<V>(load16(grow + lg * kN), g);
    if constexpr (kValueGrad && kN == 8) {
      load4(grow + 4 * lg, ga);
      load4(grow + 4 * (sl.g + lg), ga + 4);
    }
  }

  for (int it = 0; it < sl.iters; ++it) {
    const int pi = s + (it << sl.lg_spq);
    const bool has_point = has_q && pi < np;
    const long long i = pt0 + pi;
    SampleCorners c;
    bool inside = false;
    float aw = 0.f, sv = 0.f, gx = 0.f, gy = 0.f;
    int l = 0;
    if (has_point) {
      l = pi / P;
      inside = msda_corners<true>(to_float(loc[2 * i]),
                                  to_float(loc[2 * i + 1]), lv.h[l], lv.w[l],
                                  &c);
    }
    if (inside && lg < sl.g) {
      aw = to_float(attw[i]);
      const long long vl = vb + (long long)lv.start[l] * row;
      if constexpr (kPointGrads) {
        uint4 raw[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          raw[k] = c.ok[k] ? load16(value + vl + (long long)c.t[k] * row +
                                    lg * kN)
                           : make_uint4(0u, 0u, 0u, 0u);
        float v[4][kN];
#pragma unroll
        for (int k = 0; k < 4; ++k) widen<V>(raw[k], v[k]);
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          sv += g[j] * (c.w[0] * v[0][j] + c.w[1] * v[1][j] +
                        c.w[2] * v[2][j] + c.w[3] * v[3][j]);
          gx += g[j] * ((1.f - c.fy) * (v[1][j] - v[0][j]) +
                        c.fy * (v[3][j] - v[2][j]));
          gy += g[j] * ((1.f - c.fx) * (v[2][j] - v[0][j]) +
                        c.fx * (v[3][j] - v[1][j]));
        }
      }
      if constexpr (kValueGrad) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!c.ok[k]) continue;
          float* dst = grad_value + vl + (long long)c.t[k] * row;
          if constexpr (kN == 8) {
            atomic_add_scaled<4>(dst + 4 * lg, ga, aw * c.w[k]);
            atomic_add_scaled<4>(dst + 4 * (sl.g + lg), ga + 4, aw * c.w[k]);
          } else {
            atomic_add_scaled<4>(dst + 4 * lg, g, aw * c.w[k]);
          }
        }
      }
    }
    if constexpr (kPointGrads) {
      // sum over the slot's lanes only; every lane of the warp takes part
      for (int o = 1; o < (1 << sl.lg_gp); o <<= 1) {
        sv += __shfl_xor_sync(0xffffffffu, sv, o);
        gx += __shfl_xor_sync(0xffffffffu, gx, o);
        gy += __shfl_xor_sync(0xffffffffu, gy, o);
      }
      if (has_point && lg == 0) {
        const float W = inside ? (float)lv.w[l] : 0.f;
        const float H = inside ? (float)lv.h[l] : 0.f;
        if (grad_attw) grad_attw[i] = from_float<A>(sv);
        if (grad_loc) {
          grad_loc[2 * i] = from_float<C>(aw * gx * W);
          grad_loc[2 * i + 1] = from_float<C>(aw * gy * H);
        }
      }
    }
  }
}

// The scalar kernel: one warp per (b, q, m), a channel per lane, any D and
// any alignment; runtime null checks pick the gradients. Same layouts as
// the vector kernel.
template <typename V, typename C, typename A>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    msda_bwd_kernel(const V* __restrict__ value, const C* __restrict__ loc,
                    const A* __restrict__ attw, const V* __restrict__ go,
                    float* __restrict__ grad_value, C* __restrict__ grad_loc,
                    A* __restrict__ grad_attw, int S, int M, int D, int Lq,
                    int P, Levels lv) {
  const int lane = threadIdx.x & 31;
  // grid (Lq / kWarpsPerBlock, M, B): a warp per (b, q, m)
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int m = blockIdx.y, b = blockIdx.z;
  if (q >= Lq) return;

  const long long row = (long long)M * D;  // token stride inside value
  const long long pt0 = (((long long)b * Lq + q) * M + m) * lv.n * P;
  const long long vb = (long long)b * S * row + (long long)m * D;
  const V* gq = go + (((long long)b * Lq + q) * M + m) * D;
  const bool point_grads = grad_loc != nullptr || grad_attw != nullptr;

  for (int l = 0; l < lv.n; ++l) {
    const int H = lv.h[l], W = lv.w[l];
    const long long vl = vb + (long long)lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const long long i = pt0 + (long long)l * P + p;
      SampleCorners c;
      if (!msda_corners<true>(to_float(loc[2 * i]), to_float(loc[2 * i + 1]),
                              H, W, &c)) {
        if (lane == 0) {
          if (grad_attw) grad_attw[i] = from_float<A>(0.f);
          if (grad_loc) {
            grad_loc[2 * i] = from_float<C>(0.f);
            grad_loc[2 * i + 1] = from_float<C>(0.f);
          }
        }
        continue;
      }
      const float aw = to_float(attw[i]);
      long long r[4];  // row offsets of the corners; read only where ok
#pragma unroll
      for (int k = 0; k < 4; ++k) r[k] = vl + (long long)c.t[k] * row;

      float sv = 0.f, gx = 0.f, gy = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float gd = to_float(gq[d]);
        if (point_grads) {
          float v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            v[k] = c.ok[k] ? to_float(value[r[k] + d]) : 0.f;
          sv += gd * (c.w[0] * v[0] + c.w[1] * v[1] + c.w[2] * v[2] +
                      c.w[3] * v[3]);
          gx += gd * ((1.f - c.fy) * (v[1] - v[0]) + c.fy * (v[3] - v[2]));
          gy += gd * ((1.f - c.fx) * (v[2] - v[0]) + c.fx * (v[3] - v[1]));
        }
        if (grad_value) {
          const float ag = aw * gd;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (c.ok[k]) atomicAdd(grad_value + r[k] + d, ag * c.w[k]);
        }
      }
      if (point_grads) {
        for (int o = 16; o > 0; o >>= 1) {
          sv += __shfl_xor_sync(0xffffffffu, sv, o);
          gx += __shfl_xor_sync(0xffffffffu, gx, o);
          gy += __shfl_xor_sync(0xffffffffu, gy, o);
        }
        if (lane == 0) {
          if (grad_attw) grad_attw[i] = from_float<A>(sv);
          if (grad_loc) {
            grad_loc[2 * i] = from_float<C>(aw * gx * (float)W);
            grad_loc[2 * i + 1] = from_float<C>(aw * gy * (float)H);
          }
        }
      }
    }
  }
}

template <typename V, typename C, typename A, bool kValueGrad,
          bool kPointGrads>
void launch_vec(const dim3& grid, const V* value, const C* loc, const A* attw,
                const V* go, float* gv, C* gloc, A* gattw, int S, int M,
                int D, int Lq, int P, const Levels& lv, const Slots& sl,
                cudaStream_t stream) {
  msda_bwd_vec_kernel<V, C, A, kValueGrad, kPointGrads>
      <<<grid, kWarpsPerBlock * 32, 0, stream>>>(
          value, loc, attw, go, gv, gloc, gattw, S, M, D, Lq, P, lv, sl);
}

template <typename V, typename C, typename A>
int launch(const void* value, const void* loc, const void* attw,
           const void* go, float* grad_value_f32, void* grad_value,
           void* grad_loc, void* grad_attw, int B, int S, int M, int D,
           int Lq, int P, const Levels& lv, cudaStream_t stream) {
  const bool value_grad = grad_value_f32 != nullptr;
  const bool point_grads = grad_loc != nullptr || grad_attw != nullptr;
  Slots sl;
  const bool vec = (value_grad || point_grads) &&
                   make_slots(D, (int)sizeof(V), lv.n * P, &sl) &&
                   aligned16(go) &&
                   (!point_grads || aligned16(value)) &&
                   (!value_grad || aligned16(grad_value_f32));
  dim3 grid;
  if (!msda_grid(vec ? (Lq + (1LL << sl.lg_qw) - 1) >> sl.lg_qw : Lq, M, B,
                 &grid))
    return -4;
  if (!empty_grid(grid) && (value_grad || point_grads)) {
    const V* v = static_cast<const V*>(value);
    const C* c = static_cast<const C*>(loc);
    const A* a = static_cast<const A*>(attw);
    const V* g = static_cast<const V*>(go);
    C* gl = static_cast<C*>(grad_loc);
    A* ga = static_cast<A*>(grad_attw);
    ++(vec ? vector_launches : scalar_launches);
    if (!vec)
      msda_bwd_kernel<V, C, A><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
          v, c, a, g, grad_value_f32, gl, ga, S, M, D, Lq, P, lv);
    else if (!point_grads)
      launch_vec<V, C, A, true, false>(grid, v, c, a, g, grad_value_f32, gl,
                                       ga, S, M, D, Lq, P, lv, sl, stream);
    else if (!value_grad)
      launch_vec<V, C, A, false, true>(grid, v, c, a, g, grad_value_f32, gl,
                                       ga, S, M, D, Lq, P, lv, sl, stream);
    else
      launch_vec<V, C, A, true, true>(grid, v, c, a, g, grad_value_f32, gl,
                                      ga, S, M, D, Lq, P, lv, sl, stream);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // a bf16 value takes its gradient from the f32 accumulator in one pass
  if (grad_value_f32 != nullptr && (void*)grad_value_f32 != grad_value)
    return launch_cast_to_bf16(grad_value_f32,
                               static_cast<__nv_bfloat16*>(grad_value),
                               (long long)B * S * M * D, stream);
  return (int)cudaGetLastError();
}

template <typename V>
int dispatch_coords(int loc_dtype, int attw_dtype, const void* value,
                    const void* loc, const void* attw, const void* go,
                    float* gv32, void* gv, void* gloc, void* gattw, int B,
                    int S, int M, int D, int Lq, int P, const Levels& lv,
                    cudaStream_t stream) {
  if (loc_dtype == kFloat32 && attw_dtype == kFloat32)
    return launch<V, float, float>(value, loc, attw, go, gv32, gv, gloc,
                                   gattw, B, S, M, D, Lq, P, lv, stream);
  if (loc_dtype == kFloat32 && attw_dtype == kBFloat16)
    return launch<V, float, __nv_bfloat16>(value, loc, attw, go, gv32, gv,
                                           gloc, gattw, B, S, M, D, Lq, P,
                                           lv, stream);
  if (loc_dtype == kBFloat16 && attw_dtype == kFloat32)
    return launch<V, __nv_bfloat16, float>(value, loc, attw, go, gv32, gv,
                                           gloc, gattw, B, S, M, D, Lq, P,
                                           lv, stream);
  if (loc_dtype == kBFloat16 && attw_dtype == kBFloat16)
    return launch<V, __nv_bfloat16, __nv_bfloat16>(
        value, loc, attw, go, gv32, gv, gloc, gattw, B, S, M, D, Lq, P, lv,
        stream);
  return -3;
}

}  // namespace

// grad_value_f32: the zeroed f32 accumulator (B, S, M, D), or null when no
// value gradient is wanted; grad_value: the value-dtype gradient (the same
// pointer for an f32 value). grad_loc / grad_attw: null when not wanted.
// go has the value's dtype. Returns 0 on success, a cudaError_t code (> 0)
// if a launch failed, or a negative code for arguments the kernel does not
// take: -1 level count, -2 S != sum(H*W), -3 dtype combination, -4 grid
// too large, -5 an f32 value whose accumulator is not its gradient.
extern "C" int msda_bwd(const void* value, const void* loc, const void* attw,
                        const void* grad_out, float* grad_value_f32,
                        void* grad_value, void* grad_loc, void* grad_attw,
                        int B, int S, int M, int D, int Lq, int L, int P,
                        const int* shapes, int value_dtype, int loc_dtype,
                        int attw_dtype, void* stream) {
  Levels lv;
  const int rc = make_levels(L, shapes, S, &lv);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == kFloat32) {
    if (grad_value_f32 != nullptr && (void*)grad_value_f32 != grad_value)
      return -5;
    return dispatch_coords<float>(loc_dtype, attw_dtype, value, loc, attw,
                                  grad_out, grad_value_f32, grad_value,
                                  grad_loc, grad_attw, B, S, M, D, Lq, P, lv,
                                  s);
  }
  if (value_dtype == kBFloat16)
    return dispatch_coords<__nv_bfloat16>(
        loc_dtype, attw_dtype, value, loc, attw, grad_out, grad_value_f32,
        grad_value, grad_loc, grad_attw, B, S, M, D, Lq, P, lv, s);
  return -3;
}

extern "C" const char* msda_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches of each kernel since the library was loaded.
extern "C" long long msda_bwd_vector_launches() { return vector_launches; }
extern "C" long long msda_bwd_scalar_launches() { return scalar_launches; }
