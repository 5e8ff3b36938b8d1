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
// whose four corners all lie outside gets exact zero gradients.
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
// point gathers 4 corner rows and scatters 4 rows of f32 atomics into
// grad_value. A head's value and grad_value slabs (S x D) are shared by all
// queries of that head and stay in L2, where the atomics resolve.
//
// Design:
// - One warp per (b, q, m), channels across lanes, as in msda_fwd.cu: the go
//   row, each corner row and each row of atomics is one contiguous access of
//   D elements. Warps are numbered q-fastest, so the warps in flight
//   together share (b, m) and hit the same slabs in cache.
// - grad_value: f32 atomicAdd (compiled to a fire-and-forget RED) into an
//   f32 buffer that the wrapper zeroes, then one cast pass when the value is
//   bf16; an f32 value accumulates in its gradient directly. The order of the
//   additions changes from run to run, so grad_value is not bitwise
//   deterministic. A deterministic reduction (a sort by token, or a segment
//   pass per query) costs an extra pass and is later work.
// - grad_attw and grad_loc: per-lane partial sums over the channels, then a
//   warp shuffle reduction; lane 0 writes them in their input's dtype.
// - Pixel coordinates are rounded as PyTorch rounds `loc * W - 0.5` (no
//   fused multiply-add), so floor(px), and with it the side of a one-sided
//   difference, agrees with the plain version bit for bit.
// - A gradient whose pointer is null is not computed.
//
// Plain C interface, loaded with ctypes; see dfvod_tpu_torch/ops/msda.py.

#include "msda_common.cuh"

using namespace msda;

namespace {

// value (B, S, M, D); loc (B, Lq, M, L, P, 2) in (x, y) order;
// attw (B, Lq, M, L, P); go (B, Lq, M, D); grad_value (B, S, M, D) f32;
// grad_loc and grad_attw shaped as loc and attw. All contiguous.
template <typename V, typename C, typename A>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    msda_bwd_kernel(const V* __restrict__ value, const C* __restrict__ loc,
                    const A* __restrict__ attw, const V* __restrict__ go,
                    float* __restrict__ grad_value, C* __restrict__ grad_loc,
                    A* __restrict__ grad_attw, int B, int S, int M, int D,
                    int Lq, int P, Levels lv) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= (long long)B * M * Lq) return;
  const int q = (int)(warp % Lq);
  const long long bm = warp / Lq;
  const int m = (int)(bm % M);
  const int b = (int)(bm / M);

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
      const float x =
          __fsub_rn(__fmul_rn(to_float(loc[2 * i]), (float)W), 0.5f);
      const float y =
          __fsub_rn(__fmul_rn(to_float(loc[2 * i + 1]), (float)H), 0.5f);
      // every corner is outside the map (NaN lands here too); at x == -1
      // the corner x = 0 still carries a derivative
      if (!(x >= -1.f && y >= -1.f && x < (float)W && y < (float)H)) {
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
      const float x0f = floorf(x), y0f = floorf(y);
      const int x0 = (int)x0f, y0 = (int)y0f;
      const float fx = x - x0f, fy = y - y0f;
      const bool c00 = y0 >= 0 && x0 >= 0, c01 = y0 >= 0 && x0 + 1 < W;
      const bool c10 = y0 + 1 < H && x0 >= 0, c11 = y0 + 1 < H && x0 + 1 < W;
      const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
      const float w10 = fy * (1.f - fx), w11 = fy * fx;
      // row offsets of the corners; read only where the corner is valid
      const long long r00 = vl + ((long long)y0 * W + x0) * row;
      const long long r01 = r00 + row;
      const long long r10 = r00 + (long long)W * row;
      const long long r11 = r10 + row;

      float s = 0.f, gx = 0.f, gy = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float g = to_float(gq[d]);
        if (point_grads) {
          const float v00 = c00 ? to_float(value[r00 + d]) : 0.f;
          const float v01 = c01 ? to_float(value[r01 + d]) : 0.f;
          const float v10 = c10 ? to_float(value[r10 + d]) : 0.f;
          const float v11 = c11 ? to_float(value[r11 + d]) : 0.f;
          s += g * (w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11);
          gx += g * ((1.f - fy) * (v01 - v00) + fy * (v11 - v10));
          gy += g * ((1.f - fx) * (v10 - v00) + fx * (v11 - v01));
        }
        if (grad_value) {
          const float ag = aw * g;
          if (c00) atomicAdd(grad_value + r00 + d, ag * w00);
          if (c01) atomicAdd(grad_value + r01 + d, ag * w01);
          if (c10) atomicAdd(grad_value + r10 + d, ag * w10);
          if (c11) atomicAdd(grad_value + r11 + d, ag * w11);
        }
      }
      if (point_grads) {
        for (int o = 16; o > 0; o >>= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, o);
          gx += __shfl_xor_sync(0xffffffffu, gx, o);
          gy += __shfl_xor_sync(0xffffffffu, gy, o);
        }
        if (lane == 0) {
          if (grad_attw) grad_attw[i] = from_float<A>(s);
          if (grad_loc) {
            grad_loc[2 * i] = from_float<C>(aw * gx * (float)W);
            grad_loc[2 * i + 1] = from_float<C>(aw * gy * (float)H);
          }
        }
      }
    }
  }
}

template <typename V, typename C, typename A>
int launch(const void* value, const void* loc, const void* attw,
           const void* go, float* grad_value_f32, void* grad_value,
           void* grad_loc, void* grad_attw, int B, int S, int M, int D,
           int Lq, int P, const Levels& lv, cudaStream_t stream) {
  const long long warps = (long long)B * M * Lq;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return -4;
  if (blocks > 0) {
    msda_bwd_kernel<V, C, A><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                               stream>>>(
        static_cast<const V*>(value), static_cast<const C*>(loc),
        static_cast<const A*>(attw), static_cast<const V*>(go),
        grad_value_f32, static_cast<C*>(grad_loc), static_cast<A*>(grad_attw),
        B, S, M, D, Lq, P, lv);
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
