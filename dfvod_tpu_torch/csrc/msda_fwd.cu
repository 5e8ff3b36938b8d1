// Multi-scale deformable attention (MSDA) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel dfvod_tpu/ops/msda_pallas.py::_msda_hat_fwd_kernel
// (wrapper ms_deform_attn_pallas_hat). Both compute, for every (b, q, m):
//
//   out[b, q, m, :] = sum_{l, p} attw[b, q, m, l, p]
//                     * bilinear(value_l[b, :, m, :], loc * (W_l, H_l) - 0.5)
//
// with grid_sample's align_corners=False convention and zeros outside the
// map. The TPU kernel builds a dense tent-weight matrix (TQ, S) and multiplies
// it with the (S, D) value slab because Mosaic had no fast gather. Hopper
// gathers well, so this kernel reads the four corners of each sample
// directly, as the reference's im2col kernel does.
//
// What bounds it. The least traffic is one read of value, loc and attw and
// one write of out: about 20 MB at the B=8 encoder shape (Lq=S=1900, M=8,
// D=32, P=4, bf16 value, f32 loc), about 6 us at 3.35 TB/s. The gathered
// traffic is much larger (4 corners x L*P points x D channels per query,
// about 124 MB at that shape), but a head's value slab (S x D, 120 KB in
// bf16) is re-read by every query of that head and stays in L1/L2.
//
// What the design does about it:
// - One warp per (b, q, m), channels across lanes: each corner read is one
//   contiguous D-element row (64 bytes for bf16, D=32), coalesced.
// - Warps are numbered q-fastest, so the warps in flight together share
//   (b, m) and hit the same value slab in cache.
// - Coordinates, corner weights and the accumulator are f32 whatever the
//   storage types; the result is rounded once, to the value's type.
// A faster kernel (several points per warp, vector loads, value slab in
// shared memory) is later work.
//
// Plain C interface, loaded with ctypes; see dfvod_tpu_torch/ops/msda.py.

#include "msda_common.cuh"

using namespace msda;

namespace {

// value (B, S, M, D); loc (B, Lq, M, L, P, 2) in (x, y) order;
// attw (B, Lq, M, L, P); out (B, Lq, M, D). All contiguous.
template <typename V, typename C, typename A>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    msda_fwd_kernel(const V* __restrict__ value, const C* __restrict__ loc,
                    const A* __restrict__ attw, V* __restrict__ out, int B,
                    int S, int M, int D, int Lq, int P, Levels lv) {
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
  const V* vb = value + (long long)b * S * row + (long long)m * D;
  V* o = out + (((long long)b * Lq + q) * M + m) * D;

  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool active = d < D;
    const V* vd = vb + (active ? d : 0);
    float acc = 0.f;
    for (int l = 0; l < lv.n; ++l) {
      const int H = lv.h[l], W = lv.w[l];
      const V* vl = vd + (long long)lv.start[l] * row;
      for (int p = 0; p < P; ++p) {
        const long long i = pt0 + (long long)l * P + p;
        const float x = to_float(loc[2 * i]) * (float)W - 0.5f;
        const float y = to_float(loc[2 * i + 1]) * (float)H - 0.5f;
        // every corner is outside the map (NaN lands here too)
        if (!(x > -1.f && y > -1.f && x < (float)W && y < (float)H)) continue;
        const float aw = to_float(attw[i]);
        const float x0f = floorf(x), y0f = floorf(y);
        const int x0 = (int)x0f, y0 = (int)y0f;
        const float fx = x - x0f, fy = y - y0f;
        float s = 0.f;
        if (y0 >= 0) {
          const V* r = vl + (long long)y0 * W * row;
          if (x0 >= 0)
            s += (1.f - fy) * (1.f - fx) * to_float(r[(long long)x0 * row]);
          if (x0 + 1 < W)
            s += (1.f - fy) * fx * to_float(r[(long long)(x0 + 1) * row]);
        }
        if (y0 + 1 < H) {
          const V* r = vl + (long long)(y0 + 1) * W * row;
          if (x0 >= 0)
            s += fy * (1.f - fx) * to_float(r[(long long)x0 * row]);
          if (x0 + 1 < W)
            s += fy * fx * to_float(r[(long long)(x0 + 1) * row]);
        }
        acc += aw * s;
      }
    }
    if (active) o[d] = from_float<V>(acc);
  }
}

template <typename V, typename C, typename A>
int launch(const void* value, const void* loc, const void* attw, void* out,
           int B, int S, int M, int D, int Lq, int P, const Levels& lv,
           cudaStream_t stream) {
  const long long warps = (long long)B * M * Lq;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return -4;
  if (blocks > 0) {
    msda_fwd_kernel<V, C, A><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                               stream>>>(
        static_cast<const V*>(value), static_cast<const C*>(loc),
        static_cast<const A*>(attw), static_cast<V*>(out), B, S, M, D, Lq, P,
        lv);
  }
  return (int)cudaGetLastError();
}

template <typename V>
int dispatch_coords(int loc_dtype, int attw_dtype, const void* value,
                    const void* loc, const void* attw, void* out, int B,
                    int S, int M, int D, int Lq, int P, const Levels& lv,
                    cudaStream_t stream) {
  if (loc_dtype == kFloat32 && attw_dtype == kFloat32)
    return launch<V, float, float>(value, loc, attw, out, B, S, M, D, Lq, P,
                                   lv, stream);
  if (loc_dtype == kFloat32 && attw_dtype == kBFloat16)
    return launch<V, float, __nv_bfloat16>(value, loc, attw, out, B, S, M, D,
                                           Lq, P, lv, stream);
  if (loc_dtype == kBFloat16 && attw_dtype == kFloat32)
    return launch<V, __nv_bfloat16, float>(value, loc, attw, out, B, S, M, D,
                                           Lq, P, lv, stream);
  if (loc_dtype == kBFloat16 && attw_dtype == kBFloat16)
    return launch<V, __nv_bfloat16, __nv_bfloat16>(value, loc, attw, out, B,
                                                   S, M, D, Lq, P, lv,
                                                   stream);
  return -3;
}

}  // namespace

// Returns 0 on success, a cudaError_t code (> 0) if the launch failed, or a
// negative code for arguments the kernel does not take:
// -1 level count, -2 S != sum(H*W), -3 dtype combination, -4 grid too large.
extern "C" int msda_fwd(const void* value, const void* loc, const void* attw,
                        void* out, int B, int S, int M, int D, int Lq, int L,
                        int P, const int* shapes, int value_dtype,
                        int loc_dtype, int attw_dtype, void* stream) {
  Levels lv;
  const int rc = make_levels(L, shapes, S, &lv);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == kFloat32)
    return dispatch_coords<float>(loc_dtype, attw_dtype, value, loc, attw,
                                  out, B, S, M, D, Lq, P, lv, s);
  if (value_dtype == kBFloat16)
    return dispatch_coords<__nv_bfloat16>(loc_dtype, attw_dtype, value, loc,
                                          attw, out, B, S, M, D, Lq, P, lv,
                                          s);
  return -3;
}

extern "C" const char* msda_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
