// One epilogue pass over a FrozenBN'd conv output, and its backward, for
// Hopper (sm_90a):
//
//   y = act(x * s[c] + b[c] + R),  R = 0 | r | r * sr[c] + br[c]
//
// with act ReLU or nothing, the arithmetic in f32 (multiplies and adds
// rounded one by one, no contraction, so the result is bitwise the plain
// version's) and y rounded once to x's type. The backward reads the
// incoming gradient g and, with ReLU, the saved output y:
//
//   dx = g * [y > 0] * s[c],  dr = g * [y > 0]  or  g * [y > 0] * sr[c]
//
// (without ReLU the [y > 0] factor drops out), each rounded once.
//
// Replaces no TPU kernel: XLA fuses the JAX package's FrozenBN, ReLU and
// residual add into the convolution's epilogue on the TPU, while eager
// PyTorch ran them as up to ten passes over a bottleneck's activations
// (a strided broadcast multiply and add per FrozenBN, each ReLU, the add).
// Counterpart of dfvod_tpu/models/backbone_resnet.py's FrozenBatchNorm
// and Bottleneck.__call__ (the arithmetic, not a kernel).
//
// What bounds it: bytes. Each element of x (and r) is read once and y
// written once, with a few flops per element: at the ResNet-50 stem of a
// 32-frame 608x800 request, (32, 304, 400, 64) bf16, 498 MB read and 498 MB
// written, 0.297 ms at 3.35 TB/s. The design moves those bytes and no more:
// - 16-byte loads and stores: a thread takes 8 consecutive elements, 8
//   channels of one pixel in NHWC memory (C a multiple of 8) or 8 pixels of
//   one channel in NCHW memory (H*W a multiple of 8). Any other C or H*W
//   still loads 8 elements at a time and finds each one's channel; the
//   numel % 8 elements left over go to the first threads of block 0.
// - Streaming loads (ld.global.cs) for x, r, g and y, each read once.
// - The per-channel constants come as f32 vectors (a float4 pair in NHWC)
//   through the read-only path; a few KB, they stay in L1.
// - A grid-stride loop over SMs x resident blocks; a thread follows its
//   element's (position, channel) by adding a fixed step, with no division
//   inside the loop.
// Every pointer is 16-byte aligned (the entry refuses any other): conv
// outputs, fresh allocations and the folded constants are. The entry counts
// each path's launches: nhwc8, nchw8 and general8 (8 elements, each one's
// channel found).
//
// Plain C interface, loaded with ctypes; see
// dfvod_tpu_torch/ops/frozen_bn_act.py.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kFloat16 = 2;

constexpr int kThreads = 256;
constexpr int kVec = 8;         // elements a thread loads at a time

// residual forms
constexpr int kNone = 0;
constexpr int kIdentity = 1;
constexpr int kAffine = 2;

// paths
constexpr int kNhwc8 = 0;
constexpr int kNchw8 = 1;
constexpr int kGeneral8 = 2;
constexpr int kPaths = 3;

std::atomic<long long> fwd_launches[kPaths];
std::atomic<long long> bwd_launches[kPaths];

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// 8 consecutive elements, 16-byte aligned: one streaming 16-byte load in
// bf16 and f16, two in f32
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const __half* p, float (&v)[8]) {
  const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p));
  const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}
__device__ __forceinline__ void store8(__half* p, const float (&v)[8]) {
  uint4 raw;
  __half2* h = reinterpret_cast<__half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// The per-channel constant of each of a group's kVec elements; (p, c) is
// the group's first element's position in its run of `inner` elements of
// one channel and its channel.
__device__ __forceinline__ void channel_values(const float* __restrict__ t,
                                               int path, long long p, int c,
                                               int C, long long inner,
                                               float (&v)[kVec]) {
  if (path == kNhwc8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(t + c));
    const float4 b = __ldg(reinterpret_cast<const float4*>(t + c) + 1);
    const float w[kVec] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = w[j];
  } else if (path == kNchw8) {
    const float w = __ldg(t + c);
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = w;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v[j] = __ldg(t + c);
      if (++p == inner) {
        p = 0;
        if (++c == C) c = 0;
      }
    }
  }
}

// (p, c) of element e
__device__ __forceinline__ void locate(long long e, int C, long long inner,
                                       long long& p, int& c) {
  p = e % inner;
  c = static_cast<int>((e / inner) % C);
}

__device__ __forceinline__ float relu_f(float v) {
  return v < 0.f ? 0.f : v;     // NaN passes, as torch.relu
}

template <int FORM>
__device__ __forceinline__ float epilogue(float xv, float s, float b,
                                          float rv, float sr, float br,
                                          int relu) {
  float v = __fadd_rn(__fmul_rn(xv, s), b);
  if (FORM == kIdentity) v = __fadd_rn(v, rv);
  if (FORM == kAffine) v = __fadd_rn(v, __fadd_rn(__fmul_rn(rv, sr), br));
  return relu ? relu_f(v) : v;
}

// kVec elements a thread and step; `step_p`, `step_c`: how far (p, c)
// moves between a thread's groups, gridDim.x * kThreads * kVec elements
template <typename T, int FORM>
__global__ void __launch_bounds__(kThreads)
    frozen_bn_act_kernel(const T* __restrict__ x, const T* __restrict__ r,
                         const float* __restrict__ s,
                         const float* __restrict__ b,
                         const float* __restrict__ sr,
                         const float* __restrict__ br, T* __restrict__ y,
                         long long numel, int C, long long inner, int path,
                         int relu, long long step_p, int step_c) {
  const long long groups = numel / kVec;
  long long gi = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long gstride = static_cast<long long>(gridDim.x) * kThreads;
  long long p;
  int c;
  locate(gi * kVec, C, inner, p, c);
  for (; gi < groups; gi += gstride) {
    float xv[kVec], rv[kVec], sv[kVec], bv[kVec], srv[kVec], brv[kVec];
    load8(x + gi * kVec, xv);
    if (FORM != kNone) load8(r + gi * kVec, rv);
    channel_values(s, path, p, c, C, inner, sv);
    channel_values(b, path, p, c, C, inner, bv);
    if (FORM == kAffine) {
      channel_values(sr, path, p, c, C, inner, srv);
      channel_values(br, path, p, c, C, inner, brv);
    }
    float out[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      out[j] = epilogue<FORM>(xv[j], sv[j], bv[j],
                              FORM != kNone ? rv[j] : 0.f,
                              FORM == kAffine ? srv[j] : 0.f,
                              FORM == kAffine ? brv[j] : 0.f, relu);
    store8(y + gi * kVec, out);
    p += step_p;
    c += step_c;
    if (p >= inner) {
      p -= inner;
      ++c;
    }
    if (c >= C) c -= C;
  }
  // the numel % kVec elements after the last whole group
  const long long e = groups * kVec + threadIdx.x;
  if (blockIdx.x == 0 && e < numel) {
    locate(e, C, inner, p, c);
    const float rv = FORM != kNone ? to_f(r[e]) : 0.f;
    y[e] = from_f<T>(epilogue<FORM>(to_f(x[e]), s[c], b[c], rv,
                                    FORM == kAffine ? sr[c] : 0.f,
                                    FORM == kAffine ? br[c] : 0.f, relu));
  }
}

__device__ __forceinline__ void grads(float gv, float yv, float s, float sr,
                                      int relu, bool affine, float& dx,
                                      float& dr) {
  const float gm = (!relu || yv > 0.f) ? gv : 0.f;
  dx = __fmul_rn(gm, s);
  dr = affine ? __fmul_rn(gm, sr) : gm;
}

// dx (null where not asked for) and dr (null for the form without a
// residual or where not asked for); y is read only with ReLU, sr only for
// the affine residual
template <typename T>
__global__ void __launch_bounds__(kThreads)
    frozen_bn_act_bwd_kernel(const T* __restrict__ g, const T* __restrict__ y,
                             const float* __restrict__ s,
                             const float* __restrict__ sr, T* __restrict__ dx,
                             T* __restrict__ dr, long long numel, int C,
                             long long inner, int path, int relu,
                             long long step_p, int step_c) {
  const bool affine = sr != nullptr;
  const long long groups = numel / kVec;
  long long gi = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long gstride = static_cast<long long>(gridDim.x) * kThreads;
  long long p;
  int c;
  locate(gi * kVec, C, inner, p, c);
  for (; gi < groups; gi += gstride) {
    float gv[kVec], yv[kVec], sv[kVec], srv[kVec];
    load8(g + gi * kVec, gv);
    if (relu) load8(y + gi * kVec, yv);
    if (dx) channel_values(s, path, p, c, C, inner, sv);
    if (dr && affine) channel_values(sr, path, p, c, C, inner, srv);
    float ox[kVec], orr[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      grads(gv[j], relu ? yv[j] : 0.f, dx ? sv[j] : 0.f,
            (dr && affine) ? srv[j] : 0.f, relu, affine, ox[j], orr[j]);
    if (dx) store8(dx + gi * kVec, ox);
    if (dr) store8(dr + gi * kVec, orr);
    p += step_p;
    c += step_c;
    if (p >= inner) {
      p -= inner;
      ++c;
    }
    if (c >= C) c -= C;
  }
  const long long e = groups * kVec + threadIdx.x;
  if (blockIdx.x == 0 && e < numel) {
    locate(e, C, inner, p, c);
    float ox, orr;
    grads(to_f(g[e]), relu ? to_f(y[e]) : 0.f, s[c], affine ? sr[c] : 0.f,
          relu, affine, ox, orr);
    if (dx) dx[e] = from_f<T>(ox);
    if (dr) dr[e] = from_f<T>(orr);
  }
}

int sm_count() {
  static std::atomic<int> counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  int n = counts[dev].load();
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n < 1)
      n = 132;
    counts[dev].store(n);
  }
  return n;
}

// blocks of kThreads for `work` groups: no more than the card holds at
// once (SMs x resident blocks of this kernel, which `resident` keeps once
// asked: one per kernel), no more than the work needs
template <typename K>
int grid_for(K kernel, long long work, std::atomic<int>& resident) {
  int per_sm = resident.load();
  if (per_sm == 0) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0) !=
            cudaSuccess || per_sm < 1)
      per_sm = 1;
    resident.store(per_sm);
  }
  const long long need = (work + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sm_count()) * per_sm;
  return static_cast<int>(need < most ? (need > 0 ? need : 1) : most);
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int choose_path(int C, long long inner) {
  if (inner == 1 && C % 8 == 0) return kNhwc8;
  if (inner % 8 == 0) return kNchw8;
  return kGeneral8;
}

// (step_p, step_c) for a grid of `blocks` x kThreads threads, kVec
// elements each
void steps(int blocks, int C, long long inner, long long& step_p,
           int& step_c) {
  const long long q = static_cast<long long>(blocks) * kThreads * kVec;
  step_p = q % inner;
  step_c = static_cast<int>((q / inner) % C);
}

template <typename T, int FORM>
int launch_fwd(const void* x, const void* r, const float* s, const float* b,
               const float* sr, const float* br, void* y, long long numel,
               int C, long long inner, int path, int relu,
               cudaStream_t stream) {
  static std::atomic<int> resident{0};
  auto kernel = frozen_bn_act_kernel<T, FORM>;
  const int blocks = grid_for(kernel, numel / kVec > 0 ? numel / kVec : 1,
                              resident);
  long long step_p;
  int step_c;
  steps(blocks, C, inner, step_p, step_c);
  kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), s, b, sr, br,
      static_cast<T*>(y), numel, C, inner, path, relu, step_p, step_c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_form(const void* x, const void* r, const float* s,
                  const float* b, const float* sr, const float* br, void* y,
                  long long numel, int C, long long inner, int path, int relu,
                  cudaStream_t stream) {
  if (r == nullptr)
    return launch_fwd<T, kNone>(x, r, s, b, sr, br, y, numel, C, inner,
                                path, relu, stream);
  if (sr == nullptr)
    return launch_fwd<T, kIdentity>(x, r, s, b, sr, br, y, numel, C, inner,
                                    path, relu, stream);
  return launch_fwd<T, kAffine>(x, r, s, b, sr, br, y, numel, C, inner,
                                path, relu, stream);
}

template <typename T>
int launch_bwd(const void* g, const void* y, const float* s, const float* sr,
               void* dx, void* dr, long long numel, int C, long long inner,
               int path, int relu, cudaStream_t stream) {
  static std::atomic<int> resident{0};
  auto kernel = frozen_bn_act_bwd_kernel<T>;
  const int blocks = grid_for(kernel, numel / kVec > 0 ? numel / kVec : 1,
                              resident);
  long long step_p;
  int step_c;
  steps(blocks, C, inner, step_p, step_c);
  kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(y), s, sr,
      static_cast<T*>(dx), static_cast<T*>(dr), numel, C, inner, path, relu,
      step_p, step_c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = act(x * s + b + R) over a contiguous 4-d (N, C, H, W) tensor whose
// memory is NHWC (inner = 1) or NCHW (inner = H * W): element e has channel
// (e / inner) % C. R is 0 (r null), r (sr and br null) or r * sr + br; r
// and y share x's type and memory order. s, b, sr, br: C f32 constants.
// Every pointer 16-byte aligned. dtype 0 f32, 1 bf16, 2 f16. Returns 0, a
// negative code for arguments it refuses, or the launch's CUDA error.
extern "C" int frozen_bn_act_fwd(const void* x, const void* r, const void* s,
                                 const void* b, const void* sr,
                                 const void* br, void* y, long long numel,
                                 int C, long long inner, int dtype, int relu,
                                 void* stream) {
  if (numel < 0 || C < 1 || inner < 1 || x == nullptr || y == nullptr ||
      s == nullptr || b == nullptr)
    return -1;
  if ((sr == nullptr) != (br == nullptr) || (r == nullptr && sr != nullptr))
    return -2;
  if (!(aligned16(x) && aligned16(r) && aligned16(y) && aligned16(s) &&
        aligned16(b) && aligned16(sr) && aligned16(br)))
    return -4;
  if (numel == 0) return 0;
  const int path = choose_path(C, inner);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fs = static_cast<const float*>(s),
              *fb = static_cast<const float*>(b),
              *fsr = static_cast<const float*>(sr),
              *fbr = static_cast<const float*>(br);
  int rc;
  if (dtype == kFloat32)
    rc = dispatch_form<float>(x, r, fs, fb, fsr, fbr, y, numel, C, inner,
                              path, relu, st);
  else if (dtype == kBFloat16)
    rc = dispatch_form<__nv_bfloat16>(x, r, fs, fb, fsr, fbr, y, numel, C,
                                      inner, path, relu, st);
  else if (dtype == kFloat16)
    rc = dispatch_form<__half>(x, r, fs, fb, fsr, fbr, y, numel, C, inner,
                               path, relu, st);
  else
    return -3;
  if (rc == 0) fwd_launches[path].fetch_add(1);
  return rc;
}

// dx = g * [y > 0] * s and dr = g * [y > 0] (* sr) as the file's head
// says; y is read only with relu, sr only for the affine residual; dx or dr
// null where not asked for. g, y, dx, dr share one type and memory order;
// every pointer 16-byte aligned.
extern "C" int frozen_bn_act_bwd(const void* g, const void* y, const void* s,
                                 const void* sr, void* dx, void* dr,
                                 long long numel, int C, long long inner,
                                 int dtype, int relu, void* stream) {
  if (numel < 0 || C < 1 || inner < 1 || g == nullptr || s == nullptr ||
      (relu && y == nullptr) || (dx == nullptr && dr == nullptr))
    return -1;
  if (!(aligned16(g) && aligned16(relu ? y : nullptr) && aligned16(dx) &&
        aligned16(dr) && aligned16(s) && aligned16(sr)))
    return -4;
  if (numel == 0) return 0;
  const int path = choose_path(C, inner);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fs = static_cast<const float*>(s),
              *fsr = static_cast<const float*>(sr);
  int rc;
  if (dtype == kFloat32)
    rc = launch_bwd<float>(g, y, fs, fsr, dx, dr, numel, C, inner, path, relu,
                           st);
  else if (dtype == kBFloat16)
    rc = launch_bwd<__nv_bfloat16>(g, y, fs, fsr, dx, dr, numel, C, inner,
                                   path, relu, st);
  else if (dtype == kFloat16)
    rc = launch_bwd<__half>(g, y, fs, fsr, dx, dr, numel, C, inner, path,
                            relu, st);
  else
    return -3;
  if (rc == 0) bwd_launches[path].fetch_add(1);
  return rc;
}

extern "C" const char* frozen_bn_act_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches of each path (0 nhwc8, 1 nchw8, 2 general8) since the
// library was loaded; -1 for another path number.
extern "C" long long frozen_bn_act_fwd_launches(int path) {
  return path >= 0 && path < kPaths ? fwd_launches[path].load() : -1;
}
extern "C" long long frozen_bn_act_bwd_launches(int path) {
  return path >= 0 && path < kPaths ? bwd_launches[path].load() : -1;
}
