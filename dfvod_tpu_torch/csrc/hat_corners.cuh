// The sample corners of the pixel-coordinate sampling kernels (K3,
// hat_sample_fwd.cu; K5a, hat_sample_sparse_fwd.cu): the weight of token
// (sy, sx) is the tent relu(1 - |px - sx|) * relu(1 - |py - sy|), with no
// -0.5 shift. A point with a non-finite coordinate or one outside (-1, W) x
// (-1, H) is dropped before any float-to-int conversion: (int)floorf(NaN)
// is undefined. Coordinates and weights are f32.
#pragma once

namespace hat {

// The corners of one sample point: token offsets (-1 where the corner is
// outside the grid) and their weights, aw folded in. False when the point
// contributes nothing.
struct Corners {
  int t[4];
  float w[4];
};

__device__ __forceinline__ bool corners(float x, float y, float a, int H,
                                        int W, Corners* c) {
  // every corner outside the grid (NaN lands here too)
  if (!(x > -1.f && y > -1.f && x < (float)W && y < (float)H)) return false;
  const float x0f = floorf(x), y0f = floorf(y);
  const int x0 = (int)x0f, y0 = (int)y0f;
  const float fx = x - x0f, fy = y - y0f;
  const bool xl = x0 >= 0, xr = x0 + 1 < W, yt = y0 >= 0, yb = y0 + 1 < H;
  const int t00 = y0 * W + x0;
  c->t[0] = yt && xl ? t00 : -1;
  c->t[1] = yt && xr ? t00 + 1 : -1;
  c->t[2] = yb && xl ? t00 + W : -1;
  c->t[3] = yb && xr ? t00 + W + 1 : -1;
  c->w[0] = a * (1.f - fy) * (1.f - fx);
  c->w[1] = a * (1.f - fy) * fx;
  c->w[2] = a * fy * (1.f - fx);
  c->w[3] = a * fy * fx;
  return true;
}

}  // namespace hat
