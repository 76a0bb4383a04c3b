// The latent-Gaussian algebra of the S model's training loss, forward and
// backward, one launch each (dpivae_tpu_torch/ops/latent.py wraps them).
//
// Replaces no TPU kernel: in the JAX package XLA fused this algebra into
// the loss's compiled program (dpivae_tpu/models/vae.py, the loss; its
// encoder heads, dpivae_tpu/ops/mvn.py and the z_x squash), so it was
// never a Pallas kernel. On the card the same algebra ran as about 95
// PyTorch kernels forward and 160 backward a training step, each on a
// (samples, rows, d) tensor of a few thousand values.
//
// What it computes, per row b of the batch and sample s of the n MC
// samples, from the encoder heads' raw outputs (mean, log-sigma, tril),
// the encoder normals eps (n, rows, d) and the two learned priors' raw
// outputs:
//   loc = clamp(mean, +-50), sigma = exp(clamp(log_sigma, -7, 3)),
//   L = strict-lower clamp(tril, +-20) + diag(sigma + jitter);
//   r = loc + L eps, log q = sum(-eps^2 / 2) + d c - sum(log diag L);
//   z_x = sigmoid(k r_x) (ub - lb) + lb, with its log-det;
//   log p_x(z_x) (a normal or a uniform per dimension), and the priors'
//   log p_c(r_c), log p_y(r_y) by forward substitution;
//   KL_x[b] = mean_s(log q - log|J| - log p_x - log p_c - log p_y).
// The backward takes the grads of z_x, z_c, z_y and KL_x and returns the
// grads of every raw head output; each clamp passes the gradient where its
// input lies inside its bounds, the bounds included, as torch.clamp does.
//
// What bounds it on an H100: launches. A training call reads the 64 rows'
// heads and 1,024 x 6 normals and writes as many latents, about 60 KB:
// 18 ns at 3.35 TB/s, against about 2 us for a launch inside a graph. So
// the design spends one launch each way and keeps every intermediate in
// registers and shared memory:
// - one warp per row; its lanes walk the row's MC samples, 32 at a time,
//   with the row's loc and L (and the priors') in shared memory;
// - the MC mean and the backward's sums over samples run in a fixed order
//   without atomics (each gradient entry is summed over the samples in
//   order by one lane), so runs and graph replays give the same bits;
// - the latent width is a compile-time bucket (8 or 16), so per-sample
//   vectors sit in registers;
// - the forward rounds as the plain version does on the card: accurate
//   expf / logf / log1pf, built with -fmad=false (each product and sum
//   rounds on its own, as in the plain version's separate kernels), and
//   every sum over the latent dimensions and the MC mean added in the
//   order of PyTorch's reduction kernels at these shapes (tree_sum; the
//   wrapper passes the mean's split). The backward's closed forms round
//   in their own way.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxDims = 16;
constexpr int kWarps = 4;  // rows a block
constexpr int kLanes = 32;
// The most MC samples a row whose mean the forward adds in torch.mean's
// order; beyond, in a fixed order of its own.
constexpr int kMaxOrderedSamples = 256;
constexpr unsigned kFull = 0xffffffffu;

// Everything but the pointers, passed by value.
struct Params {
  int n, rows, d, nx, nc, ny;
  int full_e, full_c, full_y;
  // torch.mean's split of a row's samples among threads (the forward adds
  // in its order); 0 for a fixed order of the kernel's own
  int mean_split;
  float gauss;   // -log(2 pi) / 2
  float jitter;  // added to the diagonal of L
  float k, log_k;
  float dc_e, dc_c, dc_y;  // d * gauss of the three densities
  float inv_n;             // the MC mean's factor
  // The z_x prior per dimension: kind 0, a normal (loc, 1 / scale,
  // log scale); kind 1, a uniform (low, high, -log(high - low)).
  int px_kind[kMaxDims];
  float px0[kMaxDims], px1[kMaxDims], px2[kMaxDims];
};

struct Heads {
  const float* mean;
  const float* log_sigma;
  const float* tril;  // null for a diagonal head
};

struct Inputs {
  Heads enc, pc, py;
  const float* eps;
  const float* lb;
  const float* ub;
};

// A row's Gaussians in shared memory, at latent positions 0..d-1: the
// encoder's, and the two priors' in one block-diagonal matrix (c at
// [nx, nx + nc), y at [nx + nc, d)).
template <int D>
struct RowState {
  float loc[D], L[D * D], sig[D];
  float ploc[D], PL[D * D], psig[D];
  float a[D], lb[D];  // the squash's ub - lb and lb, z_x positions
  float hld, hld_c, hld_y;
};

// The backward's per-sample vectors for one chunk of 32 samples.
template <int D>
struct Chunk {
  float g[kLanes][D];  // grad of the pre-squash latent r
  float e[kLanes][D];  // the encoder normals
  float u[kLanes][D];  // L_p^-1 (r - loc_p), prior positions
  float v[kLanes][D];  // L_p^-T u
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  // torch.clamp: NaN stays NaN
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float inside(float x, float lo, float hi) {
  return (x >= lo && x <= hi) ? 1.0f : 0.0f;
}

__device__ __forceinline__ float softplus(float x) {
  return x > 20.0f ? x : log1pf(expf(x));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Block of a latent position: 0 z_x, 1 z_c, 2 z_y.
__device__ __forceinline__ int block_of(int i, const Params& p) {
  return i < p.nx ? 0 : (i < p.nx + p.nc ? 1 : 2);
}

// A sum over the last axis of m <= D values in the order of PyTorch's CUDA
// reduction at these widths: thread t of W (the largest power of two <=
// m) adds v[t] and v[t + W], then a tree halves W to 1. So the forward
// rounds as the plain version's kernels do.
template <int W, int D>
__device__ __forceinline__ float tree_sum(const float (&v)[D], int m) {
  float p[W];
#pragma unroll
  for (int t = 0; t < W; ++t) {
    p[t] = v[t];
    if (t + W < D && t + W < m) p[t] = p[t] + v[t + W < D ? t + W : t];
  }
#pragma unroll
  for (int off = W / 2; off > 0; off /= 2) {
#pragma unroll
    for (int t = 0; t < off; ++t) p[t] = p[t] + p[t + off];
  }
  return p[0];
}

template <int D>
__device__ float torch_sum(const float (&v)[D], int m) {
  if (m <= 0) return 0.0f;
  if (D >= 16 && m >= 16) return tree_sum<(D >= 16 ? 16 : 1), D>(v, m);
  if (m >= 8) return tree_sum<(D >= 8 ? 8 : 1), D>(v, m);
  if (m >= 4) return tree_sum<4, D>(v, m);
  if (m >= 2) return tree_sum<2, D>(v, m);
  return v[0];
}

// torch_sum over positions [at, at + m) of t.
template <int D>
__device__ float block_sum(const float (&t)[D], int at, int m) {
  float v[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    float x = 0.0f;
#pragma unroll
    for (int i = k; i < D; ++i)
      if (i == at + k) x = t[i];
    v[k] = x;
  }
  return torch_sum<D>(v, m);
}

// One Gaussian head's (loc, L, sigma) for row b into shared memory at
// positions [at, at + m); L's row stride is D. Warp-cooperative.
template <int D>
__device__ void load_head(const Heads& h, int b, int m, bool full, int at,
                          float* loc, float* L, float* sig, float jitter,
                          int lane) {
  for (int i = lane; i < m; i += kLanes) {
    loc[at + i] = clampf(h.mean[(long long)b * m + i], -50.0f, 50.0f);
    sig[at + i] = expf(clampf(h.log_sigma[(long long)b * m + i], -7.0f, 3.0f));
  }
  for (int e = lane; e < m * m; e += kLanes) {
    const int i = e / m, j = e % m;
    float v = 0.0f;
    if (j == i) {
      v = expf(clampf(h.log_sigma[(long long)b * m + i], -7.0f, 3.0f)) +
          jitter;
    } else if (j < i && full) {
      v = clampf(h.tril[(long long)b * m * m + e], -20.0f, 20.0f);
    }
    L[(at + i) * D + at + j] = v;
  }
}

template <int D>
__device__ void load_row(const Inputs& in, const Params& p, int b,
                         RowState<D>& st, int lane) {
  load_head<D>(in.enc, b, p.d, p.full_e, 0, st.loc, st.L, st.sig, p.jitter,
               lane);
  load_head<D>(in.pc, b, p.nc, p.full_c, p.nx, st.ploc, st.PL, st.psig,
               p.jitter, lane);
  load_head<D>(in.py, b, p.ny, p.full_y, p.nx + p.nc, st.ploc, st.PL,
               st.psig, p.jitter, lane);
  for (int i = lane; i < p.nx; i += kLanes) {
    st.lb[i] = in.lb[i];
    st.a[i] = in.ub[i] - in.lb[i];
  }
  __syncwarp();
  if (lane == 0) {
    // sum(log diag L) of each Gaussian
    float h[D], hc[D], hy[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const int c = p.nx + k, y = p.nx + p.nc + k;
      h[k] = k < p.d ? logf(st.L[k * D + k]) : 0.0f;
      hc[k] = k < p.nc ? logf(st.PL[c * D + c]) : 0.0f;
      hy[k] = k < p.ny ? logf(st.PL[y * D + y]) : 0.0f;
    }
    st.hld = torch_sum<D>(h, p.d);
    st.hld_c = torch_sum<D>(hc, p.nc);
    st.hld_y = torch_sum<D>(hy, p.ny);
  }
  __syncwarp();
}

// One sample's forward: the normals e, the pre-squash latent r, the
// squashed z_x in zx, the priors' u = L_p^-1 (r - loc_p), and the sample's
// KL term.
template <int D>
__device__ float sample_forward(const Params& p, const RowState<D>& st,
                                const float* eps, float (&e)[D],
                                float (&r)[D], float (&zx)[D],
                                float (&u)[D]) {
#pragma unroll
  for (int j = 0; j < D; ++j) e[j] = j < p.d ? eps[j] : 0.0f;
  // r = loc + L e (the upper triangle's zeros summed too), and log q from
  // the normals
  float t[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    r[i] = 0.0f;
    if (i < p.d) {
      float prod[D];
#pragma unroll
      for (int j = 0; j < D; ++j) prod[j] = st.L[i * D + j] * e[j];
      r[i] = st.loc[i] + torch_sum<D>(prod, p.d);
    }
    t[i] = (-0.5f * e[i]) * e[i];
  }
  const float log_q = (torch_sum<D>(t, p.d) + p.dc_e) - st.hld;
  // The squash of z_x and its log-det (Logistic, then ShiftScale), and
  // log p_x
  float ld_logistic[D], ld_shift[D], lpx[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    zx[i] = ld_logistic[i] = ld_shift[i] = lpx[i] = 0.0f;
    if (i < p.nx) {
      const float kz = r[i] * p.k;
      ld_logistic[i] = (kz - softplus(kz) * 2.0f) + p.log_k;
      const float z = sigmoid(kz) * st.a[i] + st.lb[i];
      zx[i] = z;
      ld_shift[i] = logf(fabsf(st.a[i])) * 1.0f;
      if (p.px_kind[i] == 0) {
        const float zn = (z - p.px0[i]) * p.px1[i];
        lpx[i] = (((-0.5f * zn) * zn) + p.gauss) - p.px2[i];
      } else {
        lpx[i] = (z >= p.px0[i] && z <= p.px1[i]) ? p.px2[i] : -INFINITY;
      }
    }
  }
  const float log_det = (0.0f + torch_sum<D>(ld_logistic, p.nx)) +
                        torch_sum<D>(ld_shift, p.nx);
  // The learned priors at z_c and z_y, by forward substitution
#pragma unroll
  for (int i = 0; i < D; ++i) {
    u[i] = t[i] = 0.0f;
    if (i >= p.nx && i < p.d) {
      const int bi = block_of(i, p);
      const bool full = bi == 1 ? p.full_c : p.full_y;
      float acc = r[i] - st.ploc[i];
      if (full) {
#pragma unroll
        for (int j = 0; j < i; ++j) {
          if (block_of(j, p) == bi) acc = acc - st.PL[i * D + j] * u[j];
        }
      }
      u[i] = acc / st.PL[i * D + i];
      t[i] = (-0.5f * u[i]) * u[i];
    }
  }
  const float lpc = (block_sum<D>(t, p.nx, p.nc) + p.dc_c) - st.hld_c;
  const float lpy = (block_sum<D>(t, p.nx + p.nc, p.ny) + p.dc_y) - st.hld_y;
  return (log_q - log_det) - ((torch_sum<D>(lpx, p.nx) + lpc) + lpy);
}

template <int D>
__global__ void __launch_bounds__(kWarps * kLanes)
latent_gauss_fwd_kernel(Inputs in, Params p, float* __restrict__ zx_out,
                        float* __restrict__ zc_out,
                        float* __restrict__ zy_out,
                        float* __restrict__ kl_out) {
  __shared__ RowState<D> rows[kWarps];
  __shared__ float terms[kWarps][kMaxOrderedSamples];
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= p.rows) return;  // whole warps only
  RowState<D>& st = rows[warp];
  load_row<D>(in, p, b, st, lane);
  const bool ordered = p.mean_split > 0;
  float part = 0.0f;
  for (int s = lane; s < p.n; s += kLanes) {
    const long long at = (long long)s * p.rows + b;
    float e[D], r[D], zx[D], u[D];
    const float term = sample_forward<D>(p, st, in.eps + at * p.d, e, r, zx,
                                         u);
    if (ordered) terms[warp][s] = term; else part = part + term;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      if (i < p.nx) {
        zx_out[at * p.nx + i] = zx[i];
      } else if (i < p.nx + p.nc) {
        zc_out[at * p.nc + (i - p.nx)] = r[i];
      } else if (i < p.d) {
        zy_out[at * p.ny + (i - p.nx - p.nc)] = r[i];
      }
    }
  }
  if (ordered) {
    // torch.mean's order over the samples: thread y of mean_split adds
    // samples y, y + mean_split, ... into four interleaved accumulators,
    // combined in order, then a tree halves mean_split to 1.
    __syncwarp();
    const int h = p.mean_split;
    part = 0.0f;
    if (lane < h) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int k = 0;
      for (int s = lane; s < p.n; s += h, ++k)
        acc[k & 3] = acc[k & 3] + terms[warp][s];
      part = ((acc[0] + acc[1]) + acc[2]) + acc[3];
    }
    for (int off = h / 2; off > 0; off /= 2)
      part = part + __shfl_down_sync(kFull, part, off);
  } else {
    // Lane 0's sum, over the same tree in every run
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2)
      part = part + __shfl_xor_sync(kFull, part, off);
  }
  if (lane == 0) kl_out[b] = part * p.inv_n;
}

// The backward's entries of one row: the encoder's loc (d), its L (lower
// with the diagonal, or the diagonal alone), then each prior's loc and L.
// Entry e -> (kind, i, j) at latent positions: kind 0 encoder loc, 1
// encoder L, 2 prior loc, 3 prior L.
__device__ __forceinline__ void tri_entry(int e, bool full, int& i, int& j) {
  if (!full) {
    i = j = e;
    return;
  }
  i = 0;
  while ((i + 1) * (i + 2) / 2 <= e) ++i;
  j = e - i * (i + 1) / 2;
}

__device__ bool entry_of(int e, const Params& p, int& kind, int& i, int& j) {
  if (e < p.d) {
    kind = 0;
    i = j = e;
    return true;
  }
  e -= p.d;
  const int ne = p.full_e ? p.d * (p.d + 1) / 2 : p.d;
  if (e < ne) {
    kind = 1;
    tri_entry(e, p.full_e, i, j);
    return true;
  }
  e -= ne;
  for (int blk = 1; blk <= 2; ++blk) {
    const int m = blk == 1 ? p.nc : p.ny;
    const bool full = blk == 1 ? p.full_c : p.full_y;
    const int at = blk == 1 ? p.nx : p.nx + p.nc;
    if (e < m) {
      kind = 2;
      i = j = at + e;
      return true;
    }
    e -= m;
    const int nl = full ? m * (m + 1) / 2 : m;
    if (e < nl) {
      kind = 3;
      tri_entry(e, full, i, j);
      i += at;
      j += at;
      return true;
    }
    e -= nl;
  }
  return false;
}

template <int D>
struct Entries {
  // an upper bound on a row's entries: d + d(d+1)/2 for the encoder, as
  // much again for the two priors together
  static constexpr int kMax = 2 * (D + D * (D + 1) / 2);
  static constexpr int kPerLane = (kMax + kLanes - 1) / kLanes;
};

struct Grads {
  float* mean;
  float* log_sigma;
  float* tril;
};

struct Outputs {
  Grads enc, pc, py;
};

struct Upstream {
  const float* gzx;
  const float* gzc;
  const float* gzy;
  const float* gkl;
};

template <int D>
__global__ void __launch_bounds__(kWarps * kLanes)
latent_gauss_bwd_kernel(Inputs in, Upstream up, Outputs out, Params p) {
  __shared__ RowState<D> rows[kWarps];
  __shared__ Chunk<D> chunks[kWarps];
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= p.rows) return;  // whole warps only
  RowState<D>& st = rows[warp];
  Chunk<D>& ch = chunks[warp];
  load_row<D>(in, p, b, st, lane);
  const float gkl = up.gkl[b];
  const float w = gkl * p.inv_n;  // each sample's share of KL_x's grad

  constexpr int kPer = Entries<D>::kPerLane;
  int kind[kPer], ei[kPer], ej[kPer];
  float acc[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    acc[q] = 0.0f;
    if (!entry_of(lane + q * kLanes, p, kind[q], ei[q], ej[q])) kind[q] = -1;
  }

  for (int s0 = 0; s0 < p.n; s0 += kLanes) {
    const int s = s0 + lane;
    if (s < p.n) {
      const long long at = (long long)s * p.rows + b;
      float e[D], r[D], zx[D], u[D];
      sample_forward<D>(p, st, in.eps + at * p.d, e, r, zx, u);
      // v = L_p^-T u by back substitution, per prior block
      float v[D];
#pragma unroll
      for (int i = D - 1; i >= 0; --i) {
        v[i] = 0.0f;
        if (i >= p.nx && i < p.d) {
          const int bi = block_of(i, p);
          const bool full = bi == 1 ? p.full_c : p.full_y;
          float a = u[i];
          if (full) {
#pragma unroll
            for (int j = i + 1; j < D; ++j) {
              if (j < p.d && block_of(j, p) == bi)
                a = a - st.PL[j * D + i] * v[j];
            }
          }
          v[i] = a / st.PL[i * D + i];
        }
      }
      // The grad of r: the decoders' grads through the squash, and the KL
      // term's (the squash's log-det, log p_x, the priors)
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float g = 0.0f;
        if (i < p.nx) {
          const float sg = sigmoid(r[i] * p.k);
          const float dz = st.a[i] * ((1.0f - sg) * sg) * p.k;
          float dlp = 0.0f;
          if (p.px_kind[i] == 0) {
            const float zn = (zx[i] - p.px0[i]) * p.px1[i];
            dlp = -zn * p.px1[i];
          }
          const float dlogdet = p.k * (1.0f - 2.0f * sg);
          g = up.gzx[at * p.nx + i] * dz + w * (-dlogdet - dlp * dz);
        } else if (i < p.nx + p.nc) {
          g = up.gzc[at * p.nc + (i - p.nx)] + w * v[i];
        } else if (i < p.d) {
          g = up.gzy[at * p.ny + (i - p.nx - p.nc)] + w * v[i];
        }
        ch.g[lane][i] = g;
        ch.e[lane][i] = e[i];
        ch.u[lane][i] = u[i];
        ch.v[lane][i] = v[i];
      }
    }
    __syncwarp();
    // Each lane sums its entries over the chunk's samples, in order
    const int m = min(kLanes, p.n - s0);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int k = kind[q], i = ei[q], j = ej[q];
      if (k < 0) continue;
      float a = acc[q];
      for (int t = 0; t < m; ++t) {
        float x;
        if (k == 0) x = ch.g[t][i];
        else if (k == 1) x = ch.g[t][i] * ch.e[t][j];
        else if (k == 2) x = ch.v[t][i];
        else x = ch.v[t][i] * ch.u[t][j];
        a = a + x;
      }
      acc[q] = a;
    }
    __syncwarp();
  }

  // The raw heads' grads, through the jitter, exp and clamps
  const long long bd = (long long)b * p.d;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int k = kind[q], i = ei[q], j = ej[q];
    if (k < 0) continue;
    if (k == 0) {
      out.enc.mean[bd + i] = acc[q] * inside(in.enc.mean[bd + i], -50.f, 50.f);
    } else if (k == 1 && i == j) {
      const float gl = acc[q] - gkl / st.L[i * D + i];
      out.enc.log_sigma[bd + i] =
          gl * st.sig[i] * inside(in.enc.log_sigma[bd + i], -7.f, 3.f);
    } else if (k == 1) {
      const long long t = bd * p.d + i * p.d + j;
      out.enc.tril[t] = acc[q] * inside(in.enc.tril[t], -20.f, 20.f);
    } else {
      const bool c = block_of(i, p) == 1;
      const int at = c ? p.nx : p.nx + p.nc, m = c ? p.nc : p.ny;
      const Heads& h = c ? in.pc : in.py;
      const Grads& g = c ? out.pc : out.py;
      const long long bm = (long long)b * m;
      const int li = i - at, lj = j - at;
      const float gv = -w * acc[q];
      if (k == 2) {
        g.mean[bm + li] = gv * inside(h.mean[bm + li], -50.f, 50.f);
      } else if (i == j) {
        const float gl = gv + gkl / st.PL[i * D + i];
        g.log_sigma[bm + li] =
            gl * st.psig[i] * inside(h.log_sigma[bm + li], -7.f, 3.f);
      } else {
        const long long t = bm * m + li * m + lj;
        g.tril[t] = gv * inside(h.tril[t], -20.f, 20.f);
      }
    }
  }
  // The tril heads' entries on and above the diagonal take no grad
  if (p.full_e) {
    for (int e = lane; e < p.d * p.d; e += kLanes)
      if (e % p.d >= e / p.d) out.enc.tril[bd * p.d + e] = 0.0f;
  }
  if (p.full_c) {
    for (int e = lane; e < p.nc * p.nc; e += kLanes)
      if (e % p.nc >= e / p.nc)
        out.pc.tril[(long long)b * p.nc * p.nc + e] = 0.0f;
  }
  if (p.full_y) {
    for (int e = lane; e < p.ny * p.ny; e += kLanes)
      if (e % p.ny >= e / p.ny)
        out.py.tril[(long long)b * p.ny * p.ny + e] = 0.0f;
  }
}

// ints: n, rows, d, nx, nc, ny, full_e, full_c, full_y, mean_split.
// floats: gauss, jitter, k, log k, dc_e, dc_c, dc_y, inv_n, then kMaxDims
// each of the z_x prior's kind, p0, p1, p2.
int read_params(const long long* ints, const float* floats, Params& p) {
  p.n = (int)ints[0];
  p.rows = (int)ints[1];
  p.d = (int)ints[2];
  p.nx = (int)ints[3];
  p.nc = (int)ints[4];
  p.ny = (int)ints[5];
  p.full_e = (int)ints[6];
  p.full_c = (int)ints[7];
  p.full_y = (int)ints[8];
  p.mean_split = (int)ints[9];
  p.gauss = floats[0];
  p.jitter = floats[1];
  p.k = floats[2];
  p.log_k = floats[3];
  p.dc_e = floats[4];
  p.dc_c = floats[5];
  p.dc_y = floats[6];
  p.inv_n = floats[7];
  for (int i = 0; i < kMaxDims; ++i) {
    p.px_kind[i] = (int)floats[8 + i];
    p.px0[i] = floats[8 + kMaxDims + i];
    p.px1[i] = floats[8 + 2 * kMaxDims + i];
    p.px2[i] = floats[8 + 3 * kMaxDims + i];
  }
  if (p.n < 1 || p.rows < 1 || p.d < 1 || p.d > kMaxDims || p.nx < 0 ||
      p.nc < 0 || p.ny < 0 || p.nx + p.nc + p.ny != p.d ||
      p.mean_split < 0 || p.mean_split > kLanes ||
      (p.mean_split > 0 && p.n > kMaxOrderedSamples))
    return (int)cudaErrorInvalidValue;
  return 0;
}

Inputs make_inputs(const float* const* heads, const float* eps,
                   const float* lb, const float* ub) {
  Inputs in;
  in.enc = Heads{heads[0], heads[1], heads[2]};
  in.pc = Heads{heads[3], heads[4], heads[5]};
  in.py = Heads{heads[6], heads[7], heads[8]};
  in.eps = eps;
  in.lb = lb;
  in.ub = ub;
  return in;
}

}  // namespace

extern "C" {

const char* latent_gauss_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// heads: the nine raw outputs (encoder, prior c, prior y; each mean,
// log-sigma, tril or null). Writes z_x, z_c, z_y (n, rows, *) and KL_x
// (rows,). Returns the launch's error code.
int latent_gauss_fwd(const float* const* heads, const float* eps,
                     const float* lb, const float* ub, float* zx, float* zc,
                     float* zy, float* kl, const long long* ints,
                     const float* floats, void* stream) {
  Params p;
  int err = read_params(ints, floats, p);
  if (err) return err;
  const Inputs in = make_inputs(heads, eps, lb, ub);
  const dim3 grid((p.rows + kWarps - 1) / kWarps), block(kWarps * kLanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.d <= 8)
    latent_gauss_fwd_kernel<8><<<grid, block, 0, st>>>(in, p, zx, zc, zy, kl);
  else
    latent_gauss_fwd_kernel<16><<<grid, block, 0, st>>>(in, p, zx, zc, zy,
                                                        kl);
  return (int)cudaGetLastError();
}

// upstream: the grads of z_x, z_c, z_y and KL_x; grads: the nine raw
// outputs' grads, in the order of heads (null where a tril is null).
int latent_gauss_bwd(const float* const* heads, const float* eps,
                     const float* lb, const float* ub,
                     const float* const* upstream, float* const* grads,
                     const long long* ints, const float* floats,
                     void* stream) {
  Params p;
  int err = read_params(ints, floats, p);
  if (err) return err;
  const Inputs in = make_inputs(heads, eps, lb, ub);
  const Upstream up{upstream[0], upstream[1], upstream[2], upstream[3]};
  Outputs out;
  out.enc = Grads{grads[0], grads[1], grads[2]};
  out.pc = Grads{grads[3], grads[4], grads[5]};
  out.py = Grads{grads[6], grads[7], grads[8]};
  const dim3 grid((p.rows + kWarps - 1) / kWarps), block(kWarps * kLanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.d <= 8)
    latent_gauss_bwd_kernel<8><<<grid, block, 0, st>>>(in, up, out, p);
  else
    latent_gauss_bwd_kernel<16><<<grid, block, 0, st>>>(in, up, out, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
