// The two kernels of the fused two-layer MLP: the forward (this note) and
// the backward's hidden-layer recompute (fused_mlp_hidden_kernel, below).
//
// Fused two-layer MLP forward, y = relu(x @ W0^T + b0) @ W1^T + b1, with
// f32-accurate arithmetic.
//
// Replaces the TPU kernel dpivae_tpu/ops/pallas_mlp.py:_mlp_kernel
// (launched by _pallas_forward), the data-driven branch of decoder_x.
// Weights are in torch.nn.Linear layout: W0 (H, d_in), W1 (d_out, H).
//
// What bounds it on an H100 SXM (published peaks at 700 W): at the serving
// shape, 262,144 rows x (4 -> 128 -> 32), it must move 37.8 MB (x in, y
// out, weights once: 11.3 us at 3.35 TB/s). The second layer is 4,096 of
// the 4,608 multiply-adds of a row. On the CUDA cores in f32 that layer
// alone floors the kernel at 32 us (67 TFLOP/s); on the TF32 tensor cores
// in three passes (below) it needs 13.0 us (495 TFLOP/s), the first layer
// 4.0 us on the CUDA cores. So with the tensor cores the kernel is bound by
// tensor operations and bytes about equally (13.0 against 11.3 us). As
// built it reaches about a quarter of that bound (chip_smoke.py prints the
// share): a k step is a chain of shared-memory loads, FMAs, splits and
// dependent mma.sync, and at 92 registers a thread 16 warps share an SM,
// too few to hide that chain's latency (inferred from the code; more warps
// per SM, capped registers and prefetching the next tile's x measured no
// faster).
//
// What the design does about it:
// - Layer 2 runs on the tensor cores, mma.sync m16n8k8 TF32, in the 3xTF32
//   split: each f32 operand v becomes hi = tf32(v) and lo = v - hi, and a
//   product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi. That keeps about 21 of
//   f32's 24 bits of each product; one TF32 pass keeps 11 and misses
//   rtol/atol 1e-5 against the f32 plain version (tests/
//   test_torch_port_ops.py shows both on an f32 model of the arithmetic,
//   which rounds where the tensor cores truncate: under 1e-5 against
//   float64 for the split, over 1e-3 for one pass; the kernel's own error
//   is measured only on the card). The tensor cores' own accumulation
//   truncates to the accumulator's magnitude: with all three passes summed
//   into one accumulator the CUDA tests missed 1e-5 at 65,536 x
//   (4 -> 256 -> 32) (1.19e-5). So the two small cross terms get their own
//   accumulator, and each k step's hi*hi product is summed from zero on the
//   tensor cores and added to an f32 register total with rounded adds:
//   every truncation is then relative to one k step's 8 products. Measured
//   on an H100 80GB HBM3 at 700 W (chip_smoke.py, W1 at scale 0.3, so
//   outputs spread as sqrt(H)): max abs error against float64 4.3e-6 at
//   H = 256, 6.4e-6 at 512, 5.9e-6 at 1,024, where plain f32 (cuBLAS)
//   reads 7.8e-6, 1.2e-5 and 3.0e-5. The split is closer to float64 than
//   plain f32 is, so where it misses 1e-5 against plain at H = 1,024 the
//   miss is plain's; going back to f32 FMA would not remove it.
// - mma.sync, not wgmma: N = d_out = 32 and K = H = 128 are small, and one
//   warp that owns a 16-row m-tile gives the parallelism that 1,024 rows
//   need. wgmma and TMA pay off only if a measurement shows the kernel
//   bound by the tensor pipe.
// - Layer 1 runs in f32 on the CUDA cores, straight into the A fragments:
//   for each 8-wide k step a lane computes exactly the four hidden values
//   its fragment holds (rows g and g+8 of its m-tile, hidden k0+t and
//   k0+t+4, with g = lane / 4 and t = lane % 4), from its two rows of x
//   held in registers. h never goes to shared or device memory, and there
//   is no barrier inside the k loop.
// - Tiling by row count. Up to kSplitTilesPerSm m-tiles per SM (1,024 and
//   8,192 rows on 132 SMs) a block of kSplitWarps warps takes one m-tile
//   and splits its k steps among the warps, which read their B fragments
//   of W1, and W0 and b0, straight from the L1/L2 caches and split them in
//   registers; one barrier sums the warps' partial tiles through shared
//   memory. So 1,024 rows put their 64 m-tiles on 64 SMs with a quarter of
//   the k steps on each warp. Above that (16,384 rows and up) blocks of
//   kStagedWarps warps are persistent (one wave, sized by the occupancy
//   calculator): each stages W1's column tile once, split into hi and lo and
//   laid out in fragment order (one conflict-free 16-byte load per lane per
//   n-tile and k step), and W0 and b0 padded; then each warp walks m-tiles
//   with all k steps. Each path forced at 4 -> 128 -> 32 (chip_smoke.py,
//   same card): split 0.0070 / 0.0085 / 0.0165 / 0.0207 ms against staged
//   0.0085 / 0.0087 / 0.0090 / 0.0121 ms at 1,024 / 8,192 / 16,384 /
//   32,768 rows, so the switch sits between 8,192 and 16,384.
// - K (hidden) and N (d_out) are padded to multiples of 8 with zeros, and
//   every n-tile of a column tile is computed (a branch per n-tile cost
//   more than the zero work it saves); d_out over 32 is tiled over
//   blockIdx.y, layer 1 recomputed per column tile. d_in is a compile-time
//   bucket (4, 8 or 16; zero-padded above d_in), so layer 1 is unrolled;
//   d_in over 16 takes a runtime-length loop that reads x and W0 from the
//   caches, on the split path only.
// - Stores go out of the C fragments: a quad writes 32 contiguous bytes of
//   a row per n-tile (8-byte stores; scalar where d_out is odd), ragged
//   rows and columns masked. Staging C through shared memory for 16-byte
//   stores was not tried: y is 33.5 MB of the serving shape's 37.8, and the
//   kernel runs well below the byte bound.
// - Sweep members (the counterpart of pallas_call's batching rule, which
//   adds a grid axis under jax.vmap) go on blockIdx.z: one launch covers
//   every member, each block offsetting its pointers by its member's
//   strides (MemberStrides; 0 for an array the members share). The bodies
//   are those of a single call, which is the one-member case. The path is
//   chosen on the m-tiles of all members together, and the staged path's
//   persistent grid is divided among the members.
// - Where the staged weights do not fit one block's shared memory (H over
//   about 840 at d_in 4, e.g. H = 1,024) or d_in is over 16, every row
//   count takes the split path, which stages nothing: any width runs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kWarp = 32;
constexpr int kTileM = 16;            // rows of an m-tile, one warp's
constexpr int kTileN = 32;            // output columns of a block
constexpr int kNT = kTileN / 8;       // n-tiles of 8 columns in a block
constexpr int kStagedWarps = 8;
constexpr int kSplitWarps = 4;        // warps sharing one m-tile's k steps
constexpr int kSplitTilesPerSm = 4;   // up to here the split path
constexpr int kThreads = 256;

// The split path's warp w reduces and stores n-tile w.
static_assert(kSplitWarps >= kNT, "a split block needs a warp per n-tile");

// Elements between one member's array and the next, for a launch over a
// member axis (blockIdx.z); 0 shares the array across members. A single
// call is one member with every stride 0.
struct MemberStrides {
  int64_t x, w0, b0, w1, b1, out;
};

// d_in rounded up to the compile-time width the kernels are built for.
int din_bucket(int d_in) {
  return d_in <= 4 ? 4 : d_in <= 8 ? 8 : d_in <= 16 ? 16 : (d_in + 3) / 4 * 4;
}

// The staged forward's shared memory, in floats: W1's column tile in
// fragment order (hi and lo), W0 with rows padded to the d_in bucket, b0;
// all over the hidden width padded to a multiple of 8.
size_t fwd_smem_floats(int d_in, int d_hidden) {
  const size_t kp = (size_t)(d_hidden + 7) / 8 * 8;
  return kp * 2 * kTileN + kp * din_bucket(d_in) + kp;
}

// v = hi + lo. hi is v rounded to TF32 (10 mantissa bits, to nearest,
// ties away from zero: cvt.rna.tf32.f32 done with two integer operations),
// lo the exact f32 remainder; the tensor cores read only lo's TF32 bits
// (they drop its low 13), which costs about 2^-22 of v.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// Layer 1 into the A fragment: h += (xa, xb) x (wa, wb), the lane's two
// rows by its two hidden units.
__device__ __forceinline__ void fma4(float (&h)[4], float xa, float xb, float wa,
                                     float wb) {
  h[0] = fmaf(xa, wa, h[0]);
  h[1] = fmaf(xb, wa, h[1]);
  h[2] = fmaf(xa, wb, h[2]);
  h[3] = fmaf(xb, wb, h[3]);
}

// c += a (16x8, row) * b (8x8, col), TF32 inputs, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b, from a zero accumulator.
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

template <int DINB, bool kStaged>
__global__ void __launch_bounds__(kStagedWarps * kWarp)
fused_mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                     const float* __restrict__ b0, const float* __restrict__ w1,
                     const float* __restrict__ b1, float* __restrict__ out,
                     int64_t rows, int d_in, int d_hidden, int d_out,
                     MemberStrides ms) {
  static_assert(DINB > 0 || !kStaged, "the staged path takes a d_in bucket");
  // Member blockIdx.z's arrays; a stride of 0 shares an array across members.
  {
    const int64_t m = blockIdx.z;
    x += m * ms.x;
    w0 += m * ms.w0;
    b0 += m * ms.b0;
    w1 += m * ms.w1;
    b1 += m * ms.b1;
    out += m * ms.out;
  }
  constexpr int kDx = DINB > 0 ? DINB : 1;   // x and W0 rows in registers
  extern __shared__ __align__(16) float smem[];
  const int n_ks = (d_hidden + 7) / 8;
  const int kp = n_ks * 8;
  // [n_ks][kNT][kWarp] of {b0 hi, b1 hi, b0 lo, b1 lo}
  float4* w1f = reinterpret_cast<float4*>(smem);
  float* w0s = smem + (size_t)kp * 2 * kTileN;           // [kp][DINB]
  float* b0s = w0s + (size_t)kp * DINB;                  // [kp]

  const int lane = threadIdx.x % kWarp;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col0 = blockIdx.y * kTileN;
  const int n_nt = min(kNT, (d_out - col0 + 7) / 8);     // n-tiles with columns

  if constexpr (kStaged) {
    for (int i = threadIdx.x; i < n_ks * kNT * kWarp; i += blockDim.x) {
      const int ln = i % kWarp;
      const int n = col0 + (i / kWarp) % kNT * 8 + (ln >> 2);
      const int k = i / (kWarp * kNT) * 8 + (ln & 3);
      const float* wr = w1 + (size_t)n * d_hidden;
      const float v0 = n < d_out && k < d_hidden ? wr[k] : 0.f;
      const float v1 = n < d_out && k + 4 < d_hidden ? wr[k + 4] : 0.f;
      uint32_t h0, l0, h1, l1;
      split_tf32(v0, h0, l0);
      split_tf32(v1, h1, l1);
      w1f[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                           __uint_as_float(l0), __uint_as_float(l1));
    }
    for (int i = threadIdx.x; i < kp * kDx; i += blockDim.x) {
      const int k = i / kDx;
      const int j = i % kDx;
      w0s[i] = k < d_hidden && j < d_in ? w0[(size_t)k * d_in + j] : 0.f;
    }
    for (int i = threadIdx.x; i < kp; i += blockDim.x)
      b0s[i] = i < d_hidden ? b0[i] : 0.f;
    __syncthreads();
  }

  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const bool pair_store = (d_out % 2) == 0;
  // Writes n-tile nt of the C fragment: v0, v1 at (g, 2t, 2t+1), v2, v3 at
  // (g+8, 2t, 2t+1) of the m-tile whose row g is r_lo.
  auto store = [&](int64_t r_lo, int nt, const float (&v)[4]) {
    const int c = col0 + nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = r_lo + 8 * half;
      if (row >= rows) continue;
      float* o = out + row * d_out + c;
      if (pair_store && c + 1 < d_out) {
        *reinterpret_cast<float2*>(o) = make_float2(v[2 * half], v[2 * half + 1]);
      } else {
        if (c < d_out) o[0] = v[2 * half];
        if (c + 1 < d_out) o[1] = v[2 * half + 1];
      }
    }
  };
  float bias[kNT][2];         // the staged path's; the split path adds b1 last
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = col0 + nt * 8 + 2 * t + e;
      bias[nt][e] = kStaged && c < d_out ? __ldg(b1 + c) : 0.f;
    }

  // Staged: every warp walks m-tiles, each with all k steps. Split: the
  // block's warps share one m-tile, warp w taking k steps w, w + warps, ...
  const int64_t n_mt = (rows + kTileM - 1) / kTileM;
  const int64_t mt0 = kStaged ? (int64_t)blockIdx.x * warps + warp : blockIdx.x;
  const int64_t mt_step = kStaged ? (int64_t)gridDim.x * warps : gridDim.x;
  const int ks0 = kStaged ? 0 : warp;
  const int ks_step = kStaged ? 1 : warps;
  for (int64_t mt = mt0; mt < n_mt; mt += mt_step) {
    const int64_t r_lo = mt * kTileM + g;
    const int64_t r_hi = r_lo + 8;
    float xa[kDx], xb[kDx];
#pragma unroll
    for (int j = 0; j < DINB; ++j) {
      xa[j] = j < d_in && r_lo < rows ? __ldg(x + r_lo * d_in + j) : 0.f;
      xb[j] = j < d_in && r_hi < rows ? __ldg(x + r_hi * d_in + j) : 0.f;
    }
    // acc sums the hi*hi products (and b1), small the two cross terms.
    float acc[kNT][4], small[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      acc[nt][0] = acc[nt][2] = bias[nt][0];
      acc[nt][1] = acc[nt][3] = bias[nt][1];
#pragma unroll
      for (int i = 0; i < 4; ++i) small[nt][i] = 0.f;
    }

#pragma unroll 2
    for (int ks = ks0; ks < n_ks; ks += ks_step) {
      const int ka = ks * 8 + t;   // hidden unit of a0/a1; a2/a3 take ka + 4
      const int kb = ka + 4;
      // The A fragment: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4).
      float h[4];
      if constexpr (kStaged) {
        h[0] = h[1] = b0s[ka];
        h[2] = h[3] = b0s[kb];
#pragma unroll
        for (int j = 0; j < DINB; j += 4) {
          const float4 va = *reinterpret_cast<const float4*>(w0s + ka * DINB + j);
          const float4 vb = *reinterpret_cast<const float4*>(w0s + kb * DINB + j);
          fma4(h, xa[j], xb[j], va.x, vb.x);
          fma4(h, xa[j + 1], xb[j + 1], va.y, vb.y);
          fma4(h, xa[j + 2], xb[j + 2], va.z, vb.z);
          fma4(h, xa[j + 3], xb[j + 3], va.w, vb.w);
        }
      } else {
        const bool in_a = ka < d_hidden, in_b = kb < d_hidden;
        const float* wra = w0 + (size_t)(in_a ? ka : 0) * d_in;
        const float* wrb = w0 + (size_t)(in_b ? kb : 0) * d_in;
        h[0] = h[1] = in_a ? __ldg(b0 + ka) : 0.f;
        h[2] = h[3] = in_b ? __ldg(b0 + kb) : 0.f;
        if constexpr (DINB > 0) {
#pragma unroll
          for (int j = 0; j < DINB; ++j)
            fma4(h, xa[j], xb[j], j < d_in && in_a ? __ldg(wra + j) : 0.f,
                 j < d_in && in_b ? __ldg(wrb + j) : 0.f);
        } else {
          // d_in over 16: a runtime loop, x read again from the caches.
          for (int j = 0; j < d_in; ++j)
            fma4(h, r_lo < rows ? __ldg(x + r_lo * d_in + j) : 0.f,
                 r_hi < rows ? __ldg(x + r_hi * d_in + j) : 0.f,
                 in_a ? __ldg(wra + j) : 0.f, in_b ? __ldg(wrb + j) : 0.f);
        }
      }
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(fmaxf(h[i], 0.f), ah[i], al[i]);

#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t bh0, bh1, bl0, bl1;   // b0 (k = t, n = g), b1 (k = t+4, n = g)
        if constexpr (kStaged) {
          const float4 f = w1f[(ks * kNT + nt) * kWarp + lane];
          bh0 = __float_as_uint(f.x);
          bh1 = __float_as_uint(f.y);
          bl0 = __float_as_uint(f.z);
          bl1 = __float_as_uint(f.w);
        } else {
          const int n = col0 + nt * 8 + g;
          const float* wr = w1 + (size_t)n * d_hidden;
          split_tf32(n < d_out && ka < d_hidden ? __ldg(wr + ka) : 0.f, bh0, bl0);
          split_tf32(n < d_out && kb < d_hidden ? __ldg(wr + kb) : 0.f, bh1, bl1);
        }
        mma_tf32(small[nt], al, bh0, bh1);
        mma_tf32(small[nt], ah, bl0, bl1);
        float big[4];
        mma_tf32_zero(big, ah, bh0, bh1);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] += big[i];
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] += small[nt][i];

    if constexpr (kStaged) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        if (nt >= n_nt) break;
        store(r_lo, nt, acc[nt]);
      }
    } else {
      // Sum the warps' partial tiles through shared memory, [warps][kNT]
      // [kWarp] float4s (conflict-free); warp w then adds b1 to n-tile w
      // and stores it.
      float4* red = reinterpret_cast<float4*>(smem);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        red[(warp * kNT + nt) * kWarp + lane] =
            make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
      __syncthreads();
      if (warp < n_nt) {
        const int c = col0 + warp * 8 + 2 * t;
        const float c0 = c < d_out ? __ldg(b1 + c) : 0.f;
        const float c1 = c + 1 < d_out ? __ldg(b1 + c + 1) : 0.f;
        float v[4] = {c0, c1, c0, c1};
        for (int w = 0; w < warps; ++w) {
          const float4 p = red[(w * kNT + warp) * kWarp + lane];
          v[0] += p.x;
          v[1] += p.y;
          v[2] += p.z;
          v[3] += p.w;
        }
        store(r_lo, warp, v);
      }
      __syncthreads();   // red is free for the block's next m-tile
    }
  }
}

// Hidden-layer recompute for the backward pass, h = relu(x @ W0^T + b0),
// in f32. Replaces the TPU kernel dpivae_tpu/ops/pallas_mlp.py:
// _mlp_hidden_kernel (launched by _pallas_hidden): the forward never saves
// the (rows, H) activation, so the backward rebuilds it.
//
// What bounds it on an H100 SXM (published peaks at 700 W): it writes
// rows x H f32 and reads almost nothing, so the bytes it stores bound it:
// 0.16 us at 1,024 x (4 -> 128), 20.4 us at 65,536 x (4 -> 256) at
// 3.35 TB/s. At 1,024 rows, in practice, launch latency bounds it.
//
// What the design does about it: every lane owns 4 consecutive hidden units
// and holds their W0 rows and b0 in registers (read-only loads, once); no
// shared memory and no barrier. For each row it reads that row's x (one
// address for the whole row group: a broadcast) and writes one 16-byte
// store, so a warp covers 128 hidden units of a row with 512 contiguous
// bytes (H = 256 takes two warps; narrower H packs several rows into a
// warp). A grid-stride loop over rows, sized from the SM count, unrolls
// kHiddenUnroll rows per lane so that several 16-byte stores are in flight
// per thread. The stores are streaming (st.global.cs): h is written once
// and read once by the backward's products, and evict-first stores reached
// the write rate sooner. Where H % 4 != 0 a row's start is not 16-byte
// aligned and the lane stores 4 scalars instead. d_in is a compile-time
// bucket (4, 8 or 16, zero-padded), so the FMAs are unrolled with no
// runtime loop; d_in over 16 takes a runtime-length loop that reads W0
// from the caches. H over 4 * kThreads takes several passes over the rows,
// each lane owning the next group of 4 units in each. Sweep members go on
// blockIdx.z as in the forward, the row grid divided among them.
constexpr int kHiddenUnroll = 4;
constexpr int kHiddenBlocksPerSm = 8;

template <int DINB>
__global__ void __launch_bounds__(kThreads)
fused_mlp_hidden_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                        const float* __restrict__ b0, float* __restrict__ h,
                        int64_t rows, int d_in, int d_hidden, int lanes_per_row,
                        MemberStrides ms) {
  constexpr int kDx = DINB > 0 ? DINB : 1;   // x and W0 rows in registers
  {
    const int64_t m = blockIdx.z;   // the member; ms.out is h's stride
    x += m * ms.x;
    w0 += m * ms.w0;
    b0 += m * ms.b0;
    h += m * ms.out;
  }
  const int rows_per_pass = blockDim.x / lanes_per_row;
  const int slot = threadIdx.x / lanes_per_row;
  if (slot >= rows_per_pass) return;
  const bool vec = (d_hidden % 4) == 0;
  const int64_t stride = (int64_t)gridDim.x * rows_per_pass;

  for (int k0 = 4 * (threadIdx.x % lanes_per_row); k0 < d_hidden;
       k0 += 4 * lanes_per_row) {
    float w[4][kDx], bias[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + i;
      bias[i] = k < d_hidden ? __ldg(b0 + k) : 0.f;
#pragma unroll
      for (int j = 0; j < DINB; ++j)
        w[i][j] = k < d_hidden && j < d_in ? __ldg(w0 + k * d_in + j) : 0.f;
    }

    for (int64_t r0 = (int64_t)blockIdx.x * rows_per_pass + slot; r0 < rows;
         r0 += kHiddenUnroll * stride) {
      float xv[kHiddenUnroll][kDx];
#pragma unroll
      for (int u = 0; u < kHiddenUnroll; ++u) {
        const int64_t row = r0 + u * stride;
#pragma unroll
        for (int j = 0; j < DINB; ++j)
          xv[u][j] = row < rows && j < d_in ? __ldg(x + row * d_in + j) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kHiddenUnroll; ++u) {
        const int64_t row = r0 + u * stride;
        if (row >= rows) break;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = bias[i];
        if constexpr (DINB > 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < DINB; ++j) v[i] = fmaf(xv[u][j], w[i][j], v[i]);
        } else {
          for (int j = 0; j < d_in; ++j) {
            const float xj = __ldg(x + row * d_in + j);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (k0 + i < d_hidden)
                v[i] = fmaf(xj, __ldg(w0 + (k0 + i) * d_in + j), v[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = fmaxf(v[i], 0.f);
        float* dst = h + row * d_hidden + k0;
        if (vec) {
          __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k0 + i < d_hidden) dst[i] = v[i];
        }
      }
    }
  }
}

// What a launch asks of the runtime that does not change between launches:
// the device's limits, and for each staged forward kernel the dynamic
// shared memory already granted and its occupancy at its last size. Read or
// set once per device and reused, so a launch costs no attribute queries;
// launches hold g_launch_mutex while they read or update it.
constexpr int kMaxDevices = 64;
constexpr int kBuckets = 3;           // d_in buckets 4, 8, 16
struct StagedState {
  size_t granted = 0;         // largest dynamic shared memory granted
  size_t occ_smem = 0;        // per_sm holds for this size
  int per_sm = 0;
};
struct DeviceState {
  int n_sm = 0;               // 0 until the limits are read
  int max_smem = 0;
  StagedState fwd[kBuckets];
};
std::mutex g_launch_mutex;
DeviceState g_devices[kMaxDevices];

// The calling thread's current device, its limits read on first use.
cudaError_t current_device(DeviceState** state) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceState& s = g_devices[device];
  if (s.n_sm == 0) {
    int max_smem = 0, n_sm = 0;
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    s.max_smem = max_smem;
    s.n_sm = n_sm;
  }
  *state = &s;
  return cudaSuccess;
}

// path: -1 chooses by the m-tiles of all members and the width, 0 takes the
// split path and 1 the staged path whatever the row count (refused where it
// cannot run).
template <int DINB>
cudaError_t launch_fwd(const float* x, const float* w0, const float* b0,
                       const float* w1, const float* b1, float* out,
                       long long rows, int d_in, int d_hidden, int d_out,
                       int members, const MemberStrides& ms, int path,
                       DeviceState& s, cudaStream_t stream) {
  const int col_tiles = (d_out + kTileN - 1) / kTileN;
  const long long n_mt = (rows + kTileM - 1) / kTileM;
  const size_t smem = fwd_smem_floats(d_in, d_hidden) * sizeof(float);
  const bool can_stage = DINB > 0 && smem <= (size_t)s.max_smem;
  const bool staged =
      path < 0 ? can_stage && n_mt * col_tiles * members >
                                  (long long)kSplitTilesPerSm * s.n_sm
               : path == 1;
  if (!staged) {
    if (n_mt > 0x7fffffffLL) return cudaErrorInvalidValue;
    const size_t red = (size_t)kSplitWarps * kNT * kWarp * sizeof(float4);
    dim3 grid((unsigned)n_mt, (unsigned)col_tiles, (unsigned)members);
    fused_mlp_fwd_kernel<DINB, false><<<grid, kSplitWarps * kWarp, red, stream>>>(
        x, w0, b0, w1, b1, out, rows, d_in, d_hidden, d_out, ms);
    return cudaGetLastError();
  }
  if (!can_stage) return cudaErrorInvalidValue;
  if constexpr (DINB > 0) {
    StagedState& st = s.fwd[DINB == 4 ? 0 : DINB == 8 ? 1 : 2];
    const void* kernel = (const void*)fused_mlp_fwd_kernel<DINB, true>;
    cudaError_t err = cudaSuccess;
    if (smem > st.granted) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
      st.granted = smem;
    }
    if (st.occ_smem != smem) {
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_mlp_fwd_kernel<DINB, true>, kStagedWarps * kWarp, smem);
      if (err != cudaSuccess) return err;
      st.per_sm = per_sm < 1 ? 1 : per_sm;
      st.occ_smem = smem;
    }
    // One wave of resident blocks, shared among column tiles and members
    // (at least one block each).
    const long long blocks = (n_mt + kStagedWarps - 1) / kStagedWarps;
    const long long share = (long long)col_tiles * members;
    long long resident = ((long long)s.n_sm * st.per_sm + share - 1) / share;
    if (resident < 1) resident = 1;
    dim3 grid((unsigned)(blocks < resident ? blocks : resident), (unsigned)col_tiles,
              (unsigned)members);
    fused_mlp_fwd_kernel<DINB, true><<<grid, kStagedWarps * kWarp, smem, stream>>>(
        x, w0, b0, w1, b1, out, rows, d_in, d_hidden, d_out, ms);
  }
  return cudaGetLastError();
}

template <int DINB>
cudaError_t launch_hidden(const float* x, const float* w0, const float* b0,
                          float* h, long long rows, int d_in, int d_hidden,
                          int members, const MemberStrides& ms,
                          const DeviceState& s, cudaStream_t stream) {
  // Lanes of a row: a power of two up to a warp, whole warps above, at most
  // the block.
  const int quads = (d_hidden + 3) / 4;
  int lanes = 1;
  while (lanes < quads && lanes < kWarp) lanes *= 2;
  if (quads > kWarp) lanes = (quads + kWarp - 1) / kWarp * kWarp;
  if (lanes > kThreads) lanes = kThreads;
  const int rows_per_pass = kThreads / lanes;
  const long long passes = (rows + rows_per_pass - 1) / rows_per_pass;
  long long most = (long long)s.n_sm * kHiddenBlocksPerSm / members;
  if (most < 1) most = 1;
  dim3 grid((unsigned)(passes < most ? passes : most), 1, (unsigned)members);
  fused_mlp_hidden_kernel<DINB><<<grid, kThreads, 0, stream>>>(
      x, w0, b0, h, rows, d_in, d_hidden, lanes, ms);
  return cudaGetLastError();
}

// The grid's member axis (blockIdx.z) takes at most 65,535 members.
constexpr int kMaxMembers = 65535;

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the staged forward needs for
// these widths. Where they exceed the device's limit for one block, or
// d_in is over 16, the forward takes its split path (8 KB) at every row
// count.
size_t fused_mlp_fwd_smem_bytes(int d_in, int d_hidden) {
  return fwd_smem_floats(d_in, d_hidden) * sizeof(float);
}

const char* fused_mlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// fused_mlp_fwd on the path named (see launch_fwd): -1 as fused_mlp_fwd
// does, 0 the split path, 1 the staged path. For measuring the two paths
// against each other at one row count.
int fused_mlp_fwd_on_path(const void* x, const void* w0, const void* b0,
                          const void* w1, const void* b1, void* out,
                          long long rows, int d_in, int d_hidden, int d_out,
                          int members, long long stride_x, long long stride_w0,
                          long long stride_b0, long long stride_w1,
                          long long stride_b1, long long stride_out, int path,
                          void* stream) {
  if (rows <= 0 || members <= 0) return cudaSuccess;
  if (d_in < 1 || d_hidden < 1 || d_out < 1 || members > kMaxMembers ||
      (d_out + kTileN - 1) / kTileN > 65535)
    return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(g_launch_mutex);
  DeviceState* s = nullptr;
  cudaError_t err = current_device(&s);
  if (err != cudaSuccess) return err;
  const MemberStrides ms{stride_x, stride_w0, stride_b0, stride_w1, stride_b1,
                         stride_out};
  const auto* xp = static_cast<const float*>(x);
  const auto* w0p = static_cast<const float*>(w0);
  const auto* b0p = static_cast<const float*>(b0);
  const auto* w1p = static_cast<const float*>(w1);
  const auto* b1p = static_cast<const float*>(b1);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (d_in <= 4)
    return launch_fwd<4>(xp, w0p, b0p, w1p, b1p, op, rows, d_in, d_hidden,
                         d_out, members, ms, path, *s, st);
  if (d_in <= 8)
    return launch_fwd<8>(xp, w0p, b0p, w1p, b1p, op, rows, d_in, d_hidden,
                         d_out, members, ms, path, *s, st);
  if (d_in <= 16)
    return launch_fwd<16>(xp, w0p, b0p, w1p, b1p, op, rows, d_in, d_hidden,
                          d_out, members, ms, path, *s, st);
  return launch_fwd<0>(xp, w0p, b0p, w1p, b1p, op, rows, d_in, d_hidden, d_out,
                       members, ms, path, *s, st);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take (d_out over
// 65,535 column tiles, more than 65,535 members, or over 2^31 - 1 m-tiles
// of 16 rows on the split path). Pointers are device pointers to f32
// arrays, each member's contiguous: x (rows, d_in), w0 (d_hidden, d_in),
// b0 (d_hidden), w1 (d_out, d_hidden), b1 (d_out), out (rows, d_out);
// member m's start at m times the array's stride in elements (0: shared).
// A single call is members = 1.
int fused_mlp_fwd(const void* x, const void* w0, const void* b0, const void* w1,
                  const void* b1, void* out, long long rows, int d_in,
                  int d_hidden, int d_out, int members, long long stride_x,
                  long long stride_w0, long long stride_b0, long long stride_w1,
                  long long stride_b1, long long stride_out, void* stream) {
  return fused_mlp_fwd_on_path(x, w0, b0, w1, b1, out, rows, d_in, d_hidden,
                               d_out, members, stride_x, stride_w0, stride_b0,
                               stride_w1, stride_b1, stride_out, -1, stream);
}

// Bytes of dynamic shared memory one block of the hidden kernel needs:
// none, since it keeps its weights in registers.
size_t fused_mlp_hidden_smem_bytes(int d_in, int d_hidden) {
  (void)d_in;
  (void)d_hidden;
  return 0;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for widths under 1 or more than 65,535 members.
// Pointers are device pointers to f32 arrays, each member's contiguous: x
// (rows, d_in), w0 (d_hidden, d_in), b0 (d_hidden), h (rows, d_hidden);
// member strides as in fused_mlp_fwd.
int fused_mlp_hidden(const void* x, const void* w0, const void* b0, void* h,
                     long long rows, int d_in, int d_hidden, int members,
                     long long stride_x, long long stride_w0,
                     long long stride_b0, long long stride_h, void* stream) {
  if (rows <= 0 || members <= 0) return cudaSuccess;
  if (d_in < 1 || d_hidden < 1 || members > kMaxMembers)
    return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(g_launch_mutex);
  DeviceState* s = nullptr;
  cudaError_t err = current_device(&s);
  if (err != cudaSuccess) return err;
  const MemberStrides ms{stride_x, stride_w0, stride_b0, 0, 0, stride_h};
  const auto* xp = static_cast<const float*>(x);
  const auto* w0p = static_cast<const float*>(w0);
  const auto* b0p = static_cast<const float*>(b0);
  auto* hp = static_cast<float*>(h);
  auto st = static_cast<cudaStream_t>(stream);
  if (d_in <= 4)
    return launch_hidden<4>(xp, w0p, b0p, hp, rows, d_in, d_hidden, members, ms,
                            *s, st);
  if (d_in <= 8)
    return launch_hidden<8>(xp, w0p, b0p, hp, rows, d_in, d_hidden, members, ms,
                            *s, st);
  if (d_in <= 16)
    return launch_hidden<16>(xp, w0p, b0p, hp, rows, d_in, d_hidden, members,
                             ms, *s, st);
  return launch_hidden<0>(xp, w0p, b0p, hp, rows, d_in, d_hidden, members, ms,
                          *s, st);
}

}  // extern "C"
