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
// tensor operations and bytes about equally (13.0 against 11.3 us).
//
// Arithmetic, on both paths. Layer 1 runs in f32 on the CUDA cores,
// straight into the registers of layer 2's A operand: for each 8-wide k
// step a lane computes exactly the four hidden values its fragment holds
// (rows g and g+8 of its 16 rows, hidden k0+t and k0+t+4, with g = lane / 4
// and t = lane % 4), from its two rows of x held in registers, then the
// ReLU. h never goes to shared or device memory. Layer 2 runs on the TF32
// tensor cores in the 3xTF32 split: each f32 operand v becomes hi = tf32(v)
// and lo = v - hi, and a product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi. That
// keeps about 21 of f32's 24 bits of each product; one TF32 pass keeps 11
// and misses rtol/atol 1e-5 against the f32 plain version (tests/
// test_torch_port_ops.py shows both on an f32 model of the arithmetic,
// which rounds where the tensor cores truncate). The tensor cores' own
// accumulation truncates to the accumulator's magnitude: with all three
// passes summed into one accumulator the CUDA tests missed 1e-5 at 65,536 x
// (4 -> 256 -> 32) (1.19e-5). So the two small cross terms chain in their
// own accumulator, and each k step's hi*hi product is summed from zero on
// the tensor cores and added to an f32 register total with rounded adds:
// every truncation is then relative to one k step's 8 products.
//
// The forward has two paths; the launcher (launch_fwd) picks one by the
// row count and the widths.
//
// The staged path (fused_mlp_fwd_kernel_wgmma), above kSplitTilesPerSm
// m-tiles of 16 rows per SM over all members and column tiles (above 8,448
// rows at d_out 32 on 132 SMs: serving, validation, the member-batched
// launches), built for Hopper:
// - Persistent blocks of warpgroups (4 at d_in 4 and d_out up to 32, where
//   the kernel fits 128 registers a thread, so one block a SM stages W1
//   once; 2 elsewhere), one wave sized by the occupancy calculator; each
//   warpgroup owns a 64-row tile at a time and walks tiles with a stride.
//   Sweep members go on blockIdx.z, the wave divided among them.
// - Layer 2 on wgmma.mma_async m64nNk8 TF32, N the whole d_out rounded up
//   to 32 or 64: one tensor instruction per pass, k step and 64 rows, where
//   mma.sync m16n8k8 took 16 at d_out 32 and 32 at 64; and d_out 64 is one
//   tile, so layer 1 is computed once. A comes from registers (each warp's
//   16 rows of the m64 A fragment are the m16n8k8 A fragment above), B from
//   shared memory: each block splits W1 once into hi and lo and stores both
//   in wgmma's K-major canonical layout without swizzle (core matrices of 8
//   columns x 4 k, 128 contiguous bytes).
// - The k loop takes steps in pairs with two sets of A registers: step
//   s + 1's layer 1 runs while step s's three products are in flight, then
//   wgmma.wait_group 0 and step s's hi*hi temporary (scale-d 0) is added to
//   the f32 total. Waiting for the previous step only (wait_group 1, with
//   two temporaries) makes ptxas serialize every wgmma (C7514: the cross
//   terms' accumulator is in flight across all steps) and measured slower.
// - x comes in with 16-byte read-only loads, the next tile's while this one
//   computes.
// - The output leaves through shared memory: each warp adds b1 and writes
//   its 16 rows into one of its two staging buffers (each lane turning the
//   order of its n-tiles by its row, so that the 8 rows of a store, whose
//   starts share banks, hit different ones); 16 rows of the row-major
//   (rows, d_out) output are one contiguous span, so lane 0 sends them with
//   one 1-D bulk async copy (cp.async.bulk) after a proxy fence and a warp
//   barrier. The copy overlaps the next tile's products; a buffer is reused
//   after cp.async.bulk.wait_group.read. The ragged last tile copies exactly
//   its rows.
// - It takes d_in 4, 8, 12 or 16 (a compile-time bucket, layer 1
//   unrolled), d_out a multiple of 4 up to 64, x and the output 16-byte
//   aligned with member strides to match, and W1's two copies, W0, b0 and
//   the staging tiles in one block's shared memory (H up to 592 at d_in 4
//   and d_out 32, 304 at d_in 8 and d_out 64). Anything else takes the
//   split path at every row count.
// - ptxas (-Xptxas -v): registers a thread at (d_in bucket, N) (4, 32) 114
//   (4 warpgroups a block), (4, 64) 171, (8, 32) 139, (8, 64) 196,
//   (16, 32) 187, (16, 64) 240, no spills; dynamic shared memory at
//   H = 128 100,864 bytes a block at (4, 32) and 135,680 at (8, 64).
// - Measured (fused_mlp_ab.py, NVIDIA H100 80GB HBM3 at 700.00 W, against
//   the mma.sync body it replaced, in turns in one process): serving
//   262,144 x (4 -> 128 -> 32) 0.0480 against 0.0567 ms, 27 % of the
//   13.0 us bound; 32,768 rows 0.0113 against 0.0124 ms; 262,144 x
//   (8 -> 128 -> 64) 0.0866 against 0.1170 ms; 66 members x 32,768 x
//   (8 -> 128 -> 64) 0.595 against 0.868 ms (36 % of its bound). What
//   holds it back is latency: 16 warps an SM (the accumulators take 48
//   registers a thread at N 32), a wait for the tensor cores every k step,
//   and layer 1, the splits and the adds on the CUDA cores; with one of
//   them taken out (fused_mlp_ab.py --ablate) the others do not hide it.
//
// The split path (fused_mlp_fwd_kernel), for fewer rows and for the widths
// the staged path does not take: a block of kSplitWarps warps takes one
// m-tile of 16 rows and splits its k steps among the warps, on mma.sync
// m16n8k8 TF32; the warps read their B fragments of W1, and W0 and b0,
// straight from the L1/L2 caches and split them in registers; one barrier
// sums the warps' partial tiles through shared memory. So 1,024 rows put
// their 64 m-tiles on 64 SMs with a quarter of the k steps on each warp.
// It stages nothing, so any width runs: K (hidden) and N (d_out) are
// padded to multiples of 8 with zeros, d_out over 32 is tiled over
// blockIdx.y (layer 1 recomputed per column tile), d_in over 16 takes a
// runtime-length loop. Stores go out of the C fragments (8-byte stores;
// scalar where d_out is odd). Up to kSplitTilesPerSm m-tiles per SM (1,024
// and 8,192 rows on 132 SMs) it is the faster path.
//
// Sweep members (the counterpart of pallas_call's batching rule, which adds
// a grid axis under jax.vmap) go on blockIdx.z on both paths: one launch
// covers every member, each block offsetting its pointers by its member's
// strides (MemberStrides; 0 for an array the members share). The path is
// chosen on the m-tiles of all members together.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;         // the hidden kernel's block
// The split path.
constexpr int kTileM = 16;            // rows of an m-tile, one warp's
constexpr int kTileN = 32;            // output columns of a block
constexpr int kNT = kTileN / 8;       // n-tiles of 8 columns in a block
constexpr int kSplitWarps = 4;        // warps sharing one m-tile's k steps
constexpr int kSplitTilesPerSm = 4;   // up to here the split path
// The staged path.
constexpr int kTileRows = 64;         // wgmma's M: one warpgroup's tile
constexpr int kGroupThreads = 128;    // a warpgroup
constexpr int kMaxN = 64;             // the widest d_out it takes
constexpr int kStageBatch = 8;        // W1 loads in flight per thread, staging

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

// The staged path's wgmma width for d_out: 32 or 64.
int staged_n(int d_out) { return d_out <= 32 ? 32 : kMaxN; }

// Warpgroups of a staged block for a d_in bucket and wgmma width: 4 where
// the kernel fits 128 registers a thread (d_in 4, N 32), so that one block
// a SM stages W1 once; 2 elsewhere (1 block a SM at N 64).
__host__ __device__ constexpr int staged_groups(int dinb, int n) {
  return dinb == 4 && n == 32 ? 4 : 2;
}

// The staged forward's shared memory, in floats: W1 split into hi and lo in
// wgmma's layout (N x kp each), W0 with rows padded to the d_in bucket, b0,
// and two 64 x d_out staging tiles a warpgroup; kp is the hidden width
// padded to a multiple of 16 (the k loop takes steps in pairs).
size_t staged_smem_floats(int d_in, int d_hidden, int d_out) {
  const size_t kp = (size_t)(d_hidden + 15) / 16 * 16;
  const int groups = staged_groups(din_bucket(d_in), staged_n(d_out));
  return kp * 2 * staged_n(d_out) + kp * din_bucket(d_in) + kp +
         (size_t)groups * 2 * kTileRows * d_out;
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

// The split path: see the note above.
template <int DINB>
__global__ void __launch_bounds__(kThreads)
fused_mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                     const float* __restrict__ b0, const float* __restrict__ w1,
                     const float* __restrict__ b1, float* __restrict__ out,
                     int64_t rows, int d_in, int d_hidden, int d_out,
                     MemberStrides ms) {
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
  constexpr int kDx = DINB > 0 ? DINB : 1;   // x rows in registers
  extern __shared__ __align__(16) float smem[];
  const int n_ks = (d_hidden + 7) / 8;

  const int lane = threadIdx.x % kWarp;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col0 = blockIdx.y * kTileN;
  const int n_nt = min(kNT, (d_out - col0 + 7) / 8);     // n-tiles with columns

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

  // The block's warps share one m-tile, warp w taking k steps w, w + warps,
  // ...
  const int64_t n_mt = (rows + kTileM - 1) / kTileM;
  for (int64_t mt = blockIdx.x; mt < n_mt; mt += gridDim.x) {
    const int64_t r_lo = mt * kTileM + g;
    const int64_t r_hi = r_lo + 8;
    float xa[kDx], xb[kDx];
#pragma unroll
    for (int j = 0; j < DINB; ++j) {
      xa[j] = j < d_in && r_lo < rows ? __ldg(x + r_lo * d_in + j) : 0.f;
      xb[j] = j < d_in && r_hi < rows ? __ldg(x + r_hi * d_in + j) : 0.f;
    }
    // acc sums the hi*hi products, small the two cross terms.
    float acc[kNT][4], small[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = small[nt][i] = 0.f;

#pragma unroll 2
    for (int ks = warp; ks < n_ks; ks += warps) {
      const int ka = ks * 8 + t;   // hidden unit of a0/a1; a2/a3 take ka + 4
      const int kb = ka + 4;
      // The A fragment: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4).
      float h[4];
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
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(fmaxf(h[i], 0.f), ah[i], al[i]);

#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t bh0, bh1, bl0, bl1;   // b0 (k = t, n = g), b1 (k = t+4, n = g)
        const int n = col0 + nt * 8 + g;
        const float* wr = w1 + (size_t)n * d_hidden;
        split_tf32(n < d_out && ka < d_hidden ? __ldg(wr + ka) : 0.f, bh0, bl0);
        split_tf32(n < d_out && kb < d_hidden ? __ldg(wr + kb) : 0.f, bh1, bl1);
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

    // Sum the warps' partial tiles through shared memory, [warps][kNT]
    // [kWarp] float4s (conflict-free); warp w then adds b1 to n-tile w and
    // stores it.
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

// ---------------------------------------------------------------------------
// The staged path: wgmma, bulk async stores, a persistent tile loop.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma's descriptor of B in shared memory: K-major, no swizzle. A core
// matrix is 8 columns (n) x 16 bytes (4 k), stored as 128 contiguous
// bytes; a k8 step's second core matrix along K lies 128 bytes on (the
// leading byte offset), the next 8 columns 256 bytes on (the stride byte
// offset).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// d (+)= a * b over one k8 step of 64 rows: a in registers (per warp the
// m16n8k8 A fragment of its 16 rows), b (8 x N) from shared memory through
// desc, d the m64nN accumulator (per warp the m16n8 C fragments of its rows,
// n-tile j in d[4j..4j+3]). scale_d 0 writes d = a * b.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits for every wgmma this warpgroup committed.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins the registers here, so that the compiler moves no access to them
// across a wgmma wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]));
}

// a[r], with r in 0..3 known only at run time and a's index at compile time.
__device__ __forceinline__ float pick4(int r, float a0, float a1, float a2, float a3) {
  return r == 0 ? a0 : r == 1 ? a1 : r == 2 ? a2 : a3;
}

template <int R>
__device__ __forceinline__ void add_regs(float (&acc)[R], const float (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] += v[i];
}

template <int DINB, int N>
__global__ void __launch_bounds__(staged_groups(DINB, N) * kGroupThreads)
fused_mlp_fwd_kernel_wgmma(const float* __restrict__ x, const float* __restrict__ w0,
                           const float* __restrict__ b0, const float* __restrict__ w1,
                           const float* __restrict__ b1, float* __restrict__ out,
                           int64_t rows, int d_in, int d_hidden, int d_out,
                           MemberStrides ms) {
  static_assert(DINB % 4 == 0 && (N == 32 || N == 64), "d_in bucket, wgmma N");
  constexpr int kRegs = N / 2;   // a thread's accumulator registers
  constexpr int kGroups = staged_groups(DINB, N);
  {
    const int64_t m = blockIdx.z;
    x += m * ms.x;
    w0 += m * ms.w0;
    b0 += m * ms.b0;
    w1 += m * ms.w1;
    b1 += m * ms.b1;
    out += m * ms.out;
  }
  extern __shared__ __align__(128) float smem[];
  const int kp = (d_hidden + 15) / 16 * 16;
  float* w1h = smem;                       // [kp / 8][N / 8][2][8][4]
  float* w1l = w1h + (size_t)kp * N;       // the same, lo
  float* w0s = w1l + (size_t)kp * N;       // [kp][DINB]
  float* b0s = w0s + (size_t)kp * DINB;    // [kp]
  float* stage = b0s + kp;                 // [kGroups][2][kTileRows * d_out]

  // W1[n][k] to k step k / 8, column group n / 8, k half (k / 4) % 2, then
  // row n % 8 of 16 bytes; read along W1's rows (coalesced), kStageBatch
  // loads in flight per thread.
  for (int i0 = threadIdx.x; i0 < N * kp; i0 += kStageBatch * blockDim.x) {
    float v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      const int n = i / kp;
      const int k = i % kp;
      v[u] = i < N * kp && n < d_out && k < d_hidden
                 ? __ldg(w1 + (size_t)n * d_hidden + k) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i >= N * kp) break;
      const int n = i / kp;
      const int k = i % kp;
      uint32_t hi, lo;
      split_tf32(v[u], hi, lo);
      const int o = (k >> 3) * (8 * N) + (n >> 3) * 64 + ((k >> 2) & 1) * 32 +
                    (n & 7) * 4 + (k & 3);
      w1h[o] = __uint_as_float(hi);
      w1l[o] = __uint_as_float(lo);
    }
  }
  for (int i = threadIdx.x; i < kp * DINB; i += blockDim.x) {
    const int k = i / DINB;
    const int j = i % DINB;
    w0s[i] = k < d_hidden && j < d_in ? w0[(size_t)k * d_in + j] : 0.f;
  }
  for (int i = threadIdx.x; i < kp; i += blockDim.x)
    b0s[i] = i < d_hidden ? b0[i] : 0.f;
  // The stores above are the generic proxy's; wgmma reads through the async
  // proxy.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int group = threadIdx.x / kGroupThreads;
  const int gt = threadIdx.x % kGroupThreads;
  const int warp = gt / kWarp;
  const int lane = gt % kWarp;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_a = warp * 16 + g;   // the thread's rows of a tile: row_a, +8

  // b1 of the accumulator's columns: register 4j + 2h + e holds column
  // 8j + 2t + e (of row row_a + 8h).
  float bias[N / 8][2];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * t + e;
      bias[j][e] = c < d_out ? __ldg(b1 + c) : 0.f;
    }

  const uint32_t hi_addr = smem_addr(w1h);
  const uint32_t lo_addr = smem_addr(w1l);
  constexpr uint32_t kStepBytes = 8 * N * sizeof(float);
  float* my_stage = stage + (size_t)group * 2 * kTileRows * d_out;

  // x rows row_a and row_a + 8 of a tile, zero past the last row.
  auto load_x = [&](int64_t tile, float (&xa)[DINB], float (&xb)[DINB]) {
    const int64_t ra = tile * kTileRows + row_a;
    const int64_t rb = ra + 8;
#pragma unroll
    for (int j = 0; j < DINB; j += 4) {
      float4 va = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vb = va;
      if (j < d_in && ra < rows)
        va = __ldg(reinterpret_cast<const float4*>(x + ra * d_in + j));
      if (j < d_in && rb < rows)
        vb = __ldg(reinterpret_cast<const float4*>(x + rb * d_in + j));
      xa[j] = va.x, xa[j + 1] = va.y, xa[j + 2] = va.z, xa[j + 3] = va.w;
      xb[j] = vb.x, xb[j + 1] = vb.y, xb[j + 2] = vb.z, xb[j + 3] = vb.w;
    }
  };
  // Layer 1 of k step s into the A fragment, split into hi and lo.
  auto hidden = [&](int s, const float (&xa)[DINB], const float (&xb)[DINB],
                    uint32_t (&ah)[4], uint32_t (&al)[4]) {
    const int ka = s * 8 + t;
    const int kb = ka + 4;
    float h[4];
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
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(fmaxf(h[i], 0.f), ah[i], al[i]);
  };
  float small[kRegs], big[kRegs], acc[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) small[i] = big[i] = 0.f;
  // The three passes of k step s, one commit group: the cross terms
  // chained into small (chain 0 starts a tile's chain), hi*hi into big from
  // zero.
  auto passes = [&](int s, const uint32_t (&ah)[4], const uint32_t (&al)[4],
                    int chain) {
    const uint64_t bh = b_desc(hi_addr + s * kStepBytes);
    const uint64_t bl = b_desc(lo_addr + s * kStepBytes);
    wgmma_fence();
    wgmma_tf32(small, al, bh, chain);
    wgmma_tf32(small, ah, bl, 1);
    wgmma_tf32(big, ah, bh, 0);
    wgmma_commit();
  };
  // big, once its passes are done, into the f32 total.
  auto retire = [&]() {
    wgmma_wait_all();
    fence_regs(big);
    add_regs(acc, big);
  };

  const int64_t n_tiles = (rows + kTileRows - 1) / kTileRows;
  const int64_t tile_step = (int64_t)gridDim.x * kGroups;
  const int n_steps = kp / 8;
  float xa[DINB], xb[DINB];
  int64_t tile = (int64_t)blockIdx.x * kGroups + group;
  load_x(tile, xa, xb);
  for (int buf = 0; tile < n_tiles; tile += tile_step, buf ^= 1) {
    float na[DINB], nb[DINB];   // the next tile's x, in flight meanwhile
    load_x(tile + tile_step, na, nb);
#pragma unroll
    for (int i = 0; i < kRegs; ++i) acc[i] = bias[i / 4][i % 2];

    // Steps in pairs, the A registers alternating: step s + 1's layer 1
    // runs while step s's products are in flight, and no register that a
    // wgmma in flight reads or writes is touched meanwhile.
    uint32_t ah0[4], al0[4], ah1[4], al1[4];
    hidden(0, xa, xb, ah0, al0);
    for (int s = 0; s < n_steps; s += 2) {
      passes(s, ah0, al0, s > 0);
      hidden(s + 1, xa, xb, ah1, al1);
      retire();
      passes(s + 1, ah1, al1, 1);
      if (s + 2 < n_steps) hidden(s + 2, xa, xb, ah0, al0);
      retire();
    }
    fence_regs(small);
    add_regs(acc, small);

    // The epilogue, each warp on its own 16 rows: its copy from this buffer
    // two tiles ago has been read; the rows are written into it, fenced for
    // the async proxy, and sent by lane 0.
    float* st = my_stage + ((size_t)buf * kTileRows + warp * 16) * d_out;
    if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    __syncwarp();
    // A lane stores its n-tiles in an order turned by its row (n-tile
    // jj ^ rot at store jj), so that the 8 rows of a store, whose starts
    // share banks, hit different ones.
    const int rot = g & 3;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
      const int c = 8 * (jj ^ rot) + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * h + e;
          v[e] = pick4(rot, acc[4 * jj + i], acc[4 * (jj ^ 1) + i],
                       acc[4 * (jj ^ 2) + i], acc[4 * (jj ^ 3) + i]);
        }
        if (c < d_out)
          *reinterpret_cast<float2*>(st + (g + 8 * h) * d_out + c) =
              make_float2(v[0], v[1]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    const int64_t r0 = tile * kTileRows + warp * 16;
    if (lane == 0 && r0 < rows) {
      const int64_t n_rows = rows - r0 < 16 ? rows - r0 : 16;
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
              out + r0 * d_out),
          "r"(smem_addr(st)), "r"((uint32_t)(n_rows * d_out * sizeof(float)))
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
#pragma unroll
    for (int j = 0; j < DINB; ++j) xa[j] = na[j], xb[j] = nb[j];
  }
  // Shared memory stays the block's until its copies are done.
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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
  StagedState fwd[kBuckets][2];   // [d_in bucket][N 32, 64]
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int DINB, int N>
cudaError_t launch_staged(const float* x, const float* w0, const float* b0,
                         const float* w1, const float* b1, float* out,
                         long long rows, int d_in, int d_hidden, int d_out,
                         int members, const MemberStrides& ms, size_t smem,
                         DeviceState& s, cudaStream_t stream) {
  StagedState& st = s.fwd[DINB == 4 ? 0 : DINB == 8 ? 1 : 2][N == 32 ? 0 : 1];
  const void* kernel = (const void*)fused_mlp_fwd_kernel_wgmma<DINB, N>;
  constexpr int kGroups = staged_groups(DINB, N);
  constexpr int threads = kGroups * kGroupThreads;
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
        &per_sm, fused_mlp_fwd_kernel_wgmma<DINB, N>, threads, smem);
    if (err != cudaSuccess) return err;
    st.per_sm = per_sm < 1 ? 1 : per_sm;
    st.occ_smem = smem;
  }
  // One wave of resident blocks, shared among the members (at least one
  // block each).
  const long long tiles = (rows + kTileRows - 1) / kTileRows;
  const long long blocks = (tiles + kGroups - 1) / kGroups;
  long long resident = ((long long)s.n_sm * st.per_sm + members - 1) / members;
  if (resident < 1) resident = 1;
  dim3 grid((unsigned)(blocks < resident ? blocks : resident), 1, (unsigned)members);
  fused_mlp_fwd_kernel_wgmma<DINB, N><<<grid, threads, smem, stream>>>(
      x, w0, b0, w1, b1, out, rows, d_in, d_hidden, d_out, ms);
  return cudaGetLastError();
}

// path: -1 chooses by the m-tiles of all members and the widths, 0 takes
// the split path and 1 the staged path whatever the row count (refused
// where it cannot run). The staged path takes d_in a multiple of 4 up to 16,
// d_out a multiple of 4 up to 64, x and out 16-byte aligned with member
// strides of whole 16-byte units (its loads and bulk copies need them), and
// shared memory for its widths; everything else runs split.
template <int DINB>
cudaError_t launch_fwd(const float* x, const float* w0, const float* b0,
                       const float* w1, const float* b1, float* out,
                       long long rows, int d_in, int d_hidden, int d_out,
                       int members, const MemberStrides& ms, int path,
                       DeviceState& s, cudaStream_t stream) {
  const int col_tiles = (d_out + kTileN - 1) / kTileN;
  const long long n_mt = (rows + kTileM - 1) / kTileM;
  const size_t smem = staged_smem_floats(d_in, d_hidden, d_out) * sizeof(float);
  const bool can_stage = DINB > 0 && d_in % 4 == 0 && d_out % 4 == 0 &&
                        d_out <= kMaxN && aligned16(x) && aligned16(out) &&
                        ms.x % 4 == 0 && ms.out % 4 == 0 &&
                        smem <= (size_t)s.max_smem;
  const bool staged =
      path < 0 ? can_stage && n_mt * col_tiles * members >
                                 (long long)kSplitTilesPerSm * s.n_sm
               : path == 1;
  if (!staged) {
    if (n_mt > 0x7fffffffLL) return cudaErrorInvalidValue;
    const size_t red = (size_t)kSplitWarps * kNT * kWarp * sizeof(float4);
    dim3 grid((unsigned)n_mt, (unsigned)col_tiles, (unsigned)members);
    fused_mlp_fwd_kernel<DINB><<<grid, kSplitWarps * kWarp, red, stream>>>(
        x, w0, b0, w1, b1, out, rows, d_in, d_hidden, d_out, ms);
    return cudaGetLastError();
  }
  if (!can_stage) return cudaErrorInvalidValue;
  if constexpr (DINB > 0) {
    if (d_out <= 32)
      return launch_staged<DINB, 32>(x, w0, b0, w1, b1, out, rows, d_in, d_hidden,
                                    d_out, members, ms, smem, s, stream);
    return launch_staged<DINB, kMaxN>(x, w0, b0, w1, b1, out, rows, d_in, d_hidden,
                                     d_out, members, ms, smem, s, stream);
  }
  return cudaErrorInvalidValue;
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
// these widths at a d_out of up to 32 (d_out 33 to 64 stages twice W1's
// columns and twice the staging tiles). Where the bytes for the call's
// widths exceed the device's limit for one block, the forward takes its
// split path (8 KB) at every row count.
size_t fused_mlp_fwd_smem_bytes(int d_in, int d_hidden) {
  return staged_smem_floats(d_in, d_hidden, 32) * sizeof(float);
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
