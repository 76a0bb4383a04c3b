// The two kernels of the fused two-layer MLP: the forward (this note) and
// the backward's hidden-layer recompute (fused_mlp_hidden_kernel, below).
//
// Fused two-layer MLP forward, y = relu(x @ W0^T + b0) @ W1^T + b1, in f32.
//
// Replaces the TPU kernel dpivae_tpu/ops/pallas_mlp.py:_mlp_kernel
// (launched by _pallas_forward), the data-driven branch of decoder_x.
// Weights are in torch.nn.Linear layout: W0 (H, d_in), W1 (d_out, H).
//
// What bounds it on an H100: at the serving shape, 262,144 rows x
// (4 -> 128 -> 32), it does 2.42 GFLOP and must move 37.8 MB (x in, y out,
// weights once). In full f32 on the CUDA cores (no TF32, no tensor cores)
// that is about 36 us of arithmetic against about 11 us of memory traffic,
// so it is bounded by f32 FMA throughput. Most of the arithmetic is the
// second layer (H * d_out = 4,096 FMA a row against d_in * H = 512).
//
// What the design does about it:
// - The (rows, H) hidden activation never goes to device memory: the block
//   computes it chunk by chunk into shared memory and folds each chunk
//   straight into register accumulators, so device traffic is x, y and the
//   weights only, which keeps memory well under the arithmetic bound.
// - W0, b0, the block's column tile of W1 (transposed, zero-padded to 32
//   columns) and b1 are staged in shared memory once per block; blocks are
//   persistent (one wave, a grid-stride loop over 128-row tiles), so the
//   staging is paid once per block and not once per tile.
// - The second layer is register-tiled: each thread owns 4 rows x 4 output
//   columns and, per hidden unit, does 16 FMAs from two 16-byte shared-memory
//   loads (4 hidden values, 4 weights). The hidden-chunk pass is what holds
//   the kernel well below its arithmetic bound: per hidden value it does
//   2 * d_in + 1 four-byte shared-memory loads and one store for d_in FMAs,
//   so there shared-memory bandwidth, not the FMA pipes, sets the pace.
// - Any row count (masked ragged tail) and any d_in, H, d_out whose staged
//   weights fit one block's shared memory; d_out > 32 is tiled over
//   blockIdx.y. Larger shapes are refused by the launcher.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 128;        // rows per tile
constexpr int kTileCols = 32;         // output columns per block
constexpr int kRowsPerThread = 4;
constexpr int kColsPerThread = 4;
constexpr int kChunk = 32;            // hidden units per pass
constexpr int kColThreads = kTileCols / kColsPerThread;   // 8

static_assert(kColThreads * (kTileRows / kRowsPerThread) == kThreads,
              "thread layout must cover the output tile");

size_t smem_floats(int d_in, int d_hidden) {
  return (size_t)d_hidden * kTileCols      // W1 column tile, transposed
         + (size_t)kChunk * kTileRows      // hidden chunk
         + kTileCols                       // b1 tile
         + (size_t)d_hidden * d_in         // W0
         + d_hidden                        // b0
         + (size_t)d_in * kTileRows;       // x tile, transposed
}

__global__ void __launch_bounds__(kThreads)
fused_mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                     const float* __restrict__ b0, const float* __restrict__ w1,
                     const float* __restrict__ b1, float* __restrict__ out,
                     int64_t rows, int d_in, int d_hidden, int d_out) {
  extern __shared__ __align__(16) float smem[];
  // The float4 reads below need w1s and hs at 16-byte offsets: both sit
  // first, and d_hidden * kTileCols is a multiple of 4.
  float* w1s = smem;                                   // [d_hidden][kTileCols]
  float* hs = w1s + (size_t)d_hidden * kTileCols;      // [kChunk][kTileRows]
  float* b1s = hs + kChunk * kTileRows;                // [kTileCols]
  float* w0s = b1s + kTileCols;                        // [d_hidden][d_in]
  float* b0s = w0s + (size_t)d_hidden * d_in;          // [d_hidden]
  float* xs = b0s + d_hidden;                          // [d_in][kTileRows]

  const int tid = threadIdx.x;
  const int tx = tid % kColThreads;
  const int ty = tid / kColThreads;
  const int col0 = blockIdx.y * kTileCols;

  for (int i = tid; i < d_hidden * d_in; i += kThreads) w0s[i] = w0[i];
  for (int i = tid; i < d_hidden; i += kThreads) b0s[i] = b0[i];
  for (int i = tid; i < d_hidden * kTileCols; i += kThreads) {
    const int k = i / kTileCols;
    const int col = col0 + i % kTileCols;
    w1s[i] = col < d_out ? w1[(size_t)col * d_hidden + k] : 0.f;
  }
  if (tid < kTileCols) b1s[tid] = col0 + tid < d_out ? b1[col0 + tid] : 0.f;

  const bool vec_store = (d_out % 4) == 0;
  const int64_t n_tiles = (rows + kTileRows - 1) / kTileRows;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = tile * kTileRows;
    __syncthreads();  // staging done; the previous tile is done with xs, hs
    for (int i = tid; i < kTileRows * d_in; i += kThreads) {
      const int r = i / d_in;
      const int j = i % d_in;
      const int64_t row = row0 + r;
      xs[j * kTileRows + r] = row < rows ? x[row * d_in + j] : 0.f;
    }

    float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m)
#pragma unroll
      for (int n = 0; n < kColsPerThread; ++n)
        acc[m][n] = b1s[tx * kColsPerThread + n];

    for (int h0 = 0; h0 < d_hidden; h0 += kChunk) {
      const int kc = min(kChunk, d_hidden - h0);
      __syncthreads();  // xs written; the previous chunk of hs consumed
      for (int i = tid; i < kChunk * kTileRows; i += kThreads) {
        const int kk = i / kTileRows;
        const int r = i % kTileRows;
        float v = 0.f;
        if (kk < kc) {
          const int k = h0 + kk;
          const float* wrow = w0s + (size_t)k * d_in;
          v = b0s[k];
          for (int j = 0; j < d_in; ++j) v = fmaf(wrow[j], xs[j * kTileRows + r], v);
          v = fmaxf(v, 0.f);
        }
        hs[i] = v;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        const float4 hv = *reinterpret_cast<const float4*>(
            hs + kk * kTileRows + ty * kRowsPerThread);
        const float4 wv = *reinterpret_cast<const float4*>(
            w1s + (size_t)(h0 + kk) * kTileCols + tx * kColsPerThread);
        const float h[kRowsPerThread] = {hv.x, hv.y, hv.z, hv.w};
        const float w[kColsPerThread] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int m = 0; m < kRowsPerThread; ++m)
#pragma unroll
          for (int n = 0; n < kColsPerThread; ++n)
            acc[m][n] = fmaf(h[m], w[n], acc[m][n]);
      }
    }

    const int c = col0 + tx * kColsPerThread;
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) {
      const int64_t row = row0 + ty * kRowsPerThread + m;
      if (row >= rows) continue;
      float* o = out + row * d_out;
      if (vec_store && c + kColsPerThread <= d_out) {
        *reinterpret_cast<float4*>(o + c) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      } else {
#pragma unroll
        for (int n = 0; n < kColsPerThread; ++n)
          if (c + n < d_out) o[c + n] = acc[m][n];
      }
    }
  }
}

// Hidden-layer recompute for the backward pass, h = relu(x @ W0^T + b0),
// in f32. Replaces the TPU kernel dpivae_tpu/ops/pallas_mlp.py:
// _mlp_hidden_kernel (launched by _pallas_hidden): the forward never saves
// the (rows, H) activation, so the backward rebuilds it.
//
// What bounds it on an H100: at the training shape, 1,024 rows x (4 -> 128),
// it must write 0.52 MB of h against 1 MFLOP of arithmetic, so it is bound
// by the bytes it writes (0.16 us at 3.35 TB/s); at 1,024 rows, in practice,
// by launch latency.
//
// What the design does about it: each block stages W0 (transposed, so that
// neighbouring threads read neighbouring hidden units), b0 and its tile of
// kHiddenRows rows of x in shared memory; each thread then computes h
// values with consecutive threads on consecutive hidden units of one row,
// so every warp's store is one coalesced 128-byte line. Any row count
// (masked ragged tail) and any d_in, H whose staged weights fit one block's
// shared memory; larger shapes are refused by the launcher.
constexpr int kHiddenRows = 32;       // rows per block

size_t hidden_smem_floats(int d_in, int d_hidden) {
  return (size_t)d_in * d_hidden          // W0, transposed
         + d_hidden                       // b0
         + (size_t)kHiddenRows * d_in;    // x tile
}

__global__ void __launch_bounds__(kThreads)
fused_mlp_hidden_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                        const float* __restrict__ b0, float* __restrict__ h,
                        int64_t rows, int d_in, int d_hidden) {
  extern __shared__ __align__(16) float smem[];
  float* w0t = smem;                                   // [d_in][d_hidden]
  float* b0s = w0t + (size_t)d_in * d_hidden;          // [d_hidden]
  float* xs = b0s + d_hidden;                          // [kHiddenRows][d_in]

  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * kHiddenRows;
  const int64_t left = rows - row0;
  const int n_rows = left < kHiddenRows ? (int)left : kHiddenRows;

  for (int i = tid; i < d_hidden * d_in; i += kThreads) {
    const int k = i / d_in;
    const int j = i % d_in;
    w0t[(size_t)j * d_hidden + k] = w0[i];
  }
  for (int i = tid; i < d_hidden; i += kThreads) b0s[i] = b0[i];
  for (int i = tid; i < n_rows * d_in; i += kThreads) xs[i] = x[row0 * d_in + i];
  __syncthreads();

  const int n_out = n_rows * d_hidden;
  for (int i = tid; i < n_out; i += kThreads) {
    const int r = i / d_hidden;
    const int k = i % d_hidden;
    const float* xr = xs + r * d_in;
    float v = b0s[k];
    for (int j = 0; j < d_in; ++j) v = fmaf(xr[j], w0t[(size_t)j * d_hidden + k], v);
    h[row0 * d_hidden + i] = fmaxf(v, 0.f);
  }
}

// What a launch asks of the runtime that does not change between launches:
// the device's limits, the dynamic shared memory already granted to each
// kernel, and the forward's occupancy at its last size. Read or set once per
// device and reused, so a launch costs no attribute queries; launches hold
// g_launch_mutex while they read or update it.
constexpr int kMaxDevices = 64;
struct DeviceState {
  int n_sm = 0;               // 0 until the limits are read
  int max_smem = 0;
  size_t fwd_granted = 0;     // largest size granted to fused_mlp_fwd_kernel
  size_t hidden_granted = 0;  // ... and to fused_mlp_hidden_kernel
  size_t fwd_occ_smem = 0;    // fwd_per_sm holds for this size
  int fwd_per_sm = 0;
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

// Grants `kernel` `smem` bytes of dynamic shared memory on the current
// device, unless `*granted` (its earlier grant there) already covers them;
// refuses more than the device allows one block.
cudaError_t set_smem(const void* kernel, size_t smem, const DeviceState& s,
                     size_t* granted) {
  if (smem > (size_t)s.max_smem) return cudaErrorInvalidValue;
  if (smem <= *granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *granted = smem;
  return err;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for these widths.
size_t fused_mlp_fwd_smem_bytes(int d_in, int d_hidden) {
  return smem_floats(d_in, d_hidden) * sizeof(float);
}

const char* fused_mlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers to contiguous f32 arrays: x (rows, d_in),
// w0 (d_hidden, d_in), b0 (d_hidden), w1 (d_out, d_hidden), b1 (d_out),
// out (rows, d_out).
int fused_mlp_fwd(const void* x, const void* w0, const void* b0, const void* w1,
                  const void* b1, void* out, long long rows, int d_in,
                  int d_hidden, int d_out, void* stream) {
  if (rows <= 0) return cudaSuccess;
  const size_t smem = fused_mlp_fwd_smem_bytes(d_in, d_hidden);
  std::lock_guard<std::mutex> lock(g_launch_mutex);
  DeviceState* s = nullptr;
  cudaError_t err = current_device(&s);
  if (err != cudaSuccess) return err;
  err = set_smem((const void*)fused_mlp_fwd_kernel, smem, *s, &s->fwd_granted);
  if (err != cudaSuccess) return err;
  if (s->fwd_occ_smem != smem) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_mlp_fwd_kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    s->fwd_per_sm = per_sm < 1 ? 1 : per_sm;
    s->fwd_occ_smem = smem;
  }

  const int col_tiles = (d_out + kTileCols - 1) / kTileCols;
  const long long n_tiles = (rows + kTileRows - 1) / kTileRows;
  long long resident =
      ((long long)s->n_sm * s->fwd_per_sm + col_tiles - 1) / col_tiles;
  const long long grid_x = n_tiles < resident ? n_tiles : resident;
  dim3 grid((unsigned)grid_x, (unsigned)col_tiles);
  fused_mlp_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w0),
      static_cast<const float*>(b0), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<float*>(out), rows, d_in,
      d_hidden, d_out);
  return cudaGetLastError();
}

// Bytes of dynamic shared memory one block of the hidden kernel needs.
size_t fused_mlp_hidden_smem_bytes(int d_in, int d_hidden) {
  return hidden_smem_floats(d_in, d_hidden) * sizeof(float);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers to contiguous f32 arrays: x (rows, d_in),
// w0 (d_hidden, d_in), b0 (d_hidden), h (rows, d_hidden).
int fused_mlp_hidden(const void* x, const void* w0, const void* b0, void* h,
                     long long rows, int d_in, int d_hidden, void* stream) {
  if (rows <= 0) return cudaSuccess;
  const long long n_blocks = (rows + kHiddenRows - 1) / kHiddenRows;
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = fused_mlp_hidden_smem_bytes(d_in, d_hidden);
  std::lock_guard<std::mutex> lock(g_launch_mutex);
  DeviceState* s = nullptr;
  cudaError_t err = current_device(&s);
  if (err != cudaSuccess) return err;
  err = set_smem((const void*)fused_mlp_hidden_kernel, smem, *s,
                 &s->hidden_granted);
  if (err != cudaSuccess) return err;
  fused_mlp_hidden_kernel<<<(unsigned)n_blocks, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w0),
      static_cast<const float*>(b0), static_cast<float*>(h), rows, d_in,
      d_hidden);
  return cudaGetLastError();
}

}  // extern "C"
