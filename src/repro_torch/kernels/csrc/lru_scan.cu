// Linear-recurrence scan h_t = a_t * h_{t-1} + b_t and its gradient, for
// Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lru_scan.py::lru_scan
// (_scan_kernel): over (B, S, C) tensors, from h_{-1} = 0, with an fp32
// carry per (batch, channel) and fp32 output.  The Mamba-1 mixer calls it
// with the (d_inner, n_state) plane flattened into C channels; the RG-LRU
// mixer with its lru_width channels.
//
// Bound.  Two flops per element against 3 elements moved (a and b read
// once, h written once): bound by bytes, 12 B an element in fp32 and
// 8 B read + 4 B written with bf16 inputs.  At (4, 2048, 131072) fp32 that
// is 12.9 GB, 3.85 ms at 3.35 TB/s; at (4, 2048, 4096) 0.120 ms; at
// (1, 2048, 4096) 0.030 ms.
//
// Design: the sequence is split inside each block, in one pass.
//   - A block owns a tile of 32 channels of one batch row, one lane a
//     channel, so each load and store of a step is one coalesced line of
//     the warp (128 bytes in fp32, 64 in bf16).  Grid: B * ceil(C / 32)
//     blocks in x, (batch, tile) folded together, so any batch launches.
//     At recurrentgemma's (4, 2048, 4096) that is 512 blocks, at batch 1
//     128; each walks the whole sequence and waits on no other block.
//   - The block walks S in chunks of L = W * P steps.  Warp w takes the
//     P consecutive steps [kL + wP, kL + wP + P) of chunk k into
//     registers, scans them from 0 and keeps the segment's product of a
//     beside the segment's h: the aggregate (prod a, h_end).
//   - The W aggregates go through shared memory (double-buffered by the
//     chunk's parity, so one __syncthreads a chunk).  Every warp folds
//     them in order, j = 0..W-1, from the carry of the previous chunk:
//     carry = prod_j * carry + h_end_j.  Before its own j it has the carry
//     into its segment; after all W, the carry out of the chunk.  All
//     warps fold the same values in the same order, so they agree on the
//     carry bit for bit and no second barrier is needed.
//   - The fix-up: each warp runs its P steps once more from the carry
//     into its segment, h = fma(a, h, b) on the a and b still in its
//     registers, and stores each h.  Within a segment h is the sequential
//     recurrence; only the carries between segments are reassociated
//     (prod * carry + h_end), which keeps the result within 1e-5 of the
//     sequential loop (tests/test_torch_scan_split.py shows the same
//     decomposition on the CPU).  a == 0 gives h = b exactly.
//   - Bytes in flight: the loads of chunk k+1 are issued before chunk k
//     is scanned, into a second set of registers, so each thread keeps
//     2P loads in flight through the scan, the barrier, the fold and the
//     stores.  The a and b are read once and h is written once: 12 B an
//     element, no second pass and no padded copy.
//   - Every layout in one path: loads are per element (4 or 2 bytes), so
//     a view whose pointer is not 16-byte aligned, any C (the ragged
//     tile's lanes idle) and any S (steps past the end load the identity
//     a = 1, b = 0 and store nothing) need no other code.  TMA would need
//     16-byte aligned addresses and strides, and so a second load path.
//   - Deterministic: the order of operations depends on the shape only;
//     nothing goes through atomics.
//   - Offsets are 64-bit: B * S * C passes 2^31 bytes at the Mamba
//     serving shape.
// The schedule: tile 32, W = 16, P = 16 (L = 256), 512 threads a block.
//   - 32 channels is the narrowest tile whose step is a whole 128-byte
//     line, and it gives the most blocks: 128 at batch 1 and width 4096,
//     one on each of 128 of the 132 SMs.
//   - A block at batch 1 is alone on its SM, so its own loads in flight
//     must cover the memory's latency: 512 threads x 2P = 16,384 loads
//     (64 KB in fp32) with P = 16.  100 registers a thread (ptxas), so
//     one block an SM; P = 8 fits two blocks in 64 registers but keeps
//     fewer loads in flight.
//   - Measured on an H100 80GB HBM3 at 700 W (`python3 chip_smoke.py
//     --scan-schedules 8x8,8x16,16x8,16x16,32x8`): (16, 16) was the
//     fastest or within 1 % of it in fp32 at (4, 2048, 4096),
//     (1, 2048, 4096) and (4, 2048, 131072); (32, 8) spills at 64
//     registers.
// Inputs are fp32 or bf16 (read as bf16, computed in fp32); output fp32.
//
// The gradient (lru_scan_backward_kernel).  It replaces no Pallas kernel:
// the reference trains through jax.lax.associative_scan
// (src/repro/models/ssm.py::_scan_assoc, src/repro/models/rglru.py), and
// its Pallas scan has no custom_vjp.  It is the port's gradient of the
// scan above, held against jax.vjp of the reference's scan on the CPU
// (tests/test_torch_scan_backward.py).  Given a, h and gbar = dL/dh it
// computes, for each (batch, channel),
//   g_t = gbar_t + a_{t+1} g_{t+1}   (a_S = 0),
//   dL/db_t = g_t,   dL/da_t = g_t h_{t-1}   (h_{-1} = 0: dL/da_0 = 0).
// Three flops per element against 5 elements moved (a, gbar and h read
// once, both gradients written once in fp32): bound by bytes, 20 B an
// element with fp32 a and 18 B with bf16 a.  At falcon-mamba-7b's train
// shape (8, 512, 131072) that is 10.74 GB, 3.205 ms at 3.35 TB/s; at
// recurrentgemma-9b's (8, 512, 4096) 0.100 ms.
// Design: the forward's schedule walked backwards in time, in one pass.
//   - The adjoint is the same recurrence in reversed index i = S - 1 - t:
//     gates a_{S-i} (0 at i = 0) and inputs gbar_{S-1-i}.  A block owns
//     32 channels of one batch row, walks i in chunks of L = W * P steps
//     counted from t = S - 1, each warp scans its P steps into (prod a,
//     g_end), the W aggregates are folded in order through the same
//     double-buffered shared memory, and the fix-up runs each segment
//     once more from the carry into it.  Every fmaf is the forward's on
//     the reversed sequence, so g equals the forward kernel run on
//     time-reversed copies of gbar and of a shifted by one step, bit for
//     bit (the route this kernel replaced: two flipped copies, a zero
//     fill, the forward launch, a flip back and a product).
//   - The a a step needs is the one at t + 1 and its h the one at t - 1:
//     per-lane loads one row off the segment, like every load here, so
//     they cost no alignment.  The a and gbar of the next chunk are
//     prefetched as in the forward; the P values of h are issued before
//     the chunk's barrier and fold, so they arrive under the fold, and
//     are used only in the fix-up.
//   - dL/da is a separate fp32 multiply of g by h (__fmul_rn, never
//     folded into an fma), and dL/da_0 is stored as 0, as the product of
//     the replaced route gave.
//   - No flipped copy, no zero fill, no second kernel: 20 B an element
//     against about 14 passes over a (B, S, C) fp32 tensor before.
//   - The register budget: 512 threads leave 128 registers a thread, and
//     5P = 80 values are live across the fold (the forward's 4P take it
//     to 100).  Each step's bound check is p < rem, with rem the steps
//     left in the sequence from the segment's first (0 for a lane past
//     the last channel), computed once a segment: both instances then
//     fit 128 registers with no spill.  Measured on an H100 80GB HBM3 at
//     700 W (`python3 tools/scan_backward_variants.py`, the same bits in
//     every variant): checked per step as live && i0 + p < seq, the fp32
//     instance spills 4 bytes and takes 3-4 % longer at mamba's train
//     shape; with rem clamped to a 32-bit int, 2-3 % longer in fp32 (1 %
//     shorter with bf16 a); with h copied into shared memory by cp.async
//     instead of registers, a tie in fp32 and 3-4 % longer with bf16 a.
//
// Interface.  Plain C entry points for ctypes: device pointers and the
// CUDA stream arrive as void*, sizes as int64.  Each returns the result
// of cudaGetLastError() after its launch (0 = success), or
// cudaErrorInvalidConfiguration for a grid past 2^31 - 1 blocks; it
// allocates nothing and does not synchronize.  The backward's entry
// points are named after the dtype of a; h, gbar and both gradients are
// fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;   // channels of a block: one lane each
constexpr int kWarps = 16;  // W: warps of a block, segments of a chunk
constexpr int kSteps = 16;  // P: steps of a segment; a chunk is 256 steps

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One warp's segment of P steps from t0 into registers; past the end of
// the sequence, or for a lane past the last channel, the identity
// (a, b) = (1, 0).
template <typename T, int P>
__device__ __forceinline__ void load_segment(const T* __restrict__ a,
                                             const T* __restrict__ b,
                                             int64_t t0, int64_t seq,
                                             int64_t channels, bool live,
                                             float (&av)[P], float (&bv)[P]) {
  a += t0 * channels;
  b += t0 * channels;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const bool ok = live && t0 + p < seq;
    av[p] = ok ? to_float(*a) : 1.0f;
    bv[p] = ok ? to_float(*b) : 0.0f;
    a += channels;
    b += channels;
  }
}

// Chunk k: prefetch chunk k+1 into (an, bn), scan (av, bv) from 0, fold
// the W aggregates from `carry` (updated to the carry out of chunk k),
// and store h from the carry into this warp's segment.
template <typename T, int W, int P>
__device__ __forceinline__ void scan_chunk(
    const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ h,
    int64_t k, int64_t chunks, int64_t seq, int64_t channels, bool live,
    int warp, int lane, float& carry, float (&av)[P], float (&bv)[P],
    float (&an)[P], float (&bn)[P], float2 (*agg)[kTile]) {
  constexpr int L = W * P;
  const int64_t t0 = k * L + static_cast<int64_t>(warp) * P;
  if (k + 1 < chunks)
    load_segment<T, P>(a, b, t0 + L, seq, channels, live, an, bn);
  float prod = 1.0f, hend = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    hend = fmaf(av[p], hend, bv[p]);
    prod *= av[p];
  }
  agg[warp][lane] = make_float2(prod, hend);
  __syncthreads();
  float x = carry;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (j == warp) x = carry;
    const float2 g = agg[j][lane];
    carry = fmaf(g.x, carry, g.y);
  }
  float* out = h + t0 * channels;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    x = fmaf(av[p], x, bv[p]);
    if (live && t0 + p < seq) *out = x;
    out += channels;
  }
}

template <typename T, int W, int P>
__global__ void __launch_bounds__(W * kTile)
    lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    float* __restrict__ h, int64_t seq, int64_t channels,
                    int64_t tiles) {
  constexpr int L = W * P;
  __shared__ float2 agg[2][W][kTile];
  const int lane = threadIdx.x % kTile;
  const int warp = threadIdx.x / kTile;
  const int64_t row = blockIdx.x / tiles;
  const int64_t c = (blockIdx.x % tiles) * kTile + lane;
  const bool live = c < channels;
  const int64_t base = row * seq * channels + (live ? c : 0);
  a += base;
  b += base;
  h += base;
  const int64_t chunks = (seq + L - 1) / L;
  float a0[P], b0[P], a1[P], b1[P];
  load_segment<T, P>(a, b, static_cast<int64_t>(warp) * P, seq, channels,
                     live, a0, b0);
  float carry = 0.0f;
  for (int64_t k = 0; k < chunks; k += 2) {
    scan_chunk<T, W, P>(a, b, h, k, chunks, seq, channels, live, warp, lane,
                        carry, a0, b0, a1, b1, agg[0]);
    if (k + 1 < chunks)
      scan_chunk<T, W, P>(a, b, h, k + 1, chunks, seq, channels, live, warp,
                          lane, carry, a1, b1, a0, b0, agg[1]);
  }
}

// The adjoint's segment of P reversed steps from i0 into registers:
// reversed step i is time step t = S - 1 - i, with the gate a_{t+1} (0 at
// i = 0, where t + 1 = S) and the input gbar_t; past the start of the
// sequence (i >= S), or for a lane past the last channel, the identity
// (1, 0).  Pointers step back one row a step and are read only in range.
template <typename T, int P>
__device__ __forceinline__ void load_segment_rev(const T* __restrict__ a,
                                                 const float* __restrict__ g,
                                                 int64_t i0, int64_t seq,
                                                 int64_t channels, bool live,
                                                 float (&av)[P],
                                                 float (&gv)[P]) {
  const int64_t t0 = seq - 1 - i0;
  const int64_t rem = live ? seq - i0 : 0;
  a += (t0 + 1) * channels;
  g += t0 * channels;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const bool ok = p < rem;
    av[p] = ok ? (i0 + p > 0 ? to_float(*a) : 0.0f) : 1.0f;
    gv[p] = ok ? *g : 0.0f;
    a -= channels;
    g -= channels;
  }
}

// h_{t-1} for the segment's P reversed steps from i0 (0 where t = 0 or
// past the start).
template <int P>
__device__ __forceinline__ void load_h_rev(const float* __restrict__ h,
                                           int64_t i0, int64_t seq,
                                           int64_t channels, bool live,
                                           float (&hv)[P]) {
  const int64_t rem = live ? seq - 1 - i0 : 0;
  h += (seq - 2 - i0) * channels;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    hv[p] = p < rem ? *h : 0.0f;
    h -= channels;
  }
}

// Reversed chunk k: prefetch chunk k+1 into (an, gn), scan (av, gv) from
// 0, issue this segment's h loads, fold the W aggregates from `carry`
// (updated to the carry out of chunk k), and store g and g * h from the
// carry into this warp's segment.  The scan, fold and fix-up are
// scan_chunk's, operation for operation.
template <typename T, int W, int P>
__device__ __forceinline__ void adjoint_chunk(
    const T* __restrict__ a, const float* __restrict__ gbar,
    const float* __restrict__ h, float* __restrict__ grad_a,
    float* __restrict__ grad_b, int64_t k, int64_t chunks, int64_t seq,
    int64_t channels, bool live, int warp, int lane, float& carry,
    float (&av)[P], float (&gv)[P], float (&an)[P], float (&gn)[P],
    float2 (*agg)[kTile]) {
  constexpr int L = W * P;
  const int64_t i0 = k * L + static_cast<int64_t>(warp) * P;
  if (k + 1 < chunks)
    load_segment_rev<T, P>(a, gbar, i0 + L, seq, channels, live, an, gn);
  float prod = 1.0f, gend = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    gend = fmaf(av[p], gend, gv[p]);
    prod *= av[p];
  }
  agg[warp][lane] = make_float2(prod, gend);
  float hv[P];
  load_h_rev<P>(h, i0, seq, channels, live, hv);
  __syncthreads();
  float x = carry;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (j == warp) x = carry;
    const float2 s = agg[j][lane];
    carry = fmaf(s.x, carry, s.y);
  }
  const int64_t t0 = seq - 1 - i0;
  const int64_t rem = live ? seq - i0 : 0;
  float* ob = grad_b + t0 * channels;
  float* oa = grad_a + t0 * channels;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    x = fmaf(av[p], x, gv[p]);
    if (p < rem) {
      *ob = x;
      *oa = p < rem - 1 ? __fmul_rn(x, hv[p]) : 0.0f;
    }
    ob -= channels;
    oa -= channels;
  }
}

template <typename T, int W, int P>
__global__ void __launch_bounds__(W * kTile)
    lru_scan_backward_kernel(const T* __restrict__ a,
                             const float* __restrict__ h,
                             const float* __restrict__ gbar,
                             float* __restrict__ grad_a,
                             float* __restrict__ grad_b, int64_t seq,
                             int64_t channels, int64_t tiles) {
  constexpr int L = W * P;
  __shared__ float2 agg[2][W][kTile];
  const int lane = threadIdx.x % kTile;
  const int warp = threadIdx.x / kTile;
  const int64_t row = blockIdx.x / tiles;
  const int64_t c = (blockIdx.x % tiles) * kTile + lane;
  const bool live = c < channels;
  const int64_t base = row * seq * channels + (live ? c : 0);
  a += base;
  h += base;
  gbar += base;
  grad_a += base;
  grad_b += base;
  const int64_t chunks = (seq + L - 1) / L;
  float a0[P], g0[P], a1[P], g1[P];
  load_segment_rev<T, P>(a, gbar, static_cast<int64_t>(warp) * P, seq,
                         channels, live, a0, g0);
  float carry = 0.0f;
  for (int64_t k = 0; k < chunks; k += 2) {
    adjoint_chunk<T, W, P>(a, gbar, h, grad_a, grad_b, k, chunks, seq,
                           channels, live, warp, lane, carry, a0, g0, a1, g1,
                           agg[0]);
    if (k + 1 < chunks)
      adjoint_chunk<T, W, P>(a, gbar, h, grad_a, grad_b, k + 1, chunks, seq,
                             channels, live, warp, lane, carry, a1, g1, a0,
                             g0, agg[1]);
  }
}

template <typename T>
int launch(const void* a, const void* b, void* h, int64_t batch, int64_t seq,
           int64_t channels, void* stream) {
  const int64_t tiles = (channels + kTile - 1) / kTile;
  const int64_t blocks = batch * tiles;
  if (blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  lru_scan_kernel<T, kWarps, kSteps>
      <<<static_cast<unsigned>(blocks), kWarps * kTile, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a), static_cast<const T*>(b),
          static_cast<float*>(h), seq, channels, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backward(const void* a, const void* h, const void* gbar,
                    void* grad_a, void* grad_b, int64_t batch, int64_t seq,
                    int64_t channels, void* stream) {
  const int64_t tiles = (channels + kTile - 1) / kTile;
  const int64_t blocks = batch * tiles;
  if (blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  lru_scan_backward_kernel<T, kWarps, kSteps>
      <<<static_cast<unsigned>(blocks), kWarps * kTile, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a), static_cast<const float*>(h),
          static_cast<const float*>(gbar), static_cast<float*>(grad_a),
          static_cast<float*>(grad_b), seq, channels, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_lru_scan_f32(const void* a, const void* b, void* h,
                                  int64_t batch, int64_t seq,
                                  int64_t channels, void* stream) {
  return launch<float>(a, b, h, batch, seq, channels, stream);
}

extern "C" int repro_lru_scan_bf16(const void* a, const void* b, void* h,
                                   int64_t batch, int64_t seq,
                                   int64_t channels, void* stream) {
  return launch<__nv_bfloat16>(a, b, h, batch, seq, channels, stream);
}

extern "C" int repro_lru_scan_backward_f32(const void* a, const void* h,
                                           const void* gbar, void* grad_a,
                                           void* grad_b, int64_t batch,
                                           int64_t seq, int64_t channels,
                                           void* stream) {
  return launch_backward<float>(a, h, gbar, grad_a, grad_b, batch, seq,
                                channels, stream);
}

extern "C" int repro_lru_scan_backward_bf16(const void* a, const void* h,
                                            const void* gbar, void* grad_a,
                                            void* grad_b, int64_t batch,
                                            int64_t seq, int64_t channels,
                                            void* stream) {
  return launch_backward<__nv_bfloat16>(a, h, gbar, grad_a, grad_b, batch,
                                        seq, channels, stream);
}
