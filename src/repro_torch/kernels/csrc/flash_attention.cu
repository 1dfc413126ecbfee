// Forward flash attention (online softmax) on CUDA cores, fp32, for Hopper.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (_flash_kernel)
// for float32 inputs: softmax(scale * q k^T) v, causal or not, fp32 in and
// out, with the JAX zoo's logit softcapping and query offset
// (repro/models/layers.py `_softmax_attend` under `causal_attend`'s
// mask): with softcap > 0 a logit s = scale * q.k becomes
// softcap * tanh(s / softcap) (tanhf) before the mask.  Query row i sits
// at position q_offset + i, keys at 0 .. seq_k - 1.  Products, the
// running max m, the running sum l and the output accumulator are fp32.
// Masked logits are -1e30 (keys at positions >= seq_k, and with `causal`
// keys after the query's position), and the denominator is
// max(l, 1e-30), as in the TPU kernel.  bf16 inputs go to the tensor-core
// kernel of flash_attention_sm90.cu; float32 stays here, on the CUDA cores,
// because tensor cores would round its operands to TF32.
//
// Layout.  q and o are (B, Sq, H, d), k and v (B, Sk, Hk, d), each with its
// own 64-bit element strides for batch, sequence and head and a unit
// stride over d, so the serving path's strided views are read in place.
// Query head h reads kv head h / (H / Hk), the grouping of GQA.  A
// (BH, S, d) tensor is the case H = Hk = 1.
//
// Design.  The TPU kernel walks the k blocks as a sequential grid axis
// and carries m, l and acc in VMEM scratch from one grid step to the
// next.  Hopper blocks run in parallel and in no order, so here one
// thread block owns a 64-row q tile of one (batch, head) and loops over
// the k tiles itself:
//   - 8 warps of 32 lanes; each warp owns 8 q rows of the tile.
//   - The q tile is staged once in shared memory.  Each 32-key K tile
//     and V tile is staged in shared memory, zero-filled past seq_k and
//     past d (loads are masked, not only logits).
//   - Scores: lane j computes the dot products of key j of the tile with
//     the warp's 8 q rows (float4 reads of the K row; the q rows are
//     read by every lane at once, which shared memory broadcasts).  K
//     rows are padded by 4 floats so the lanes' float4 reads fall in
//     distinct banks.
//   - Online softmax per row: a warp-shuffle max and sum update m and l,
//     and the accumulator is rescaled by exp(m_old - m_new).
//   - P V: the lanes' probabilities go through a per-warp shared buffer;
//     lane j owns output columns j, j + 32, ... of the accumulator
//     (conflict-free reads of the V row, coalesced stores).
//   - With `causal`, k tiles wholly after a block's last row's position
//     are never loaded, and a warp skips a tile wholly after its own
//     last row's (both give exactly zero weight).  Blocks of the longest
//     rows are launched first.
// The head dimension is a template bucket (32, 64, 128 or 256, d <= the
// bucket, zero-padded), so every loop over it unrolls; softcap is the
// template flag kSoftcap, so the instances without it carry no tanh.
//
// Bound.  Causal fp32 attention at (96, 2048, 128) is ~1.0e11 flops on
// ~4e8 bytes: bound by operations, at the CUDA cores' 67 TFLOP/s.
//
// Interface.  A plain C entry point for ctypes: device pointers, the
// stride array (host memory, 12 int64: batch, seq, head of q, k, v, o)
// and the CUDA stream arrive as pointers, sizes, flags and the query
// offset as int, the scale and softcap as float.  A negative offset is
// refused (rows that see no key; the Python op raises first).  It returns a cudaError_t as int (0 = success), the
// result of cudaGetLastError() after its launch.
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerWarp = 8;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kRowsPerWarp * kWarps;  // 64 q rows per block
constexpr int kBlockK = 32;                     // one key per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// Shared-memory layout (in floats) for head-dimension bucket D.
template <int D>
struct Smem {
  static constexpr int kKStride = D + 4;  // padded: float4 reads spread banks
  static constexpr int kQ = kBlockQ * D;
  static constexpr int kK = kBlockK * kKStride;
  static constexpr int kV = kBlockK * D;
  static constexpr int kP = kWarps * kBlockK * kRowsPerWarp;
  static constexpr size_t kBytes = (kQ + kK + kV + kP) * sizeof(float);
};

// Element strides (batch, sequence, head) of q, k, v and o; the stride
// over d is 1.
struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

// Rows [row0, row0 + n_rows) of a (seq, d) matrix whose rows lie
// `row_stride` elements apart into a tile with row stride `stride`; rows
// >= seq and columns >= d are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int stride,
                                          int n_rows,
                                          const float* __restrict__ src,
                                          long long row_stride, int row0,
                                          int seq, int d) {
  for (int i = threadIdx.x; i < n_rows * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    const int row = row0 + r;
    float x = 0.0f;
    if (row < seq && c < d) x = src[row * row_stride + c];
    dst[r * stride + c] = x;
  }
}

// grid: x = batch * H + head, y = q tile (reversed: longest rows first).
template <int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 Strides st, int seq_q, int seq_k, int q_offset,
                 int n_heads, int group, int d, int causal, float scale,
                 float softcap) {
  using L = Smem<D>;
  constexpr int R = kRowsPerWarp;
  constexpr int C = D / 32;  // accumulator columns per lane
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned base
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + L::kQ;
  float* v_s = k_s + L::kK;
  float* p_s = v_s + L::kV;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // longest rows first
  const long long b = blockIdx.x / n_heads;
  const int h = blockIdx.x % n_heads;
  const int hk = h / group;  // the kv head of this q head (GQA)
  const float* q_bh = q + b * st.qb + h * st.qh;
  const float* k_bh = k + b * st.kb + hk * st.kh;
  const float* v_bh = v + b * st.vb + hk * st.vh;
  float* o_bh = o + b * st.ob + h * st.oh;
  const int row0 = q0 + warp * R;  // this warp's first q row

  load_tile<D>(q_s, D, kBlockQ, q_bh, st.qs, q0, seq_q, d);

  float m[R], l[R], acc[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.0f;
  }

  const float* q_w = q_s + warp * R * D;
  float* p_w = p_s + warp * kBlockK * R;  // [key][row] for this warp
  const int pos0 = q_offset + row0;  // this warp's first row's position
  const int k_end = causal ? min(seq_k, q_offset + q0 + kBlockQ) : seq_k;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // every warp is done with the previous K and V tile
    load_tile<D>(k_s, L::kKStride, kBlockK, k_bh, st.ks, k0, seq_k, d);
    load_tile<D>(v_s, D, kBlockK, v_bh, st.vs, k0, seq_k, d);
    __syncthreads();  // the tiles (and, at t = 0, the q tile) are in place
    if (causal && k0 > pos0 + R - 1) continue;  // warp-uniform

    // scores of key k0 + lane against the warp's R rows
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.0f;
    const float* k_row = k_s + lane * L::kKStride;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(k_row + c);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q_w + r * D + c);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    // online softmax, one row at a time across the warp
    const int key = k0 + lane;
    float p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool keep = key < seq_k && (!causal || key <= pos0 + r);
      float x = s[r] * scale;
      if constexpr (kSoftcap) x = softcap * tanhf(x / softcap);
      x = keep ? x : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      p[r] = expf(x - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= alpha;
    }
    float4* p_lane = reinterpret_cast<float4*>(p_w + lane * R);
    p_lane[0] = make_float4(p[0], p[1], p[2], p[3]);
    p_lane[1] = make_float4(p[4], p[5], p[6], p[7]);
    __syncwarp();

    // acc += P V over the tile's keys
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(p_w + j * R);
      const float4 pb = *reinterpret_cast<const float4*>(p_w + j * R + 4);
      const float pj[R] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float vv = v_s[j * D + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][c] = fmaf(pj[r], vv, acc[r][c]);
      }
    }
    __syncwarp();  // p_w is rewritten by the next tile
  }

  // rows past seq_q (the tail of the last q tile) are never written
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row >= seq_q) break;
    const float denom = fmaxf(l[r], 1e-30f);
    float* out_row = o_bh + row * st.os;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = lane + 32 * c;
      if (col < d) out_row[col] = acc[r][c] / denom;
    }
  }
}

template <int D, bool kSoftcap>
int launch(const float* q, const float* k, const float* v, float* o,
           const Strides& st, int batch, int seq_q, int seq_k,
           int q_offset, int n_heads, int group, int d, int causal,
           float scale, float softcap, cudaStream_t stream) {
  constexpr size_t smem = Smem<D>::kBytes;
  // Above 48 KB of dynamic shared memory a kernel must opt in, once per
  // instantiation (before any launch, so also before a graph capture).
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D, kSoftcap>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid(batch * n_heads, (seq_q + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<D, kSoftcap><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, st, seq_q, seq_k, q_offset, n_heads, group, d, causal,
      scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (batch, seq_q, n_heads, d); k, v: (batch, seq_k, n_kv_heads, d);
// strides: 12 element strides (batch, seq, head) of q, k, v, o; query row
// i at position q_offset + i.
extern "C" int repro_flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int batch,
    int seq_q, int seq_k, int n_heads, int n_kv_heads, int d,
    const long long* strides, int causal, float scale, float softcap,
    int q_offset, void* stream) {
  if (batch <= 0 || seq_q <= 0 || seq_q > 65535 * kBlockQ || seq_k <= 0 ||
      q_offset < 0 || d <= 0 || d > 256 ||
      n_heads <= 0 || n_kv_heads <= 0 || n_heads % n_kv_heads != 0 ||
      static_cast<long long>(batch) * n_heads > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  const int group = n_heads / n_kv_heads;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_F32(D)                                                   \
  return softcap > 0.0f                                                      \
             ? launch<D, true>(qf, kf, vf, of, st, batch, seq_q, seq_k,      \
                               q_offset, n_heads, group, d, causal, scale,   \
                               softcap, s)                                   \
             : launch<D, false>(qf, kf, vf, of, st, batch, seq_q, seq_k,     \
                                q_offset, n_heads, group, d, causal, scale,  \
                                softcap, s)
  if (d <= 32) REPRO_FLASH_F32(32);
  if (d <= 64) REPRO_FLASH_F32(64);
  if (d <= 128) REPRO_FLASH_F32(128);
  REPRO_FLASH_F32(256);
#undef REPRO_FLASH_F32
}
