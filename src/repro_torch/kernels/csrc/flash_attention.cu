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
// Layout.  q and o are (B, Sq, H, d) and (B, Sq, H, dv), k (B, Sk, Hk, d)
// and v (B, Sk, Hk, dv) with dv <= d, each with its own 64-bit element
// strides for batch, sequence and head and a unit stride over the last
// dimension, so the serving path's strided views are read in place, and
// so is a v narrower than q and k (multi-head latent attention: d = 192,
// dv = 128).  Query head h reads kv head h / (H / Hk), the grouping of
// GQA.  A (BH, S, d) tensor is the case H = Hk = 1.
//
// Bound.  Causal fp32 attention is bound by operations at the CUDA cores'
// 67 TFLOP/s: (4, 2048, 24, 8, 128) is 1.03e11 flops on 1.6e8 bytes.
// So the design is that of a SIMT GEMM, kept fed from shared memory,
// whose 128-bit reads cost its pipe 4 cycles a warp: each float4 read has
// to feed as many FMAs as the registers allow.
//   - A block owns a tile of query rows of one (batch, head) and walks
//     the key tiles of 64 keys itself, the TPU kernel's sequential grid
//     axis.  Its warps own 2 R rows each, R = 8 or 4 rows a lane: the
//     launch takes the tallest tile whose grid still gives every SM a
//     block, 128 rows (R = 8, 8 warps; only where dv <= 128, whose
//     accumulator fits the registers), else 64, 32 or 16 (R = 4, 8, 4 or
//     2 warps), so the 256-token replays fill the card too.
//   - Register blocking.  Lane (ty, tx) of a warp, ty in {0, 1} and tx in
//     0..15, owns an R x 4 micro-tile of the scores, rows R ty .. R ty +
//     R - 1 of its warp's and keys tx, tx + 16, tx + 32, tx + 48 of the
//     tile: per 4 columns of d it reads R float4 of q and four of K and
//     does 16 R FMAs.  q and K rows are padded by 4 floats, so 8 lanes
//     reading 8 K rows hit distinct banks and the lanes that share a q
//     row read one address.  For P V the same lane owns the same R rows
//     and dv / 16 output columns (float4 or float2 chunks, 64 or 32
//     columns apart): per key R / 4 float4 of P and dv / 64 float4 (or
//     dv / 32 float2) of V feed R dv / 16 FMAs.  P goes through a
//     per-warp shared buffer (key-major, 2 R rows a key); only the warp's
//     own lanes read it.
//   - Softmax once per tile on the micro-tile: each lane's 4 keys of a row,
//     then a 4-step shuffle max over the 16 lanes of the row; the running
//     sum l stays per lane (every lane of a row rescales by the same
//     factor) and is summed across the 16 lanes once, at the end.  Logits
//     are kept in log2 units (log2(e) folded into the scale, exp2f); the
//     softcapped instance applies tanhf first, the others carry no tanh.
//   - Asynchronous copies.  q, K and V tiles arrive by cp.async, 16 bytes
//     a copy where an operand's base, strides and width allow, 4 bytes
//     otherwise (a view one element past an aligned base), zero-filled
//     past seq and past d (dv).  K and V each have one buffer (two of
//     each would not fit at d = 256) and each copy starts half a tile
//     ahead: V of tile t while q k^T of tile t runs, K of tile t + 1
//     while P V of tile t runs.
//   - With `causal`, key tiles wholly after a block's last row's position
//     are never loaded, a warp skips the tiles wholly after its own last
//     row's (both give exactly zero weight) and masks only the tiles that
//     cross its rows' positions or seq_k.  Blocks of the longest rows are
//     launched first.
// The head width is a template bucket D (32 to 256 in steps of 32, d <=
// D, zero-filled) and the value width one DV of its own (D itself, and
// 128 at D = 192 for latent attention; any other dv < d runs at DV = D,
// its columns past dv zero-filled in shared memory), so every loop over
// them unrolls; softcap is the template flag kSoftcap.
//
// Interface.  A plain C entry point for ctypes: device pointers, the
// stride array (host memory, 12 int64: batch, seq, head of q, k, v, o)
// and the CUDA stream arrive as pointers, sizes, flags and the query
// offset as int, the scale and softcap as float.  A negative offset is
// refused (rows that see no key; the Python op raises first).  It returns
// a cudaError_t as int (0 = success), the result of cudaGetLastError()
// after its launch.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kMaxBlockQ = kMaxWarps * 16;  // 128 q rows (R = 8)
constexpr int kBlockK = 64;       // keys per tile: 16 lanes x 4
constexpr float kNegInf = -1e30f;
constexpr double kLog2e = 1.4426950408889634;
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's limit on sm_90

// Shared-memory layout (in floats) for head width D, value width DV and
// R rows a lane (2 R a warp).
template <int D, int DV, int R>
struct Tile {
  static constexpr int kWarpRows = 2 * R;
  static constexpr int kDS = D + 4;  // q and K row stride; padded: Design
  static constexpr int kVS = DV;
  static constexpr int kPW = kBlockK * kWarpRows;  // P of one warp
  static constexpr size_t bytes(int warps) {
    return static_cast<size_t>(warps * kWarpRows * kDS +
                               kBlockK * kDS + kBlockK * kVS +
                               warps * kPW) * sizeof(float);
  }
};

// Element strides (batch, sequence, head) of q, k, v and o; the stride
// over the last dimension is 1.
struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

// Which operands take 16-byte copies (q, k, v) and stores (o).
enum : int { kVecQ = 1, kVecK = 2, kVecV = 4, kVecO = 8 };

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (4) bytes; `src_bytes` of them read, the rest zero.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float row_max(float v) {  // over 16 lanes
#pragma unroll
  for (int offset = 8; offset > 0; offset >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  }
  return v;
}

__device__ __forceinline__ float row_sum(float v) {  // over 16 lanes
#pragma unroll
  for (int offset = 8; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// Starts the copies of rows [row0, row0 + n_rows) of a (seq, width)
// operand whose rows lie `rs` elements apart into `dst` (row stride `ds`
// floats, W >= width columns); rows >= seq and columns >= width are
// zero-filled.  `vec`: 16-byte copies (base, strides and width multiples
// of 4 floats), else 4-byte ones.
template <int W>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ds,
                                          int n_rows,
                                          const float* __restrict__ src,
                                          long long rs, int row0, int seq,
                                          int width, bool vec) {
  if (vec) {
    constexpr int C4 = W / 4;
    for (int i = threadIdx.x; i < n_rows * C4; i += blockDim.x) {
      const int r = i / C4;
      const int c = (i % C4) * 4;
      const int row = row0 + r;
      const bool in = row < seq && c < width;
      cp_async16(dst + r * ds + c, in ? src + row * rs + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * W; i += blockDim.x) {
      const int r = i / W;
      const int c = i % W;
      const int row = row0 + r;
      const bool in = row < seq && c < width;
      cp_async4(dst + r * ds + c, in ? src + row * rs + c : src,
                in ? 4 : 0);
    }
  }
}

// grid: x = batch * H + head, y = q tile (reversed: longest rows first);
// blockDim.x = 32 * W.  scale_log2 = scale * log2(e); with kSoftcap the
// logit is cap_log2 * tanh(s * cap_in), cap_in = scale / softcap and
// cap_log2 = softcap * log2(e).
template <int D, int DV, int R, bool kSoftcap>
__global__ void __launch_bounds__(kMaxThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 Strides st, int seq_q, int seq_k, int q_offset,
                 int n_heads, int group, int d, int dv, int causal,
                 float scale_log2, float cap_in, float cap_log2, int vec) {
  using T = Tile<D, DV, R>;
  static_assert(R % 4 == 0, "rows a lane: whole float4 of P");
  constexpr int VW = DV % 64 == 0 ? 4 : 2;  // P V column chunk width
  constexpr int NV = DV / (16 * VW);        // chunks per lane and row
  constexpr int NC = DV / 16;               // output columns per lane
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned base
  const int block_q = (blockDim.x / 32) * T::kWarpRows;
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + block_q * T::kDS;
  float* v_s = k_s + kBlockK * T::kDS;
  float* p_s = v_s + kBlockK * T::kVS;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ty = lane / 16;  // row group of the warp
  const int tx = lane % 16;  // key (column) group
  const int q0 = (gridDim.y - 1 - blockIdx.y) * block_q;  // longest first
  const long long b = blockIdx.x / n_heads;
  const int h = blockIdx.x % n_heads;
  const int hk = h / group;  // the kv head of this q head (GQA)
  const float* q_bh = q + b * st.qb + h * st.qh;
  const float* k_bh = k + b * st.kb + hk * st.kh;
  const float* v_bh = v + b * st.vb + hk * st.vh;
  float* o_bh = o + b * st.ob + h * st.oh;

  const int wrow0 = warp * T::kWarpRows;  // the warp's rows in the tile
  const int trow0 = wrow0 + ty * R;       // the lane's R rows
  const int wpos0 = q_offset + q0 + wrow0;  // position of the warp's first
  const bool warp_live = q0 + wrow0 < seq_q;
  const int q_end = min(q0 + block_q, seq_q);
  const int k_end = causal ? min(seq_k, q_offset + q_end) : seq_k;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;

  load_tile<D>(q_s, T::kDS, block_q, q_bh, st.qs, q0, seq_q, d,
               vec & kVecQ);
  load_tile<D>(k_s, T::kDS, kBlockK, k_bh, st.ks, 0, seq_k, d, vec & kVecK);
  cp_async_commit();

  float m[R], l[R], acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }
  float* p_w = p_s + warp * T::kPW;  // [key][2 R rows] of this warp

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    cp_async_wait_all();
    __syncthreads();  // K of tile t (and q) in place; V's buffer free
    load_tile<DV>(v_s, T::kVS, kBlockK, v_bh, st.vs, k0, seq_k, dv,
                  vec & kVecV);
    cp_async_commit();
    // warp-uniform: the warp has rows, and this tile has keys they see
    const bool live =
        warp_live && !(causal && k0 > wpos0 + T::kWarpRows - 1);
    if (live) {
      // scores of the lane's R rows against keys tx + 16 j
      float s[R][4];
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
      }
      const float* q_l = q_s + trow0 * T::kDS;
      const float* k_l = k_s + tx * T::kDS;
#pragma unroll 4
      for (int c = 0; c < D; c += 4) {
        float4 qf[R], kf[4];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          qf[i] = *reinterpret_cast<const float4*>(q_l + i * T::kDS + c);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kf[j] = *reinterpret_cast<const float4*>(k_l + 16 * j * T::kDS + c);
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qf[i].x, kf[j].x, s[i][j]);
            s[i][j] = fmaf(qf[i].y, kf[j].y, s[i][j]);
            s[i][j] = fmaf(qf[i].z, kf[j].z, s[i][j]);
            s[i][j] = fmaf(qf[i].w, kf[j].w, s[i][j]);
          }
        }
      }

      // logits in log2 units; the mask only where the tile crosses the
      // rows' positions or seq_k
      const bool masked = k0 + kBlockK > seq_k ||
                          (causal && k0 + kBlockK - 1 > wpos0);
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x;
          if constexpr (kSoftcap) {
            x = cap_log2 * tanhf(s[i][j] * cap_in);
          } else {
            x = s[i][j] * scale_log2;
          }
          if (masked) {
            const int key = k0 + tx + 16 * j;
            const bool keep =
                key < seq_k && (!causal || key <= wpos0 + ty * R + i);
            x = keep ? x : kNegInf;
          }
          s[i][j] = x;
        }
      }

      // online softmax over the tile, one row at a time
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float mx = row_max(
            fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = exp2f(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = exp2f(s[i][j] - m_new);
          sum += s[i][j];
        }
        l[i] = l[i] * alpha + sum;  // this lane's keys only
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < R; i += 4) {
          *reinterpret_cast<float4*>(p_w + (tx + 16 * j) * T::kWarpRows +
                                     ty * R + i) =
              make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);
        }
      }
      __syncwarp();
    }
    cp_async_wait_all();
    __syncthreads();  // V of tile t in place; K's buffer free
    if (t + 1 < n_tiles) {
      load_tile<D>(k_s, T::kDS, kBlockK, k_bh, st.ks, k0 + kBlockK, seq_k,
                   d, vec & kVecK);
      cp_async_commit();
    }
    if (live) {
      // acc += P V over the tile's keys
      const float* v_l = v_s + VW * tx;
      const float* p_l = p_w + ty * R;
#pragma unroll 4
      for (int j = 0; j < kBlockK; ++j) {
        float p[R];
#pragma unroll
        for (int i = 0; i < R; i += 4) {
          const float4 f = *reinterpret_cast<const float4*>(
              p_l + j * T::kWarpRows + i);
          p[i] = f.x; p[i + 1] = f.y; p[i + 2] = f.z; p[i + 3] = f.w;
        }
        const float* v_row = v_l + j * T::kVS;
#pragma unroll
        for (int u = 0; u < NV; ++u) {
          float x[VW];
          if constexpr (VW == 4) {
            const float4 f = *reinterpret_cast<const float4*>(v_row + 64 * u);
            x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
          } else {
            const float2 f = *reinterpret_cast<const float2*>(v_row + 32 * u);
            x[0] = f.x; x[1] = f.y;
          }
#pragma unroll
          for (int i = 0; i < R; ++i) {
#pragma unroll
            for (int e = 0; e < VW; ++e) {
              acc[i][u * VW + e] = fmaf(p[i], x[e], acc[i][u * VW + e]);
            }
          }
        }
      }
      __syncwarp();  // p_w is rewritten by the next tile
    }
  }

  // rows past seq_q (the tail of the last q tile) are never written
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float denom = fmaxf(row_sum(l[i]), 1e-30f);
    const int row = q0 + trow0 + i;
    if (row >= seq_q) continue;
    float* out_row = o_bh + row * st.os;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int col = VW * tx + 16 * VW * u;
      float y[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) y[e] = acc[i][u * VW + e] / denom;
      if ((vec & kVecO) && col + VW <= dv) {
        if constexpr (VW == 4) {
          *reinterpret_cast<float4*>(out_row + col) =
              make_float4(y[0], y[1], y[2], y[3]);
        } else {
          *reinterpret_cast<float2*>(out_row + col) = make_float2(y[0], y[1]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          if (col + e < dv) out_row[col + e] = y[e];
        }
      }
    }
  }
}

// Whether an operand with base `p`, the (stride, size) pairs of its
// outer dimensions and last dimension `width` can be moved 16 bytes at a
// time: the base, every stride it steps and the width multiples of 4
// floats.
bool vec16(const void* p, const long long* strides, const int* sizes,
           int n, int width) {
  if (reinterpret_cast<unsigned long long>(p) % 16 != 0 || width % 4 != 0)
    return false;
  for (int i = 0; i < n; ++i) {
    if (sizes[i] > 1 && strides[i] % 4 != 0) return false;
  }
  return true;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      n = 0;
      return 132;
    }
  }
  return n;
}

struct Args {
  const float *q, *k, *v;
  float* o;
  Strides st;
  int batch, seq_q, seq_k, q_offset, n_heads, group, d, dv, causal, vec;
  float scale, softcap;
};

// One launch of the R-rows-a-lane instance with `warps` warps.
template <int D, int DV, int R, bool kSoftcap>
int launch(const Args& a, int warps, cudaStream_t stream) {
  using T = Tile<D, DV, R>;
  static_assert(D % 32 == 0 && DV % 32 == 0 && DV <= D && D <= 256, "");
  static_assert(T::bytes(kMaxWarps) <= kMaxSmem, "tile over 227 KB");
  // Above 48 KB of dynamic shared memory a kernel must opt in, once per
  // instantiation (before any launch, so also before a graph capture).
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D, DV, R, kSoftcap>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(T::bytes(kMaxWarps)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int block_q = warps * T::kWarpRows;
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(a.batch) *
                                        a.n_heads),
                  (a.seq_q + block_q - 1) / block_q);
  const float scale_log2 = static_cast<float>(a.scale * kLog2e);
  const float cap_in = kSoftcap ? a.scale / a.softcap : 0.0f;
  const float cap_log2 =
      kSoftcap ? static_cast<float>(a.softcap * kLog2e) : 0.0f;
  flash_fwd_kernel<D, DV, R, kSoftcap>
      <<<grid, warps * 32, T::bytes(warps), stream>>>(
          a.q, a.k, a.v, a.o, a.st, a.seq_q, a.seq_k, a.q_offset,
          a.n_heads, a.group, a.d, a.dv, a.causal, scale_log2, cap_in,
          cap_log2, a.vec);
  return static_cast<int>(cudaGetLastError());
}

// The tallest q tile whose grid still gives every SM a block: 128 rows
// (R = 8, 8 warps; only where DV <= 128, whose accumulator fits the
// registers), else 64, 32 or 16 rows (R = 4, 8, 4 or 2 warps).
template <int D, int DV, bool kSoftcap>
int launch_tiled(const Args& a, cudaStream_t stream) {
  const long long bh = static_cast<long long>(a.batch) * a.n_heads;
  const auto blocks = [&](int rows) {
    return bh * ((a.seq_q + rows - 1) / rows);
  };
  const int n_sm = sm_count();
  if constexpr (DV <= 128) {
    if (blocks(kMaxBlockQ) >= n_sm) {
      return launch<D, DV, 8, kSoftcap>(a, kMaxWarps, stream);
    }
  }
  int warps = kMaxWarps;
  while (warps > 2 && blocks(warps * 8) < n_sm) warps /= 2;
  return launch<D, DV, 4, kSoftcap>(a, warps, stream);
}

template <int D, int DV>
int launch_capped(const Args& a, cudaStream_t stream) {
  return a.softcap > 0.0f ? launch_tiled<D, DV, true>(a, stream)
                          : launch_tiled<D, DV, false>(a, stream);
}

}  // namespace

// q: (batch, seq_q, n_heads, d); k: (batch, seq_k, n_kv_heads, d); v:
// (batch, seq_k, n_kv_heads, dv); o: (batch, seq_q, n_heads, dv);
// strides: 12 element strides (batch, seq, head) of q, k, v, o; query row
// i at position q_offset + i.
extern "C" int repro_flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int batch,
    int seq_q, int seq_k, int n_heads, int n_kv_heads, int d, int dv,
    const long long* strides, int causal, float scale, float softcap,
    int q_offset, void* stream) {
  if (batch <= 0 || seq_q <= 0 || seq_q > 65535 * (kMaxBlockQ / 2) ||
      seq_k <= 0 || q_offset < 0 || d <= 0 || d > 256 || dv <= 0 ||
      dv > d || n_heads <= 0 || n_kv_heads <= 0 ||
      n_heads % n_kv_heads != 0 ||
      static_cast<long long>(batch) * n_heads > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<float*>(o),
         Strides{strides[0], strides[1], strides[2],  strides[3],
                 strides[4], strides[5], strides[6],  strides[7],
                 strides[8], strides[9], strides[10], strides[11]},
         batch, seq_q, seq_k, q_offset, n_heads, n_heads / n_kv_heads, d,
         dv, causal, 0, scale, softcap};
  const int q_sizes[3] = {batch, seq_q, n_heads};
  const int kv_sizes[3] = {batch, seq_k, n_kv_heads};
  a.vec = (vec16(q, strides, q_sizes, 3, d) ? kVecQ : 0) |
          (vec16(k, strides + 3, kv_sizes, 3, d) ? kVecK : 0) |
          (vec16(v, strides + 6, kv_sizes, 3, dv) ? kVecV : 0) |
          (vec16(o, strides + 9, q_sizes, 3, dv) ? kVecO : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32) return launch_capped<32, 32>(a, s);
  if (d <= 64) return launch_capped<64, 64>(a, s);
  if (d <= 96) return launch_capped<96, 96>(a, s);
  if (d <= 128) return launch_capped<128, 128>(a, s);
  if (d <= 160) return launch_capped<160, 160>(a, s);
  if (d <= 192) {
    return dv <= 128 ? launch_capped<192, 128>(a, s)
                     : launch_capped<192, 192>(a, s);
  }
  if (d <= 224) return launch_capped<224, 224>(a, s);
  return launch_capped<256, 256>(a, s);
}
