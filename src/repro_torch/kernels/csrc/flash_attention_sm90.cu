// Forward flash attention for bf16 on Hopper's tensor cores.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (_flash_kernel)
// for bfloat16 inputs: softmax(scale * q k^T) v, causal or not, bf16 in and
// out, with the JAX zoo's logit softcapping and query offset
// (repro/models/layers.py `_softmax_attend` under `causal_attend`'s mask):
// with softcap > 0 a logit s = scale * q.k becomes softcap * tanh(s /
// softcap) before the mask, and query row i sits at position q_offset + i,
// keys at 0 .. seq_k - 1.  The running max m, the running sum l and the
// output accumulator are fp32.  Masked logits are -1e30 (keys at positions
// >= seq_k, and with `causal` keys after the query's position), and the
// denominator is max(l, 1e-30), as in the TPU kernel.  The probabilities are rounded to bf16 before the product with v,
// as the JAX zoo's `_softmax_attend` casts them to v's dtype.  float32
// inputs stay on the CUDA-core kernel of flash_attention.cu.
//
// Layout.  q is (B, Sq, H, d), k (B, Sk, Hk, d), v (B, Sk, Hk, dv) and o
// (B, Sq, H, dv) with dv <= d (multi-head latent attention's prefill:
// d = 192, dv = 128), each with its own 64-bit element strides for
// batch, sequence and head and a unit stride over d: the serving path's
// (B, S, H, d) projections are read in place, and query head h reads kv
// head h / (H / Hk), the grouping of GQA, with no copy of K or V per
// query head.  A (BH, S, d) tensor is H = Hk = 1.
//
// Bound.  Causal attention at the llama serving shape (B*H, S, d) =
// (96, 2048, 128) is ~1.0e11 flops on ~2e8 bytes: bound by operations, at
// the 989 TFLOP/s of the dense bf16 tensor cores.  Both products must run
// there, and the tiles must arrive without holding up the math.
//
// One kernel, `flash_wgmma_kernel` (TMA + wgmma).  TMA reads q, k and v in
// place when d % 8 == 0 and each pointer and stride is a multiple of 16
// bytes; the Python wrapper copies any other operand into an aligned buffer
// with d zero-padded to a multiple of 8 (zero columns add nothing to
// q k^T, and the padded output columns are dropped), and the entry point
// below refuses such a layout.  One block of three warpgroups (FA3's
// schedule) owns a 128-row q tile of one (batch, head):
// - Warpgroup 2 is the producer.  One of its threads issues the TMA
//   loads of the q tile and of a ring of K/V stages (3 where they fit,
//   else 2), K and V on their own mbarriers so Q K^T starts before V
//   lands; it is the only thread that waits on the `empty` mbarriers, and
//   it refills a stage as soon as both consumer warpgroups have released
//   it, with no consumer waiting for that.  The tensor maps are built on
//   the host per call over the strided 4-D (d, H, S, B) views (v's and
//   o's of width dv) and passed as __grid_constant__ parameters.  Boxes
//   are 64 columns wide with the 128-byte swizzle, so d and dv are padded
//   to the instance's chunks in shared memory by TMA's zero fill (a box
//   wholly past the width is all zeros), and rows past Sq (q) or Sk (K,
//   V) are zero-filled too.
// - Warpgroups 0 and 1 consume, 64 q rows each.  `__launch_bounds__(384,
//   1)` gives every thread 168 registers; the producer gives registers
//   back (`setmaxnreg.dec` to 24) and the consumers take them
//   (`setmaxnreg.inc` to 240; the loop below uses up to 224).  ptxas
//   honours `setmaxnreg` only where it can tell each warpgroup's code
//   apart: the barriers are set up and fenced before one if/else on the
//   warpgroup index (made warp-uniform by `__shfl_sync`), and its two
//   branches never meet again (nothing runs after them).  A loader
//   inside a consumer warpgroup would wait there for both warpgroups to
//   release a stage, holding the two in lockstep.
// - S = Q K^T is a `wgmma` with both operands in swizzled shared memory
//   (K-major); the online softmax runs on the fp32 accumulator in
//   registers with exp2 and scale * log2(e) folded in (with softcap, the
//   tanh acts on scale * s first, see `softmax_tile`); P is converted to
//   bf16 in the accumulator's own fragment layout and fed back as the
//   register A operand of O += P V, with V read from shared memory
//   MN-major.  A warpgroup issues S_t and then P_{t-1} V_{t-1}, waits
//   for S_t alone, and runs the softmax of tile t while P_{t-1} V_{t-1}
//   is still on the tensor cores.
// - Ping-pong: the consumers take turns to issue their products (two
//   named barriers), so one warpgroup's softmax runs while the other's
//   products keep the tensor cores busy.  At d = 64 an exponential costs
//   an SM as much as a score's two products (16 `ex2` a clock against
//   ~2048 bf16 multiply-adds), so the softmaxes must not run side by
//   side.  The order of operations of a row is unchanged, so the output
//   does not depend on the schedule.
// - The K tiles are walked from the last to the first, so the only
//   tiles that need a mask (the causal diagonal and the tail past Sk)
//   come first; with `causal`, tiles wholly after the q tile's last
//   position are never loaded, and a warpgroup skips a tile wholly after
//   its own rows' positions.  A row whose first tiles are all masked
//   takes garbage weights there, which the first tile it sees a key in
//   rescales by exactly 0; the last tile holds key 0, which every row
//   sees (so a negative q_offset, rows that see no key, is refused).
//   The tiles that need a mask are walked by a loop of their own, so
//   the others (all but the first one or two of a row) carry none of
//   its instructions.  The accumulator is rescaled only for rows whose
//   max grew.
// - Instances <DC, DVC, BK>: DC 64-column chunks of d (q, K), DVC of
//   the V tile and the O accumulator, BK keys a K/V stage, chosen so the
//   q tile and the stages fit in 227 KB and the accumulators in 240
//   registers; the caller names one (the Python wrapper's
//   `bf16_instance`): <1, 1, 128> for d <= 64 and <2, 2, 128> for
//   d <= 128 (3 stages), <3, 2, 128> for d <= 192 with dv <= 128 (2
//   stages of 80 KB; latent attention), <3, 3, 96> for d <= 192 (2
//   stages of 72 KB; stablelm's 160: 15 % faster there than 3 stages of
//   64 keys), <4, 4, 64> for d <= 256 (2 stages).  Zero columns of q and
//   K add nothing to Q K^T, and O's columns past dv are never stored.
// - Softcap and the offset are template flags (kSoftcap; kOffset: a
//   query offset or a key length of its own), so the instance with
//   neither does the arithmetic it did before they existed (its
//   q_offset is the constant 0 and its key length the query length).
// It launches one block per (batch, head, q tile), heads taken in groups
// of about one wave and the longest q tiles of a group first
// (`block_work`), so the blocks in flight share their K/V in L2.
//
// Interface.  A plain C entry point for ctypes: device pointers, the stride
// array (host memory, 12 int64: batch, seq, head of q, k, v, o) and the CUDA
// stream arrive as pointers, sizes, the flag and the query offset as int,
// the scale and softcap as float.  It returns a cudaError_t as int (0 = success), the result of
// cudaGetLastError() after its launch.  The TMA descriptors are encoded
// through the driver entry point found by cudaGetDriverEntryPoint, so the
// library does not link libcuda.
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Element strides (batch, sequence, head) of q, k, v and o; the stride
// over d is 1.
struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x on the special-function unit, subnormal results flushed to zero
// (probabilities below 1e-38).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 1/x on the special-function unit (relative error within 1 ulp).
__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Online-softmax update of one row pair from a tile of fp32 scores laid
// out as an mma/wgmma accumulator: element e of a thread is row a
// (e % 4 < 2) or row b (e % 4 >= 2) of its quad, key column
// 8 * (e / 4) + 2 * (lane % 4) + (e % 2) of the tile.  Scores become
// probabilities in place; m is in log2 units; l is this thread's partial
// row sum (the quad's lanes are summed once, at the end).  `pos_a` is row
// a's position (q_offset + its row), row b's is pos_a + 8.  Without
// kSoftcap a logit in log2 units is s * scale_a (scale_a = scale *
// log2 e); with it, softcap * tanh(scale * s / softcap) * log2 e, as
// scale_b - 2 scale_b / (1 + 2^(s * scale_a)) with scale_a = 2 log2 e *
// scale / softcap and scale_b = softcap * log2 e: tanh y = 1 - 2 / (1 +
// e^(2y)) on two special-function ops, an absolute error of a few float32
// ulps of scale_b (an overflowing 2^ gives +inf and the cap exactly).
// kMasked: the tile may hold keys at or past seq_k or, with `causal`,
// after a row's position, which get the logit -1e30; a template flag, so
// that the tiles that need no mask (all but the first one or two of a
// row's walk) carry no instruction of it.  Returns the factors the
// accumulator is rescaled by.
template <int N, bool kSoftcap, bool kMasked>
__device__ __forceinline__ float2 softmax_tile(float (&s)[N], int key0,
                                               int pos_a,
                                               int seq_k, bool causal,
                                               float scale_a, float scale_b,
                                               float& m_a, float& m_b,
                                               float& l_a, float& l_b) {
  const int lane = threadIdx.x % 32;
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    float x;
    if constexpr (kSoftcap) {
      x = fmaf(-2.0f * scale_b, fast_rcp(1.0f + fast_exp2(s[e] * scale_a)),
               scale_b);
    } else {
      x = s[e] * scale_a;
    }
    if constexpr (kMasked) {
      const int key = key0 + 8 * (e / 4) + 2 * (lane % 4) + (e % 2);
      const int pos = (e % 4 < 2) ? pos_a : pos_a + 8;
      if (key >= seq_k || (causal && key > pos)) x = kNegInf;
    }
    s[e] = x;
    if (e % 4 < 2) {
      mx_a = fmaxf(mx_a, x);
    } else {
      mx_b = fmaxf(mx_b, x);
    }
  }
  const float new_a = fmaxf(m_a, quad_max(mx_a));
  const float new_b = fmaxf(m_b, quad_max(mx_b));
  const float2 alpha =
      make_float2(fast_exp2(m_a - new_a), fast_exp2(m_b - new_b));
  m_a = new_a;
  m_b = new_b;
  float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float p = fast_exp2(s[e] - ((e % 4 < 2) ? new_a : new_b));
    s[e] = p;
    if (e % 4 < 2) {
      sum_a += p;
    } else {
      sum_b += p;
    }
  }
  l_a = l_a * alpha.x + sum_a;
  l_b = l_b * alpha.y + sum_b;
  return alpha;
}

// Rescales an accumulator in the same layout, only where a row's max grew.
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float2 alpha) {
  if (alpha.x != 1.0f) {
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      o[e] *= alpha.x;
      o[e + 1] *= alpha.x;
    }
  }
  if (alpha.y != 1.0f) {
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      o[e + 2] *= alpha.y;
      o[e + 3] *= alpha.y;
    }
  }
}

// The work of block `block`: heads are taken in groups of `group_heads`
// (about one wave of blocks: the number of SMs over the q tiles a head
// has), and within a group the q tiles go from the longest rows down, the
// heads of a tile side by side.  So the blocks in flight share the
// group's K and V in L2 (a head-major order reads each head's K/V from
// device memory once), and each group still ends on its shortest tiles.
__device__ __forceinline__ void block_work(int block, int n_qt, int n_bh,
                                           int group_heads, int& q_tile,
                                           int& bh) {
  const int per_group = group_heads * n_qt;
  const int group = block / per_group;
  const int first = group * group_heads;
  const int heads = min(group_heads, n_bh - first);
  const int i = block - group * per_group;
  q_tile = n_qt - 1 - i / heads;
  bh = first + i % heads;
}

int heads_per_group(int n_qt, int n_bh) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      n_sm = 132;
    }
  }
  const int g = n_sm / n_qt;
  return g < 1 ? 1 : (g > n_bh ? n_bh : g);
}

// ================================================ TMA + wgmma (sm_90a)

constexpr int kWgBlockQ = 128;  // q rows per block: 64 per consumer warpgroup
constexpr int kConsumerThreads = 256;  // two consumer warpgroups
constexpr int kWgThreads = 384;        // and the producer warpgroup
// registers a thread after `setmaxnreg`: 128 * 24 + 256 * 240 = 64512 of
// the SM's 65536 (each thread starts with 168 = 65536 / 384, rounded
// down to a multiple of 8)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kChunk = 64;         // d columns per TMA box (128 swizzled bytes)
constexpr int kChunkBytes = kChunk * 2;
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use

// Shared memory of a block (bytes from a 1024-byte aligned base): the q
// tile, then K and V stages, as DC (q, K) or DVC (V) chunks of `rows` x
// 128 bytes in the 128-byte swizzle TMA writes and wgmma reads; then the
// mbarriers (q_full, k_full[S], v_full[S], k_empty[S], v_empty[S]) and
// the slack of the base's alignment.
template <int DC, int DVC, int BK>
struct WgSmem {
  static constexpr int kQ = kWgBlockQ * kChunkBytes * DC;
  static constexpr int kKT = BK * kChunkBytes * DC;   // one K stage
  static constexpr int kVT = BK * kChunkBytes * DVC;  // one V stage
  // a stage: K, V and their four mbarriers
  static constexpr int kStageBytes = kKT + kVT + 4 * 8;
  static constexpr int kFixed = kQ + 8 + 1024;
  // K/V ring: 3 stages where they fit, else 2 (d = 256, and d = 192 at
  // 96 or 128 keys a stage)
  static constexpr int kStages = kFixed + 3 * kStageBytes <= kMaxSmem ? 3 : 2;
  static constexpr int kK = kQ;
  static constexpr int kV = kK + kStages * kKT;
  static constexpr int kBar = kV + kStages * kVT;
  static constexpr int kBytes = kFixed + kStages * kStageBytes;
  static_assert(kBytes <= kMaxSmem, "the q tile and 2 K/V stages must fit");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the phase of `bar` with parity `parity` has completed.  The
// loop is one asm block without a timeout: a `trap` in it, or the loop as
// C++ control flow, is a divergent path to ptxas, which then serialises
// every wgmma of the kernel.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Named barrier `id` (1 or 2; 0 is __syncthreads') over the two consumer
// warpgroups: `bar_sync` waits until the other warpgroup has arrived,
// `bar_arrive` arrives without waiting.
__device__ __forceinline__ void bar_sync(uint32_t id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumerThreads)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumerThreads)
               : "memory");
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  `lbo` and
// `sbo` in bytes: for K-major operands sbo is the stride of 8-row groups
// (1024) and lbo is unused; for MN-major ones lbo is the stride between
// 64-element column chunks and sbo that of 8-row groups along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of wgmma are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence/commit/wait instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma instructions: SS = both operands in shared memory, K-major
// (S = Q K^T); RS = A from registers, B in shared memory MN-major
// (O += P V).  m64nNk16, bf16 in, fp32 accumulators.
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct WgmmaRS<192> {
  static __device__ __forceinline__ void mma(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct WgmmaRS<256> {
  static __device__ __forceinline__ void mma(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

// S = Q K^T over d (4 k-steps of 16 per 64-column chunk), issued and
// committed.  The scores start from zero, so the last tile's are dead
// while the product runs and hold no registers across it.
template <int DC, int DVC, int BK>
__device__ __forceinline__ void issue_scores(float (&s)[BK / 2],
                                             float (&acc)[DVC * 32],
                                             uint32_t q_wg, uint32_t k_st) {
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) s[e] = 0.0f;
  fence_regs<BK / 2>(s);
  fence_regs<DVC * 32>(acc);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < DC; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = sw128_desc(
          q_wg + c * kWgBlockQ * kChunkBytes + kk * 32, 16, 1024);
      const uint64_t db =
          sw128_desc(k_st + c * BK * kChunkBytes + kk * 32, 16, 1024);
      WgmmaSS<BK>::mma(s, da, db, (c | kk) != 0);
    }
  }
  wgmma_commit();
}

// O += P V, issued and committed: 16 keys per k-step; V rows of 128
// swizzled bytes, DVC chunks of 64 columns BK * 128 bytes apart.
template <int DVC, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[DVC * 32],
                                         const uint32_t (&p)[BK / 16][4],
                                         uint32_t v_st) {
#pragma unroll
  for (int kt = 0; kt < BK / 16; ++kt) {
    const uint64_t dv =
        sw128_desc(v_st + kt * 16 * kChunkBytes, BK * kChunkBytes, 1024);
    WgmmaRS<DVC * 64>::mma(acc, p[kt], dv);
  }
  wgmma_commit();
}

// Probabilities in the accumulator layout -> bf16 A fragments of P V.
template <int BK>
__device__ __forceinline__ void pack_probs(uint32_t (&p)[BK / 16][4],
                                           const float (&s)[BK / 2]) {
#pragma unroll
  for (int kt = 0; kt < BK / 16; ++kt) {
    p[kt][0] = pack_bf16(s[8 * kt], s[8 * kt + 1]);
    p[kt][1] = pack_bf16(s[8 * kt + 2], s[8 * kt + 3]);
    p[kt][2] = pack_bf16(s[8 * kt + 4], s[8 * kt + 5]);
    p[kt][3] = pack_bf16(s[8 * kt + 6], s[8 * kt + 7]);
  }
}

// One K or V tile of the block's walk into its stage: C chunks of 64
// columns (TMA zero-fills those past the tensor's width) of `rows` keys
// of kv head `hk`, completing on `full`.
template <int C, int BK>
__device__ __forceinline__ void load_tile(const CUtensorMap* map,
                                          uint32_t dst, uint32_t full,
                                          int hk, int row0, int b) {
  mbar_expect_tx(full, BK * kChunkBytes * C);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    tma_load_4d(dst + c * BK * kChunkBytes, map, full, c * kChunk, hk, row0,
                b);
  }
}

// grid: one block per (batch * H + head, q tile), in `block_work` order.
// DC: 64-column chunks of d (q and K); DVC: of dv (V and O); BK: keys
// per K/V stage; kSoftcap: the logits are softcapped (scale_a, scale_b
// as in `softmax_tile`); kOffset: q_offset and seq_k are read (else 0
// and seq_q).  Warpgroups 0 and 1 consume (64 q rows each), warpgroup 2
// produces (one thread issues every TMA load).
template <int DC, int DVC, int BK, bool kSoftcap, bool kOffset>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   bf16* __restrict__ o, Strides st, int seq_q, int seq_k_in,
                   int q_offset_in, int n_bh, int group_heads, int n_heads,
                   int group, int dv, int causal, float scale_a,
                   float scale_b) {
  using L = WgSmem<DC, DVC, BK>;
  constexpr int S = L::kStages;
  const int seq_k = kOffset ? seq_k_in : seq_q;
  const int q_offset = kOffset ? q_offset_in : 0;
  constexpr int NS = BK / 2;       // score floats per thread (m64nBK)
  constexpr int NO = DVC * 32;     // accumulator floats per thread

  extern __shared__ uint8_t smem_wg[];
  const uint32_t base = (smem_addr(smem_wg) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8;  // + 8 * stage
  const uint32_t v_full = k_full + 8 * S;
  const uint32_t k_empty = v_full + 8 * S;
  const uint32_t v_empty = k_empty + 8 * S;
  int q_tile, bh;
  block_work(blockIdx.x, (seq_q + kWgBlockQ - 1) / kWgBlockQ, n_bh,
             group_heads, q_tile, bh);
  const int q0 = q_tile * kWgBlockQ;
  const int h = bh % n_heads;
  const int b = bh / n_heads;
  // key tiles up to the q tile's last position (its rows past seq_q are
  // never stored)
  const int k_end = causal ? min(seq_k, q_offset + q0 + kWgBlockQ) : seq_k;
  const int n_kv = (k_end + BK - 1) / BK;
  // the warpgroup, as a value ptxas knows is uniform over each warp
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(k_full + 8 * i, 1);
      mbar_init(v_full + 8 * i, 1);
      mbar_init(k_empty + 8 * i, 8);  // one arrival per consumer warp
      mbar_init(v_empty + 8 * i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One if/else on the warpgroup whose branches never meet again, so
  // that ptxas honours `setmaxnreg` (see the header).
  if (wg == 2) {
    // The producer: the q tile, then tile t's K and V (walked from the
    // last key tile down) into stage t % S as soon as both consumer
    // warpgroups have released the tile the stage held before.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x == kConsumerThreads) {
      mbar_expect_tx(q_full, L::kQ);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        tma_load_4d(base + c * kWgBlockQ * kChunkBytes, &tm_q, q_full,
                    c * kChunk, h, q0, b);
      }
      const int hk = h / group;  // the kv head of this q head (GQA)
      for (int t = 0; t < n_kv; ++t) {
        const int stage = t % S;
        const uint32_t parity = ((t / S) & 1) ^ 1;  // the stage is free
        const int row0 = (n_kv - 1 - t) * BK;
        mbar_wait(k_empty + 8 * stage, parity);
        load_tile<DC, BK>(&tm_k, base + L::kK + stage * L::kKT,
                          k_full + 8 * stage, hk, row0, b);
        mbar_wait(v_empty + 8 * stage, parity);
        load_tile<DVC, BK>(&tm_v, base + L::kV + stage * L::kVT,
                           v_full + 8 * stage, hk, row0, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    // Per tile t, iteration t issues S_t = Q K_t^T and then O += P_{t-1}
    // V_{t-1} (the previous tile's probabilities), waits for S_t alone
    // and runs the softmax of tile t while P_{t-1} V_{t-1} is still on
    // the tensor cores.  A warp releases K_t once S_t is in and V_{t-1}
    // once its product is done.  The two warpgroups take turns to issue
    // (named barriers 1 and 2, warpgroup 0 first): each issues its
    // products, passes the turn, and runs its softmax while the other's
    // products run.  Every tile of the block is a turn of each
    // warpgroup, a tile that a warpgroup skips too, so both take n_kv
    // turns; warpgroup 1 does not pass its last one on, so no arrival is
    // left over.
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const uint32_t turn = 1 + wg, next_turn = 2 - wg;
    const int wg_row0 = q0 + 64 * wg;
    const int wg_pos0 = q_offset + wg_row0;  // its first row's position
    const int row_a = wg_row0 + 16 * (tid / 32) + lane / 4;  // and row_a + 8
    float acc[NO];
#pragma unroll
    for (int e = 0; e < NO; ++e) acc[e] = 0.0f;
    float s[NS];
    uint32_t p[BK / 16][4];
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;
    const uint32_t q_wg = base + 64 * wg * kChunkBytes;  // its rows
    const uint32_t k_s = base + L::kK, v_s = base + L::kV;

#define REPRO_RELEASE(bar)             \
  do {                                 \
    __syncwarp();                      \
    if (lane == 0) mbar_arrive(bar);   \
  } while (0)
#define REPRO_PASS_TURN(t)                                   \
  do {                                                       \
    if (wg == 0 || (t) + 1 < n_kv) bar_arrive(next_turn);    \
  } while (0)
#define REPRO_SOFTMAX(t, kMasked)                                           \
  softmax_tile<NS, kSoftcap, kMasked>(                                      \
      s, (n_kv - 1 - (t)) * BK, q_offset + row_a, seq_k, causal, scale_a,   \
      scale_b, m_a, m_b, l_a, l_b)
// iteration t of the walk past the first tile
#define REPRO_STEP(t, kMasked)                                              \
  do {                                                                      \
    const int stage = (t) % S, prev = ((t) - 1) % S;                        \
    mbar_wait(k_full + 8 * stage, ((t) / S) & 1);                           \
    mbar_wait(v_full + 8 * prev, (((t) - 1) / S) & 1);                      \
    bar_sync(turn);                                                         \
    issue_scores<DC, DVC, BK>(s, acc, q_wg, k_s + stage * L::kKT);          \
    issue_pv<DVC, BK>(acc, p, v_s + prev * L::kVT);                         \
    REPRO_PASS_TURN(t);                                                     \
    wgmma_wait<1>(); /* the scores are in; P V still runs */                \
    fence_regs<NS>(s);                                                      \
    REPRO_RELEASE(k_empty + 8 * stage);                                     \
    const float2 alpha = REPRO_SOFTMAX(t, kMasked);                         \
    wgmma_wait<0>();                                                        \
    fence_regs<NO>(acc);                                                    \
    REPRO_RELEASE(v_empty + 8 * prev);                                      \
    rescale<NO>(acc, alpha);                                                \
    pack_probs<BK>(p, s);                                                   \
  } while (0)

    if (wg == 0) bar_arrive(turn);  // warpgroup 0 takes the first turn
    mbar_wait(q_full, 0);
    // with `causal` and 64-key tiles, the first tile (the diagonal of
    // warpgroup 1) lies wholly after warpgroup 0's rows: it gives zero
    // weight there, so warpgroup 0 only releases it
    const int n_skip = causal ? max(0, n_kv - 1 - (wg_pos0 + 63) / BK) : 0;
    for (int t = 0; t < n_skip; ++t) {
      const int stage = t % S;
      const uint32_t parity = (t / S) & 1;
      mbar_wait(k_full + 8 * stage, parity);
      REPRO_RELEASE(k_empty + 8 * stage);
      mbar_wait(v_full + 8 * stage, parity);
      REPRO_RELEASE(v_empty + 8 * stage);
      bar_sync(turn);
      REPRO_PASS_TURN(t);
    }
    // Tile t holds keys (n_kv - 1 - t) BK ..; it needs a mask unless its
    // keys all lie before seq_k and, with `causal`, at or before the
    // warpgroup's first row.  Those tiles come first in the walk.
    const int j_clear =
        min(seq_k, causal ? wg_pos0 + 1 : seq_k) / BK;  // tiles from key 0
    const int t_clear = max(n_skip + 1, n_kv - j_clear);

    // the first tile: scores and probabilities only (O is still zero)
    {
      const int stage = n_skip % S;
      mbar_wait(k_full + 8 * stage, (n_skip / S) & 1);
      bar_sync(turn);
      issue_scores<DC, DVC, BK>(s, acc, q_wg, k_s + stage * L::kKT);
      REPRO_PASS_TURN(n_skip);
      wgmma_wait<0>();
      fence_regs<NS>(s);
      REPRO_RELEASE(k_empty + 8 * stage);
      if (n_skip < n_kv - j_clear) {
        REPRO_SOFTMAX(n_skip, true);
      } else {
        REPRO_SOFTMAX(n_skip, false);
      }
      pack_probs<BK>(p, s);
    }
    int t = n_skip + 1;
    for (; t < t_clear; ++t) REPRO_STEP(t, true);
    for (; t < n_kv; ++t) REPRO_STEP(t, false);
    {
      const int last = (n_kv - 1) % S;
      mbar_wait(v_full + 8 * last, ((n_kv - 1) / S) & 1);
      fence_regs<NO>(acc);
      wgmma_fence();
      issue_pv<DVC, BK>(acc, p, v_s + last * L::kVT);
      wgmma_wait<0>();
      fence_regs<NO>(acc);
    }
#undef REPRO_RELEASE
#undef REPRO_PASS_TURN
#undef REPRO_SOFTMAX
#undef REPRO_STEP

    const float inv_a = 1.0f / fmaxf(quad_sum(l_a), 1e-30f);
    const float inv_b = 1.0f / fmaxf(quad_sum(l_b), 1e-30f);
    bf16* o_bh = o + static_cast<long long>(b) * st.ob + h * st.oh;
#pragma unroll
    for (int e = 0; e < NO; e += 2) {
      const bool first = e % 4 < 2;
      const int row = first ? row_a : row_a + 8;
      const int col = 8 * (e / 4) + 2 * (lane % 4);  // even; dv % 8 == 0
      if (row < seq_q && col < dv) {
        const float inv = first ? inv_a : inv_b;
        *reinterpret_cast<uint32_t*>(o_bh + row * st.os + col) =
            pack_bf16(acc[e] * inv, acc[e + 1] * inv);
      }
    }
  }
}

// ------------------------------------------------------------ host side

// cuTensorMapEncodeTiled, found through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The (d, heads, seq, batch) view of a (batch, seq, heads, d) tensor with
// element strides (sb, ss, sh), in boxes of 64 columns x `rows` rows of one
// head and batch.  A dimension of size 1 gets the packed stride, which TMA
// never steps.
bool encode(CUtensorMap* map, const void* ptr, int batch, int seq, int heads,
            int d, long long sb, long long ss, long long sh, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const long long e = sizeof(bf16);
  if (heads == 1) sh = d;
  if (seq == 1) ss = sh * heads;
  if (batch == 1) sb = ss * seq;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh * e),
                                 static_cast<cuuint64_t>(ss * e),
                                 static_cast<cuuint64_t>(sb * e)};
  const cuuint32_t box[4] = {kChunk, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA reads a tensor in place if its base is 16-byte aligned and every
// stride it steps is a positive multiple of 16 bytes (8 bf16 values).
bool stride_ok(int size, long long stride) {
  return size == 1 || (stride > 0 && stride % 8 == 0);
}

bool tma_ok(const void* p, int batch, int seq, int heads, long long sb,
            long long ss, long long sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && stride_ok(batch, sb) &&
         stride_ok(seq, ss) && stride_ok(heads, sh);
}

template <int DC, int DVC, int BK, bool kSoftcap, bool kOffset>
int launch_wgmma(const void* q, const void* k, const void* v, bf16* o,
                 const Strides& st, int batch, int seq_q, int seq_k,
                 int q_offset, int n_heads, int n_kv_heads, int d, int dv,
                 int causal, float scale_a, float scale_b,
                 cudaStream_t stream) {
  constexpr int smem = WgSmem<DC, DVC, BK>::kBytes;
  static bool opted_in = false;  // above 48 KB a kernel must opt in
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<DC, DVC, BK, kSoftcap, kOffset>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode(&tm_q, q, batch, seq_q, n_heads, d, st.qb, st.qs, st.qh,
              kWgBlockQ) ||
      !encode(&tm_k, k, batch, seq_k, n_kv_heads, d, st.kb, st.ks, st.kh,
              BK) ||
      !encode(&tm_v, v, batch, seq_k, n_kv_heads, dv, st.vb, st.vs, st.vh,
              BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_qt = (seq_q + kWgBlockQ - 1) / kWgBlockQ;
  const int n_bh = batch * n_heads;
  flash_wgmma_kernel<DC, DVC, BK, kSoftcap, kOffset>
      <<<n_bh * n_qt, kWgThreads, smem, stream>>>(
          tm_q, tm_k, tm_v, o, st, seq_q, seq_k, q_offset, n_bh,
          heads_per_group(n_qt, n_bh), n_heads, n_heads / n_kv_heads, dv,
          causal, scale_a, scale_b);
  return static_cast<int>(cudaGetLastError());
}

// The instance for the call: softcapped (with the offset read), offset
// only, or neither.
template <int DC, int DVC, int BK>
int dispatch(const void* q, const void* k, const void* v, bf16* o,
             const Strides& st, int batch, int seq_q, int seq_k, int q_offset,
             int n_heads, int n_kv_heads, int d, int dv, int causal,
             float scale_a, float scale_b, bool capped, cudaStream_t stream) {
  if (capped) {
    return launch_wgmma<DC, DVC, BK, true, true>(
        q, k, v, o, st, batch, seq_q, seq_k, q_offset, n_heads, n_kv_heads,
        d, dv, causal, scale_a, scale_b, stream);
  }
  if (q_offset != 0 || seq_k != seq_q) {
    return launch_wgmma<DC, DVC, BK, false, true>(
        q, k, v, o, st, batch, seq_q, seq_k, q_offset, n_heads, n_kv_heads,
        d, dv, causal, scale_a, scale_b, stream);
  }
  return launch_wgmma<DC, DVC, BK, false, false>(
      q, k, v, o, st, batch, seq_q, seq_k, q_offset, n_heads, n_kv_heads, d,
      dv, causal, scale_a, scale_b, stream);
}

}  // namespace

// q: (batch, seq_q, n_heads, d); k: (batch, seq_k, n_kv_heads, d); v:
// (batch, seq_k, n_kv_heads, dv); o: (batch, seq_q, n_heads, dv), dv <=
// d; strides: 12 element strides (batch, seq, head) of q, k, v, o; query
// row i at position q_offset + i; softcap > 0 takes the softcapped
// instance; (dc, dvc, bk) the instance <DC, DVC, BK> the caller chose
// (the Python wrapper's `bf16_instance`).  A layout TMA cannot read, a
// negative offset, or an instance that is not built or too narrow for
// d or dv returns cudaErrorInvalidValue (see the header).
extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int batch,
    int seq_q, int seq_k, int n_heads, int n_kv_heads, int d, int dv,
    int dc, int dvc, int bk, const long long* strides, int causal,
    float scale, float softcap, int q_offset, void* stream) {
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  if (batch <= 0 || seq_q <= 0 || seq_k <= 0 || q_offset < 0 || d <= 0 ||
      d > 64 * dc || d % 8 != 0 || dv <= 0 || dv > d || dv > 64 * dvc ||
      dv % 8 != 0 || n_heads <= 0 || n_kv_heads <= 0 ||
      n_heads % n_kv_heads != 0 ||
      static_cast<long long>(batch) * n_heads *
              ((seq_q + kWgBlockQ - 1) / kWgBlockQ) > 2147483647LL ||
      static_cast<long long>(q_offset) + seq_q + kWgBlockQ > 2147483647LL ||
      reinterpret_cast<uintptr_t>(o) % 4 != 0 || st.os % 2 != 0 ||
      st.ob % 2 != 0 || st.oh % 2 != 0 ||
      !tma_ok(q, batch, seq_q, n_heads, st.qb, st.qs, st.qh) ||
      !tma_ok(k, batch, seq_k, n_kv_heads, st.kb, st.ks, st.kh) ||
      !tma_ok(v, batch, seq_k, n_kv_heads, st.vb, st.vs, st.vh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool capped = softcap > 0.0f;
  // log2-unit factors of `softmax_tile`
  const float scale_a =
      capped ? 2.0f * kLog2e * scale / softcap : scale * kLog2e;
  const float scale_b = capped ? softcap * kLog2e : 0.0f;
  bf16* ob = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the instances built (see the header); TMA zero-fills the columns past
  // d and dv, so a narrower v is read in place by each of them
#define REPRO_FLASH_WG(DC, DVC, BK)                                        \
  if (dc == DC && dvc == DVC && bk == BK) {                                \
    return dispatch<DC, DVC, BK>(q, k, v, ob, st, batch, seq_q, seq_k,     \
                                 q_offset, n_heads, n_kv_heads, d, dv,     \
                                 causal, scale_a, scale_b, capped, s);     \
  }
  REPRO_FLASH_WG(1, 1, 128)
  REPRO_FLASH_WG(2, 2, 128)
  REPRO_FLASH_WG(3, 2, 128)
  REPRO_FLASH_WG(3, 3, 96)
  REPRO_FLASH_WG(4, 4, 64)
#undef REPRO_FLASH_WG
  return static_cast<int>(cudaErrorInvalidValue);
}

