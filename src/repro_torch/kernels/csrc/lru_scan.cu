// Linear-recurrence scan h_t = a_t * h_{t-1} + b_t, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lru_scan.py::lru_scan
// (_scan_kernel): over (B, S, C) tensors, from h_{-1} = 0, with an fp32
// carry per (batch, channel) and fp32 output.  The Mamba-1 mixer calls it
// with the (d_inner, n_state) plane flattened into C channels.
//
// Design.  The TPU kernel blocks the sequence and carries h in VMEM
// scratch across a sequential grid axis.  Hopper has no sequential grid
// axis and needs none here: the recurrence is independent per channel, so
// one thread owns one (batch, channel) and walks t = 0..S-1 itself,
// keeping h in a register (h = fmaf(a, h, b), one store a step).
//   - Threads of a warp take consecutive channels, so every load and
//     store of a time step is one coalesced 128-byte line per warp.
//   - The loads of a and b do not depend on h: kUnroll steps of both are
//     loaded into registers before the chain of FMAs over them runs, so
//     each thread keeps 2 * kUnroll loads in flight.
//   - Grid: ceil(C / 256) x B blocks of 256 threads.
//   - Offsets are 64-bit: B * S * C passes 2^31 bytes at the Mamba
//     serving shape (4, 2048, 131072).
// Inputs are fp32 or bf16 (read as bf16, computed in fp32); output fp32.
//
// Bound.  Two flops per element against 3 elements moved (a and b read,
// h written): bound by bytes.  At (4, 2048, 131072) fp32 that is 12.9 GB,
// 3.85 ms at 3.35 TB/s.
//
// Interface.  Plain C entry points for ctypes: device pointers and the
// CUDA stream arrive as void*, sizes as int64.  Each returns the result of
// cudaGetLastError() after its launch (0 = success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    float* __restrict__ h, int64_t seq, int64_t channels) {
  const int64_t c =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= channels) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * seq * channels + c;
  a += base;
  b += base;
  h += base;
  float carry = 0.0f;
  int64_t t = 0;
  for (; t + kUnroll <= seq; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t off = (t + u) * channels;
      av[u] = to_float(a[off]);
      bv[u] = to_float(b[off]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      carry = fmaf(av[u], carry, bv[u]);
      h[(t + u) * channels] = carry;
    }
  }
  for (; t < seq; ++t) {
    const int64_t off = t * channels;
    carry = fmaf(to_float(a[off]), carry, to_float(b[off]));
    h[off] = carry;
  }
}

template <typename T>
int launch(const void* a, const void* b, void* h, int64_t batch,
           int64_t seq, int64_t channels, void* stream) {
  const dim3 grid(static_cast<unsigned>((channels + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  lru_scan_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float*>(h), seq, channels);
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
