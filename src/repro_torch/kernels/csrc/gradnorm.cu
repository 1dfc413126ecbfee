// Row-wise sum of squares and the fused last-layer sigma score, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gradnorm.py::rownorm2
// (_rownorm2_kernel) and its caller gradnorm_sigma.  For a linear head
// with cross-entropy loss the per-sample head-gradient norm^2 is
//     sigma_j = (||h_j||^2 + 1) * ||p_j - y_j||^2
// so the score is two row-wise squared norms.
//
// Design.  The TPU kernel walks the feature axis as a sequential grid
// dimension and carries the partial sum in VMEM scratch from one grid
// step to the next.  Hopper blocks run in parallel and in no order, so
// nothing can carry between them: here one warp owns one row and loops
// over its features in-register (lane j reads columns j, j+32, ... so
// a warp's loads are coalesced), then reduces across the warp with
// shuffles.  Eight warps per 256-thread block.  Accumulation is fp32.
//
// Bound.  The work is a few flops per element read, so the kernel is
// bound by bytes: each input element is read once and one float per
// row is written.  The fused entry point reads a row of h and a row of
// p - y and writes sigma directly, where the reference makes two passes
// and a third elementwise combine.
//
// Interface.  Plain C entry points for ctypes: device pointers and the
// CUDA stream arrive as void*, sizes as int.  Each returns the result
// of cudaGetLastError() after its launch (0 = success); a refused
// launch never runs and would otherwise go unnoticed.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// Sum of squares of one row of `cols` floats, returned on every lane.
__device__ __forceinline__ float row_sumsq(const float* __restrict__ row,
                                           int cols, int lane) {
  float acc = 0.0f;
  for (int j = lane; j < cols; j += 32) {
    const float v = row[j];
    acc = fmaf(v, v, acc);
  }
  return warp_sum(acc);
}

__global__ void __launch_bounds__(kThreads)
rownorm2_kernel(const float* __restrict__ x, float* __restrict__ out,
                int rows, int cols) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // warp-uniform: the whole warp leaves
  const float s = row_sumsq(x + static_cast<long long>(row) * cols, cols, lane);
  if (lane == 0) out[row] = s;
}

__global__ void __launch_bounds__(kThreads)
gradnorm_sigma_kernel(const float* __restrict__ h,
                      const float* __restrict__ d,
                      float* __restrict__ out,
                      int rows, int cols_h, int cols_d) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float sh = row_sumsq(h + static_cast<long long>(row) * cols_h, cols_h, lane);
  const float sd = row_sumsq(d + static_cast<long long>(row) * cols_d, cols_d, lane);
  if (lane == 0) out[row] = (sh + 1.0f) * sd;
}

inline int grid_for(int rows) {
  return (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

}  // namespace

extern "C" int repro_rownorm2_f32(const void* x, void* out, int rows,
                                  int cols, void* stream) {
  rownorm2_kernel<<<grid_for(rows), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows, cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_gradnorm_sigma_f32(const void* h, const void* d,
                                        void* out, int rows, int cols_h,
                                        int cols_d, void* stream) {
  gradnorm_sigma_kernel<<<grid_for(rows), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(d),
      static_cast<float*>(out), rows, cols_h, cols_d);
  return static_cast<int>(cudaGetLastError());
}
