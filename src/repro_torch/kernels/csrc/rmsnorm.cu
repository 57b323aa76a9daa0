// Fused RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * g, fp32 inside,
// written back in the input's type.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (wrapper `rmsnorm`, pallas_call at rmsnorm.py:35). The TPU kernel tiles 256
// rows into VMEM and reduces each row there; on the serving path the port
// calls this kernel for ln1, q_norm, k_norm, ln2 and final_norm.
//
// What bounds it on the H100: bytes. It does ~4 flops per element against
// 4 bytes moved (bf16 in and out), far below the ~295 flops/byte where the
// card stops being limited by its 3.35 TB/s of memory.
//
// Design: one warp per row and 8 rows per block. Rows on the path are short
// (d = 128 for q_norm/k_norm, 1024 for the residual norms), so one warp holds
// a whole row and the sum of squares needs only a warp-shuffle reduction: no
// shared-memory stage and no block-wide barrier. The second pass re-reads the
// row, which is still in L1. Loads are scalar and coalesced across the warp;
// vector loads are left for a later change.

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // one warp each

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ y,
               long long rows, int d, float eps) {
    const int lane = threadIdx.x & 31;
    const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
    if (row >= rows) return;  // the whole warp leaves together
    const T* xr = x + row * d;
    T* yr = y + row * d;

    float ss = 0.f;
    for (int i = lane; i < d; i += 32) {
        const float v = to_float(xr[i]);
        ss = fmaf(v, v, ss);
    }
    ss = warp_sum(ss);
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
    for (int i = lane; i < d; i += 32) {
        yr[i] = from_float<T>(to_float(xr[i]) * inv * to_float(g[i]));
    }
}

template <typename T>
void launch(const void* x, const void* g, void* y, long long rows, int d, float eps,
            cudaStream_t stream) {
    const unsigned blocks = static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
    rmsnorm_kernel<T><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(y), rows, d, eps);
}

}  // namespace

// x, y: [rows, d] contiguous; g: [d]; all of one dtype (ReproDtype).
extern "C" int rmsnorm_fwd(const void* x, const void* g, void* y, int dtype,
                           long long rows, int d, float eps, void* stream) {
    if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == REPRO_F32) {
        launch<float>(x, g, y, rows, d, eps, s);
    } else if (dtype == REPRO_BF16) {
        launch<__nv_bfloat16>(x, g, y, rows, d, eps, s);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
