// Fused RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * g, fp32 inside,
// written back in the input's type (fp32 or bf16).
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (wrapper `rmsnorm`, pallas_call at rmsnorm.py:35). The TPU kernel tiles 256
// rows into VMEM and reduces each row there; on the serving path the port
// calls this kernel for ln1, q_norm, k_norm, ln2 and final_norm.
//
// What bounds it on the H100: at 16000 rows, bytes (~4 flops per element
// against 4 bytes moved in bf16, far below the card's ~295 flops/byte), so x
// is read once and y written once. At the 4-row decode shapes it is latency:
// a few kilobytes, one dependent load, reduce and store, and the yardstick
// there is F.rms_norm of the same call, not the bytes bound.
//
// Design: a group of G threads (a power of two up to 256) owns a row and
// holds it in registers, NV = 2 units of VEC elements per thread, between the
// sum of squares and the scaled write. The wrapper picks VEC, G and whether
// the row is held from the row's width and alignment (kernels/rmsnorm.py
// `plan`):
// - VEC = 16 bytes (8 bf16 or 4 fp32) where x, g and y are 16-byte aligned
//   and d is a multiple of it; one element otherwise (a tail such as d = 100,
//   or a view at an offset such as x[1:] of a [rows, 100] bf16 tensor). It is
//   a path of the same kernel, not a fallback.
// - G covers the row with two units per thread, up to 256 threads: 8 threads
//   at d = 128 bf16 (q_norm/k_norm, several rows per warp, reduced by
//   shuffles over the group), 128 at d = 2048 (reduced by shuffles, then one
//   shared-memory step across the group's warps). So a 4 x 2048 decode call
//   has 4 x 128 threads in flight, not 4 x 32. Two 16-byte loads in flight
//   per thread, not one, is what lifts 16000 x 2048 to ~83% of the bytes
//   bound on the H100 (PERF.md section 6).
// - A row wider than 2 units at G = 256 (d > 4096 bf16 with vector loads,
//   d > 512 with scalar ones) is streamed and read twice.
// Blocks of 256 threads walk rows with a grid stride, so each thread loads
// its slice of the gain once and reuses it for every row it normalises, and
// loads its slice of the next row before it reduces the current one.

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NT = 256;                  // threads per block
constexpr int NV = 2;                    // units per thread of a held row

// VEC elements as loaded: one 16-byte word, or one element.
template <typename T, int VEC>
using Raw = std::conditional_t<VEC == 1, T, uint4>;

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Raw<T, VEC>& raw, float (&out)[VEC]) {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_float(e[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> pack(const float (&in)[VEC]) {
    Raw<T, VEC> raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_float<T>(in[i]);
    return raw;
}

// Sum over the G threads of a row: shuffles, then (G > 32) shared memory.
__device__ __forceinline__ float group_sum(float v, int group, float* red) {
    if (group <= 32) {
        for (int off = group >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        return v;
    }
    v = warp_sum(v);
    const int warp = threadIdx.x >> 5, per_row = group >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    const int first = warp / per_row * per_row;
    float total = 0.f;
    for (int w = 0; w < per_row; ++w) total += red[first + w];
    return total;
}

template <typename T, int VEC, bool HELD>
__global__ void __launch_bounds__(NT)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ y,
               long long rows, int d, float eps, int group) {
    using R = Raw<T, VEC>;
    __shared__ float red[2][NT / 32];    // by row-loop parity: one barrier per row
    const R* xu = reinterpret_cast<const R*>(x);
    const R* gu = reinterpret_cast<const R*>(g);
    R* yu = reinterpret_cast<R*>(y);
    const int units = d / VEC;           // per row
    const int lane = threadIdx.x % group;
    const int rows_per_block = NT / group;
    const long long step = static_cast<long long>(gridDim.x) * rows_per_block;
    long long row = static_cast<long long>(blockIdx.x) * rows_per_block + threadIdx.x / group;
    int parity = 0;

    if constexpr (HELD) {
        // This thread's units of the gain, and of the row it works on; the
        // next row's units are loaded before this row is reduced, so each
        // thread keeps two rows' loads in flight.
        R gv[NV], cur[NV], nxt[NV];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
            const int u = lane + j * group;
            if (u < units) gv[j] = gu[u];
            if (u < units && row < rows) cur[j] = xu[row * units + u];
        }
        // The loop's trip count is the same for every thread of the block.
        for (long long base = row - threadIdx.x / group; base < rows;
             base += step, row += step, parity ^= 1) {
#pragma unroll
            for (int j = 0; j < NV; ++j) {
                const int u = lane + j * group;
                if (u < units && row + step < rows) nxt[j] = xu[(row + step) * units + u];
            }
            float ss = 0.f;
#pragma unroll
            for (int j = 0; j < NV; ++j) {
                if (lane + j * group < units && row < rows) {
                    float v[VEC];
                    unpack<T, VEC>(cur[j], v);
#pragma unroll
                    for (int i = 0; i < VEC; ++i) ss = fmaf(v[i], v[i], ss);
                }
            }
            const float inv = rsqrtf(group_sum(ss, group, red[parity]) / d + eps);
#pragma unroll
            for (int j = 0; j < NV; ++j) {
                const int u = lane + j * group;
                if (u < units && row < rows) {
                    float v[VEC], w[VEC];
                    unpack<T, VEC>(cur[j], v);
                    unpack<T, VEC>(gv[j], w);
#pragma unroll
                    for (int i = 0; i < VEC; ++i) v[i] = v[i] * inv * w[i];
                    yu[row * units + u] = pack<T, VEC>(v);
                }
                cur[j] = nxt[j];
            }
        }
    } else {                             // a row too wide for registers: read twice
        for (long long base = row - threadIdx.x / group; base < rows;
             base += step, row += step, parity ^= 1) {
            float ss = 0.f, v[VEC], w[VEC];
            for (int u = lane; row < rows && u < units; u += group) {
                unpack<T, VEC>(xu[row * units + u], v);
#pragma unroll
                for (int i = 0; i < VEC; ++i) ss = fmaf(v[i], v[i], ss);
            }
            const float inv = rsqrtf(group_sum(ss, group, red[parity]) / d + eps);
            for (int u = lane; row < rows && u < units; u += group) {
                unpack<T, VEC>(xu[row * units + u], v);
                unpack<T, VEC>(gu[u], w);
#pragma unroll
                for (int i = 0; i < VEC; ++i) v[i] = v[i] * inv * w[i];
                yu[row * units + u] = pack<T, VEC>(v);
            }
        }
    }
}

template <typename T, int VEC>
int launch_vec(const void* x, const void* g, void* y, long long rows, int d, float eps,
               int group, bool held, unsigned blocks, cudaStream_t s) {
    auto args = [&](auto kernel) {
        kernel<<<blocks, NT, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(g),
                                     static_cast<T*>(y), rows, d, eps, group);
        return 0;
    };
    return held ? args(rmsnorm_kernel<T, VEC, true>) : args(rmsnorm_kernel<T, VEC, false>);
}

template <typename T>
int launch(const void* x, const void* g, void* y, long long rows, int d, float eps, int vec,
           int group, bool held, int sms, cudaStream_t s) {
    // At most as many blocks as are resident at once (8 of 256 threads fill
    // an SM), and as few as give every block the same number of row groups,
    // so no last partial round of rows runs on a few blocks alone.
    const long long rows_per_block = NT / group;
    const long long groups = (rows + rows_per_block - 1) / rows_per_block;
    const long long rounds = (groups + 8LL * sms - 1) / (8LL * sms);
    const unsigned blocks = static_cast<unsigned>((groups + rounds - 1) / rounds);
    if (vec == 1) return launch_vec<T, 1>(x, g, y, rows, d, eps, group, held, blocks, s);
    if (vec == 16 / static_cast<int>(sizeof(T)) && d % vec == 0)
        return launch_vec<T, 16 / sizeof(T)>(x, g, y, rows, d, eps, group, held, blocks, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, y: [rows, d] contiguous; g: [d]; all of one dtype (ReproDtype). vec,
// group and held as chosen by kernels/rmsnorm.py `plan`; sms: the device's
// multiprocessor count.
extern "C" int rmsnorm_fwd(const void* x, const void* g, void* y, int dtype, long long rows,
                           int d, float eps, int vec, int group, int held, int sms,
                           void* stream) {
    if (rows <= 0 || d <= 0 || group <= 0 || group > NT || (group & (group - 1)) != 0
        || sms <= 0 || (held && static_cast<long long>(group) * NV * vec < d))
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    int err;
    if (dtype == REPRO_F32) {
        err = launch<float>(x, g, y, rows, d, eps, vec, group, held != 0, sms, s);
    } else if (dtype == REPRO_BF16) {
        err = launch<__nv_bfloat16>(x, g, y, rows, d, eps, vec, group, held != 0, sms, s);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return err != 0 ? err : static_cast<int>(cudaGetLastError());
}
