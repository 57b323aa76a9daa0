// RMSNorm backward for Hopper, fp32: with r = rsqrt(mean(x^2) + eps) per row,
//   dx = r * (g * dy) - x * r^3 * mean((g * dy) * x)
//   dg = sum over rows of dy * x * r
//
// The Pallas TPU kernel repro/kernels/rmsnorm.py::_rmsnorm_kernel (pallas_call
// at rmsnorm.py:35) has no VJP: the JAX package trains through its jnp norm.
// This is the backward of the port's forward (rmsnorm.cu), for the member
// step's fp32 norms (ln1, ln2, q_norm, k_norm, final_norm). The bf16
// backward, the trainer's, is rmsnorm_bwd_sm90.cu.
//
// What bounds it on the H100: bytes. x and dy are read and dx written (~7
// flops per element against 12 bytes), far below the card's ~295
// flops/byte.
//
// Design: the forward's row layout. A group of G threads (a power of two up
// to 256) owns a row, VEC elements per load: 4 (16 bytes) where x, g, dy and
// dx are all 16-byte aligned and d a multiple of 4, else 1 (the wrapper's
// `plan`, the same rule as the forward). A first pass over the row sums x^2
// and (g * dy) * x, the group reduces both at once, and a second pass (its
// loads hit L1) writes dx. Blocks of 256 threads walk rows with a grid
// stride; each row slot of a block adds its rows' dy * x * r into its own
// slice of shared memory, so no two threads add to one word. dg is then
// reduced in a fixed order, without atomics, so it is the same on every run:
// each block sums its slots into one fp32 row of `partial` [blocks, d], and a
// second kernel sums those rows column by column.

#include "common.cuh"

namespace {

constexpr int NT = 256;                  // threads per block
constexpr int DG_SLICES = NT / 32;       // block rows one dg thread column sums

template <int VEC>
struct Unit { float v[VEC]; };

template <int VEC>
__device__ __forceinline__ Unit<VEC> load_unit(const float* p, long long u) {
    Unit<VEC> out;
    if constexpr (VEC == 4) {
        const float4 w = reinterpret_cast<const float4*>(p)[u];
        out.v[0] = w.x; out.v[1] = w.y; out.v[2] = w.z; out.v[3] = w.w;
    } else {
        out.v[0] = p[u];
    }
    return out;
}

template <int VEC>
__device__ __forceinline__ void store_unit(float* p, long long u, const Unit<VEC>& in) {
    if constexpr (VEC == 4) {
        reinterpret_cast<float4*>(p)[u] = make_float4(in.v[0], in.v[1], in.v[2], in.v[3]);
    } else {
        p[u] = in.v[0];
    }
}

// Sums of a and b over the G threads of a row: shuffles, then (G > 32) one
// shared-memory step across the group's warps.
__device__ __forceinline__ void group_sum2(float& a, float& b, int group, float (*red)[NT / 32]) {
    if (group <= 32) {
        for (int off = group >> 1; off > 0; off >>= 1) {
            a += __shfl_xor_sync(0xffffffffu, a, off);
            b += __shfl_xor_sync(0xffffffffu, b, off);
        }
        return;
    }
    a = warp_sum(a);
    b = warp_sum(b);
    const int warp = threadIdx.x >> 5, per_row = group >> 5;
    if ((threadIdx.x & 31) == 0) {
        red[0][warp] = a;
        red[1][warp] = b;
    }
    __syncthreads();
    const int first = warp / per_row * per_row;
    a = 0.f;
    b = 0.f;
    for (int w = 0; w < per_row; ++w) {
        a += red[0][first + w];
        b += red[1][first + w];
    }
}

template <int VEC>
__global__ void __launch_bounds__(NT)
rmsnorm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ dy, float* __restrict__ dx,
                   float* __restrict__ partial, long long rows, int d, float eps, int group) {
    extern __shared__ float dg_slots[];  // [NT / group][d]: this block's sums per row slot
    __shared__ float red[2][2][NT / 32]; // by row-loop parity: one barrier per row
    const int units = d / VEC;
    const int slot = threadIdx.x / group, lane = threadIdx.x % group;
    const int rows_per_block = NT / group;
    const long long step = static_cast<long long>(gridDim.x) * rows_per_block;
    float* my_dg = dg_slots + slot * d;
    for (int i = threadIdx.x; i < rows_per_block * d; i += NT) dg_slots[i] = 0.f;
    __syncthreads();

    int parity = 0;
    long long row = static_cast<long long>(blockIdx.x) * rows_per_block + slot;
    // The loop's trip count is the same for every thread of the block.
    for (long long base = row - slot; base < rows; base += step, row += step, parity ^= 1) {
        const bool live = row < rows;
        const float* xr = x + row * d;
        const float* dyr = dy + row * d;
        float ss = 0.f, sgx = 0.f;
        for (int u = lane; live && u < units; u += group) {
            const Unit<VEC> xv = load_unit<VEC>(xr, u), dv = load_unit<VEC>(dyr, u),
                            gv = load_unit<VEC>(g, u);
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                ss = fmaf(xv.v[i], xv.v[i], ss);
                sgx = fmaf(gv.v[i] * dv.v[i], xv.v[i], sgx);
            }
        }
        group_sum2(ss, sgx, group, red[parity]);
        const float r = rsqrtf(ss / d + eps);
        const float c = r * r * r * (sgx / d);
        for (int u = lane; live && u < units; u += group) {
            const Unit<VEC> xv = load_unit<VEC>(xr, u), dv = load_unit<VEC>(dyr, u),
                            gv = load_unit<VEC>(g, u);
            Unit<VEC> out;
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                out.v[i] = r * (gv.v[i] * dv.v[i]) - xv.v[i] * c;
                my_dg[u * VEC + i] += dv.v[i] * xv.v[i] * r;
            }
            store_unit<VEC>(dx + row * d, u, out);
        }
    }
    __syncthreads();
    for (int col = threadIdx.x; col < d; col += NT) {
        float s = 0.f;
        for (int k = 0; k < rows_per_block; ++k) s += dg_slots[k * d + col];
        partial[static_cast<long long>(blockIdx.x) * d + col] = s;
    }
}

// dg[col] = sum over blocks of partial[block][col], in a fixed order: a
// block of 256 threads takes 32 columns, eight threads per column sum every
// eighth block row, and the eight sums are added in order.
__global__ void __launch_bounds__(NT)
rmsnorm_bwd_dg_kernel(const float* __restrict__ partial, float* __restrict__ dg, int blocks,
                      int d) {
    __shared__ float part[DG_SLICES][33];
    const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
    const int col = blockIdx.x * 32 + lane;
    float s = 0.f;
    if (col < d)
        for (int b = slice; b < blocks; b += DG_SLICES)
            s += partial[static_cast<long long>(b) * d + col];
    part[slice][lane] = s;
    __syncthreads();
    if (slice == 0 && col < d) {
        float total = 0.f;
#pragma unroll
        for (int k = 0; k < DG_SLICES; ++k) total += part[k][lane];
        dg[col] = total;
    }
}

template <int VEC>
int launch(const float* x, const float* g, const float* dy, float* dx, float* dg, float* partial,
           long long rows, int d, float eps, int group, int blocks, cudaStream_t s) {
    const int smem = NT / group * d * static_cast<int>(sizeof(float));
    const cudaError_t err = cudaFuncSetAttribute(
        rmsnorm_bwd_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    rmsnorm_bwd_kernel<VEC><<<blocks, NT, smem, s>>>(x, g, dy, dx, partial, rows, d, eps, group);
    rmsnorm_bwd_dg_kernel<<<(d + 31) / 32, NT, 0, s>>>(partial, dg, blocks, d);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dy, dx: [rows, d] contiguous fp32; g, dg: [d]; partial: fp32 scratch
// [blocks, d]. vec and group as chosen by kernels/rmsnorm.py `plan`, blocks
// by `bwd_blocks`.
extern "C" int rmsnorm_bwd(const void* x, const void* g, const void* dy, void* dx, void* dg,
                           void* partial, long long rows, int d, float eps, int vec, int group,
                           int blocks, void* stream) {
    if (rows <= 0 || d <= 0 || group <= 0 || group > NT || (group & (group - 1)) != 0
        || blocks <= 0 || (vec != 1 && (vec != 4 || d % 4 != 0)))
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    auto c = [](const void* p) { return static_cast<const float*>(p); };
    auto w = [](void* p) { return static_cast<float*>(p); };
    if (vec == 4)
        return launch<4>(c(x), c(g), c(dy), w(dx), w(dg), w(partial), rows, d, eps, group,
                         blocks, s);
    return launch<1>(c(x), c(g), c(dy), w(dx), w(dg), w(partial), rows, d, eps, group, blocks,
                     s);
}
