// RMSNorm backward in bf16 for Hopper: with r = rsqrt(mean(x^2) + eps) per
// row,
//   dx = r * (g * dy) - x * r^3 * mean((g * dy) * x)
//   dg = sum over rows of dy * x * r
// in fp32 from bf16 x, g and dy, dx and dg written back in bf16: the
// arithmetic of JAX's autodiff through repro/models/common.py:51-55 (cast to
// fp32, compute, cast back), up to the order of the sums. dg is summed in
// fp32 in a fixed order and rounded to bf16 once. The fp32 backward is
// rmsnorm_bwd.cu.
//
// The Pallas TPU kernel repro/kernels/rmsnorm.py::_rmsnorm_kernel (pallas_call
// at rmsnorm.py:35) has no VJP: the JAX package trains through its jnp norm.
// This is the backward of the port's forward (rmsnorm.cu) for the trainer's
// norms (ln1, ln2, q_norm, k_norm, final_norm).
//
// What bounds it on the H100: bytes. x and dy are read and dx written, 6
// bytes an element against ~10 flops, far below the card's ~295 flops/byte.
// So each row is read from device memory once, and the dg sums stay on chip.
//
// Design (the 16-byte path, `rmsnorm_bwd_sm90_rows_kernel`): one wave of
// clusters of CLUSTER blocks, one block per SM (each block asks for
// SMEM_MAX bytes of shared memory, so no two share an SM, and the wrapper
// launches no more clusters than the card holds at once); block b owns the
// band of rows [b * rows_per_block, (b + 1) * rows_per_block). A group of G
// threads (a power of two, 8 to 256) owns a row, 16 bytes (8 elements) a
// unit, at most U = 4 units a thread; the block's NT / G row slots take
// NT / G rows a pass. A thread holds its units of its slot's row of x and
// dy in registers (16-byte loads through the read-only path) and loads
// those of the next pass's row before it reduces this one, so the next rows
// are in flight while these are reduced; the row's sums and dx come from
// the registers, and each row is read from device memory once. (A ring of
// shared-memory stages filled by 1-D bulk asynchronous copies measured
// slower at the trainer's shapes.)
//
// dg in a fixed order, one owner per sum. A thread owns the same columns in
// every row it touches and sums dy * x * r for them in fp32 registers over
// its slot's rows (band rows slot, slot + NT / G, ... in order). At the end
// the slots of a warp (G < 32) are added by a butterfly of shuffles (xor G,
// 2G, ...), and the block's warp rows (or, G >= 32, slot rows) in order in
// shared memory, into one fp32 row. Block `rank` of the cluster owns the
// rank-th slice of the columns: every block sends its row's slices to their
// owners by asynchronous stores into the owners' shared memory (st.async,
// distributed shared memory), which complete on the owner's mbarrier, and
// the owner adds the CLUSTER slices in rank order and writes the cluster's
// row to `partial` [clusters, d]; no barrier across the cluster waits for
// the block's global stores. A second small kernel adds the clusters' rows
// (8 warps of a block each taking every 8th row of 32 columns, then the
// warps in order) and rounds once. One owner per output, so two calls give
// the same bits.
//
// Why clusters of 2: an H100 holds 15 clusters of 8 (or 30 of 4) at one
// block an SM, 120 of its 132 SMs, but 66 of 2, every SM; measured at the
// trainer's shapes, the main loop on 132 SMs gains more (~1 us) than the
// 8-block exchange saves in the second kernel.
//
// The scalar path (`rmsnorm_bwd_sm90_scalar_kernel`) takes views off 16-byte
// alignment, d not a multiple of 8 and rows wider than the 16-byte path
// holds (d > 8192): the same bands and slots, with loads of one element
// straight from device memory, a second pass over the row for dx (its loads
// hit L1), each slot's dg sums in its own row of shared memory (a column has
// one owner thread, so no two threads add to one word), the slots added in
// order; each block then reads its slice of its peers' rows (distributed
// shared memory) between two cluster barriers, in rank order.

#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;              // threads per block
constexpr int CLUSTER = 2;           // blocks per cluster
constexpr int MAX_CLUSTERS = 128;    // clusters a launch takes at most
constexpr int VEC = 8;               // bf16 elements in 16 bytes
constexpr int MAX_UNITS = 4;         // 16-byte units a thread holds (16-byte path)
constexpr int SMEM_MAX = 232448 - 512;   // dynamic shared memory of a block

struct Band {
    long long rows;            // of the whole tensor
    long long rows_per_block;  // this block's band: [b * rows_per_block, ...)
    int d;
    float eps;
    int group;                 // threads per row
};

// Columns of dg each block of a cluster owns.
__host__ __device__ constexpr int share_of(int d) { return (d + CLUSTER - 1) / CLUSTER; }

// Rows of dg sums a block of the 16-byte path adds at its end: one a warp
// (G < 32, the warp's slots added first) or one a slot.
__host__ __device__ constexpr int row_count(int group) { return group < 32 ? NT / 32 : NT / group; }

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The shared::cluster address of `p` in block `rank`'s shared memory.
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_u32(p)),
                 "r"(rank));
    return remote;
}

// `v` into block `rank`'s shared memory at this block's address `p`; its
// arrival counts 4 bytes on that block's mbarrier at this block's `bar`.
__device__ __forceinline__ void store_peer(const float* p, uint32_t rank, float v,
                                           const uint64_t* bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
        :: "r"(peer_addr(p, rank)), "r"(__float_as_uint(v)), "r"(peer_addr(bar, rank))
        : "memory");
}

// Wait for the phase of the given parity of an mbarrier that the cluster's
// asynchronous stores complete; traps after some seconds instead of hanging.
__device__ __forceinline__ void mbar_wait_cluster(const uint64_t* bar, int parity) {
    for (long long n = 0;; ++n) {
        uint32_t done;
        asm volatile(
            "{\n.reg .pred P1;\n"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%1], %2;\n"
            "selp.u32 %0, 1, 0, P1;\n}\n"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
        if (done) return;
        if (n > (1LL << 28)) __trap();
    }
}

// 16 bytes of a row read once, through the read-only path.
__device__ __forceinline__ uint4 ld_stream(const bf16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack(const uint4 w, float (&f)[VEC]) {
    const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        f[2 * j] = __uint_as_float(v[j] << 16);
        f[2 * j + 1] = __uint_as_float(v[j] & 0xffff0000u);
    }
}

__device__ __forceinline__ uint4 pack(const float (&f)[VEC]) {
    return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                      pack_bf16(f[6], f[7]));
}

// Sums of a and b over the G threads of a row: shuffles, then (G > 32) one
// shared-memory step across the group's warps. Every thread of the block
// calls it the same number of times.
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

// The cluster's exchange buffers: `recv` [CLUSTER][share_of(d)] floats at
// the end of the dynamic shared memory, and the mbarrier its stores
// complete. Thread 0 calls it after the block's barrier init is fenced and
// before the block's cluster_arrive, expecting every peer's slice.
__device__ __forceinline__ void expect_slices(uint64_t* recv_bar, int d) {
    const int owned = max(0, min(share_of(d), d - static_cast<int>(cluster_rank()) * share_of(d)));
    mbar_expect_tx(smem_u32(recv_bar), static_cast<uint32_t>(CLUSTER * owned * 4));
}

// `row`: this block's dg sums (d floats in shared memory, complete for every
// thread). Sends each slice to its owner, then adds the slices this block
// owns in rank order and writes them to partial[cluster][:]. Every thread
// calls it, after its cluster_arrive.
__device__ __forceinline__ void exchange_dg(const float* row, float* recv, uint64_t* recv_bar,
                                            float* __restrict__ partial, int d) {
    const int share = share_of(d);
    const uint32_t rank = cluster_rank();
    cluster_wait();  // every peer's recv_bar is initialised
    for (int col = threadIdx.x; col < d; col += NT) {
        const int owner = col / share;
        store_peer(recv + rank * share + (col - owner * share), owner, row[col], recv_bar);
    }
    mbar_wait_cluster(recv_bar, 0);
    const int base = static_cast<int>(rank) * share;
    const int owned = max(0, min(share, d - base));
    float* out = partial + static_cast<long long>(blockIdx.x / CLUSTER) * d + base;
    for (int j = threadIdx.x; j < owned; j += NT) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < CLUSTER; ++k) s += recv[k * share + j];
        out[j] = s;
    }
}

// The scalar path's exchange: the owner reads its slice of every peer's row
// (distributed shared memory) between two cluster barriers, so the row
// needs no buffer beside it and d may be as wide as shared memory holds.
__device__ __forceinline__ void gather_dg(const float* row, float* __restrict__ partial, int d) {
    cluster_arrive();  // every block's row in place
    cluster_wait();
    const int share = share_of(d), base = static_cast<int>(cluster_rank()) * share;
    const int owned = max(0, min(share, d - base));
    float* out = partial + static_cast<long long>(blockIdx.x / CLUSTER) * d + base;
    for (int j = threadIdx.x; j < owned; j += NT) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < CLUSTER; ++k) {
            float v;
            asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v)
                         : "r"(peer_addr(row + base + j, k)) : "memory");
            s += v;
        }
        out[j] = s;
    }
    cluster_arrive();  // no block leaves while a peer may still read its row
    cluster_wait();
}

template <int U>
__global__ void __launch_bounds__(NT, 1)
rmsnorm_bwd_sm90_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                             const bf16* __restrict__ dy, bf16* __restrict__ dx,
                             float* __restrict__ partial, Band p) {
    extern __shared__ __align__(128) float smem[];  // [row_count(G)][d] rows, then recv
    __shared__ __align__(8) uint64_t recv_bar;
    __shared__ float red[2][2][NT / 32];  // by pass parity: one barrier per pass (G > 32)

    const int d = p.d, units = d / VEC, G = p.group, n_slots = NT / G;
    const int slot = threadIdx.x / G, lane = threadIdx.x % G;
    const long long r0 = min(p.rows, blockIdx.x * p.rows_per_block);
    const long long band = min(p.rows, r0 + p.rows_per_block) - r0;
    float* recv = smem + row_count(G) * d;

    if (threadIdx.x == 0) {
        mbar_init(smem_u32(&recv_bar), 1);
        mbar_fence_init();
        expect_slices(&recv_bar, d);
    }
    cluster_arrive();

    // band row rr of x and dy, this thread's units, into xn and dn (zeros
    // past the band): the next pass's row is in flight while this one is
    // reduced
    uint4 xn[U], dn[U];
    auto fetch = [&](long long rr) {
#pragma unroll
        for (int k = 0; k < U; ++k) {
            const int u = lane + k * G;
            if (rr < band && u < units) {
                xn[k] = ld_stream(x + (r0 + rr) * d + u * VEC);
                dn[k] = ld_stream(dy + (r0 + rr) * d + u * VEC);
            } else {
                xn[k] = make_uint4(0, 0, 0, 0);
                dn[k] = make_uint4(0, 0, 0, 0);
            }
        }
    };
    fetch(slot);

    float gv[U][VEC], acc[U][VEC];
#pragma unroll
    for (int k = 0; k < U; ++k) {
        const int u = lane + k * G;
        if (u < units) {
            unpack(reinterpret_cast<const uint4*>(g)[u], gv[k]);
        } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) gv[k][i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[k][i] = 0.f;
    }

    int parity = 0;
    // the trip count is the same for every thread of the block
    for (long long base = 0; base < band; base += n_slots, parity ^= 1) {
        const long long rr = base + slot;
        const bool live = rr < band;
        uint4 xw[U], dw[U];
#pragma unroll
        for (int k = 0; k < U; ++k) {
            xw[k] = xn[k];
            dw[k] = dn[k];
        }
        fetch(rr + n_slots);
        float ss = 0.f, sgx = 0.f;
#pragma unroll
        for (int k = 0; k < U; ++k) {
            float xf[VEC], df[VEC];
            unpack(xw[k], xf);
            unpack(dw[k], df);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
                ss = fmaf(xf[e], xf[e], ss);
                sgx = fmaf(gv[k][e] * df[e], xf[e], sgx);
            }
        }
        group_sum2(ss, sgx, G, red[parity]);
        if (!live) continue;
        const float r = rsqrtf(ss / d + p.eps);
        const float c = r * r * r * (sgx / d);
        bf16* out = dx + (r0 + rr) * d;
#pragma unroll
        for (int k = 0; k < U; ++k) {
            const int u = lane + k * G;
            if (u < units) {
                float xf[VEC], df[VEC], o[VEC];
                unpack(xw[k], xf);
                unpack(dw[k], df);
#pragma unroll
                for (int e = 0; e < VEC; ++e) {
                    o[e] = r * (gv[k][e] * df[e]) - xf[e] * c;
                    acc[k][e] += df[e] * xf[e] * r;
                }
                reinterpret_cast<uint4*>(out)[u] = pack(o);
            }
        }
    }

    // The slots of a warp (G < 32) by a butterfly: every lane ends with the
    // warp's sums for its columns.
    for (int off = G; off < 32; off <<= 1) {
#pragma unroll
        for (int k = 0; k < U; ++k)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[k][e] += __shfl_xor_sync(0xffffffffu, acc[k][e], off);
    }
    // The rows of the warps (G < 32) or slots (G >= 32), added in order
    // into rows[0].
    float* rows = smem;
    const int n_rows = row_count(G);
    const int row = G < 32 ? static_cast<int>(threadIdx.x >> 5) : slot;
    if (G >= 32 || (threadIdx.x & 31) < G) {
#pragma unroll
        for (int k = 0; k < U; ++k) {
            const int u = lane + k * G;
            if (u < units) {
                float4* dst = reinterpret_cast<float4*>(rows + row * d + u * VEC);
                dst[0] = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
                dst[1] = make_float4(acc[k][4], acc[k][5], acc[k][6], acc[k][7]);
            }
        }
    }
    __syncthreads();
    for (int col = threadIdx.x; col < d; col += NT) {
        float v[NT / 32];
#pragma unroll
        for (int k = 0; k < NT / 32; ++k) v[k] = k < n_rows ? rows[k * d + col] : 0.f;
        float s = v[0];
#pragma unroll
        for (int k = 1; k < NT / 32; ++k)
            if (k < n_rows) s += v[k];
        rows[col] = s;  // only this thread reads column col
    }
    __syncthreads();
    exchange_dg(rows, recv, &recv_bar, partial, d);
}

__global__ void __launch_bounds__(NT, 1)
rmsnorm_bwd_sm90_scalar_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                               const bf16* __restrict__ dy, bf16* __restrict__ dx,
                               float* __restrict__ partial, Band p) {
    extern __shared__ __align__(128) float dg_slots[];  // [NT / G][d]
    __shared__ float red[2][2][NT / 32];

    const int d = p.d, G = p.group, n_slots = NT / G;
    const int slot = threadIdx.x / G, lane = threadIdx.x % G;
    const long long r0 = min(p.rows, blockIdx.x * p.rows_per_block);
    const long long r1 = min(p.rows, r0 + p.rows_per_block);
    float* my_dg = dg_slots + slot * d;
    for (int i = threadIdx.x; i < n_slots * d; i += NT) dg_slots[i] = 0.f;
    __syncthreads();

    int parity = 0;
    // the trip count is the same for every thread of the block
    for (long long base = r0; base < r1; base += n_slots, parity ^= 1) {
        const long long row = base + slot;
        const bool live = row < r1;
        const bf16* xr = x + row * d;
        const bf16* dyr = dy + row * d;
        float ss = 0.f, sgx = 0.f;
        for (int u = lane; live && u < d; u += G) {
            const float xv = to_float(xr[u]), dv = to_float(dyr[u]), gv = to_float(g[u]);
            ss = fmaf(xv, xv, ss);
            sgx = fmaf(gv * dv, xv, sgx);
        }
        group_sum2(ss, sgx, G, red[parity]);
        const float r = rsqrtf(ss / d + p.eps);
        const float c = r * r * r * (sgx / d);
        for (int u = lane; live && u < d; u += G) {
            const float xv = to_float(xr[u]), dv = to_float(dyr[u]), gv = to_float(g[u]);
            dx[row * d + u] = from_float<bf16>(r * (gv * dv) - xv * c);
            my_dg[u] += dv * xv * r;
        }
    }
    __syncthreads();
    for (int col = threadIdx.x; col < d; col += NT) {
        float s = 0.f;
        for (int k = 0; k < n_slots; ++k) s += dg_slots[k * d + col];
        dg_slots[col] = s;  // only this thread reads column col
    }
    gather_dg(dg_slots, partial, d);
}

// dg[col] = the clusters' rows of partial added in a fixed order, rounded to
// bf16 once: a block of NT threads takes 32 columns; warp w adds rows w,
// w + NT / 32, ... in order (all of its loads in flight together), and the
// warps' sums are added in warp order.
__global__ void __launch_bounds__(NT)
rmsnorm_bwd_sm90_dg_kernel(const float* __restrict__ partial, bf16* __restrict__ dg,
                           int clusters, int d) {
    constexpr int WARPS = NT / 32, PER_WARP = (MAX_CLUSTERS + WARPS - 1) / WARPS;
    __shared__ float sums[WARPS][33];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int col = blockIdx.x * 32 + lane;
    float v[PER_WARP];
#pragma unroll
    for (int k = 0; k < PER_WARP; ++k) {
        const int c = warp + k * WARPS;
        v[k] = c < clusters && col < d ? __ldcg(partial + static_cast<long long>(c) * d + col)
                                       : 0.f;
    }
    float s = v[0];
#pragma unroll
    for (int k = 1; k < PER_WARP; ++k)
        if (warp + k * WARPS < clusters) s += v[k];
    sums[warp][lane] = s;
    __syncthreads();
    if (warp == 0 && col < d) {
        float total = sums[0][lane];
        for (int w = 1; w < min(WARPS, clusters); ++w) total += sums[w][lane];
        dg[col] = from_float<bf16>(total);
    }
}

template <typename Kernel>
cudaLaunchConfig_t rows_config(Kernel kernel, int clusters, cudaStream_t stream,
                               cudaLaunchAttribute* attr, cudaError_t* err) {
    *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = CLUSTER;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(clusters * CLUSTER);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = SMEM_MAX;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// Calls f(kernel) with the kernel of the path (vec, group, d) takes, or
// returns cudaErrorInvalidValue.
template <typename F>
int with_kernel(int vec, int group, int d, F f) {
    if (vec == 1) return f(rmsnorm_bwd_sm90_scalar_kernel);
    const int per_thread = (d / VEC + group - 1) / group;
    if (vec != VEC || d % VEC != 0 || group < 8 || per_thread > MAX_UNITS)
        return static_cast<int>(cudaErrorInvalidValue);
    if (per_thread == 1) return f(rmsnorm_bwd_sm90_rows_kernel<1>);
    if (per_thread == 2) return f(rmsnorm_bwd_sm90_rows_kernel<2>);
    return f(rmsnorm_bwd_sm90_rows_kernel<4>);
}

}  // namespace

// x, dy, dx: [rows, d] bf16, contiguous; g, dg: [d] bf16; partial: fp32
// scratch [clusters, d]. vec (8: the 16-byte path, 1: the scalar path),
// group, clusters and rows_per_block as chosen by kernels/rmsnorm.py
// `bwd_plan`; what they need of shared memory (row_count(group) * d * 4
// bytes and CLUSTER * share_of(d) * 4 on the 16-byte path, NT / group * d *
// 4 on the scalar one) must fit SMEM_MAX.
extern "C" int rmsnorm_bwd_bf16(const void* x, const void* g, const void* dy, void* dx,
                                void* dg, void* partial, long long rows, int d, float eps,
                                int vec, int group, int clusters, long long rows_per_block,
                                void* stream) {
    if (rows <= 0 || d <= 0 || group <= 0 || group > NT || (group & (group - 1)) != 0 ||
        clusters <= 0 || clusters > MAX_CLUSTERS || rows_per_block <= 0 ||
        static_cast<long long>(clusters) * CLUSTER * rows_per_block < rows)
        return static_cast<int>(cudaErrorInvalidValue);
    const int n_slots = NT / group;
    const long long need = vec == VEC ? static_cast<long long>(row_count(group)) * d * 4 +
                                            CLUSTER * share_of(d) * 4
                                      : static_cast<long long>(n_slots) * d * 4;
    if (need > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const Band band{rows, rows_per_block, d, eps, group};
    auto s = static_cast<cudaStream_t>(stream);
    float* part = static_cast<float*>(partial);
    const int code = with_kernel(vec, group, d, [&](auto kernel) {
        cudaLaunchAttribute attr;
        cudaError_t err;
        const cudaLaunchConfig_t cfg = rows_config(kernel, clusters, s, &attr, &err);
        if (err == cudaSuccess)
            err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(x),
                                     static_cast<const bf16*>(g), static_cast<const bf16*>(dy),
                                     static_cast<bf16*>(dx), part, band);
        return static_cast<int>(err);
    });
    if (code != 0) return code;
    rmsnorm_bwd_sm90_dg_kernel<<<(d + 31) / 32, NT, 0, s>>>(part, static_cast<bf16*>(dg),
                                                            clusters, d);
    return static_cast<int>(cudaGetLastError());
}

// How many clusters of the path's kernel the card holds at once, one block
// an SM (cudaOccupancyMaxActiveClusters at SMEM_MAX bytes a block): the
// most `bwd_plan` launches, so that the launch is one wave.
extern "C" int rmsnorm_bwd_bf16_max_clusters(int vec, int group, int d, int* clusters) {
    return with_kernel(vec, group, d, [&](auto kernel) {
        cudaLaunchAttribute attr;
        cudaError_t err;
        const cudaLaunchConfig_t cfg = rows_config(kernel, 1, nullptr, &attr, &err);
        if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
        return static_cast<int>(err);
    });
}
