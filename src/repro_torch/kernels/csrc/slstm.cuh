// Helpers of the sLSTM scans (slstm_scan.cu and slstm_scan_bwd.cu), both one
// thread-block cluster per head: cluster barriers, distributed shared memory
// addresses, mbarriers with transaction counts, st.async into a peer's
// shared memory, bf16 unpacking and the cell's log_sigmoid.
#pragma once

#include <cstdint>

#include "common.cuh"

__device__ __forceinline__ float log_sigmoid(float x) {
    return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the same shared-memory address in block `rank` of the cluster
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_addr(p)),
                 "r"(rank));
    return remote;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// Both of a block's mbarriers initialised and made visible to the cluster
// (thread 0; a cluster barrier must follow before any peer stores).
__device__ __forceinline__ void mbar_init_pair(uint64_t* bars) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// this block's one arrival of the phase, expecting `bytes` from the cluster
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    return done != 0;
}

// Wait until the phase of the given parity has completed. A step whose bytes
// never all arrive traps after some seconds instead of spinning forever.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    for (long long n = 0; !mbar_try_wait(bar, parity); ++n)
        if (n > (1LL << 28)) __trap();
}

// float4 to the cluster shared-memory address `addr` (a peer's, from
// peer_addr); its arrival counts 16 bytes on the mbarrier at cluster address `bar`
__device__ __forceinline__ void store_remote(uint32_t addr, float4 v, uint32_t bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
        "[%5];" ::"r"(addr),
        "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
        : "memory");
}

// float4 into block `rank`'s shared memory at this block's address `p`;
// its arrival counts 16 bytes on that block's mbarrier at this block's `bar`
__device__ __forceinline__ void store_peer(const float* p, uint32_t rank, float4 v,
                                           uint64_t* bar) {
    store_remote(peer_addr(p, rank), v, peer_addr(bar, rank));
}

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// 8 bf16 values packed in 16 bytes, exactly as fp32
__device__ __forceinline__ void unpack8(const uint4 u, float (&v)[8]) {
    v[0] = bf16_lo(u.x), v[1] = bf16_hi(u.x), v[2] = bf16_lo(u.y), v[3] = bf16_hi(u.y);
    v[4] = bf16_lo(u.z), v[5] = bf16_hi(u.z), v[6] = bf16_lo(u.w), v[7] = bf16_hi(u.w);
}

// two adjacent values of R in device memory, exactly as fp32
__device__ __forceinline__ float2 load2_global(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2_global(const __nv_bfloat16* p) {
    const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p));
    return make_float2(bf16_lo(u), bf16_hi(u));
}
