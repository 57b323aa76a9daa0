// sLSTM time scan for Hopper: one thread-block cluster per head, h
// exchanged through distributed shared memory, fp32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel repro/kernels/slstm_scan.py::_slstm_kernel
// (wrapper `slstm_scan`, pallas_call at slstm_scan.py:94). Same math, per
// head h, gate-major per head ([i, f, z, o], dh each), fp32 throughout:
//
//     pre  = wx_t + h_{t-1} @ R_h + b_h
//     m_t  = max(log_sigmoid(f) + m, min(i, I_CLAMP))
//     c_t  = exp(log_sigmoid(f) + m - m_t) c + exp(min(i, I_CLAMP) - m_t) tanh(z)
//     n_t  = exp(log_sigmoid(f) + m - m_t) n + exp(min(i, I_CLAMP) - m_t)
//     h_t  = sigmoid(o) c_t / max(n_t, 1)
//
// from c = n = h = 0, m = -1e30 (as the TPU kernel), and beyond it the final
// (c, n, m, h) written out: prefill hands them to decode.
//
// What bounds it on the H100: the per-step chain, not the card's rates.
// A step is 2 * B * 4dh * dh flops per head (8.4 MFLOP at B=1, 4 heads,
// dh=512): 0.29 us even over only 64 SMs at 128 fp32 FMAs per clock each,
// and the next step needs every unit's h of this one. The bound this
// repository states is max(flops / 67 TFLOP/s, bytes / 3.35 TB/s); the
// kernel sits above it by the latency of one step times T. On an H100 SXM
// (clock64 probes in a copy of the kernel) a step at the path shape takes
// ~3300 cycles: ~1700 the dot, ~900 the partial sums and the gate math,
// ~450 waiting for the cluster's h.
//
// The design. The TPU kernel pins a head's R_h [dh, 4dh] in one core's VMEM
// (2 MiB of bf16 at dh=512); an SM has 227 KB of shared memory. So a head
// is one thread-block cluster of G blocks (G = dh / units, at most 16, the
// largest cluster Hopper schedules; units = 32, or 16 where dh is not a
// multiple of 32). Block `rank` of the cluster owns units
// [rank * units, (rank + 1) * units), holds their 4 gate columns of R_h in
// shared memory for the whole scan (dh x 128 bf16 = 128 KiB at dh=512,
// stored unit-major: slice column 4j + q is gate q of unit j) and keeps
// their (c, n, m) in shared memory. Heads never talk to each other, so the
// clusters need not be resident together: no cooperative launch, no
// device-memory scratch.
//
// Per step, per tile of batch rows:
//  - the dot: thread (segment s, column group g) sums rows
//    [s * rows, (s + 1) * rows) of 8 adjacent slice columns, one 16-byte
//    load of R per row and h read as float4 broadcasts, so each value read
//    from shared memory feeds 8 FMAs per batch row. Streaming the whole
//    128 KiB slice through shared memory would take 1024 cycles a step at
//    128 bytes a clock, so for one batch row of a bf16 slice each thread
//    holds the first kRegRows of its rows in registers (254 registers, no
//    spills). A warp's segments combine through shuffles, the warps'
//    partial sums through shared memory, in a fixed order; every product
//    and sum is an fp32 FMA or add, R converted exactly from bf16.
//  - the gates: thread 4j + q adds gate q of unit j; four adjacent lanes
//    then hold a unit's four gates, and lane q = 0 updates its state and
//    writes h to hs.
//  - the exchange: each warp stores the h of its 8 units as two float4
//    into h_s[(t+1) & 1] of every block of the cluster, itself included,
//    with st.async; each store counts its 16 bytes on the receiving block's
//    mbarrier for that buffer, whose phase completes when all B * dh * 4
//    bytes of the step have landed. A block waits on its own mbarrier
//    (acquire) before it reads h_t. No device-memory round trip, no fence,
//    no atomic, no spin.
//  - one cluster barrier (barrier.cluster.arrive.relaxed / wait.acquire)
//    per step guards the buffer reuse. h is double-buffered: in step t a
//    block reads h_s[t & 1] and its peers write h_s[(t+1) & 1]; a block can
//    only write into a peer's h_s[t & 1] in step t+1, after the barrier of
//    step t, which it passes only once that peer has arrived, that is, has
//    finished reading h_s[t & 1] in step t. So one barrier per step is
//    enough. The barrier need not release the h stores (the mbarrier's
//    transaction count delivers them): a release arrive cost ~930 cycles a
//    step on an H100 SXM even with only local stores pending, the relaxed
//    one ~50.
// One cluster barrier before the first step puts every block's zeroed h
// and initialised mbarriers in place before a peer writes to them, and one
// after the last keeps every block alive until no peer can write into its
// shared memory any more.
//
// fp32 R: a dh=512 slice is 256 KiB and does not fit; its first `resident`
// rows (a multiple of a warp's rows, as many as fit) live in shared memory
// and the warps whose rows lie beyond read theirs from device memory (L2)
// every step. That path serves the fp32 checks; it is not tuned.

#include <cstdint>
#include <type_traits>

#include "slstm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4;          // batch rows per pass of the dot when B > 1
constexpr int kRegRows = 16;      // rows of a dot thread's segment in registers
constexpr int kMaxBatch = 16;
constexpr int kMaxCluster = 16;   // non-portable cluster size (8 is portable)
constexpr int kMaxSmem = 232448;  // shared memory a block may use
constexpr int kBarrierBytes = 16; // its static part: two mbarriers
constexpr float kIClamp = 15.f;
constexpr float kMInit = -1e30f;

// One block's work split and shared-memory layout (bytes); the wrapper's
// slstm_plan chooses G, segments and resident rows by the same rules.
struct Layout {
    int G, units, cols, groups, rows, warps, tile, bpad, resident;
    int h_off, part_off, state_off, bytes;
};

// false for a split this kernel cannot run (see slstm_plan for the rules)
bool make_layout(int B, int dh, int G, int segments, int resident, int r_size, Layout* L) {
    if (B < 1 || B > kMaxBatch || dh <= 0 || G < 1 || G > kMaxCluster || dh % G) return false;
    L->G = G;
    L->units = dh / G;
    if (L->units != 16 && L->units != 32) return false;
    L->cols = 4 * L->units;
    L->groups = L->units / 2;  // column groups of 8
    if (segments < 1 || dh % (4 * segments) || segments * L->groups > kThreads ||
        segments * L->groups % 32)
        return false;
    L->rows = dh / segments;
    L->warps = segments * L->groups / 32;
    const int warp_rows = 32 / L->groups * L->rows;
    if (resident < 0 || resident > dh || resident % warp_rows) return false;
    L->resident = resident;
    L->tile = B == 1 ? 1 : kTile;
    L->bpad = (B + L->tile - 1) / L->tile * L->tile;
    long long off = static_cast<long long>(r_size) * resident * L->cols;   // R slice
    L->h_off = static_cast<int>(off);
    off += 4LL * 2 * L->bpad * dh;                                          // h, 2 buffers
    L->part_off = static_cast<int>(off);
    off += 4LL * L->warps * L->tile * L->cols;                              // partial dots
    L->state_off = static_cast<int>(off);
    off += 4LL * 3 * B * L->units;                                          // c, n, m
    L->bytes = static_cast<int>(off);
    return off + kBarrierBytes <= kMaxSmem;
}

// 8 adjacent values of the shared R slice, exactly as fp32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
    unpack8(*reinterpret_cast<const uint4*>(p), v);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ float comp(const float4& v, int x) {
    return x == 0 ? v.x : x == 1 ? v.y : x == 2 ? v.z : v.w;
}

// acc[b][c] += sum over `rows` rows d of h[b][d] * R[d][c], rows in order.
// Shared slice: row d's 8 columns at rp + d * stride. Device memory (fp32
// tail): row d's columns 4j + q are r[d][q * dh + j] for the two units at rp.
template <int NB, bool kShared, typename TR>
__device__ __forceinline__ void dot_rows(const TR* rp, int stride, int dh, const float* hp,
                                         int rows, float (&acc)[NB][8]) {
#pragma unroll 4
    for (int d = 0; d < rows; d += 4) {
        float4 hv[NB];
#pragma unroll
        for (int b = 0; b < NB; ++b) hv[b] = *reinterpret_cast<const float4*>(hp + b * dh + d);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            float rv[8];
            const TR* row = rp + static_cast<long long>(d + x) * stride;
            if constexpr (kShared) {
                load8(row, rv);
            } else {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float2 two = load2_global(row + q * dh);
                    rv[q] = two.x;
                    rv[4 + q] = two.y;
                }
            }
#pragma unroll
            for (int b = 0; b < NB; ++b) {
                const float hx = comp(hv[b], x);
#pragma unroll
                for (int c = 0; c < 8; ++c) acc[b][c] = fmaf(hx, rv[c], acc[b][c]);
            }
        }
    }
}

// The same for one batch row over the kRegRows rows of a bf16 slice held in
// registers (8 columns per uint4).
__device__ __forceinline__ void dot_regs(const uint4 (&rr)[kRegRows], const float* hp,
                                         float (&acc)[1][8]) {
#pragma unroll
    for (int d = 0; d < kRegRows; d += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(hp + d);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            float rv[8];
            unpack8(rr[d + x], rv);
            const float hx = comp(hv, x);
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[0][c] = fmaf(hx, rv[c], acc[0][c]);
        }
    }
}

// TW: type of wx and hs; TR: type of r; NB: batch rows per pass of the dot.
// Grid: nh clusters of L.G blocks, cluster k = head k.
template <typename TW, typename TR, int NB>
__global__ void __launch_bounds__(kThreads, 1)
slstm_scan_kernel(const TW* __restrict__ wx, const TR* __restrict__ r,
                  const float* __restrict__ bias, TW* __restrict__ hs,
                  float* __restrict__ c_out, float* __restrict__ n_out,
                  float* __restrict__ m_out, float* __restrict__ h_out,
                  float* __restrict__ pre_out, float* __restrict__ steps_out, const Layout L,
                  int B, int T_len, int nh, int dh) {
    constexpr int kIters = (NB * 128 + kThreads - 1) / kThreads;  // gate entries per thread
    extern __shared__ __align__(16) unsigned char smem_raw[];
    TR* r_s = reinterpret_cast<TR*>(smem_raw);                         // [resident][cols]
    float* h_s = reinterpret_cast<float*>(smem_raw + L.h_off);        // [2][bpad][dh]
    float* part = reinterpret_cast<float*>(smem_raw + L.part_off);    // [warps][NB][cols]
    float* st = reinterpret_cast<float*>(smem_raw + L.state_off);     // [3][B][units]
    __shared__ uint64_t bars[2];  // bars[k]: h arriving in buffer k (kBarrierBytes)

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int U = L.units, cols = L.cols, G = L.G;
    const int head = blockIdx.x / G;
    const int u0 = static_cast<int>(cluster_rank()) * U;
    const int gd = 4 * dh;
    const TR* r_head = r + static_cast<long long>(head) * dh * gd;

    // the R slice, read in device order (gate q, units j...) 16 bytes at a
    // time, stored unit-major
    constexpr int kVec = 16 / sizeof(TR);
    const int vecs = cols / kVec;
    for (int i = tid; i < L.resident * vecs; i += kThreads) {
        const int d = i / vecs, c = (i - d * vecs) * kVec;
        const int q = c / U, j = c - q * U;
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
            r_head + static_cast<long long>(d) * gd + q * dh + u0 + j));
        const TR* v = reinterpret_cast<const TR*>(&raw);
#pragma unroll
        for (int k = 0; k < kVec; ++k) r_s[d * cols + 4 * (j + k) + q] = v[k];
    }
    for (int i = tid; i < 2 * L.bpad * dh; i += kThreads) h_s[i] = 0.f;
    for (int i = tid; i < B * U; i += kThreads) {
        st[i] = 0.f;
        st[B * U + i] = 0.f;
        st[2 * B * U + i] = kMInit;
    }

    // dot thread: column group g (units 2g, 2g+1), rows [k0, k0 + L.rows)
    const bool dotter = warp < L.warps;
    const int g = tid % L.groups;
    const int k0 = tid / L.groups * L.rows;
    const bool shared_rows = k0 < L.resident;  // the same for a whole warp

    // gate entry e = tid + i * kThreads of a pass: batch row e / cols,
    // slice column e % cols; its bias is the same in every pass
    float bq[kIters];
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
        const int col = (tid + i * kThreads) % cols;
        bq[i] = bias[head * gd + (col & 3) * dh + u0 + (col >> 2)];
    }
    float wq[kIters];  // wx of the pass's gate entries, loaded a pass ahead
    auto load_wx = [&](int t, int b0) {
#pragma unroll
        for (int i = 0; i < kIters; ++i) {
            const int e = tid + i * kThreads, b = b0 + e / cols, col = e % cols;
            wq[i] = 0.f;
            if (e < NB * cols && b < B)
                wq[i] = to_float(wx[((static_cast<long long>(b) * T_len + t) * nh + head) * gd +
                                    (col & 3) * dh + u0 + (col >> 2)]);
        }
    };
    load_wx(0, 0);
    if (tid == 0) mbar_init_pair(bars);
    // every block's R slice, zeroed h, state and barriers in place
    cluster_arrive();
    cluster_wait();
    // one batch row of a bf16 slice: the segment's first kRegRows rows from
    // registers (wider tiles need the registers for their accumulators)
    constexpr bool kSplit = NB == 1 && sizeof(TR) == 2;
    const bool split = kSplit && shared_rows && L.rows >= kRegRows;
    uint4 rr[kSplit ? kRegRows : 1];
    if constexpr (kSplit) {
        if (dotter && split) {
#pragma unroll
            for (int d = 0; d < kRegRows; ++d)
                rr[d] = *reinterpret_cast<const uint4*>(r_s + (k0 + d) * cols + 8 * g);
        }
    }

    for (int t = 0; t < T_len; ++t) {
        const float* h_cur = h_s + (t & 1) * L.bpad * dh;
        float* h_nxt = h_s + ((t + 1) & 1) * L.bpad * dh;
        uint64_t* bar = bars + ((t + 1) & 1);
        if (tid == 0) mbar_expect(bar, B * dh * 4);  // h_t of all dh units
        for (int b0 = 0; b0 < B; b0 += NB) {
            if (b0 > 0) load_wx(t, b0);
            float acc[NB][8];
#pragma unroll
            for (int b = 0; b < NB; ++b)
#pragma unroll
                for (int c = 0; c < 8; ++c) acc[b][c] = 0.f;
            if (dotter) {
                const float* hp = h_cur + b0 * dh + k0;
                if (split) {
                    if constexpr (kSplit) {  // rows in order: registers, then shared memory
                        dot_regs(rr, hp, acc);
                        dot_rows<NB, true>(r_s + (k0 + kRegRows) * cols + 8 * g, cols, dh,
                                           hp + kRegRows, L.rows - kRegRows, acc);
                    }
                } else if (shared_rows) {
                    dot_rows<NB, true>(r_s + k0 * cols + 8 * g, cols, dh, hp, L.rows, acc);
                } else {
                    dot_rows<NB, false>(r_head + static_cast<long long>(k0) * gd + u0 + 2 * g, gd,
                                        dh, hp, L.rows, acc);
                }
                for (int off = L.groups; off < 32; off <<= 1)  // the warp's segments
#pragma unroll
                    for (int b = 0; b < NB; ++b)
#pragma unroll
                        for (int c = 0; c < 8; ++c)
                            acc[b][c] += __shfl_xor_sync(0xffffffffu, acc[b][c], off);
            }
            if (b0 > 0) __syncthreads();  // the last pass's gates have read `part`
            if (dotter && lane < L.groups) {
#pragma unroll
                for (int b = 0; b < NB; ++b) {
                    float4* p = reinterpret_cast<float4*>(part + (warp * NB + b) * cols + 8 * g);
                    p[0] = make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
                    p[1] = make_float4(acc[b][4], acc[b][5], acc[b][6], acc[b][7]);
                }
            }
            __syncthreads();

#pragma unroll
            for (int i = 0; i < kIters; ++i) {
                const int e = tid + i * kThreads, bl = e / cols, b = b0 + bl;
                if (e >= NB * cols || b >= B) continue;  // whole warps
                const int col = e - bl * cols, j = col >> 2, q = col & 3;
                // the warps' partial dots in order; all 8 loads at once when
                // every warp holds one (the path's shape)
                float rec = 0.f;
                const float* pc = part + bl * cols + col;
                if (L.warps == kThreads / 32) {
                    float pv[kThreads / 32];
#pragma unroll
                    for (int w = 0; w < kThreads / 32; ++w) pv[w] = pc[w * NB * cols];
#pragma unroll
                    for (int w = 0; w < kThreads / 32; ++w) rec += pv[w];
                } else {
                    for (int w = 0; w < L.warps; ++w) rec += pc[w * NB * cols];
                }
                const float pre = wq[i] + rec + bq[i];
                const long long bt = static_cast<long long>(b) * T_len + t;
                if (pre_out != nullptr) pre_out[(bt * nh + head) * gd + q * dh + u0 + j] = pre;
                const int g0 = lane & ~3;
                const float p_i = __shfl_sync(0xffffffffu, pre, g0);
                const float p_f = __shfl_sync(0xffffffffu, pre, g0 + 1);
                const float p_z = __shfl_sync(0xffffffffu, pre, g0 + 2);
                const float p_o = __shfl_sync(0xffffffffu, pre, g0 + 3);
                float h = 0.f;
                if (q == 0) {
                    float* sc = st + b * U + j;
                    const float c = sc[0], n = sc[B * U], m = sc[2 * B * U];
                    const float i_log = fminf(p_i, kIClamp);
                    const float f_log = log_sigmoid(p_f);
                    const float m_new = fmaxf(f_log + m, i_log);
                    const float ig = expf(i_log - m_new);
                    const float fg = expf(f_log + m - m_new);
                    const float c_new = fg * c + ig * tanhf(p_z);
                    const float n_new = fg * n + ig;
                    h = (1.f / (1.f + expf(-p_o))) * c_new / fmaxf(n_new, 1.f);
                    sc[0] = c_new;
                    sc[B * U] = n_new;
                    sc[2 * B * U] = m_new;
                    hs[(bt * nh + head) * dh + u0 + j] = from_float<TW>(h);
                    if (steps_out != nullptr) {  // (c, n, m, h) after step t, for the backward
                        const long long o = (bt * nh + head) * dh + u0 + j,
                                        plane = static_cast<long long>(B) * T_len * nh * dh;
                        steps_out[o] = c_new;
                        steps_out[plane + o] = n_new;
                        steps_out[2 * plane + o] = m_new;
                        steps_out[3 * plane + o] = h;
                    }
                    if (t + 1 == T_len) {
                        const long long o = (static_cast<long long>(b) * nh + head) * dh + u0 + j;
                        c_out[o] = c_new;
                        n_out[o] = n_new;
                        m_out[o] = m_new;
                        h_out[o] = h;
                    }
                }
                // this warp's 8 units (lanes 0, 4, ..., 28 hold their h): lane
                // 2p + k sends units [4k, 4k + 4) to block p of the cluster
                const int k = lane & 1, peer = lane >> 1;
                const float4 v = make_float4(__shfl_sync(0xffffffffu, h, 16 * k),
                                             __shfl_sync(0xffffffffu, h, 16 * k + 4),
                                             __shfl_sync(0xffffffffu, h, 16 * k + 8),
                                             __shfl_sync(0xffffffffu, h, 16 * k + 12));
                if (peer < G)
                    store_peer(h_nxt + b * dh + u0 + ((col - lane) >> 2) + 4 * k, peer, v, bar);
            }
        }
        // h_t of every block in place before any block reads it, and every
        // block past this step's dot before any writes its h_s again (see
        // the note)
        cluster_arrive_relaxed();
        if (t + 1 < T_len) load_wx(t + 1, 0);
        mbar_wait(bar, (t >> 1) & 1);
        cluster_wait();
    }
    cluster_arrive();  // no block leaves while a store may still reach it
    cluster_wait();
}

// Calls f(TW{}, TR{}, integral_constant<NB>) for the dtypes and tile.
template <typename F>
int dispatch(int wx_dtype, int r_dtype, int B, F&& f) {
    auto by_tile = [&](auto tw, auto tr) {
        return B == 1 ? f(tw, tr, std::integral_constant<int, 1>{})
                      : f(tw, tr, std::integral_constant<int, kTile>{});
    };
    auto by_r = [&](auto tw) {
        if (r_dtype == REPRO_F32) return by_tile(tw, float{});
        if (r_dtype == REPRO_BF16) return by_tile(tw, __nv_bfloat16{});
        return static_cast<int>(cudaErrorInvalidValue);
    };
    if (wx_dtype == REPRO_F32) return by_r(float{});
    if (wx_dtype == REPRO_BF16) return by_r(__nv_bfloat16{});
    return static_cast<int>(cudaErrorInvalidValue);
}

// The launch configuration of one cluster of L.G blocks per head, after the
// kernel's attributes allow it.
template <typename Kernel>
cudaError_t configure(Kernel kernel, const Layout& L, int nh, cudaStream_t stream,
                      cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           L.bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = L.G;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(nh * L.G);
    cfg->blockDim = dim3(kThreads);
    cfg->dynamicSmemBytes = L.bytes;
    cfg->stream = stream;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return cudaSuccess;
}

int r_size(int r_dtype) { return r_dtype == REPRO_BF16 ? 2 : 4; }

}  // namespace

// wx: [B,T,nh,4dh] and hs: [B,T,nh,dh] of one dtype (wx_dtype); r: [nh,dh,4dh]
// (r_dtype); bias: [nh,4dh] fp32; c/n/m/h_out: [B,nh,dh] fp32; pre_out (each
// step's pre-activations, [B,T,nh,4dh]) and steps_out ((c, n, m, h) after
// each step, [4,B,T,nh,dh]): fp32 or null, written for the backward. All
// contiguous. G blocks per head, `segments` row segments of the dot and
// `resident` rows of R in shared memory as slstm_plan chooses them.
extern "C" int slstm_scan_fwd(const void* wx, const void* r, const float* bias, void* hs,
                              float* c_out, float* n_out, float* m_out, float* h_out,
                              float* pre_out, float* steps_out, int wx_dtype, int r_dtype,
                              int B, int T_len, int nh, int dh, int G,
                              int segments, int resident, void* stream) {
    Layout L;
    if (T_len <= 0 || nh <= 0 ||
        !make_layout(B, dh, G, segments, resident, r_size(r_dtype), &L))
        return static_cast<int>(cudaErrorInvalidValue);
    return dispatch(wx_dtype, r_dtype, B, [&](auto tw, auto tr, auto nb) {
        using TW = decltype(tw);
        using TR = decltype(tr);
        auto kernel = slstm_scan_kernel<TW, TR, decltype(nb)::value>;
        cudaLaunchAttribute attr;
        cudaLaunchConfig_t cfg;
        cudaError_t err = configure(kernel, L, nh, static_cast<cudaStream_t>(stream), &attr, &cfg);
        if (err != cudaSuccess) return static_cast<int>(err);
        // refuses a cluster shape the card cannot schedule; nothing falls back
        err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TW*>(wx),
                                 static_cast<const TR*>(r), bias, static_cast<TW*>(hs), c_out,
                                 n_out, m_out, h_out, pre_out, steps_out, L, B, T_len, nh,
                                 dh);
        if (err != cudaSuccess) return static_cast<int>(err);
        return static_cast<int>(cudaGetLastError());
    });
}

// How many of these clusters the card can hold at once
// (cudaOccupancyMaxActiveClusters); heads beyond that run in later waves.
extern "C" int slstm_scan_max_clusters(int wx_dtype, int r_dtype, int B, int nh, int dh, int G,
                                       int segments, int resident, int* clusters) {
    Layout L;
    if (nh <= 0 || !make_layout(B, dh, G, segments, resident, r_size(r_dtype), &L))
        return static_cast<int>(cudaErrorInvalidValue);
    return dispatch(wx_dtype, r_dtype, B, [&](auto tw, auto tr, auto nb) {
        auto kernel = slstm_scan_kernel<decltype(tw), decltype(tr), decltype(nb)::value>;
        cudaLaunchAttribute attr;
        cudaLaunchConfig_t cfg;
        cudaError_t err = configure(kernel, L, nh, nullptr, &attr, &cfg);
        if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
        return static_cast<int>(err);
    });
}
