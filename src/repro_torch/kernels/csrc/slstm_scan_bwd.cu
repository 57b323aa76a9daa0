// Backward of the sLSTM time scan for Hopper: one launch, one thread-block
// cluster per head walking time in reverse; the recurrent product on the
// tensor cores for bf16 R (with fp32's accuracy), on the CUDA cores for fp32 R.
//
// It replaces no TPU kernel: repro/kernels/slstm_scan.py::_slstm_kernel
// (pallas_call at slstm_scan.py:94) has no VJP, and the JAX package trains
// through autodiff of its lax.scan over _slstm_cell. This is the backward of
// the port's forward (slstm_scan.cu), per head h, gate-major per head
// ([i, f, z, o], dh each):
//
//     pre_t = wx_t + h_{t-1} @ R_h + b_h,  (c, n, m, h)_t = cell(pre_t, (c, n, m)_{t-1})
//
// With dh_t = dhs_t + R_h dpre_{t+1} (the gradient of h_t from its output
// and from the next step's pre-activations), the cell's local backward gives
// dpre_t and the gradients of (c, n, m)_{t-1}, carried to the step before:
//
//     n' = max(n_t, 1), h = sigmoid(o) c_t / n'
//     dc_t += dh sigmoid(o) / n';  dn_t -= dh sigmoid(o) c_t / n'^2 [n_t > 1]
//     ig = exp(i' - m_t), fg = exp(log_sigmoid(f) + m - m_t), i' = min(i, I_CLAMP)
//     dig = dc_t tanh(z) + dn_t,  dfg = dc_t c + dn_t n
//     dm_t' = dm_t - dig ig - dfg fg, split over the max that gives m_t
//     di = (dig ig + [i' wins] dm_t') [i < I_CLAMP],  df = (dfg fg + [a wins] dm_t') sigmoid(-f)
//     dz = dc_t ig (1 - tanh(z)^2),  do = dh c_t / n' sigmoid(o) (1 - sigmoid(o))
//     (dc, dn, dm)_{t-1} = (dc_t fg, dn_t fg, dfg fg + [a wins] dm_t')
//
// where a = log_sigmoid(f) + m and every [x wins] is JAX's rule for
// jnp.maximum / jnp.minimum: 1 for the larger (smaller), 1/2 at a tie, 0
// otherwise. At t = 0, m = -1e30 and n_t = exp(0) = 1 exactly, so max(n_t,
// 1) ties at every unit's first step; there fg = 0 and i wins the max, so
// dn's share cancels between ig and m_t and no term meets an inf. A tie
// that reaches a gradient needs n_t = 1 with fg > 0.
//
// The forward writes each step's pre-activations and (c, n, m, h) when grad
// is needed (slstm_scan.cu's pre_out and steps_out, 7 B T nh dh floats), so
// the walk recomputes nothing. dwx = dpre; db = sum over batch and time of
// dpre; dR = sum_t h_{t-1}^T dpre_t has no counterpart in the TPU kernel's
// body, and the wrapper takes it as one fp32 product over the stacked steps.
//
// What bounds it on the H100: the chain of T dependent steps, as in the
// forward. A step is 2 B 4dh dh flops per head (the recurrent product R_h
// dpre_{t+1}), and the next step needs every unit's dh_t of this one, so a
// step costs its latency: the cell, the product, the exchange between the
// head's blocks and the barriers. At xlstm's microbatch (B=4, dh=512) on an
// H100 SXM at 1980 MHz a step takes ~4600 cycles (clock64 stamps,
// scripts/slstm_bwd_variants.py): the tensor cores' product ~1450 (~1830
// in the warps sharing a scheduler with those), combining and sending the
// partial dots ~870, the cell with its rank sum ~550, the next step's
// forward values ~790 on the first warps, barriers ~400.
//
// The design, the forward's grid: a head is one thread-block cluster of G
// blocks (G = dh / units, units 32 or 16, at most 16), launched once for the
// whole walk. Block `rank` owns units [rank * units, (rank + 1) * units) and
// their 4 gate columns of R_h. Per step, reversed:
//  - the cell: thread (batch row b, unit u) sums the G partial dots that
//    reached it in rank order (dh_t = dhs_t + that sum) and runs the local
//    backward with (dc, dn, dm) in registers for the whole walk. What it
//    takes from the forward's step (the exponentials, tanh, the divisions
//    by max(n_t, 1)) was computed during the step before, once the thread's
//    warp was done with its product, from a ring of kStages steps of pre,
//    (c, n, m)_{t-1} and dhs that cp.async fills kStages - 1 steps ahead; so
//    the chain holds a dozen multiply-adds. It writes dpre_t to shared
//    memory and to dwx in device memory without waiting, and adds it to
//    its own db in registers.
//  - the recurrent product as exchanged partial dots: dh_rec[b][d] = sum_e
//    R_h[d, e] dpre_t[b][e] runs over all 4dh columns and a block holds only
//    its own 4 * units, so each block sums over its own columns for every
//    row d of the head and sends each block the rows it owns. bf16 R (the
//    path): on the tensor cores, mma.m16n8k16 with fp32 sums; warp w takes
//    rows [64w, 64w + 64) and holds its whole slice of R as A fragments in
//    registers for the walk (128 registers, read once from device memory;
//    the block's columns taken gate-major, k = q * units + j, so each
//    fragment register is one 4-byte load). dpre is split into three bf16
//    terms, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), which
//    sum to x within fp32's rounding, laid along N (n = term * NB + b); R
//    times each is exact, so the product keeps fp32's accuracy. The terms'
//    sums are added (hi + mid) + lo. fp32 R: on the CUDA cores, R's slice
//    in shared memory (unit-major, 16-byte slots XOR-swizzled by (row / 4)
//    % 8), thread (row group g, half k) taking rows [4g, 4g + 4) and the even
//    or odd 8-column chunks, halves added by one shuffle; rows beyond what
//    fits (a dh=512 slice is 256 KiB) read from L2 every step, as in the
//    forward. That path serves the checks; it is not tuned.
//  - the exchange: each 4-row group of a batch row goes as one float4 by
//    st.async into its owner's recv[parity][rank][b][unit], counted on the
//    owner's mbarrier (peer addresses computed once). A block receives
//    G * B * units * 4 = B * dh * 4 bytes a step, as the forward's h
//    exchange. No atomics: the receiver sums in rank order, so two calls
//    give the same bits.
//  - one relaxed cluster barrier a step guards the double buffer: a block
//    arrives once its cell has read recv[s & 1] and waits at the step's
//    end, so a peer writes recv[s & 1] again (in step s + 1) only after it
//    has been read; the arrival comes before the product, whose time hides
//    the barrier's. One cluster barrier before the first step puts every
//    block's mbarriers in place; the last step's is the one after the walk.
// db: after the walk each block sums its threads' db over batch rows, in
// order, and writes its units' 4 gates once. No step launches, no carry in
// device memory, no second pass.

#include <cstdint>
#include <type_traits>

#include "slstm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4;          // batch rows per pass of the product (fewer: 1 or 2)
constexpr int kMaxBatch = 16;
constexpr int kMaxCluster = 16;   // non-portable cluster size (8 is portable)
constexpr int kMaxSmem = 232448;  // shared memory a block may use
constexpr int kBarrierBytes = 16; // its static part: two mbarriers
constexpr int kStages = 3;        // steps of pre, (c, n, m) and dhs in the ring
constexpr int kWarpRows = 64;     // rows of R_h one warp's product covers
constexpr int kScratchRow = kWarpRows + 4;  // a warp's partial dots of one column, padded
constexpr float kIClamp = 15.f;
constexpr float kMInit = -1e30f;
static_assert(kMaxBatch * 32 <= 2 * kThreads, "the cell's thread map: two cells a thread");
static_assert(kWarpRows * kWarps >= kMaxCluster * 32, "the product's rows");

// One block's shared-memory layout (bytes); the wrapper's slstm_bwd_plan
// chooses G and the resident rows by the same rules.
struct Layout {
    int G, units, cols, tile, bpad, resident;
    int dpre_off, recv_off, ring_off, stage_bytes, split_off, scratch_off, bytes;
};

// false for a shape this kernel cannot run (see slstm_bwd_plan for the rules)
bool make_layout(int B, int dh, int G, int resident, int r_size, int w_size, Layout* L) {
    if (B < 1 || B > kMaxBatch || dh <= 0 || G < 1 || G > kMaxCluster || dh % G) return false;
    L->G = G;
    L->units = dh / G;
    if (L->units != 16 && L->units != 32) return false;
    L->cols = 4 * L->units;
    // bf16 R lives in registers; fp32 rows in whole warps' rows of 4 x 16
    if (r_size == 2 ? resident != 0
                    : resident < 0 || resident > dh || (resident % kWarpRows && resident != dh))
        return false;
    L->resident = resident;
    L->tile = B <= 2 ? B : kTile;
    L->bpad = (B + L->tile - 1) / L->tile * L->tile;
    long long off = static_cast<long long>(r_size) * resident * L->cols;  // R slice
    L->dpre_off = static_cast<int>(off);
    off += 4LL * L->bpad * L->cols;                                        // dpre_t
    L->recv_off = static_cast<int>(off);
    off += 4LL * 2 * B * dh;                                               // partials, 2 buffers
    L->ring_off = static_cast<int>(off);
    L->stage_bytes = B * L->units * (4 * 4 + 3 * 4 + w_size);              // pre, c n m, dhs
    off += static_cast<long long>(kStages) * L->stage_bytes;
    L->split_off = static_cast<int>(off);
    L->scratch_off = static_cast<int>(off);
    if (r_size == 2) {  // the tensor cores' operand and partial dots
        off += 2LL * (L->bpad / L->tile) * 16 * L->cols;
        L->scratch_off = static_cast<int>(off);
        off += 4LL * kWarps * 3 * L->tile * kScratchRow;
    }
    L->bytes = static_cast<int>(off);
    return off + kBarrierBytes <= kMaxSmem;
}

// JAX's share of the gradient of max(x, y) that goes to x.
__device__ __forceinline__ float tie(float x, float y) {
    return x > y ? 1.f : (x == y ? 0.5f : 0.f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- CUDA cores (fp32 R) ----

// 8-column chunk k of a shared fp32 row (unit 2k's gates, then unit 2k+1's)
__device__ __forceinline__ void chunk8(const float* row, int k, int key, float (&v)[8]) {
    const float4* slots = reinterpret_cast<const float4*>(row);
    const float4 a = slots[(2 * k) ^ key], b = slots[(2 * k + 1) ^ key];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// The same chunk of a row of R_h in device memory (gate-major: gate q of
// unit j at q * dh + u0 + j), for rows beyond the resident ones.
__device__ __forceinline__ void chunk8_global(const float* row, int dh, int k, float (&v)[8]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float2 two = load2_global(row + q * dh + 2 * k);
        v[q] = two.x;
        v[4 + q] = two.y;
    }
}

// acc[r][b] += sum over the thread's chunks (k = half, half + 2, ...) of
// R[4g + r][chunk] . dpre[b][chunk], chunks and columns in order.
template <int NB, bool kShared>
__device__ __forceinline__ void partial_dot(const float* r0, long long stride, int dh, int key,
                                            const float* dp, int cols, int half,
                                            float (&acc)[4][NB]) {
    const int chunks = cols / 8;
#pragma unroll 2
    for (int k = half; k < chunks; k += 2) {
        float x[NB][8];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
            const float4 lo = *reinterpret_cast<const float4*>(dp + b * cols + 8 * k);
            const float4 hi = *reinterpret_cast<const float4*>(dp + b * cols + 8 * k + 4);
            x[b][0] = lo.x, x[b][1] = lo.y, x[b][2] = lo.z, x[b][3] = lo.w;
            x[b][4] = hi.x, x[b][5] = hi.y, x[b][6] = hi.z, x[b][7] = hi.w;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            float rv[8];
            if constexpr (kShared)
                chunk8(r0 + r * stride, k, key, rv);
            else
                chunk8_global(r0 + r * stride, dh, k, rv);
#pragma unroll
            for (int b = 0; b < NB; ++b) {
                float s = acc[r][b];
#pragma unroll
                for (int c = 0; c < 8; ++c) s = fmaf(rv[c], x[b][c], s);
                acc[r][b] = s;
            }
        }
    }
}

// ---- tensor cores (bf16 R) ----

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&v)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                 : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t addr, uint32_t& v0, uint32_t& v1) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(v0), "=r"(v1)
                 : "r"(addr));
}

// c += a (16 x 16, row-major) . b (16 x 8, column-major), bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of the warp's rows [d0, d0 + 16 * mtiles) of R_h (`r_head`:
// the head's rows at the block's first unit) for every k-tile, k taken
// gate-major (k = q * U + j): two adjacent k are adjacent in device memory.
__device__ __forceinline__ void load_a(uint32_t (&a)[8][4][4], const __nv_bfloat16* r_head,
                                       int gd, int dh, int U, int d0, int mtiles, int kts,
                                       int lane) {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int kt = 0; kt < 8; ++kt)
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
            if (mt >= mtiles || kt >= kts) continue;
            const int k = 16 * kt + 2 * t4, q = k / U;
            const __nv_bfloat16* p = r_head + static_cast<long long>(d0 + 16 * mt + g) * gd +
                                     q * dh + k - q * U;
            const long long down = 8LL * gd;  // row + 8
            a[kt][mt][0] = __ldg(reinterpret_cast<const unsigned*>(p));
            a[kt][mt][1] = __ldg(reinterpret_cast<const unsigned*>(p + down));
            a[kt][mt][2] = __ldg(reinterpret_cast<const unsigned*>(p + 8));
            a[kt][mt][3] = __ldg(reinterpret_cast<const unsigned*>(p + down + 8));
        }
}

// The warp's partial dots for NB batch rows: the held A fragments times
// dpre's terms (`split`, [16][cols], read by ldmatrix from swizzled slots a
// k-tile ahead), into scratch[n][row within the warp's 64], n = term * NB + b.
template <int NB>
__device__ __forceinline__ void mma_dot(const uint32_t (&a)[8][4][4], const __nv_bfloat16* split,
                                        int mtiles, int kts, int cols, int lane, float* scratch) {
    constexpr int NT = (3 * NB + 7) / 8;  // n-tiles of 8
    float acc[4][NT][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    const int mat = lane >> 3, r8 = lane & 7, row_bytes = cols * 2;
    const uint32_t s_base = smem_addr(split);
    uint32_t b[2][NT][2];
    auto load_b = [&](int kt, uint32_t (&bb)[NT][2]) {
        if constexpr (NT == 2) {  // (n 0-7, k lo), (n 0-7, k hi), (n 8-15, k lo), (n 8-15, k hi)
            const int n = 8 * (mat >> 1) + r8, slot = 2 * kt + (mat & 1);
            uint32_t v[4];
            ldmatrix_x4(s_base + n * row_bytes + 16 * (slot ^ (n & 7)), v);
            bb[0][0] = v[0], bb[0][1] = v[1], bb[NT - 1][0] = v[2], bb[NT - 1][1] = v[3];
        } else {
            const int n = r8, slot = 2 * kt + (mat & 1);
            ldmatrix_x2(s_base + n * row_bytes + 16 * (slot ^ (n & 7)), bb[0][0], bb[0][1]);
        }
    };
    load_b(0, b[0]);
#pragma unroll
    for (int kt = 0; kt < 8; ++kt) {
        if (kt >= kts) break;
        if (kt + 1 < kts) load_b(kt + 1, b[(kt + 1) & 1]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
            if (mt < mtiles)
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
                    mma_bf16(acc[mt][nt], a[kt][mt], b[kt & 1][nt][0], b[kt & 1][nt][1]);
    }
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
        if (mt >= mtiles) break;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int n = 8 * nt + 2 * t4 + (e & 1);
                if (n < 3 * NB) scratch[n * kScratchRow + 16 * mt + g + 8 * (e >> 1)] =
                    acc[mt][nt][e];
            }
    }
}

// the bf16 terms of x: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)
__device__ __forceinline__ void split3(float x, __nv_bfloat16 (&t)[3]) {
    t[0] = __float2bfloat16(x);
    const float r1 = x - __bfloat162float(t[0]);
    t[1] = __float2bfloat16(r1);
    t[2] = __float2bfloat16(r1 - __bfloat162float(t[1]));
}

// ---- the cell ----

// What the cell's backward takes from the forward's step, computed from the
// ring a step ahead (off the chain): (c, n) before it, ig, fg, tanh(z), the
// factors of dh in do, dc and dn, the max's share, the clamp's, sigmoid(-f),
// dz / dc_t, do / (dh c_t / n'), and dhs.
struct Fwd {
    float c, n, ig, fg, z, a_do, a_dc, a_dn, share, clamp, sig_nf, f_dz, f_do, dhs;
};

template <typename TW>
__device__ __forceinline__ Fwd forward_step(const float* pre_s, const float* cnm_s,
                                            const TW* dhs_s, int B, int U, int b, int u,
                                            bool first) {
    Fwd w;
    const float pi = pre_s[(b * 4) * U + u], pf = pre_s[(b * 4 + 1) * U + u];
    const float pz = pre_s[(b * 4 + 2) * U + u], po = pre_s[(b * 4 + 3) * U + u];
    float m = kMInit;
    w.c = w.n = 0.f;
    if (!first) {
        w.c = cnm_s[b * U + u];
        w.n = cnm_s[(B + b) * U + u];
        m = cnm_s[(2 * B + b) * U + u];
    }
    // the step again, as the forward computes it
    const float i_log = fminf(pi, kIClamp);
    const float a = log_sigmoid(pf) + m;
    const float m_new = fmaxf(a, i_log);
    w.ig = expf(i_log - m_new);
    w.fg = expf(a - m_new);
    w.z = tanhf(pz);
    const float o = 1.f / (1.f + expf(-po));
    const float c_new = w.fg * w.c + w.ig * w.z;
    const float n_new = w.fg * w.n + w.ig;
    const float nn = fmaxf(n_new, 1.f);
    w.a_do = c_new / nn;
    w.a_dc = o / nn;
    w.a_dn = o * c_new / (nn * nn) * tie(n_new, 1.f);
    w.share = tie(a, i_log);
    w.clamp = tie(-pi, -kIClamp);
    w.sig_nf = 1.f / (1.f + expf(pf));
    w.f_dz = w.ig * (1.f - w.z * w.z);
    w.f_do = o * (1.f - o);
    w.dhs = to_float(dhs_s[b * U + u]);
    return w;
}

// TW: type of dhs (wx's); TR: r's; NB: batch rows per pass of the product;
// NP: cells (batch row, unit) per thread. Grid: nh clusters of L.G blocks,
// cluster k = head k.
template <typename TW, typename TR, int NB, int NP>
__global__ void __launch_bounds__(kThreads, 1)
slstm_bwd_walk_kernel(const TR* __restrict__ r, const float* __restrict__ pre,
                      const float* __restrict__ steps, const TW* __restrict__ dhs,
                      const float* __restrict__ dstate, float* __restrict__ dpre,
                      float* __restrict__ db, const Layout L, int B, int T_len, int nh, int dh) {
    constexpr bool kMma = std::is_same<TR, __nv_bfloat16>::value;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* r_s = reinterpret_cast<float*>(smem_raw);                    // fp32: [resident][cols]
    float* dpre_s = reinterpret_cast<float*>(smem_raw + L.dpre_off);   // [bpad][cols]
    float* recv = reinterpret_cast<float*>(smem_raw + L.recv_off);     // [2][G][B][units]
    unsigned char* ring = smem_raw + L.ring_off;                       // [kStages][stage]
    // bf16: dpre's three terms [bpad / NB][16][cols] and the warps' partial
    // dots [kWarps][3 NB][kScratchRow]
    __nv_bfloat16* split = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.split_off);
    float* scratch = reinterpret_cast<float*>(smem_raw + L.scratch_off);
    __shared__ uint64_t bars[2];  // bars[k]: partials arriving in buffer k (kBarrierBytes)

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int U = L.units, cols = L.cols, G = L.G;
    const int head = blockIdx.x / G;
    const uint32_t rank = cluster_rank();
    const int u0 = static_cast<int>(rank) * U;
    const int gd = 4 * dh;
    const long long plane = static_cast<long long>(B) * T_len * nh * dh;
    const TR* r_head = r + static_cast<long long>(head) * dh * gd + u0;

    if constexpr (!kMma) {
        // the fp32 slice, read in device order (gate q, units j...) 16 bytes
        // at a time, stored unit-major with each row's slots swizzled
        const int vecs = cols / 4;
        for (int i = tid; i < L.resident * vecs; i += kThreads) {
            const int d = i / vecs, c = (i - d * vecs) * 4;
            const int q = c / U, j = c - q * U, key = (d >> 2) & 7;
            const float4 v = __ldg(reinterpret_cast<const float4*>(
                r_head + static_cast<long long>(d) * gd + q * dh + j));
            const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                const int col = 4 * (j + x) + q;
                r_s[d * cols + ((col / 4) ^ key) * 4 + col % 4] = e[x];
            }
        }
    }
    for (int i = tid; i < L.bpad * cols; i += kThreads) dpre_s[i] = 0.f;
    if constexpr (kMma)
        for (int i = tid; i < L.bpad / NB * 16 * cols; i += kThreads)
            split[i] = __float2bfloat16(0.f);

    // the ring: stage s % kStages holds step s (t = T - 1 - s) as pre
    // [B][4][U], (c, n, m)_{t-1} [3][B][U] fp32 and dhs [B][U] TW
    const int pre_n = B * U / 4, cnm_n = 3 * B * U / 4;
    const int dhs_row = U * static_cast<int>(sizeof(TW)) / 16;
    auto fetch = [&](int s) {
        if (s < T_len) {
            const int t = T_len - 1 - s;
            unsigned char* st = ring + (s % kStages) * L.stage_bytes;
            const int total = pre_n + (t > 0 ? cnm_n : 0) + B * dhs_row;
            for (int i = tid; i < total; i += kThreads) {
                if (i < pre_n) {
                    const int b = i / (U / 4), rem = i - b * (U / 4);
                    const long long bt = static_cast<long long>(b) * T_len + t;
                    // the 4 gates of these 4 units
                    const float* src = pre + (bt * nh + head) * gd + u0 + 4 * rem;
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        cp_async16(reinterpret_cast<float*>(st) + (b * 4 + q) * U + 4 * rem,
                                   src + q * dh);
                } else if (t > 0 && i < pre_n + cnm_n) {
                    const int x = i - pre_n, k = x / (B * U / 4), y = x - k * (B * U / 4);
                    const int b = y / (U / 4), rem = y - b * (U / 4);
                    const long long bt = static_cast<long long>(b) * T_len + t - 1;
                    cp_async16(reinterpret_cast<float*>(st) + 4 * B * U + (k * B + b) * U + 4 * rem,
                               steps + k * plane + (bt * nh + head) * dh + u0 + 4 * rem);
                } else {
                    const int x = i - pre_n - (t > 0 ? cnm_n : 0);
                    const int b = x / dhs_row, rem = x - b * dhs_row;
                    const long long bt = static_cast<long long>(b) * T_len + t;
                    cp_async16(st + 28 * B * U + (b * U) * sizeof(TW) + 16 * rem,
                               reinterpret_cast<const unsigned char*>(
                                   dhs + (bt * nh + head) * dh + u0) +
                                   16 * rem);
                }
            }
        }
        cp_async_commit();  // an empty group past the end keeps the count
    };
    // the cells' carry, db and the next step's forward values, in registers
    // for the whole walk; cell k of this thread is p = tid + k * kThreads:
    // batch row p / U, unit p % U
    float dc[NP], dn[NP], dm[NP], dbq[NP][4];
    Fwd fw[NP];
    auto forward = [&](int s) {
        const unsigned char* st = ring + (s % kStages) * L.stage_bytes;
        const float* pre_s = reinterpret_cast<const float*>(st);
#pragma unroll
        for (int k = 0; k < NP; ++k) {
            const int p = tid + k * kThreads, b = p / U, u = p - b * U;
            if (p < B * U)
                fw[k] = forward_step(pre_s, pre_s + 4 * B * U,
                                     reinterpret_cast<const TW*>(st + 28 * B * U), B, U, b, u,
                                     s + 1 == T_len);
        }
    };
#pragma unroll
    for (int k = 0; k < NP; ++k) {
        const int p = tid + k * kThreads, b = p / U, u = p - b * U;
        dc[k] = dn[k] = dm[k] = 0.f;
        dbq[k][0] = dbq[k][1] = dbq[k][2] = dbq[k][3] = 0.f;
        if (p < B * U) {
            const long long o = (static_cast<long long>(b) * nh + head) * dh + u0 + u;
            const long long cplane = static_cast<long long>(B) * nh * dh;
            dc[k] = dstate[o];
            dn[k] = dstate[cplane + o];
            dm[k] = dstate[2 * cplane + o];
        }
    }
    for (int s = 0; s < kStages - 1; ++s) fetch(s);

    // the product's threads. Tensor cores: warp w takes rows [64w, 64w +
    // 16 mtiles) and sends 4-row groups i = lane, lane + 32 of a tile's
    // NB * 4 * mtiles. CUDA cores: thread (row group g, half of the chunks)
    // takes rows [4g, 4g + 4) and sends to their owner. Whole warps past the
    // head's rows sit out.
    const int half = lane >> 4;
    const int groups = dh / 4;
    const int g_raw = warp * 16 + (lane & 15);
    const bool dot_warp = warp * 16 < groups;
    const int g = min(g_raw, groups - 1);
    const bool sender = g_raw < groups;
    const int d0 = 4 * g, owner = d0 / U;
    const bool shared_rows = d0 < L.resident;  // the same for a whole warp
    const int mtiles = max(1, min(4, (dh - kWarpRows * warp) / 16)), kts = cols / 16;
    const int sends = NB * 4 * mtiles;
    float* my_scratch = scratch + warp * 3 * NB * kScratchRow;
    uint32_t afrag[8][4][4];
    if constexpr (kMma)
        if (dot_warp)
            load_a(afrag, reinterpret_cast<const __nv_bfloat16*>(r_head), gd, dh, U,
                   kWarpRows * warp, mtiles, kts, lane);
    // the owners' recv and mbarriers in the cluster's address space
    uint32_t to_recv[2], to_bar[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int i = lane + 32 * j, row = 4 * (i % (4 * mtiles));
        const int to = kMma ? min((kWarpRows * warp + row) / U, G - 1) : owner;
        to_recv[j] = peer_addr(recv + rank * B * U, to);
        to_bar[j] = peer_addr(bars, to);
    }

    cp_async_wait<kStages - 2>();
    __syncthreads();  // step 0's ring stage, from every thread's copies
    forward(0);
    if (tid == 0) mbar_init_pair(bars);
    // every block's barriers in place before a peer stores into it
    cluster_arrive();
    cluster_wait();

    for (int s = 0; s < T_len; ++s) {
        const int t = T_len - 1 - s;
        const float* got = recv + (s & 1) * G * B * U;
#pragma unroll
        for (int k = 0; k < NP; ++k) {
            const int p = tid + k * kThreads, b = p / U, u = p - b * U;
            if (p >= B * U) continue;
            float rec = 0.f;  // R_h dpre_{t+1} at (b, u): the G partials in rank order
            if (s > 0) {
                float part[kMaxCluster];  // every load issued before the first add
#pragma unroll
                for (int src = 0; src < kMaxCluster; ++src)
                    part[src] = got[(min(src, G - 1) * B + b) * U + u];
#pragma unroll
                for (int src = 0; src < kMaxCluster; ++src)
                    if (src < G) rec += part[src];
            }
            const Fwd& w = fw[k];
            const float gh = w.dhs + rec;
            const float dc_t = dc[k] + gh * w.a_dc;
            const float dn_t = dn[k] - gh * w.a_dn;
            const float dfg = dc_t * w.c + dn_t * w.n;
            const float dig = dc_t * w.z + dn_t;
            const float t_ig = dig * w.ig, t_fg = dfg * w.fg;
            const float dm_t = dm[k] - t_ig - t_fg;
            const float da = t_fg + dm_t * w.share;
            const float dp[4] = {(t_ig + dm_t * (1.f - w.share)) * w.clamp, da * w.sig_nf,
                                 dc_t * w.f_dz, gh * w.a_do * w.f_do};
            dc[k] = dc_t * w.fg;
            dn[k] = dn_t * w.fg;
            dm[k] = da;
            if constexpr (kMma) {  // the product's operand: dpre's terms, k = q * U + u
                const int n0 = b % NB;
                __nv_bfloat16* rows = split + (b / NB) * 16 * cols;
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    __nv_bfloat16 tq[3];
                    split3(dp[q], tq);
                    const int kk = q * U + u;
#pragma unroll
                    for (int term = 0; term < 3; ++term) {
                        const int n = term * NB + n0;
                        rows[n * cols + 8 * ((kk >> 3) ^ (n & 7)) + (kk & 7)] = tq[term];
                    }
                }
            } else {
                *reinterpret_cast<float4*>(dpre_s + b * cols + 4 * u) =
                    make_float4(dp[0], dp[1], dp[2], dp[3]);
            }
            float* q = dpre + ((static_cast<long long>(b) * T_len + t) * nh + head) * gd + u0 + u;
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                q[x * dh] = dp[x];
                dbq[k][x] += dp[x];
            }
        }
        // this block has read recv[s & 1]: peers may write it again after
        // this step's barrier (see the note)
        cluster_arrive_relaxed();
        const bool more = s + 1 < T_len;
        uint64_t* bar = bars + ((s + 1) & 1);
        if (more && tid == 0) mbar_expect(bar, B * dh * 4);  // partials of all dh units
        if (more) cp_async_wait<0>();  // step s + 1's ring stage (issued a step ago)
        __syncthreads();  // dpre_t of the block's units and step s + 1's stage in place
        if (more && dot_warp) {
            // byte offsets of recv[(s + 1) & 1] and bars[(s + 1) & 1]
            const uint32_t put_off = ((s + 1) & 1) * G * B * U * 4, bar_off = ((s + 1) & 1) * 8;
            for (int b0 = 0; b0 < B; b0 += NB) {
                if constexpr (kMma) {
                    mma_dot<NB>(afrag, split + (b0 / NB) * 16 * cols, mtiles, kts, cols, lane,
                                my_scratch);
                    __syncwarp();
                    // (hi + mid) + lo of 4 rows for one batch row, to their
                    // owner; both of a lane's groups loaded before either store
                    float4 v[2];
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        const int i = min(lane + 32 * j, sends - 1), b = i / (4 * mtiles);
                        const int row = 4 * (i - b * 4 * mtiles);
                        const float4 hi = *reinterpret_cast<const float4*>(
                            my_scratch + b * kScratchRow + row);
                        const float4 mid = *reinterpret_cast<const float4*>(
                            my_scratch + (NB + b) * kScratchRow + row);
                        const float4 lo = *reinterpret_cast<const float4*>(
                            my_scratch + (2 * NB + b) * kScratchRow + row);
                        v[j] = make_float4(hi.x + mid.x + lo.x, hi.y + mid.y + lo.y,
                                           hi.z + mid.z + lo.z, hi.w + mid.w + lo.w);
                    }
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        const int i = lane + 32 * j, b = i / (4 * mtiles);
                        const int row = 4 * (i - b * 4 * mtiles);
                        if (i < sends && b0 + b < B)
                            store_remote(to_recv[j] + put_off +
                                             ((b0 + b) * U + (kWarpRows * warp + row) % U) * 4,
                                         v[j], to_bar[j] + bar_off);
                    }
                    __syncwarp();
                } else {
                    float acc[4][NB];
#pragma unroll
                    for (int x = 0; x < 4; ++x)
#pragma unroll
                        for (int b = 0; b < NB; ++b) acc[x][b] = 0.f;
                    const float* dp = dpre_s + b0 * cols;
                    if (shared_rows)
                        partial_dot<NB, true>(r_s + d0 * cols, cols, dh, g & 7, dp, cols, half,
                                              acc);
                    else
                        partial_dot<NB, false>(reinterpret_cast<const float*>(r_head) +
                                                   static_cast<long long>(d0) * gd,
                                               gd, dh, 0, dp, cols, half, acc);
#pragma unroll
                    for (int x = 0; x < 4; ++x)
#pragma unroll
                        for (int b = 0; b < NB; ++b)
                            acc[x][b] += __shfl_xor_sync(0xffffffffu, acc[x][b], 16);
                    // lanes 16 apart hold the same sums: each sends every other row
#pragma unroll
                    for (int b = 0; b < NB; ++b)
                        if (sender && (b & 1) == half && b0 + b < B)
                            store_remote(to_recv[0] + put_off + ((b0 + b) * U + d0 - owner * U) * 4,
                                         make_float4(acc[0][b], acc[1][b], acc[2][b], acc[3][b]),
                                         to_bar[0] + bar_off);
                }
            }
        }
        fetch(s + kStages - 1);  // into the stage that held step s - 1
        // a warp done with its product computes its cells' next forward
        // values while the others finish theirs and the partials travel
        if (more) forward(s + 1);
        __syncthreads();  // every warp past its product: dpre_t's buffers free
        if (more) mbar_wait(bar, (s >> 1) & 1);
        cluster_wait();
    }
    cp_async_wait<0>();

    // db: each thread's sums over time, then over batch rows in order,
    // through dpre_s (every thread is past its last read of it)
#pragma unroll
    for (int k = 0; k < NP; ++k) {
        const int p = tid + k * kThreads, b = p / U, u = p - b * U;
        if (p < B * U)
            *reinterpret_cast<float4*>(dpre_s + b * cols + 4 * u) =
                make_float4(dbq[k][0], dbq[k][1], dbq[k][2], dbq[k][3]);
    }
    __syncthreads();
    for (int col = tid; col < cols; col += kThreads) {
        float sum = 0.f;
        for (int b = 0; b < B; ++b) sum += dpre_s[b * cols + col];
        db[static_cast<long long>(head) * gd + (col & 3) * dh + u0 + (col >> 2)] = sum;
    }
}

// Calls f(TW{}, TR{}, integral_constant<NB>, integral_constant<NP>) for the
// dtypes, the tile and the cells per thread.
template <typename F>
int dispatch(int wx_dtype, int r_dtype, const Layout& L, int B, F&& f) {
    using One = std::integral_constant<int, 1>;
    using Two = std::integral_constant<int, 2>;
    auto by_tile = [&](auto tw, auto tr) {
        if (L.tile == 1) return f(tw, tr, One{}, One{});
        if (L.tile == 2) return f(tw, tr, Two{}, One{});
        using Tile = std::integral_constant<int, kTile>;
        return B * L.units <= kThreads ? f(tw, tr, Tile{}, One{}) : f(tw, tr, Tile{}, Two{});
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

// The launch configuration of nh clusters of L.G blocks, after the kernel's
// attributes allow it.
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

int dtype_size(int dtype) { return dtype == REPRO_BF16 ? 2 : 4; }

bool layout_for(int wx_dtype, int r_dtype, int B, int nh, int dh, int G, int resident,
                Layout* L) {
    return nh > 0 && make_layout(B, dh, G, resident, dtype_size(r_dtype), dtype_size(wx_dtype), L);
}

}  // namespace

// r: [nh,dh,4dh] (r_dtype); pre: [B,T,nh,4dh] and steps: [4,B,T,nh,dh] fp32
// (the forward's pre_out and steps_out); dhs: [B,T,nh,dh] (wx_dtype), 16-byte
// aligned; dstate: [3,B,nh,dh] fp32, the final state's (dc, dn, dm); dpre
// (= dwx): [B,T,nh,4dh] fp32; db: [nh,4dh] fp32. All contiguous. G blocks
// per head and `resident` rows of an fp32 R in shared memory (0 for bf16 R,
// held in registers) as slstm_bwd_plan chooses them.
extern "C" int slstm_scan_bwd(const void* r, const float* pre, const float* steps,
                              const void* dhs, const float* dstate, float* dpre, float* db,
                              int wx_dtype, int r_dtype, int B, int T_len, int nh, int dh,
                              int G, int resident, void* stream) {
    Layout L;
    if (T_len <= 0 || !layout_for(wx_dtype, r_dtype, B, nh, dh, G, resident, &L))
        return static_cast<int>(cudaErrorInvalidValue);
    return dispatch(wx_dtype, r_dtype, L, B, [&](auto tw, auto tr, auto nb, auto np) {
        using TW = decltype(tw);
        using TR = decltype(tr);
        auto kernel = slstm_bwd_walk_kernel<TW, TR, decltype(nb)::value, decltype(np)::value>;
        cudaLaunchAttribute attr;
        cudaLaunchConfig_t cfg;
        cudaError_t err = configure(kernel, L, nh, static_cast<cudaStream_t>(stream), &attr, &cfg);
        if (err != cudaSuccess) return static_cast<int>(err);
        // refuses a cluster shape the card cannot schedule; nothing falls back
        err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TR*>(r), pre, steps,
                                 static_cast<const TW*>(dhs), dstate, dpre, db, L, B, T_len, nh,
                                 dh);
        if (err != cudaSuccess) return static_cast<int>(err);
        return static_cast<int>(cudaGetLastError());
    });
}

// How many of these clusters the card holds at once
// (cudaOccupancyMaxActiveClusters; heads beyond it run in later waves), and
// the kernel's registers, local (spill) bytes a thread and shared memory
// bytes a block: out[0..3].
extern "C" int slstm_bwd_max_clusters(int wx_dtype, int r_dtype, int B, int nh, int dh, int G,
                                      int resident, int* out) {
    Layout L;
    if (!layout_for(wx_dtype, r_dtype, B, nh, dh, G, resident, &L))
        return static_cast<int>(cudaErrorInvalidValue);
    return dispatch(wx_dtype, r_dtype, L, B, [&](auto tw, auto tr, auto nb, auto np) {
        auto kernel = slstm_bwd_walk_kernel<decltype(tw), decltype(tr), decltype(nb)::value,
                                            decltype(np)::value>;
        cudaLaunchAttribute attr;
        cudaLaunchConfig_t cfg;
        cudaFuncAttributes fa;
        cudaError_t err = configure(kernel, L, nh, nullptr, &attr, &cfg);
        if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
        if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
        if (err != cudaSuccess) return static_cast<int>(err);
        out[1] = fa.numRegs;
        out[2] = static_cast<int>(fa.localSizeBytes);
        out[3] = static_cast<int>(fa.sharedSizeBytes) + L.bytes;
        return 0;
    });
}
