// Causal / sliding-window GQA flash attention, backward, bf16, on Hopper's
// tensor cores: dq, dk, dv from bf16 q, k, v, o, do and the forward's fp32
// per-row log-sum-exp (lse), every tile product a wgmma on tiles that TMA
// places in shared memory.
//
// It replaces no TPU kernel: repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call at flash_attention.py:121) has no VJP, and the JAX package
// trains through its jnp attention. It is the backward of the port's bf16
// forward (flash_attention_sm90.cu), which the Trainer runs in bf16, in the
// fp32 backward's contract (flash_attention_bwd.cu): q [B,T,H,hd], k/v
// [B,S,KV,hd], query row t at absolute position t + q_offset, KV head =
// q head / (H/KV), scale 1/sqrt(hd), causal and window masks, any T and S,
// hd 32, 64, 80 or 128, lse = +inf for a row with no visible key (its P, and
// its share of every gradient, is then 0). With s = scale * q.k and
// P = exp(s - lse):
//   D  = rowsum(do * (o + o_lo))        (flash_bwd_delta_kernel, fp32;
//                                        o_lo: the forward's rounding
//                                        residual of O)
//   dv = P^T do,  dS = P * (do v^T - D)
//   dk = scale * dS^T q                 (flash_bwd_dkdv_sm90_kernel)
//   dq = scale * dS k                   (flash_bwd_dq_sm90_kernel)
// Two kernels each own what they write (no atomics), so every sum runs in a
// fixed order and two calls give the same bits.
//
// The one departure from the fp32 formulas: P and dS are rounded to bf16
// where they become the A operand of a product (P before P^T do, dS before
// dS^T q and dS k); S, dP, D, lse, P's exponent and every sum stay fp32. The
// JAX package's bf16 attention rounds P before P V likewise. Rounding dS as
// one bf16 (not hi + lo) kept every case of chip_smoke.py's per-row check
// within its limit (flash_attention_bwd_ref(..., bf16_operands=True) is this
// rounding in plain PyTorch).
//
// What bounds it on the H100, at the trainer's microbatch (B=4 T=S=512 H=16
// KV=8 hd=128, causal): bytes, 0.0151 ms (q, k, v, o, do read, dq, dk, dv
// written in bf16, lse read), over operations, 0.0109 ms (2.5 x the causal
// forward's 4*B*H*hd*T(T+1)/2 at 989 TFLOP/s). The kernels do 7 tile
// products per visible (query tile, key tile) pair, where a backward needs
// 5: dq sums over key tiles in its own kernel rather than by atomics.
//
// Design:
// - delta: one warp per row, as the fp32 backward's.
// - dk/dv: one block of two warpgroups per (batch, KV head, 64-key tile); K
//   and V come in once by TMA. Q and dO tiles of 64 query rows stream
//   through a 2-stage ring (TMA, one mbarrier per stage): the block loops
//   over the group's query heads and every query tile that sees one of its
//   keys, so GQA's sum over the group stays in registers. The roles split
//   across the warpgroups so that no thread holds two hd-wide accumulators:
//   warpgroup 0 computes S^T = K Q^T, then P^T, then dV += P^T dO;
//   warpgroup 1 computes dP^T = V dO^T, then dS^T = P^T (dP^T - D), then
//   dK += dS^T Q. P^T goes from the first to the second in fp32 through
//   shared memory, in the accumulator's fragment order (one float4 a thread
//   per 4 registers, so both sides' accesses are conflict-free), handed over
//   by a named barrier. S^T and dP^T are m64n64k16 products with both
//   operands K-major as TMA writes them; dV and dK are m64n{hd}k16 with A
//   the bf16 fragment of P^T or dS^T in registers (packed from the fp32
//   accumulator, as the forward packs P) and B (dO, Q) read MN-major
//   through the transpose flag, as the forward reads V. lse and D are per
//   column here: 64 of each per pass come in by 4-byte cp.async a pass
//   ahead, into the ring stage's stats buffer.
// - dq: the forward's skeleton with a known lse. One warpgroup per (batch *
//   head, 64-row query tile), heaviest tiles first under causal; Q and dO
//   by TMA once, K and V tiles through a 2-stage ring. S = Q K^T and
//   dP = dO V^T are issued together (m64n64k16, K-major), dS = P (dP - D)
//   is built on the accumulator fragment and dQ += dS K is m64n{hd}k16
//   with K read MN-major.
// - Only tile pairs that cross the causal diagonal, a window edge, T or S
//   are masked element by element; tiles that no row sees are never loaded.
//   Rows past T and keys past S are zero-filled by TMA.
// - Shared memory per block and blocks per SM on the H100 (DkdvSmem,
//   DkdvOneSmem, DqSmem; the occupancy entry below, logged by
//   chip_smoke.py with the registers and local bytes of each kernel): dk/dv
//   116,760 bytes, 1 block of 8 warps at hd 128 (168 registers), 67,608 and
//   2 at hd 64, 43,032 and 2 at hd 32; dq 99,352 bytes, 2 blocks of 4 warps
//   at hd 128 (195 registers), 50,200 and 3 at hd 64, 25,624 and 3 at hd
//   32. No spills. hd 80: below.
// - hd 80 (zamba2's shared block) has tiles of its own: five 16-column
//   atoms in 32-byte swizzle (10,240 bytes a tile, one TMA box of 64 rows
//   x 32 bytes an atom), so no column is padding. S^T, dP^T, S and dP keep
//   their 5 k16 steps; dV, dK and dQ are m64n80k16 (40 accumulator
//   registers a thread, where hd 128's tiles cost 64 over 48 zero columns).
//   dk/dv runs flash_bwd_dkdv_sm90_kernel_one_wg: one warpgroup a block
//   holds both accumulators, computes S^T and dP^T together and P^T and
//   dS^T on the same thread's elements (no P^T hand-over), and two blocks
//   share an SM (63,512 bytes and 252 registers each; three blocks' 168
//   registers spilled and ran slower). The two-warpgroup kernel on the
//   same tiles fitted two blocks an SM and ran each pass as one chain
//   through both warpgroups; it was slower (PERF.md section 6). dq is the
//   kernel above on these tiles, three blocks an SM. At hd 80 dq, dk and
//   dv go through shared memory (the Q, K and V tiles, no longer read) and
//   out by TMA, and dk/dv issues its first tiles' loads before its lse and
//   D: a block's first loads and 4-byte stores of its outputs had been a
//   large part of its time. Both give the bits of hd 128's padded tiles:
//   the dropped columns added only zeros.
// Left for later: a producer warp with setmaxnreg, the next pass's S^T
// issued under this pass's exponentials, a persistent grid, dq summed in
// the dk/dv kernel (5 products instead of 7).

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int STAGES = 2;     // ring depth of the streamed tiles
constexpr int WG = 128;       // threads of one warpgroup
constexpr int DELTA_NT = 512; // the delta kernel: one warp per row
constexpr float LOG2E = 1.4426950408889634f;

// A 64-row tile of a [*, *, *, hd] bf16 tensor as TMA writes it: atoms of
// SW-byte rows side by side along hd, swizzled by SW. hd 80 is five atoms
// of 16 columns in 32-byte swizzle, so no column of a tile is padding.
template <int HD>
struct Tile {
    static_assert(HD == 32 || HD == 64 || HD == 80 || HD == 128,
                  "the backward takes hd 32, 64, 80 or 128");
    static constexpr int W = HD;                             // columns of a tile in shared memory
    static constexpr int SW = HD == 80 ? 32 : W * 2 < 128 ? W * 2 : 128;  // swizzle = atom row bytes
    static constexpr int ATOM = SW / 2;                      // columns per atom
    static constexpr int NATOM = W / ATOM;
    static constexpr int BYTES = 64 * W * 2;
    static constexpr bool ONE_WG = HD == 80;                 // dk/dv by one warpgroup a block
    static constexpr bool TMA_STORE = HD == 80;              // dq, dk, dv stored by TMA
    static constexpr int DQ_BLOCKS = HD == 80 ? 3 : 2;       // dq blocks per SM (launch bounds)
};

constexpr int ONE_WG_BLOCKS = 2;  // blocks per SM of the one-warpgroup dk/dv kernel

template <int HD>
struct DkdvSmem {                                           // byte offsets, 1024-aligned tiles
    static constexpr int tile = Tile<HD>::BYTES;
    static constexpr int k = 0, v = tile;
    static constexpr int q = 2 * tile;                      // STAGES tiles each
    static constexpr int dout = q + STAGES * tile;
    static constexpr int p = dout + STAGES * tile;          // P^T, fp32, fragment order
    static constexpr int stats = p + WG * 32 * 4;           // STAGES x (lse[64], D[64])
    static constexpr int bar = stats + STAGES * 2 * BQ * 4; // k/v barrier, then one per stage
    static constexpr int bytes = bar + 8 * (1 + STAGES) + 1024;  // + alignment slack
};

template <int HD>
struct DkdvOneSmem {                                        // the one-warpgroup dk/dv kernel
    static constexpr int tile = Tile<HD>::BYTES;
    static constexpr int k = 0, v = tile;
    static constexpr int q = 2 * tile;                      // STAGES tiles each
    static constexpr int dout = q + STAGES * tile;
    static constexpr int stats = dout + STAGES * tile;      // STAGES x (lse[64], D[64])
    static constexpr int bar = stats + STAGES * 2 * BQ * 4; // k/v barrier, then one per stage
    static constexpr int bytes = bar + 8 * (1 + STAGES) + 1024;  // + alignment slack
};

template <int HD>
struct DqSmem {
    static constexpr int tile = Tile<HD>::BYTES;
    static constexpr int q = 0, dout = tile;
    static constexpr int k = 2 * tile;                      // STAGES tiles each
    static constexpr int v = k + STAGES * tile;
    static constexpr int bar = v + STAGES * tile;           // q/do barrier, then one per stage
    static constexpr int bytes = bar + 8 * (1 + STAGES) + 1024;
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Named barrier `id` over `n` threads: arrive without waiting, or wait.
__device__ __forceinline__ void bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// One 64-row tile (rows row0.., one head) into shared memory by TMA.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int head, int row0, int b) {
    using T = Tile<HD>;
#pragma unroll
    for (int a = 0; a < T::NATOM; ++a)
        tma_load_4d(dst + a * 64 * T::SW, map, bar, a * T::ATOM, head, row0, b);
}

// acc = A B^T over hd for two 64-row tiles, both K-major: m64n64k16 per 16
// columns of hd.
template <int HD>
__device__ __forceinline__ void rows_by_rows(float (&acc)[32], uint32_t a, uint32_t b) {
    using T = Tile<HD>;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk * 16 / T::ATOM) * 64 * T::SW + (kk * 16 % T::ATOM) * 2;
        wgmma_ss_n64(acc, smem_desc<T::SW>(a + off, 16, 8 * T::SW),
                     smem_desc<T::SW>(b + off, 16, 8 * T::SW), kk > 0);
    }
}

// acc += A X: A a 64 x 64 bf16 fragment in registers (four k16 slices), X a
// 64 x W tile read MN-major.
template <int HD>
__device__ __forceinline__ void frag_by_tile(float (&acc)[Tile<HD>::W / 2], const uint32_t (&a)[4][4],
                                             uint32_t x) {
    using T = Tile<HD>;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
        wgmma_rs(acc, a[kc], smem_desc<T::SW>(x + kc * 16 * T::SW, 64 * T::SW, 8 * T::SW));
}

// The m64n64 accumulator fragment as the A fragments of four k16 slices.
__device__ __forceinline__ void to_a_frag(uint32_t (&a)[4][4], const float (&s)[32]) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
        a[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
        a[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
        a[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
        a[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
    }
}

// A 64-row output fragment (rows r0 and r0 + 8, columns 8i + col and
// 8i + col + 1, times mul) in bf16 into a tile laid out as TMA writes it
// (store_tiles then copies it out with the same boxes): in an atom, row r
// at r * SW and its 16-byte chunk c at c ^ ((r * SW / 128) % (SW / 16)).
template <int HD>
__device__ __forceinline__ void tile_from_frag(uint32_t tile, const float (&acc)[HD / 2],
                                               float mul, int r0, int col) {
    using T = Tile<HD>;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
        const int c = (8 * i % T::ATOM) / 8;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int r = r0 + 8 * half;
            const uint32_t a = tile + (8 * i / T::ATOM) * 64 * T::SW + r * T::SW +
                               ((c ^ ((r * T::SW >> 7) & (T::SW / 16 - 1))) * 16) + col * 2;
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a),
                         "r"(pack_bf16(acc[4 * i + 2 * half] * mul,
                                       acc[4 * i + 2 * half + 1] * mul))
                         : "memory");
        }
    }
}

// Thread 0 stores a 64-row tile (rows row0.., one head) by TMA; rows past
// the tensor's end are not written.
template <int HD>
__device__ __forceinline__ void store_tile(const CUtensorMap* map, uint32_t src, int head,
                                           int row0, int b) {
    using T = Tile<HD>;
#pragma unroll
    for (int a = 0; a < T::NATOM; ++a)
        tma_store_4d(map, src + a * 64 * T::SW, a * T::ATOM, head, row0, b);
}

__device__ __forceinline__ bool visible(int t, int s, int T_len, int S_len, int causal,
                                        int window, int q_offset) {
    const int pos = t + q_offset;
    return t < T_len && s < S_len && (!causal || s <= pos) && (window <= 0 || s > pos - window);
}

// No pair of the query tile at q0 and the key tile at k0 is masked.
__device__ __forceinline__ bool whole_tiles(int q0, int k0, int T_len, int S_len, int causal,
                                            int window, int q_offset) {
    return q0 + BQ <= T_len && k0 + BK <= S_len &&
           (!causal || k0 + BK - 1 <= q0 + q_offset) &&
           (window <= 0 || k0 > q0 + BQ - 1 + q_offset - window);
}

// D[b, h, t] = sum_d do[b, t, h, d] * (o + o_lo)[b, t, h, d]: one warp per
// row; o_lo is the forward's rounding residual (flash_attention_sm90.cu).
template <int HD>
__global__ void __launch_bounds__(DELTA_NT)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ o_lo,
                       const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta,
                       long long n_rows, int T_len, int H) {
    const long long row = static_cast<long long>(blockIdx.x) * (DELTA_NT / 32) + (threadIdx.x >> 5);
    if (row >= n_rows) return;
    const int lane = threadIdx.x & 31;
    float acc = 0.f;
#pragma unroll
    for (int c = lane; c < HD; c += 32) {
        const float oc = __bfloat162float(o[row * HD + c]) + __bfloat162float(o_lo[row * HD + c]);
        acc = fmaf(__bfloat162float(dout[row * HD + c]), oc, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {                     // row = (b * T + t) * H + h
        const long long bt = row / H;
        const int h = static_cast<int>(row % H);
        const long long b = bt / T_len, t = bt % T_len;
        delta[(b * H + h) * T_len + t] = acc;
    }
}

template <int HD>
__global__ void __launch_bounds__(2 * WG, 1)
flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap dmap,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int T_len, int S_len, int H, int KV, int causal, int window,
                           int q_offset, float scale) {
    using T = Tile<HD>;
    using L = DkdvSmem<HD>;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
    unsigned char* gen = smem_raw + (base - raw);            // the same bytes, generic
    const uint32_t Ks = base + L::k, Vs = base + L::v, Qs = base + L::q, Ds = base + L::dout;
    const uint32_t kvbar = base + L::bar;
    auto full = [&](int s) { return kvbar + 8 * (1 + s); };
    float4* pbuf = reinterpret_cast<float4*>(gen + L::p);
    float* stats = reinterpret_cast<float*>(gen + L::stats);

    const int tid = threadIdx.x, wg = tid / WG, t = tid % WG;
    const int lane = t & 31, warp = t >> 5;
    const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, group = H / KV;
    const int k0 = blockIdx.y * BK;

    // The query tiles that see a key of this tile, [qt_lo, qt_hi) for every
    // head of the group: the causal edge cuts the first ones, the window
    // the last ones.
    const int nq = (T_len + BQ - 1) / BQ, k_last = min(k0 + BK, S_len) - 1;
    auto sees = [&](int qt) {
        const int q_first = qt * BQ + q_offset, q_last = min(qt * BQ + BQ, T_len) - 1 + q_offset;
        return (!causal || k0 <= q_last) && (window <= 0 || k_last > q_first - window);
    };
    int qt_lo = 0;
    while (qt_lo < nq && !sees(qt_lo)) ++qt_lo;
    int qt_hi = qt_lo;
    while (qt_hi < nq && sees(qt_hi)) ++qt_hi;
    const int nqv = qt_hi - qt_lo, n_pass = group * nqv;    // pass = group head * nqv + tile
    auto head_of = [&](int p) { return kvh * group + p / nqv; };
    auto q0_of = [&](int p) { return (qt_lo + p % nqv) * BQ; };

    auto load_pass = [&](int stage, int p) {                // thread 0: Q and dO by TMA
        mbar_expect_tx(full(stage), 2 * T::BYTES);
        load_tile<HD>(Qs + stage * T::BYTES, &qmap, full(stage), head_of(p), q0_of(p), b);
        load_tile<HD>(Ds + stage * T::BYTES, &dmap, full(stage), head_of(p), q0_of(p), b);
    };
    auto load_stats = [&](int stage, int p) {               // threads 0..127: lse[64], D[64]
        if (tid < 2 * BQ) {
            const int r = tid % BQ, q0 = q0_of(p);
            const float* src = (tid < BQ ? lse : delta) +
                               (static_cast<long long>(b) * H + head_of(p)) * T_len + q0;
            const bool ok = q0 + r < T_len;                 // rows past T: 0 (masked)
            cp_async4(smem_u32(stats + stage * 2 * BQ + tid), ok ? src + r : src, ok);
        }
    };

    if (tid == 0) {
        mbar_init(kvbar, 1);
        for (int s = 0; s < STAGES; ++s) mbar_init(full(s), 1);
        mbar_fence_init();
    }
    for (int s = 0; s < STAGES && s < n_pass; ++s) load_stats(s, s);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (tid == 0 && n_pass > 0) {                           // no pass: nothing to load
        mbar_expect_tx(kvbar, 2 * T::BYTES);
        load_tile<HD>(Ks, &kmap, kvbar, kvh, k0, b);
        load_tile<HD>(Vs, &vmap, kvbar, kvh, k0, b);
        for (int s = 0; s < STAGES && s < n_pass; ++s) load_pass(s, s);
    }

    // This thread's fragment: key rows jr and jr + 8 of the tile, query
    // columns ic + 8n and ic + 8n + 1 (n = 0..7) of the pass's tile.
    const int jr = 16 * warp + (lane >> 2), ic = 2 * (lane & 3);
    const float scale_log2 = scale * LOG2E;
    float acc[T::W / 2];                                    // wg 0: dv; wg 1: dk / scale
#pragma unroll
    for (int i = 0; i < T::W / 2; ++i) acc[i] = 0.f;

    if (n_pass > 0) mbar_wait(kvbar, 0);
    for (int p = 0; p < n_pass; ++p) {
        const int stage = p % STAGES, q0 = q0_of(p);
        const uint32_t Qt = Qs + stage * T::BYTES, Dt = Ds + stage * T::BYTES;
        const float* st = stats + stage * 2 * BQ;
        mbar_wait(full(stage), (p / STAGES) & 1);

        float s[32];                                        // wg 0: S^T; wg 1: dP^T
        wgmma_fence();
        rows_by_rows<HD>(s, wg == 0 ? Ks : Vs, wg == 0 ? Qt : Dt);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(s);

        if (wg == 0) {                                      // P^T = exp(S^T scale - lse)
            const bool whole = whole_tiles(q0, k0, T_len, S_len, causal, window, q_offset);
#pragma unroll
            for (int n = 0; n < 8; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = ic + 8 * n + (e & 1);
                    float x = exp2f(fmaf(s[4 * n + e], scale_log2, -st[i] * LOG2E));
                    if (!whole && !visible(q0 + i, k0 + jr + 8 * (e >> 1), T_len, S_len,
                                           causal, window, q_offset))
                        x = 0.f;
                    s[4 * n + e] = x;
                }
#pragma unroll
            for (int n = 0; n < 8; ++n)
                pbuf[n * WG + t] = make_float4(s[4 * n], s[4 * n + 1], s[4 * n + 2], s[4 * n + 3]);
            bar_arrive(1, 2 * WG);
        } else {                                            // dS^T = P^T (dP^T - D)
            bar_sync(1, 2 * WG);
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                const float4 pr = pbuf[n * WG + t];
                const float d0 = st[BQ + ic + 8 * n], d1 = st[BQ + ic + 8 * n + 1];
                s[4 * n] = pr.x * (s[4 * n] - d0);
                s[4 * n + 1] = pr.y * (s[4 * n + 1] - d1);
                s[4 * n + 2] = pr.z * (s[4 * n + 2] - d0);
                s[4 * n + 3] = pr.w * (s[4 * n + 3] - d1);
            }
        }

        uint32_t a[4][4];                                   // P^T or dS^T in bf16
        to_a_frag(a, s);
        reg_fence(acc);
        wgmma_fence();
        frag_by_tile<HD>(acc, a, wg == 0 ? Dt : Qt);        // dV += P^T dO; dK += dS^T Q
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(acc);

        cp_async_wait_all();                                // pass p + 1's stats landed
        __syncthreads();                                    // both warpgroups left this stage
        if (p + STAGES < n_pass) {
            if (tid == 0) load_pass(stage, p + STAGES);
            load_stats(stage, p + STAGES);
            cp_async_commit();
        }
    }

    __nv_bfloat16* out = wg == 0 ? dv : dk;
    const float mul = wg == 0 ? 1.f : scale;
    const long long row_stride = static_cast<long long>(KV) * HD;
    __nv_bfloat16* o0 = out + (static_cast<long long>(b) * S_len + k0 + jr) * row_stride + kvh * HD;
    __nv_bfloat16* o1 = o0 + 8 * row_stride;
    const bool w0 = k0 + jr < S_len, w1 = k0 + jr + 8 < S_len;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
        if (w0)
            *reinterpret_cast<uint32_t*>(o0 + 8 * i + ic) =
                pack_bf16(acc[4 * i] * mul, acc[4 * i + 1] * mul);
        if (w1)
            *reinterpret_cast<uint32_t*>(o1 + 8 * i + ic) =
                pack_bf16(acc[4 * i + 2] * mul, acc[4 * i + 3] * mul);
    }
}

// dk/dv at hd 80: one warpgroup a block, both accumulators in its
// registers (2 x 40 a thread). Each pass computes S^T = K Q^T and dP^T =
// V dO^T together, then P^T and dS^T on the two fragments as the kernel
// above's two warpgroups do (the same elements in the same thread, so the
// same bits, with no hand-over through shared memory), then dV += P^T dO
// and dK += dS^T Q together. Two blocks share an SM, each pass its own
// chain, where the kernel above (two warpgroups, P^T handed over) runs a
// pass as one chain across both warpgroups. dK and dV leave through the K
// and V tiles by TMA.
template <int HD>
__global__ void __launch_bounds__(WG, ONE_WG_BLOCKS)
flash_bwd_dkdv_sm90_kernel_one_wg(const __grid_constant__ CUtensorMap qmap,
                                  const __grid_constant__ CUtensorMap kmap,
                                  const __grid_constant__ CUtensorMap vmap,
                                  const __grid_constant__ CUtensorMap dmap,
                                  const __grid_constant__ CUtensorMap dkmap,
                                  const __grid_constant__ CUtensorMap dvmap,
                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                  int T_len, int S_len, int H, int KV, int causal, int window,
                                  int q_offset, float scale) {
    using T = Tile<HD>;
    using L = DkdvOneSmem<HD>;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
    unsigned char* gen = smem_raw + (base - raw);            // the same bytes, generic
    const uint32_t Ks = base + L::k, Vs = base + L::v, Qs = base + L::q, Ds = base + L::dout;
    const uint32_t kvbar = base + L::bar;
    auto full = [&](int s) { return kvbar + 8 * (1 + s); };
    float* stats = reinterpret_cast<float*>(gen + L::stats);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, group = H / KV;
    const int k0 = blockIdx.y * BK;

    // The passes, as in the kernel above: every query tile that sees a key
    // of this tile, for every head of the group.
    const int nq = (T_len + BQ - 1) / BQ, k_last = min(k0 + BK, S_len) - 1;
    auto sees = [&](int qt) {
        const int q_first = qt * BQ + q_offset, q_last = min(qt * BQ + BQ, T_len) - 1 + q_offset;
        return (!causal || k0 <= q_last) && (window <= 0 || k_last > q_first - window);
    };
    int qt_lo = 0;
    while (qt_lo < nq && !sees(qt_lo)) ++qt_lo;
    int qt_hi = qt_lo;
    while (qt_hi < nq && sees(qt_hi)) ++qt_hi;
    const int nqv = qt_hi - qt_lo, n_pass = group * nqv;
    auto head_of = [&](int p) { return kvh * group + p / nqv; };
    auto q0_of = [&](int p) { return (qt_lo + p % nqv) * BQ; };

    auto load_pass = [&](int stage, int p) {                // thread 0: Q and dO by TMA
        mbar_expect_tx(full(stage), 2 * T::BYTES);
        load_tile<HD>(Qs + stage * T::BYTES, &qmap, full(stage), head_of(p), q0_of(p), b);
        load_tile<HD>(Ds + stage * T::BYTES, &dmap, full(stage), head_of(p), q0_of(p), b);
    };
    auto load_stats = [&](int stage, int p) {               // every thread: lse[64], D[64]
        const int r = tid % BQ, q0 = q0_of(p);
        const float* src = (tid < BQ ? lse : delta) +
                           (static_cast<long long>(b) * H + head_of(p)) * T_len + q0;
        const bool ok = q0 + r < T_len;                     // rows past T: 0 (masked)
        cp_async4(smem_u32(stats + stage * 2 * BQ + tid), ok ? src + r : src, ok);
    };

    if (tid == 0) {
        mbar_init(kvbar, 1);
        for (int s = 0; s < STAGES; ++s) mbar_init(full(s), 1);
        mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0 && n_pass > 0) {                           // no pass: nothing to load
        mbar_expect_tx(kvbar, 2 * T::BYTES);
        load_tile<HD>(Ks, &kmap, kvbar, kvh, k0, b);
        load_tile<HD>(Vs, &vmap, kvbar, kvh, k0, b);
        for (int s = 0; s < STAGES && s < n_pass; ++s) load_pass(s, s);
    }
    for (int s = 0; s < STAGES && s < n_pass; ++s) load_stats(s, s);  // under the tiles' loads
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // This thread's fragment: key rows jr and jr + 8 of the tile, query
    // columns ic + 8n and ic + 8n + 1 (n = 0..7) of the pass's tile.
    const int jr = 16 * warp + (lane >> 2), ic = 2 * (lane & 3);
    const float scale_log2 = scale * LOG2E;
    float acc_v[T::W / 2], acc_k[T::W / 2];                 // dv; dk / scale
#pragma unroll
    for (int i = 0; i < T::W / 2; ++i) acc_v[i] = acc_k[i] = 0.f;

    if (n_pass > 0) mbar_wait(kvbar, 0);
    for (int p = 0; p < n_pass; ++p) {
        const int stage = p % STAGES, q0 = q0_of(p);
        const uint32_t Qt = Qs + stage * T::BYTES, Dt = Ds + stage * T::BYTES;
        const float* st = stats + stage * 2 * BQ;
        mbar_wait(full(stage), (p / STAGES) & 1);

        float s[32], dp[32];                                // S^T, dP^T
        wgmma_fence();
        rows_by_rows<HD>(s, Ks, Qt);
        rows_by_rows<HD>(dp, Vs, Dt);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(s);
        reg_fence(dp);

        const bool whole = whole_tiles(q0, k0, T_len, S_len, causal, window, q_offset);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {                   // P^T = exp(S^T scale - lse)
                const int i = ic + 8 * n + (e & 1);
                float x = exp2f(fmaf(s[4 * n + e], scale_log2, -st[i] * LOG2E));
                if (!whole && !visible(q0 + i, k0 + jr + 8 * (e >> 1), T_len, S_len, causal,
                                       window, q_offset))
                    x = 0.f;
                s[4 * n + e] = x;
            }
#pragma unroll
        for (int n = 0; n < 8; ++n) {                       // dS^T = P^T (dP^T - D)
            const float d0 = st[BQ + ic + 8 * n], d1 = st[BQ + ic + 8 * n + 1];
            dp[4 * n] = s[4 * n] * (dp[4 * n] - d0);
            dp[4 * n + 1] = s[4 * n + 1] * (dp[4 * n + 1] - d1);
            dp[4 * n + 2] = s[4 * n + 2] * (dp[4 * n + 2] - d0);
            dp[4 * n + 3] = s[4 * n + 3] * (dp[4 * n + 3] - d1);
        }

        uint32_t a_p[4][4], a_ds[4][4];                     // P^T, dS^T in bf16
        to_a_frag(a_p, s);
        to_a_frag(a_ds, dp);
        reg_fence(acc_v);
        reg_fence(acc_k);
        wgmma_fence();
        frag_by_tile<HD>(acc_v, a_p, Dt);                   // dV += P^T dO
        frag_by_tile<HD>(acc_k, a_ds, Qt);                  // dK += dS^T Q
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(acc_v);
        reg_fence(acc_k);

        cp_async_wait_all();                                // pass p + 1's stats landed
        __syncthreads();                                    // every warp left this stage
        if (p + STAGES < n_pass) {
            if (tid == 0) load_pass(stage, p + STAGES);
            load_stats(stage, p + STAGES);
            cp_async_commit();
        }
    }

    // dK and dV into the K and V tiles (no longer read), then out by TMA
    tile_from_frag<HD>(Ks, acc_k, scale, jr, ic);
    tile_from_frag<HD>(Vs, acc_v, 1.f, jr, ic);
    fence_async_shared();
    __syncthreads();
    if (tid == 0) {
        store_tile<HD>(&dkmap, Ks, kvh, k0, b);
        store_tile<HD>(&dvmap, Vs, kvh, k0, b);
        tma_store_commit_wait_read();
    }
}

template <int HD>
__global__ void __launch_bounds__(WG, Tile<HD>::DQ_BLOCKS)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap dmap,
                         const __grid_constant__ CUtensorMap dqmap,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int T_len, int S_len, int H, int KV,
                         int causal, int window, int q_offset, float scale) {
    using T = Tile<HD>;
    using L = DqSmem<HD>;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t Qs = base + L::q, Ds = base + L::dout, Ks = base + L::k, Vs = base + L::v;
    const uint32_t qbar = base + L::bar;
    auto full = [&](int s) { return qbar + 8 * (1 + s); };

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / (H / KV);
    const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
    const int q0 = qt * BQ;

    // The key tiles that a row of this tile sees: [kt_begin, kt_end).
    const int n_kt = (S_len + BK - 1) / BK;
    const int q_first = q0 + q_offset, q_last = min(q0 + BQ, T_len) - 1 + q_offset;
    int kt_end = n_kt, kt_begin = 0;
    if (causal) kt_end = q_last < 0 ? 0 : min(n_kt, q_last / BK + 1);
    if (window > 0) kt_begin = max(0, (q_first - window + 1) / BK);

    auto load_kv = [&](int stage, int kt) {
        mbar_expect_tx(full(stage), 2 * T::BYTES);
        load_tile<HD>(Ks + stage * T::BYTES, &kmap, full(stage), kvh, kt * BK, b);
        load_tile<HD>(Vs + stage * T::BYTES, &vmap, full(stage), kvh, kt * BK, b);
    };
    if (tid == 0) {
        mbar_init(qbar, 1);
        for (int s = 0; s < STAGES; ++s) mbar_init(full(s), 1);
        mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0) {
        mbar_expect_tx(qbar, 2 * T::BYTES);
        load_tile<HD>(Qs, &qmap, qbar, h, q0, b);
        load_tile<HD>(Ds, &dmap, qbar, h, q0, b);
        for (int s = 0; s < STAGES && kt_begin + s < kt_end; ++s) load_kv(s, kt_begin + s);
    }

    // This thread's two rows (block-local r0 and r0 + 8), their lse in log2
    // units (+inf past T: P = 0) and D.
    const int r0 = warp * 16 + (lane >> 2), col = 2 * (lane & 3);
    const bool v0 = q0 + r0 < T_len, v1 = q0 + r0 + 8 < T_len;
    const long long srow = (static_cast<long long>(b) * H + h) * T_len + q0 + r0;
    const float l0 = v0 ? lse[srow] * LOG2E : CUDART_INF_F;
    const float l1 = v1 ? lse[srow + 8] * LOG2E : CUDART_INF_F;
    const float d0 = v0 ? delta[srow] : 0.f, d1 = v1 ? delta[srow + 8] : 0.f;
    const float scale_log2 = scale * LOG2E;

    float acc[T::W / 2];
#pragma unroll
    for (int i = 0; i < T::W / 2; ++i) acc[i] = 0.f;

    mbar_wait(qbar, 0);
    for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
        const int stage = it % STAGES, k0 = kt * BK;
        const uint32_t Kt = Ks + stage * T::BYTES, Vt = Vs + stage * T::BYTES;
        mbar_wait(full(stage), (it / STAGES) & 1);

        float s[32], dp[32];
        wgmma_fence();
        rows_by_rows<HD>(s, Qs, Kt);                        // S = Q K^T
        rows_by_rows<HD>(dp, Ds, Vt);                       // dP = dO V^T
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(s);
        reg_fence(dp);

        const bool whole = whole_tiles(q0, k0, T_len, S_len, causal, window, q_offset);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool lo = e < 2;
                float pr = exp2f(fmaf(s[4 * i + e], scale_log2, -(lo ? l0 : l1)));
                if (!whole && !visible(q0 + r0 + (lo ? 0 : 8), k0 + 8 * i + col + (e & 1),
                                       T_len, S_len, causal, window, q_offset))
                    pr = 0.f;
                s[4 * i + e] = pr * (dp[4 * i + e] - (lo ? d0 : d1));
            }

        uint32_t a[4][4];                                   // dS in bf16
        to_a_frag(a, s);
        reg_fence(acc);
        wgmma_fence();
        frag_by_tile<HD>(acc, a, Kt);                       // dQ += dS K
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(acc);
        __syncthreads();                                    // every warp left this stage
        if (tid == 0 && kt + STAGES < kt_end) load_kv(stage, kt + STAGES);
    }

    if constexpr (T::TMA_STORE) {                           // dQ into Q's tile, then by TMA
        tile_from_frag<HD>(Qs, acc, scale, r0, col);
        fence_async_shared();
        __syncthreads();
        if (tid == 0) {
            store_tile<HD>(&dqmap, Qs, h, q0, b);
            tma_store_commit_wait_read();
        }
        return;
    }
    const long long row_stride = static_cast<long long>(H) * HD;
    __nv_bfloat16* o0 = dq + (static_cast<long long>(b) * T_len + q0 + r0) * row_stride + h * HD;
    __nv_bfloat16* o1 = o0 + 8 * row_stride;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
        if (v0)
            *reinterpret_cast<uint32_t*>(o0 + 8 * i + col) =
                pack_bf16(acc[4 * i] * scale, acc[4 * i + 1] * scale);
        if (v1)
            *reinterpret_cast<uint32_t*>(o1 + 8 * i + col) =
                pack_bf16(acc[4 * i + 2] * scale, acc[4 * i + 3] * scale);
    }
}

// The dk/dv kernel that head dim HD launches, its threads and shared memory.
template <int HD>
struct Dkdv {
    static auto kernel() {
        if constexpr (Tile<HD>::ONE_WG) return flash_bwd_dkdv_sm90_kernel_one_wg<HD>;
        else return flash_bwd_dkdv_sm90_kernel<HD>;
    }
    static constexpr int threads = Tile<HD>::ONE_WG ? WG : 2 * WG;
    static constexpr int bytes = Tile<HD>::ONE_WG ? DkdvOneSmem<HD>::bytes : DkdvSmem<HD>::bytes;
};

template <int HD>
cudaError_t set_smem() {
    cudaError_t err = cudaFuncSetAttribute(Dkdv<HD>::kernel(),
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Dkdv<HD>::bytes);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(flash_bwd_dq_sm90_kernel<HD>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   DqSmem<HD>::bytes);
    return err;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* o_lo,
           const float* lse, const void* dout, void* dq, void* dk, void* dv, float* delta, int B,
           int T_len, int S_len, int H, int KV, int causal, int window, int q_offset, float scale,
           cudaStream_t s) {
    using T = Tile<HD>;
    CUtensorMap qmap, kmap, vmap, dmap, dqmap, dkmap, dvmap;
    if (!make_map(&qmap, q, B, T_len, H, HD, BQ, T::ATOM, T::SW) ||
        !make_map(&kmap, k, B, S_len, KV, HD, BK, T::ATOM, T::SW) ||
        !make_map(&vmap, v, B, S_len, KV, HD, BK, T::ATOM, T::SW) ||
        !make_map(&dmap, dout, B, T_len, H, HD, BQ, T::ATOM, T::SW) ||
        !make_map(&dqmap, dq, B, T_len, H, HD, BQ, T::ATOM, T::SW) ||
        !make_map(&dkmap, dk, B, S_len, KV, HD, BK, T::ATOM, T::SW) ||
        !make_map(&dvmap, dv, B, S_len, KV, HD, BK, T::ATOM, T::SW))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = set_smem<HD>();
    if (err != cudaSuccess) return static_cast<int>(err);
    auto bf = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
    auto wbf = [](void* p) { return static_cast<__nv_bfloat16*>(p); };
    const long long n_rows = static_cast<long long>(B) * T_len * H;
    constexpr int rows_per_block = DELTA_NT / 32;
    flash_bwd_delta_kernel<HD><<<static_cast<unsigned>((n_rows + rows_per_block - 1) /
                                                       rows_per_block),
                                 DELTA_NT, 0, s>>>(bf(o), bf(o_lo), bf(dout), delta, n_rows,
                                                   T_len, H);
    const dim3 kv_grid(B * KV, (S_len + BK - 1) / BK);
    if constexpr (Tile<HD>::ONE_WG)
        flash_bwd_dkdv_sm90_kernel_one_wg<HD><<<kv_grid, WG, DkdvOneSmem<HD>::bytes, s>>>(
            qmap, kmap, vmap, dmap, dkmap, dvmap, lse, delta, T_len, S_len, H, KV, causal,
            window, q_offset, scale);
    else
        flash_bwd_dkdv_sm90_kernel<HD><<<kv_grid, 2 * WG, DkdvSmem<HD>::bytes, s>>>(
            qmap, kmap, vmap, dmap, lse, delta, wbf(dk), wbf(dv), T_len, S_len, H, KV, causal,
            window, q_offset, scale);
    const dim3 q_grid(B * H, (T_len + BQ - 1) / BQ);
    flash_bwd_dq_sm90_kernel<HD><<<q_grid, WG, DqSmem<HD>::bytes, s>>>(
        qmap, kmap, vmap, dmap, dqmap, lse, delta, wbf(dq), T_len, S_len, H, KV, causal, window,
        q_offset, scale);
    return static_cast<int>(cudaGetLastError());
}

template <int HD>
int occupancy(int* out) {
    cudaError_t err = set_smem<HD>();
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, Dkdv<HD>::kernel(),
                                                            Dkdv<HD>::threads, Dkdv<HD>::bytes);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, flash_bwd_dq_sm90_kernel<HD>,
                                                            WG, DqSmem<HD>::bytes);
    cudaFuncAttributes dkdv, dq;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&dkdv, Dkdv<HD>::kernel());
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&dq, flash_bwd_dq_sm90_kernel<HD>);
    out[0] = Dkdv<HD>::bytes;
    out[2] = DqSmem<HD>::bytes;
    if (err == cudaSuccess) {
        out[4] = dkdv.numRegs;
        out[5] = static_cast<int>(dkdv.localSizeBytes);
        out[6] = dq.numRegs;
        out[7] = static_cast<int>(dq.localSizeBytes);
    }
    return static_cast<int>(err);
}

}  // namespace

// q, o, dout, dq: [B,T,H,hd]; k, v, dk, dv: [B,S,KV,hd]; all contiguous
// bf16, 16-byte aligned; o_lo: O's rounding residual from the forward, same
// shape (D reads o + o_lo); lse (from the forward) and delta (scratch):
// fp32 [B,H,T].
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* o, const void* o_lo, const void* lse,
                                        const void* dout, void* dq, void* dk, void* dv,
                                        void* delta, int B, int T_len, int S_len, int H, int KV,
                                        int hd, int causal, int window, int q_offset,
                                        float scale, void* stream) {
    if (B <= 0 || T_len <= 0 || S_len <= 0 || KV <= 0 || H % KV != 0 || B * H > 65535 ||
        (T_len + BQ - 1) / BQ > 65535 || (S_len + BK - 1) / BK > 65535 || o_lo == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    auto l = static_cast<const float*>(lse);
    auto d = static_cast<float*>(delta);
    auto s = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 32: return launch<32>(q, k, v, o, o_lo, l, dout, dq, dk, dv, d, B, T_len, S_len, H, KV,
                                   causal, window, q_offset, scale, s);
        case 64: return launch<64>(q, k, v, o, o_lo, l, dout, dq, dk, dv, d, B, T_len, S_len, H, KV,
                                   causal, window, q_offset, scale, s);
        case 80: return launch<80>(q, k, v, o, o_lo, l, dout, dq, dk, dv, d, B, T_len, S_len, H, KV,
                                   causal, window, q_offset, scale, s);
        case 128: return launch<128>(q, k, v, o, o_lo, l, dout, dq, dk, dv, d, B, T_len, S_len, H,
                                     KV, causal, window, q_offset, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// out[0..3] = dynamic shared memory of the dk/dv kernel (bytes), its blocks
// per SM, the same two of the dq kernel, at head dim hd; out[4..7] =
// registers a thread and local (spill) bytes a thread of the dk/dv kernel,
// then of the dq kernel.
extern "C" int flash_attention_bwd_bf16_occupancy(int hd, int* out) {
    switch (hd) {
        case 32: return occupancy<32>(out);
        case 64: return occupancy<64>(out);
        case 80: return occupancy<80>(out);
        case 128: return occupancy<128>(out);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
