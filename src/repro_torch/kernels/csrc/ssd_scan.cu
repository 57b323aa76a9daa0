// SSD linear recurrence (Mamba-2 / mLSTM) for Hopper in chunked (matrix)
// form, with state in and out and an optional normalizer chain.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::_ssd_kernel
// (wrapper `ssd_scan`, pallas_call at ssd_scan.py:82). Same recurrence, per
// (batch, head), decays in log space, B and C read per group (G groups,
// head h reads group h / (H/G), as jnp.repeat expands them):
//
//     S_t = exp(a_t) * S_{t-1} + B_t (x) x_t        S: [N, P], fp32
//     y_t = C_t . S_t                               y: [P]
//
// and beyond the TPU kernel, which starts from zero and keeps its state: an
// initial state S_0, the final state S_T written out (prefill hands it to
// decode), any T (the TPU wrapper asserts T % chunk == 0; the engine prefills
// at the exact prompt length), and the mLSTM normalizer n_t = C_t . Sn_t,
// Sn_t = exp(a_t) Sn_{t-1} + w_t B_t, which is the same recurrence with one
// column whose input is w.
//
// Like the TPU kernel it walks time in chunks of L = kChunk = 64 steps.
// With a_cum the in-chunk cumulative log decay and a_tot its last value:
//
//     M[i, j] = (C_i . B_j) exp(a_cum_i - a_cum_j)  for i >= j, else 0
//     y       = exp(a_cum) * (C . S_old) + M . X
//     S_new   = exp(a_tot) S_old + B^T . (X * exp(a_tot - a_cum))
//
// All in fp32 FMAs on the CUDA cores: no tensor cores and no split of fp32
// into narrower parts; only the order of the sums differs from the
// sequential recurrence. Two choices keep the result at least as close to
// the exact recurrence as the sequential fp32 one: each decay exponent is a
// sum of a over exactly the steps it spans, in order (never the difference
// of two 64-step cumulative sums, whose rounding is that of the larger), and
// the products' long sums (C_i . B_j above all) are summed in blocks.
//
// Two paths, chosen by shape and arguments alone (the wrapper's `path`):
//
// * The chunk-parallel path (ssd_scan_chunks_fwd) for states a block holds
//   whole, N <= 64 and P <= 64, without the normalizer: Mamba-2's 64 x 64
//   (zamba2: b=1, H=80, one group). There the ordered walk below gives a
//   head 2 blocks of 32 columns, 160 blocks in all, each walking 16 chunks
//   through 8 staged rounds of barriers and L2 round trips, and its intra
//   kernel takes C . B^T again for each of the 80 heads of one group
//   (0.3433 ms at T=1000 on an H100, 7% of its bound). Here the chunks run
//   in parallel and only the chunk-to-chunk carry is ordered:
//     (a) ssd_scan_chunk_state_kernel, one block per (chunk, batch*group):
//         CB = C . B^T [64 x 64] once per group; and one per (chunk,
//         batch*head): dS = B^T . (X * exp(a_tot - a_cum)) [N x P] and
//         exp(a_tot);
//     (b) ssd_scan_chunk_pass_kernel, per (batch*head), 4 state values a
//         thread: S_c = exp(a_tot,c) S_{c-1} + dS_c from S_0, writing
//         S_{c-1} over dS_c and S_T to s1; 8 chunks' loads in flight;
//     (c) ssd_scan_chunk_out_kernel, one block per (chunk, batch*head):
//         M from CB and the segment sums, then y = exp(a_cum) * (C . S_prev)
//         + M . X, causal (row i reads M[i][0..i] rounded up to 8), C .
//         S_prev's operands waited for first.
//   The workspace (dS, then S_prev, 16 KiB per head and chunk at 64 x 64;
//   CB per group and chunk; exp(a_tot)) is the wrapper's; T=1000 at zamba2's
//   shape takes 1296 + 640 + 1280 blocks. Every output has one owner and no
//   atomics, so two calls give the same bits. Each block of (a) and (c)
//   holds its operands in fp32 in shared memory (fp32 rows by cp.async,
//   bf16 widened on load; zeros past T, N and P); its threads each own a
//   4 x 8 ((a), 128 threads) or 4 x 4 ((c), 256 threads) tile of a 64 x 64
//   product, one float4 from shared memory feeding 4 to 8 FMAs, and sums of
//   8 products join each total in order. The scratch goes with L2 policies:
//   dS and S_prev evict-last (read by the next pass), x, S_prev's last read
//   and y evict-first. Bound: operations, ~4 N P flops per step and head
//   (B and C read per group, the bytes are below). Measured on an H100:
//   0.1034 ms at T=1000, 19% of that bound, 3.3x the walk at this shape;
//   pass (c) takes ~59% of it, its four 64 x 64 tiles (70 KB) leaving 3
//   blocks an SM, and the scratch's trips through L2 and HBM most of the
//   rest. The threshold is the shape at which a block holds the state: at
//   the grid shapes of 8 to 16 state rows this path took 0.016-0.017 ms
//   against the walk's 0.017-0.054; mLSTM's 512 x 1024 state (2 MiB a
//   head) stays on the walk, unchanged.
//
// * The ordered walk (ssd_scan_fwd), every other shape: mLSTM's N = 512,
//   P = 1024 (a head's state is 2 MiB, far beyond an SM's 227 KB) and the
//   normalizer. Two kernels per call. ssd_scan_intra_kernel computes M,
//   exp(a_cum) and exp(a_tot - a_cum) once per (batch*head, chunk) into a
//   workspace the wrapper allocates (L*(L+2) fp32 per chunk), one block per
//   16 x 16 tile of M; the exponent is taken only where i >= j, so no inf
//   meets a zero. ssd_scan_kernel then owns one (batch*head, 32-column tile)
//   per block, plus one normalizer tile of width 1 per (batch, head), and
//   walks the chunks in order with its [N, 32] slice of the state in
//   registers: 4 x 33 blocks at b=1, H=4, P=1024, one wave on 132 SMs. Warp
//   w holds state rows [w*N/8, (w+1)*N/8); within a warp, four groups of 8
//   lanes split those rows and each lane holds 4 columns, so each value read
//   from shared memory feeds 16 FMAs.
//
//   Per chunk, C and then B stream through shared memory in stages of
//   kRows = 16 steps x N (32 KiB in fp32 at N = 512; a whole chunk of both
//   is 256 KiB), double-buffered with cp.async: the next stage's copy is in
//   flight while this one computes. bf16 inputs are copied as they are and
//   widened to fp32 where they are read. A C stage adds each warp's share of
//   C . S_old for its 16 steps (16 x 4 independent sums per lane, combined
//   across the lane groups by shuffles) into a per-warp partial in shared
//   memory. Before the first B stage the state is scaled by exp(a_tot); each
//   B stage then adds B_j x_j exp(a_tot - a_cum_j). At the end of the chunk
//   the 8 warps' partials are summed, scaled by exp(a_cum) and M . X is
//   added (M from L2 through shared memory); rows past T are not stored.
//   The last chunk is padded with decay 1, B = C = 0 and x = 0, so the final
//   state is the state at T, and its stages that hold only padding are
//   skipped. Bound: operations, ~4 N P flops per step and head on state
//   values that stay on chip; every column tile also reads its group's B
//   and C from L2 (bytes against HBM are far below both).

#include "common.cuh"

namespace {

constexpr int kChunk = 64;                    // L: time steps per chunk
constexpr int kRows = 16;                     // time steps of a staged B or C
constexpr int kCStages = kChunk / kRows;      // C stages, then as many B stages
constexpr int kStages = 2 * kCStages;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;                     // state columns per block
constexpr int kColsPerLane = 4;               // at most; see cols_per_lane
constexpr int kBuf = 2;                       // stage buffers: one copy in flight
constexpr int kWs = kChunk * (kChunk + 2);    // workspace floats per chunk: M, exp(a_cum), decay to end
constexpr int kMTile = 16;                    // M tile of one intra block: 16 x 16
constexpr int kMTiles = kChunk / kMTile;
static_assert(kBuf >= 2 && kBuf - 1 <= kCStages,
              "M and the decays of a chunk come with its stage kBuf - 1, before its B stages");
static_assert(kChunk % kWarps == 0 && kMTile * kMTile == kThreads, "one M entry per thread");

template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int N) {
    return kBuf * kRows * static_cast<size_t>(N) * sizeof(T)   // B / C stages
           + sizeof(float) * (kWarps * kChunk * kTile          // partial C . S_old
                              + kWs                            // M, decays
                              + kChunk * kTile);               // x
}

// ---- cp.async (16 bytes; src_bytes 0 writes zeros) ----
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// L2 cache policies: 0 none, 1 evict first (read or written once), 2 evict
// last (read again by the next kernel)
__device__ __forceinline__ unsigned long long l2_policy(int hint) {
    unsigned long long p;
    if (hint == 1)
        asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
    else
        asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
    return p;
}
__device__ __forceinline__ void cp_async16_hint(void* smem, const void* gmem, bool ok,
                                                unsigned long long pol) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(s),
                 "l"(gmem), "r"(ok ? 16 : 0), "l"(pol));
}
__device__ __forceinline__ void st4_hint(float* p, float a, float b, float c, float d,
                                         unsigned long long pol) {
    asm volatile("st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(p),
                 "f"(a), "f"(b), "f"(c), "f"(d), "l"(pol) : "memory");
}
__device__ __forceinline__ float4 ld4_hint(const float* p, unsigned long long pol) {
    float4 v;
    asm volatile("ld.global.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p), "l"(pol));
    return v;
}

// V consecutive values from shared memory as fp32
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[V]) {
    if constexpr (V == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    } else if constexpr (V == 2) {
        const float2 v = *reinterpret_cast<const float2*>(p);
        out[0] = v.x; out[1] = v.y;
    } else {
        out[0] = *p;
    }
}
__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }
template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&out)[V]) {
    if constexpr (V == 4) {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        out[0] = bf16_lo(u.x); out[1] = bf16_hi(u.x); out[2] = bf16_lo(u.y); out[3] = bf16_hi(u.y);
    } else if constexpr (V == 2) {
        const unsigned u = *reinterpret_cast<const unsigned*>(p);
        out[0] = bf16_lo(u); out[1] = bf16_hi(u);
    } else {
        out[0] = __bfloat162float(*p);
    }
}

// Sum of the log decays a[j+1 .. i], in order (exact exponent of the decay
// from step j to step i: no difference of two long cumulative sums).
__device__ __forceinline__ float seg_sum(const float* a, int j, int i) {
    float s = 0.f;
    for (int k = j + 1; k <= i; ++k) s += a[k];
    return s;
}

// Shared memory of the intra kernel: a, the 16 groups' partial tiles, then
// 16 rows of C and 16 of B, whole rows of N, each padded by 16 bytes so
// that the rows start on different banks.
template <typename T>
__host__ __device__ constexpr int intra_ld(int N) { return N + 16 / static_cast<int>(sizeof(T)); }
template <typename T>
__host__ __device__ constexpr size_t intra_smem_bytes(int N) {
    return sizeof(float) * (kChunk + kThreads * kMTile)    // a, 16 partial tiles
           + 2 * kMTile * static_cast<size_t>(intra_ld<T>(N)) * sizeof(T);
}

// One 16 x 16 tile of M for one (batch*head, chunk): blockIdx.x =
// batch*head, blockIdx.y = chunk, blockIdx.z = tile (row tile, column
// tile); thread (ti, tj) writes M[i, j]. Tiles above the diagonal are
// zeros. Tile 0 also writes exp(a_cum_i) (a_cum_i the sum of a[0..i]) and
// the decays to the chunk's end, exp(sum of a[j+1 .. L-1]). The tile's 16
// rows of C and of B come in whole, in one round of cp.async.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_intra_kernel(const float* __restrict__ a, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, float* __restrict__ ws, int T_len, int H,
                      int G, int N) {
    extern __shared__ __align__(16) unsigned char intra_raw[];
    float* a_s = reinterpret_cast<float*>(intra_raw);          // [kChunk]
    float* red = a_s + kChunk;                                 // [16][kMTile][kMTile]
    T* c_s = reinterpret_cast<T*>(red + kThreads * kMTile);    // [kMTile][ldr]
    const int ldr = intra_ld<T>(N);
    T* b_s = c_s + kMTile * ldr;                               // [kMTile][ldr]

    const int tid = threadIdx.x, bh = blockIdx.x, bi = bh / H, h = bh % H;
    const int t0 = blockIdx.y * kChunk;
    const int it = blockIdx.z / kMTiles, jt = blockIdx.z % kMTiles;
    const int ti = tid / kMTile, tj = tid % kMTile;
    const int i = it * kMTile + ti, j = jt * kMTile + tj;
    float* out = ws + (static_cast<long long>(bh) * gridDim.y + blockIdx.y) * kWs;
    // a tile above the diagonal, or whose rows are all past T, is zeros
    // (rows past T give outputs that are never stored)
    const bool live = jt <= it && it * kMTile < T_len - t0;

    if (live) {
        constexpr int E = 16 / sizeof(T);
        const int per_row = N / E;
        const long long bc0 = (static_cast<long long>(bi) * T_len * G + h / (H / G)) * N;
        const long long ldbc = static_cast<long long>(G) * N;
        for (int k = tid; k < 2 * kMTile * per_row; k += kThreads) {
            const int rr = k / per_row, q = k - rr * per_row;
            const bool is_b = rr >= kMTile;
            const int r = is_b ? rr - kMTile : rr;
            const int t = t0 + (is_b ? jt : it) * kMTile + r;
            const bool ok = t < T_len;
            cp_async16((is_b ? b_s : c_s) + r * ldr + q * E,
                       (is_b ? Bm : Cm) + bc0 + (ok ? t : 0) * ldbc + q * E, ok);
        }
        cp_async_commit();
    }
    if (tid < kChunk)
        a_s[tid] = t0 + tid < T_len ? a[(static_cast<long long>(bi) * T_len + t0 + tid) * H + h]
                                    : 0.f;   // padding: decay 1
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    if (blockIdx.z == 0 && tid < kChunk) {
        out[kChunk * kChunk + tid] = expf(seg_sum(a_s, -1, tid));
        out[kChunk * kChunk + kChunk + tid] = expf(seg_sum(a_s, tid, kChunk - 1));
    }
    if (!live) {
        out[i * kChunk + j] = 0.f;
        return;
    }
    // C_i . B_j: 16 groups of 16 threads each sum every 16th quad of n for a
    // 4 x 4 block of the tile; the groups' sums are then added in order.
    // Blocked so, the sum carries far less rounding than one 512-long chain,
    // which would carry several times the sequential recurrence's own.
    {
        const int kg = tid / kMTile, mi = (tid % kMTile) / 4, mj = tid % 4;
        float acc[4][4] = {};
        for (int n = 4 * kg; n < N; n += 4 * kMTile) {
            float cv[4][4], bv[4][4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                load_vec<4>(c_s + (mi * 4 + r) * ldr + n, cv[r]);
                load_vec<4>(b_s + (mj * 4 + r) * ldr + n, bv[r]);
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c)
#pragma unroll
                    for (int u = 0; u < 4; ++u) acc[r][c] = fmaf(cv[r][u], bv[c][u], acc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
                red[(kg * kMTile + mi * 4 + r) * kMTile + mj * 4 + c] = acc[r][c];
    }
    __syncthreads();
    float acc = 0.f;
#pragma unroll
    for (int kg = 0; kg < kMTile; ++kg) acc += red[kg * kThreads + tid];
    // the exponent only where i >= j: above it the decay would overflow
    out[i * kChunk + j] = i >= j ? acc * expf(seg_sum(a_s, j, i)) : 0.f;
}

// One stage: kRows time steps of B or C (rows past T are zeros).
template <typename T>
__device__ __forceinline__ void load_stage(T* dst, const T* src, long long ldbc, int t0,
                                           int T_len, int N, int tid) {
    constexpr int E = 16 / sizeof(T);
    const int per_row = N / E;
    for (int i = tid; i < kRows * per_row; i += kThreads) {
        const int r = i / per_row, q = i - r * per_row;
        const bool ok = t0 + r < T_len;
        cp_async16(dst + r * N + q * E, src + (ok ? t0 + r : 0) * ldbc + q * E, ok);
    }
}

// Columns per lane: the warp's state rows are split into G groups of
// lanes, each lane holding G columns, so that each value read from shared
// memory feeds V * G FMAs.
__host__ __device__ constexpr int vec_width(int npw) { return npw >= 4 ? 4 : npw; }
__host__ __device__ constexpr int cols_per_lane(int npw) {
    return npw / vec_width(npw) >= kColsPerLane ? kColsPerLane : npw / vec_width(npw);
}

// Sums v over the G lane groups (lanes g * 32/G + c); afterwards v[0] of
// group g holds the sum of column g.
template <int G>
__device__ __forceinline__ float reduce_scatter(float (&v)[G], int g) {
#pragma unroll
    for (int half = G / 2; half >= 1; half /= 2) {
        const bool hi = (g / half) & 1;
#pragma unroll
        for (int q = 0; q < half; ++q) {
            const float send = hi ? v[q] : v[q + half];
            const float keep = hi ? v[q + half] : v[q];
            v[q] = keep + __shfl_xor_sync(0xffffffffu, send, half * (32 / G));
        }
    }
    return v[0];
}

// T: element type of x, y, B and C. NPW = N / kWarps state rows per warp.
// blockIdx.x = batch*head; blockIdx.y = column tile, the last one (when w is
// given) being the normalizer chain. Lane (g, c) of a warp holds rows
// r0 + (m*G + g)*V + v, m < NPW/(V*G), v < V, of columns c*G + q, q < G.
template <typename T, int NPW>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ ws, const float* __restrict__ s0, T* __restrict__ y,
                float* __restrict__ s1, const float* __restrict__ w,
                const float* __restrict__ n0, float* __restrict__ n_out,
                float* __restrict__ n1, int T_len, int H, int groups, int P,
                int n_tiles) {
    constexpr int N = NPW * kWarps;
    constexpr int V = vec_width(NPW);
    constexpr int G = cols_per_lane(NPW);
    constexpr int MC = NPW / (V * G);           // row vectors per lane
    constexpr int kXPerThread = kChunk * kTile / kThreads;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* stage = reinterpret_cast<T*>(smem_raw);                            // [kBuf][kRows][N]
    float* part = reinterpret_cast<float*>(stage + kBuf * kRows * N);     // [kWarps][kChunk][kTile]
    float* m_s = part + kWarps * kChunk * kTile;                          // [kChunk][kChunk]
    float* ecum = m_s + kChunk * kChunk;                                  // [kChunk] exp(a_cum)
    float* dec = ecum + kChunk;                                           // [kChunk] exp(a_tot - a_cum)
    float* x_s = m_s + kWs;                                               // [kChunk][kTile]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane / (32 / G), c0 = (lane % (32 / G)) * G;   // row group, first column
    const int bh = blockIdx.x, bi = bh / H, h = bh % H;
    const bool norm = blockIdx.y == n_tiles;    // the normalizer column
    const int p0 = norm ? 0 : blockIdx.y * kTile;
    const int cols = norm ? 1 : min(kTile, P - p0);
    // x / y element (t, c) of this block: base + t * ld + c; state row n: n * lds + c
    const long long ld = norm ? H : static_cast<long long>(H) * P;
    const long long xy0 = norm ? static_cast<long long>(bi) * T_len * H + h
                               : (static_cast<long long>(bi) * T_len * H + h) * P + p0;
    const long long lds = norm ? 1 : P;
    const long long st0 = norm ? static_cast<long long>(bh) * N
                               : static_cast<long long>(bh) * N * P + p0;
    const float* init = norm ? n0 : s0;
    float* fin = norm ? n1 : s1;
    const long long ldbc = static_cast<long long>(groups) * N;
    const long long bc0 =
        (static_cast<long long>(bi) * T_len * groups + h / (H / groups)) * N;
    const T* b_src = Bm + bc0;
    const T* c_src = Cm + bc0;
    const int n_chunks = (T_len + kChunk - 1) / kChunk;
    const float* ws_bh = ws + static_cast<long long>(bh) * n_chunks * kWs;
    const int r0 = warp * NPW;                  // this warp's first state row

    // S[(m*V + v)*G + q]: row r0 + (m*G + g)*V + v, column c0 + q
    float S[NPW];
#pragma unroll
    for (int m = 0; m < MC; ++m)
#pragma unroll
        for (int v = 0; v < V; ++v)
#pragma unroll
            for (int q = 0; q < G; ++q) {
                const int row = r0 + (m * G + g) * V + v, col = c0 + q;
                S[(m * V + v) * G + q] =
                    (init != nullptr && col < cols) ? init[st0 + row * lds + col] : 0.f;
            }

    // x (or w) of a chunk, kXPerThread values per thread, zeros past T or cols
    float xr[kXPerThread];
    auto load_x = [&](int t0) {
#pragma unroll
        for (int k = 0; k < kXPerThread; ++k) {
            const int i = tid + k * kThreads, r = i / kTile, c = i % kTile;
            float v = 0.f;
            if (t0 + r < T_len && c < cols) {
                const long long gi = xy0 + (t0 + r) * ld + c;
                v = norm ? w[gi] : to_float(x[gi]);
            }
            xr[k] = v;
        }
    };

    // Stage gs of the whole walk: chunk gs / kStages, step s = gs % kStages:
    // C rows for s < kCStages, then B rows; buffer gs % kBuf. Stage
    // kBuf - 1 of a chunk also brings the chunk's M and decays (issued once
    // the previous chunk's y no longer reads them).
    const int n_stages = n_chunks * kStages;
    auto issue = [&](int gs) {
        if (gs >= n_stages) return;
        const int ch = gs / kStages, s = gs % kStages;
        load_stage(stage + (gs % kBuf) * kRows * N, s < kCStages ? c_src : b_src, ldbc,
                   ch * kChunk + (s % kCStages) * kRows, T_len, N, tid);
        if (s == kBuf - 1) {
            const float* src = ws_bh + static_cast<long long>(ch) * kWs;
            for (int i = tid; i < kWs / 4; i += kThreads) cp_async16(m_s + 4 * i, src + 4 * i, true);
        }
    };
#pragma unroll
    for (int gs = 0; gs < kBuf - 1; ++gs) {
        issue(gs);
        cp_async_commit();
    }
    load_x(0);

    for (int ch = 0; ch < n_chunks; ++ch) {
        const int t0 = ch * kChunk;
#pragma unroll
        for (int k = 0; k < kXPerThread; ++k) x_s[tid + k * kThreads] = xr[k];
        if (ch + 1 < n_chunks) load_x(t0 + kChunk);   // in flight through the chunk

        for (int s = 0; s < kStages; ++s) {
            const int gs = ch * kStages + s;
            issue(gs + kBuf - 1);
            cp_async_commit();
            asm volatile("cp.async.wait_group %0;\n" ::"n"(kBuf - 1));
            __syncthreads();

            const T* cur = stage + (gs % kBuf) * kRows * N + r0 + g * V;
            if (t0 + (s % kCStages) * kRows >= T_len) {
                // padding only: C rows whose outputs are not stored, B rows of zeros
            } else if (s < kCStages) {
                // ---- partial C . S_old over this warp's state rows ----
                float acc[kRows][G];
#pragma unroll
                for (int ii = 0; ii < kRows; ++ii)
#pragma unroll
                    for (int q = 0; q < G; ++q) acc[ii][q] = 0.f;
#pragma unroll
                for (int m = 0; m < MC; ++m) {
#pragma unroll
                    for (int ii = 0; ii < kRows; ++ii) {
                        float cv[V];
                        load_vec<V>(cur + ii * N + m * G * V, cv);
#pragma unroll
                        for (int v = 0; v < V; ++v)
#pragma unroll
                            for (int q = 0; q < G; ++q)
                                acc[ii][q] = fmaf(cv[v], S[(m * V + v) * G + q], acc[ii][q]);
                    }
                }
                float* pw = part + (warp * kChunk + s * kRows) * kTile + c0 + g;
#pragma unroll
                for (int ii = 0; ii < kRows; ++ii) pw[ii * kTile] = reduce_scatter<G>(acc[ii], g);
            } else {
                // ---- state update: S = exp(a_tot) S + sum_j B_j x_j exp(a_tot - a_cum_j) ----
                if (s == kCStages) {
                    const float e = ecum[kChunk - 1];
#pragma unroll
                    for (int i = 0; i < NPW; ++i) S[i] *= e;
                }
                const int j0 = (s - kCStages) * kRows;
#pragma unroll 2
                for (int jj = 0; jj < kRows; ++jj) {
                    const float d = dec[j0 + jj];
                    float xv[G];
                    load_vec<G>(x_s + (j0 + jj) * kTile + c0, xv);
#pragma unroll
                    for (int q = 0; q < G; ++q) xv[q] *= d;
#pragma unroll
                    for (int m = 0; m < MC; ++m) {
                        float bv[V];
                        load_vec<V>(cur + jj * N + m * G * V, bv);
#pragma unroll
                        for (int v = 0; v < V; ++v)
#pragma unroll
                            for (int q = 0; q < G; ++q)
                                S[(m * V + v) * G + q] = fmaf(bv[v], xv[q], S[(m * V + v) * G + q]);
                    }
                }
            }
            __syncthreads();
        }

        // ---- y of the chunk: exp(a_cum) * sum of the warps' partials + M . X ----
        constexpr int kRowsPerWarp = kChunk / kWarps;
        float yv[kRowsPerWarp];
#pragma unroll
        for (int m = 0; m < kRowsPerWarp; ++m) {
            const int i = warp + kWarps * m;
            float sum = 0.f;
#pragma unroll
            for (int k = 0; k < kWarps; ++k) sum += part[(k * kChunk + i) * kTile + lane];
            yv[m] = sum * ecum[i];
        }
#pragma unroll 4
        for (int j = 0; j < kChunk; j += 4) {
            float xv[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) xv[q] = x_s[(j + q) * kTile + lane];
#pragma unroll
            for (int m = 0; m < kRowsPerWarp; ++m) {
                float mv[4];
                load_vec<4>(m_s + (warp + kWarps * m) * kChunk + j, mv);
#pragma unroll
                for (int q = 0; q < 4; ++q) yv[m] = fmaf(mv[q], xv[q], yv[m]);
            }
        }
        if (lane < cols) {
#pragma unroll
            for (int m = 0; m < kRowsPerWarp; ++m) {
                const int t = t0 + warp + kWarps * m;
                if (t >= T_len) continue;
                const long long gi = xy0 + t * ld + lane;
                if (norm)
                    n_out[gi] = yv[m];
                else
                    y[gi] = from_float<T>(yv[m]);
            }
        }
        __syncthreads();   // x_s, part and m_s are the next chunk's
    }

#pragma unroll
    for (int m = 0; m < MC; ++m)
#pragma unroll
        for (int v = 0; v < V; ++v)
#pragma unroll
            for (int q = 0; q < G; ++q) {
                const int row = r0 + (m * G + g) * V + v, col = c0 + q;
                if (col < cols) fin[st0 + row * lds + col] = S[(m * V + v) * G + q];
            }
}

template <typename T, int NPW>
int launch(const void* x, const float* a, const void* Bm, const void* Cm, const float* s0,
           void* y, float* s1, const float* w, const float* n0, float* n_out, float* n1,
           float* ws, int b, int T_len, int H, int G, int P, cudaStream_t stream) {
    constexpr int N = NPW * kWarps;
    const int n_chunks = (T_len + kChunk - 1) / kChunk;
    auto intra = ssd_scan_intra_kernel<T>;
    const size_t intra_smem = intra_smem_bytes<T>(N);
    cudaError_t err = cudaFuncSetAttribute(intra, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(intra_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    intra<<<dim3(b * H, n_chunks, kMTiles * kMTiles), kThreads, intra_smem, stream>>>(
        a, static_cast<const T*>(Bm), static_cast<const T*>(Cm), ws, T_len, H, G, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    auto kernel = ssd_scan_kernel<T, NPW>;
    const size_t smem = smem_bytes<T>(N);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_tiles = (P + kTile - 1) / kTile;
    dim3 grid(b * H, n_tiles + (w != nullptr ? 1 : 0));
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(Bm), static_cast<const T*>(Cm), ws, s0,
        static_cast<T*>(y), s1, w, n0, n_out, n1, T_len, H, G, P, n_tiles);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(int N, const void* x, const float* a, const void* Bm, const void* Cm,
               const float* s0, void* y, float* s1, const float* w, const float* n0,
               float* n_out, float* n1, float* ws, int b, int T_len, int H, int G, int P,
               cudaStream_t s) {
    switch (N) {
#define REPRO_SSD_CASE(n)                                                                  \
    case n:                                                                                \
        return launch<T, n / kWarps>(x, a, Bm, Cm, s0, y, s1, w, n0, n_out, n1, ws, b,     \
                                     T_len, H, G, P, s);
        REPRO_SSD_CASE(8)
        REPRO_SSD_CASE(16)
        REPRO_SSD_CASE(32)
        REPRO_SSD_CASE(64)
        REPRO_SSD_CASE(128)
        REPRO_SSD_CASE(256)
        REPRO_SSD_CASE(512)
#undef REPRO_SSD_CASE
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// ---------------------------------------------------------------------------
// The chunk-parallel path (N <= kSmallState, P <= kSmallState, no normalizer)
// ---------------------------------------------------------------------------
constexpr int kSmallState = 64;               // N and P a chunk block holds whole
constexpr int kLd = kChunk + 4;               // shared row: 64 floats + 16 bytes
constexpr int kSumBlock = 8;                  // products summed before they join a total
constexpr int kPassDepth = 8;                 // chunks the ordered pass has in flight
constexpr int kPassThreads = 128;
constexpr int kStateThreads = 128;            // pass (a): 4 x 8 tiles of a 64 x 64 product
constexpr int kOutThreads = 256;              // pass (c): 4 x 4 tiles
static_assert(kSmallState == kChunk, "a chunk block's products are 64 x 64");

// A 64 x 64 product over NT threads: thread t owns rows r0 .. r0+3 and
// TC = 8 or 4 columns, tile_col(c) for c < TC: c0 .. c0+3, then (TC = 8)
// 32+c0 .. 32+c0+3, so that 8 lanes read 128 contiguous bytes.
template <int NT>
struct Tile {
    static constexpr int TC = kChunk * kChunk / (4 * NT);
    static constexpr int kLanes = kChunk / TC;     // threads along a row
    static_assert(TC == 4 || TC == 8, "4 x 4 or 4 x 8 tiles");
    int r0, c0;
    __device__ explicit Tile(int t) : r0(4 * (t / kLanes)), c0(4 * (t % kLanes)) {}
    __device__ int col(int c) const { return c0 + c % 4 + 32 * (c / 4); }
};

// rows t0 .. t0+63 of a source with row stride ld, `cols` values a row, into
// dst[64][kLd] as fp32 by NT threads: zeros past T_len and past cols. fp32
// rows on 16-byte boundaries go by cp.async, all in flight at once (the
// caller commits and waits); anything else (bf16, widened on the way) by
// plain loads.
template <int NT, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long ld, int t0,
                                          int T_len, int cols, int hint = 0) {
    if constexpr (sizeof(T) == sizeof(float)) {
        if (reinterpret_cast<size_t>(src) % 16 == 0 && ld % 4 == 0 && cols % 4 == 0) {
#pragma unroll
            for (int e = threadIdx.x; e < kChunk * kChunk / 4; e += NT) {
                const int r = e / (kChunk / 4), q = 4 * (e % (kChunk / 4));
                const bool ok = t0 + r < T_len && q < cols;
                if (hint)
                    cp_async16_hint(dst + r * kLd + q, src + (ok ? (t0 + r) * ld + q : 0), ok,
                                    l2_policy(hint));
                else
                    cp_async16(dst + r * kLd + q, src + (ok ? (t0 + r) * ld + q : 0), ok);
            }
            return;
        }
    }
#pragma unroll 8
    for (int e = threadIdx.x; e < kChunk * kChunk; e += NT) {
        const int r = e / kChunk, q = e % kChunk;
        dst[r * kLd + q] = (t0 + r < T_len && q < cols)
                               ? to_float(src[static_cast<long long>(t0 + r) * ld + q])
                               : 0.f;
    }
}

// 4 consecutive values to p, 4-element aligned, in one store
__device__ __forceinline__ void store4(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                              *reinterpret_cast<const unsigned*>(&hi));
}

// Row r of a thread's tile to dst + r * ld + its columns below cols: one
// store per 4 columns where dst and ld allow it.
template <int NT, typename T>
__device__ __forceinline__ void store_tile_row(T* dst, long long ld, int r, const Tile<NT>& tl,
                                               int cols, const float (&v)[Tile<NT>::TC],
                                               int hint = 0) {
    T* row = dst + r * ld;
    if (cols % 4 == 0 && ld % 4 == 0 && reinterpret_cast<size_t>(dst) % (4 * sizeof(T)) == 0) {
#pragma unroll
        for (int c = 0; c < Tile<NT>::TC; c += 4)
            if (tl.col(c) < cols) {
                if constexpr (sizeof(T) == sizeof(float)) {
                    if (hint) {
                        st4_hint(reinterpret_cast<float*>(row + tl.col(c)), v[c], v[c + 1],
                                 v[c + 2], v[c + 3], l2_policy(hint));
                        continue;
                    }
                }
                store4(row + tl.col(c), v + c);
            }
        return;
    }
#pragma unroll
    for (int c = 0; c < Tile<NT>::TC; ++c)
        if (tl.col(c) < cols) row[tl.col(c)] = from_float<T>(v[c]);
}

// acc[r][c] += sum over k < K (a multiple of kSumBlock) of A(r0 + r, k) *
// B(k, col(c)), in blocks of kSumBlock products, each block's sum added to
// acc in order. A_K / B_K: the operand is k-major (X[k * kLd + i]) rather
// than row-major (X[i * kLd + k]); either way one float4 from shared memory
// feeds 4 to 8 FMAs.
template <bool A_K, bool B_K, int NT>
__device__ __forceinline__ void tile_mma(const float* A, const float* B, int K, const Tile<NT>& tl,
                                         float (&acc)[4][Tile<NT>::TC]) {
    constexpr int TC = Tile<NT>::TC;
    for (int k0 = 0; k0 < K; k0 += kSumBlock) {
        float part[4][TC];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < TC; ++c) part[r][c] = 0.f;
#pragma unroll
        for (int kq = 0; kq < kSumBlock; kq += 4) {
            const int k = k0 + kq;
            float av[4][4], bv[TC][4];    // av[r][u] = A(r0+r, k+u), bv[c][u] = B(k+u, col c)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if constexpr (A_K) {
                    const float4 v = *reinterpret_cast<const float4*>(A + (k + q) * kLd + tl.r0);
                    av[0][q] = v.x; av[1][q] = v.y; av[2][q] = v.z; av[3][q] = v.w;
                } else {
                    const float4 v = *reinterpret_cast<const float4*>(A + (tl.r0 + q) * kLd + k);
                    av[q][0] = v.x; av[q][1] = v.y; av[q][2] = v.z; av[q][3] = v.w;
                }
            }
#pragma unroll
            for (int cg = 0; cg < TC; cg += 4) {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    float4 v;
                    if constexpr (B_K)
                        v = *reinterpret_cast<const float4*>(B + (k + u) * kLd + tl.col(cg));
                    else
                        v = *reinterpret_cast<const float4*>(B + tl.col(cg + u) * kLd + k);
                    if constexpr (B_K) {
                        bv[cg][u] = v.x; bv[cg + 1][u] = v.y; bv[cg + 2][u] = v.z;
                        bv[cg + 3][u] = v.w;
                    } else {
                        bv[cg + u][0] = v.x; bv[cg + u][1] = v.y; bv[cg + u][2] = v.z;
                        bv[cg + u][3] = v.w;
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < TC; ++c) part[r][c] = fmaf(av[r][u], bv[c][u], part[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < TC; ++c) acc[r][c] += part[r][c];
    }
}

// Pass (a). blockIdx.x = chunk; blockIdx.y < b*G: a (batch, group) block,
// which writes CB = C . B^T of the chunk ([64][64], row i, column j; the
// groups' heads share it); else a (batch, head) block, which writes the
// chunk's state contribution dS = B^T . (X * exp(a_tot - a_cum)) ([N][P])
// and exp(a_tot).
template <typename T>
__global__ void __launch_bounds__(kStateThreads)
ssd_scan_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ a,
                            const T* __restrict__ Bm, const T* __restrict__ Cm,
                            float* __restrict__ dS, float* __restrict__ cb,
                            float* __restrict__ etot, int b, int T_len, int H, int G, int N,
                            int P) {
    constexpr int NT = kStateThreads, TC = Tile<NT>::TC;
    extern __shared__ __align__(16) float sm[];
    float* u_s = sm;                       // [kChunk][kLd]
    float* v_s = u_s + kChunk * kLd;       // [kChunk][kLd]
    float* a_s = v_s + kChunk * kLd;       // [kChunk]
    float* dec = a_s + kChunk;             // [kChunk] exp(a_tot - a_cum)
    const int tid = threadIdx.x, ch = blockIdx.x, n_chunks = gridDim.x, t0 = ch * kChunk;
    const Tile<NT> tl(tid);
    float acc[4][TC] = {};
    const long long ldbc = static_cast<long long>(G) * N;

    if (static_cast<int>(blockIdx.y) < b * G) {
        const int bg = blockIdx.y, bi = bg / G, g = bg % G;
        const long long bc0 = (static_cast<long long>(bi) * T_len * G + g) * N;
        load_rows<NT>(u_s, Cm + bc0, ldbc, t0, T_len, N);
        load_rows<NT>(v_s, Bm + bc0, ldbc, t0, T_len, N);
        asm volatile("cp.async.wait_all;\n" ::);
        __syncthreads();
        tile_mma<false, false>(u_s, v_s, N, tl, acc);
        float* out = cb + (static_cast<long long>(bg) * n_chunks + ch) * kChunk * kChunk;
#pragma unroll
        for (int r = 0; r < 4; ++r) store_tile_row(out, kChunk, tl.r0 + r, tl, kChunk, acc[r]);
        return;
    }
    const int bh = blockIdx.y - b * G, bi = bh / H, h = bh % H;
    load_rows<NT>(u_s, Bm + (static_cast<long long>(bi) * T_len * G + h / (H / G)) * N, ldbc,
                  t0, T_len, N);
    load_rows<NT>(v_s, x + (static_cast<long long>(bi) * T_len * H + h) * P,
                  static_cast<long long>(H) * P, t0, T_len, P, 1);
    if (tid < kChunk)
        a_s[tid] = t0 + tid < T_len ? a[(static_cast<long long>(bi) * T_len + t0 + tid) * H + h]
                                    : 0.f;   // padding: decay 1
    __syncthreads();                       // a_s; B and x still in flight
    if (tid <= kChunk) {
        // thread j < 64: a[j+1] + ... + a[63]; thread 64: a[0] + ... + a[63]
        const int j = tid < kChunk ? tid : -1;
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
            if (k > j) s += a_s[k];
        if (tid < kChunk)
            dec[tid] = expf(s);
        else
            etot[static_cast<long long>(bh) * n_chunks + ch] = expf(s);
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
#pragma unroll 8
    for (int e = tid; e < kChunk * kChunk; e += NT)
        v_s[(e / kChunk) * kLd + e % kChunk] *= dec[e / kChunk];
    __syncthreads();
    tile_mma<true, true>(u_s, v_s, kChunk, tl, acc);
    float* out = dS + (static_cast<long long>(bh) * n_chunks + ch) * N * P;
#pragma unroll
    for (int r = 0; r < 4; ++r)
        if (tl.r0 + r < N) store_tile_row(out, P, tl.r0 + r, tl, P, acc[r], 2);
}

// Pass (b), the only ordered one: per (batch*head = blockIdx.y), each thread
// owns 4 consecutive state values and walks the chunks, S_c = exp(a_tot,c)
// S_{c-1} + dS_c, overwriting dS_c with S_{c-1} (the state the chunk starts
// from) and writing the final state. kPassDepth chunks' loads are issued
// before any of their updates.
__global__ void __launch_bounds__(kPassThreads)
ssd_scan_chunk_pass_kernel(float* __restrict__ dS, const float* __restrict__ etot,
                           const float* __restrict__ s0, float* __restrict__ s1, int n_chunks,
                           int NP) {
    const int e = 4 * (blockIdx.x * kPassThreads + threadIdx.x);
    if (e >= NP) return;
    const long long bh = blockIdx.y;
    float S[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) S[q] = s0 != nullptr ? s0[bh * NP + e + q] : 0.f;
    float* d_bh = dS + bh * n_chunks * NP + e;
    const float* e_bh = etot + bh * n_chunks;
    for (int c0 = 0; c0 < n_chunks; c0 += kPassDepth) {
        float4 d[kPassDepth];
        float ev[kPassDepth];
#pragma unroll
        for (int k = 0; k < kPassDepth; ++k)
            if (c0 + k < n_chunks) {
                d[k] = ld4_hint(d_bh + static_cast<long long>(c0 + k) * NP, l2_policy(2));
                ev[k] = e_bh[c0 + k];
            }
#pragma unroll
        for (int k = 0; k < kPassDepth; ++k)
            if (c0 + k < n_chunks) {
                st4_hint(d_bh + static_cast<long long>(c0 + k) * NP, S[0], S[1], S[2], S[3],
                         l2_policy(2));
                S[0] = fmaf(ev[k], S[0], d[k].x);
                S[1] = fmaf(ev[k], S[1], d[k].y);
                S[2] = fmaf(ev[k], S[2], d[k].z);
                S[3] = fmaf(ev[k], S[3], d[k].w);
            }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) s1[bh * NP + e + q] = S[q];
}

// Pass (c). blockIdx.x = chunk, blockIdx.y = batch*head:
// y = exp(a_cum) * (C . S_prev) + M . X with M[i][j] = CB[i][j] *
// exp(a[j+1] + ... + a[i]) for i >= j, else 0. C . S_prev's operands are
// waited for first; M's and M . X's arrive while it runs. Rows past T are
// not stored.
template <typename T>
__global__ void __launch_bounds__(kOutThreads, 3)
ssd_scan_chunk_out_kernel(const T* __restrict__ x, const float* __restrict__ a,
                          const T* __restrict__ Cm, const float* __restrict__ sprev,
                          const float* __restrict__ cb, T* __restrict__ y, int T_len, int H,
                          int G, int N, int P) {
    constexpr int NT = kOutThreads, TC = Tile<NT>::TC;
    extern __shared__ __align__(16) float sm[];
    float* c_s = sm;                       // [kChunk][kLd] C rows [i][n]
    float* s_s = c_s + kChunk * kLd;       // [kChunk][kLd] S_prev [n][p]
    float* x_s = s_s + kChunk * kLd;       // [kChunk][kLd] X [j][p]
    float* m_s = x_s + kChunk * kLd;       // [kChunk][kLd] CB, then M [i][j]
    float* a_s = m_s + kChunk * kLd;       // [kChunk]
    float* ecum = a_s + kChunk;            // [kChunk] exp(a_cum)
    const int tid = threadIdx.x, ch = blockIdx.x, n_chunks = gridDim.x, t0 = ch * kChunk;
    const int bh = blockIdx.y, bi = bh / H, h = bh % H, g = h / (H / G);
    const Tile<NT> tl(tid);
    const long long xy0 = (static_cast<long long>(bi) * T_len * H + h) * P;
    const long long ldxy = static_cast<long long>(H) * P;

    load_rows<NT>(c_s, Cm + (static_cast<long long>(bi) * T_len * G + g) * N,
                  static_cast<long long>(G) * N, t0, T_len, N);
    load_rows<NT>(s_s, sprev + (static_cast<long long>(bh) * n_chunks + ch) * N * P, P, 0, N,
                  P, 1);
    cp_async_commit();
    load_rows<NT>(x_s, x + xy0, ldxy, t0, T_len, P, 1);
    load_rows<NT>(m_s,
                  cb + (static_cast<long long>(bi * G + g) * n_chunks + ch) * kChunk * kChunk,
                  kChunk, 0, kChunk, kChunk);
    cp_async_commit();
    if (tid < kChunk)
        a_s[tid] = t0 + tid < T_len ? a[(static_cast<long long>(bi) * T_len + t0 + tid) * H + h]
                                    : 0.f;   // padding: decay 1
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    float acc[4][TC] = {};
    tile_mma<false, true>(c_s, s_s, N, tl, acc);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (tid < kChunk) {
        float s = 0.f;                     // a[0] + ... + a[i], in order
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
            if (k <= tid) s += a_s[k];
        ecum[tid] = expf(s);
    }
    {
        // thread (q, j) takes rows i of column j in [q*R, (q+1)*R); the
        // exponent a[j+1] + ... + a[i] grows one step at a time, in order
        constexpr int R = kChunk * kChunk / NT;
        const int j = tid % kChunk, i0 = (tid / kChunk) * R;
        float s = 0.f, e[R];
#pragma unroll
        for (int k = 0; k < kChunk - R; ++k)
            if (k < i0 && k > j) s += a_s[k];
        if (__all_sync(0xffffffffu, i0 + R <= j)) {
#pragma unroll
            for (int di = 0; di < R; ++di) m_s[(i0 + di) * kLd + j] = 0.f;   // above the diagonal
        } else {
#pragma unroll
            for (int di = 0; di < R; ++di) {
                if (i0 + di > j) s += a_s[i0 + di];
                e[di] = expf(s);
            }
#pragma unroll
            for (int di = 0; di < R; ++di) {
                float* m = m_s + (i0 + di) * kLd + j;
                *m = i0 + di < j ? 0.f : *m * e[di];
            }
        }
    }
    __syncthreads();
    // causal: row i reads M[i][j] for j <= i only
    float mx[4][TC] = {};
    tile_mma<false, true>(m_s, x_s, (tl.r0 + 4 + kSumBlock - 1) / kSumBlock * kSumBlock, tl, mx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[r][c] = fmaf(ecum[tl.r0 + r], acc[r][c], mx[r][c]);
        if (t0 + tl.r0 + r < T_len) store_tile_row(y + xy0, ldxy, t0 + tl.r0 + r, tl, P, acc[r], 1);
    }
}

template <typename T>
int launch_chunks(const void* x, const float* a, const void* Bm, const void* Cm,
                  const float* s0, void* y, float* s1, float* ws, int b, int T_len, int H,
                  int G, int N, int P, cudaStream_t stream) {
    const int n_chunks = (T_len + kChunk - 1) / kChunk;
    float* dS = ws;
    float* cb = dS + static_cast<long long>(b) * H * n_chunks * N * P;
    float* etot = cb + static_cast<long long>(b) * G * n_chunks * kChunk * kChunk;
    const size_t state_smem = sizeof(float) * (2 * kChunk * kLd + 2 * kChunk);
    ssd_scan_chunk_state_kernel<T>
        <<<dim3(n_chunks, b * (G + H)), kStateThreads, state_smem, stream>>>(
            static_cast<const T*>(x), a, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
            dS, cb, etot, b, T_len, H, G, N, P);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int NP = N * P;
    ssd_scan_chunk_pass_kernel<<<dim3((NP / 4 + kPassThreads - 1) / kPassThreads, b * H),
                                 kPassThreads, 0, stream>>>(dS, etot, s0, s1, n_chunks, NP);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    auto out = ssd_scan_chunk_out_kernel<T>;
    const size_t out_smem = sizeof(float) * (4 * kChunk * kLd + 2 * kChunk);
    err = cudaFuncSetAttribute(out, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(out_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    out<<<dim3(n_chunks, b * H), kOutThreads, out_smem, stream>>>(
        static_cast<const T*>(x), a, static_cast<const T*>(Cm), dS, cb, static_cast<T*>(y),
        T_len, H, G, N, P);
    return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int b, int T_len, int H, int G, int P) {
    return b <= 0 || T_len <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0;
}

}  // namespace

// x, y: [b,T,H,P] and B, C: [b,T,G,N] of one dtype (ReproDtype), G dividing
// H (head h reads group h / (H/G)), B and C 16-byte aligned; a: [b,T,H]
// fp32; s0 (may be null: zeros), s1: [b,H,N,P] fp32. Normalizer chain when w
// is not null: w: [b,T,H], n0 (may be null), n_out: [b,T,H], n1: [b,H,N], all
// fp32. ws: workspace of b*H*ceil(T/64)*64*66 fp32, 16-byte aligned. All
// contiguous; N a power of two in [8, 512]. The ordered walk: any shape.
extern "C" int ssd_scan_fwd(const void* x, const float* a, const void* Bm, const void* Cm,
                            const float* s0, void* y, float* s1, const float* w,
                            const float* n0, float* n_out, float* n1, float* ws, int dtype,
                            int b, int T_len, int H, int G, int N, int P, void* stream) {
    if (bad_shape(b, T_len, H, G, P) || (P + kTile - 1) / kTile >= 65535 ||
        (T_len + kChunk - 1) / kChunk >= 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    if (w != nullptr && (n_out == nullptr || n1 == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    if ((reinterpret_cast<size_t>(Bm) | reinterpret_cast<size_t>(Cm) |
         reinterpret_cast<size_t>(ws)) % 16 != 0)
        return static_cast<int>(cudaErrorMisalignedAddress);
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == REPRO_F32)
        return dispatch_n<float>(N, x, a, Bm, Cm, s0, y, s1, w, n0, n_out, n1, ws, b, T_len, H,
                                 G, P, s);
    if (dtype == REPRO_BF16)
        return dispatch_n<__nv_bfloat16>(N, x, a, Bm, Cm, s0, y, s1, w, n0, n_out, n1, ws, b,
                                         T_len, H, G, P, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// The chunk-parallel path, same layouts without the normalizer: N a
// multiple of 8 and N, P at most 64. ws: b*ceil(T/64)*(H*N*P + G*64*64 + H)
// fp32, 16-byte aligned. Three kernels: pass (a), (b), (c) above.
extern "C" int ssd_scan_chunks_fwd(const void* x, const float* a, const void* Bm,
                                   const void* Cm, const float* s0, void* y, float* s1,
                                   float* ws, int dtype, int b, int T_len, int H, int G, int N,
                                   int P, void* stream) {
    if (bad_shape(b, T_len, H, G, P) || N <= 0 || N % kSumBlock != 0 || N > kSmallState ||
        P > kSmallState || static_cast<long long>(b) * (G + H) >= 65535 ||
        static_cast<long long>(T_len + kChunk - 1) / kChunk >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    if (reinterpret_cast<size_t>(ws) % 16 != 0)
        return static_cast<int>(cudaErrorMisalignedAddress);
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == REPRO_F32)
        return launch_chunks<float>(x, a, Bm, Cm, s0, y, s1, ws, b, T_len, H, G, N, P, s);
    if (dtype == REPRO_BF16)
        return launch_chunks<__nv_bfloat16>(x, a, Bm, Cm, s0, y, s1, ws, b, T_len, H, G, N, P,
                                            s);
    return static_cast<int>(cudaErrorInvalidValue);
}
