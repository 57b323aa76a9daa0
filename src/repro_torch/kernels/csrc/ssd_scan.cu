// SSD linear recurrence (Mamba-2 / mLSTM) for Hopper in chunked (matrix)
// form, with state in and out and an optional normalizer chain.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::_ssd_kernel
// (wrapper `ssd_scan`, pallas_call at ssd_scan.py:82). Same recurrence, per
// (batch, head), heads already expanded from groups, decays in log space:
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
// sum of a over exactly the steps it spans (never the difference of two
// 64-step cumulative sums, whose rounding is that of the larger), and
// C_i . B_j is summed in blocks, not as one 512-long chain.
//
// Two kernels per call. ssd_scan_intra_kernel computes M, exp(a_cum) and
// exp(a_tot - a_cum) once per (batch*head, chunk) into a workspace the
// wrapper allocates (L*(L+2) fp32 per chunk), one block per 16 x 16 tile of
// M; the exponent is taken only where i >= j, so no inf meets a zero.
// ssd_scan_kernel then owns one (batch*head, 32-column tile) per block,
// plus one normalizer tile of width 1 per (batch, head), and walks the
// chunks in order with its [N, 32] slice of the state in registers: 4 x 33
// blocks at b=1, H=4, P=1024, one wave on 132 SMs. Warp w holds state rows
// [w*N/8, (w+1)*N/8); within a warp, four groups of 8 lanes split those
// rows and each lane holds 4 columns, so each value read from shared memory
// feeds 16 FMAs. The TPU kernel keeps the whole [N, P] state in VMEM; at
// N = 512, P = 1024 that is 2 MiB per head, far beyond an SM's 227 KB.
//
// Per chunk, C and then B stream through shared memory in stages of
// kRows = 16 steps x N (32 KiB in fp32 at N = 512; a whole chunk of both is
// 256 KiB), double-buffered with cp.async: the next stage's copy is in
// flight while this one computes. bf16 inputs are copied as they are and
// widened to fp32 where they are read. A C stage adds each warp's share of
// C . S_old for its 16 steps (16 x 4 independent sums per lane, combined
// across the lane groups by shuffles) into a per-warp partial in shared
// memory. Before the first B stage the state is scaled by exp(a_tot); each
// B stage then adds B_j x_j exp(a_tot - a_cum_j). At the end of the chunk
// the 8 warps' partials are summed, scaled by exp(a_cum) and M . X is added
// (M from L2 through shared memory); rows past T are not stored. The last
// chunk is padded with decay 1, B = C = 0 and x = 0, so the final state is
// the state at T, and its stages that hold only padding are skipped.
//
// What bounds it on the H100: operations, ~4 N P flops per step and head on
// state values that stay on chip; every column tile also reads the head's
// B and C from L2 (bytes against HBM are far below both). The step-by-step
// form it replaces did one FMUL and two FMAs per state element and step
// with one 64-long chain of dependent FMAs per lane and step for y; this
// does two independent FMAs per state element and step.

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
                      int N) {
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
        const long long bc0 = (static_cast<long long>(bi) * T_len * H + h) * N;
        const long long ldbc = static_cast<long long>(H) * N;
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
                float* __restrict__ n1, int T_len, int H, int P, int n_tiles) {
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
    const long long ldbc = static_cast<long long>(H) * N;
    const T* b_src = Bm + (static_cast<long long>(bi) * T_len * H + h) * N;
    const T* c_src = Cm + (static_cast<long long>(bi) * T_len * H + h) * N;
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
           float* ws, int b, int T_len, int H, int P, cudaStream_t stream) {
    constexpr int N = NPW * kWarps;
    const int n_chunks = (T_len + kChunk - 1) / kChunk;
    auto intra = ssd_scan_intra_kernel<T>;
    const size_t intra_smem = intra_smem_bytes<T>(N);
    cudaError_t err = cudaFuncSetAttribute(intra, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(intra_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    intra<<<dim3(b * H, n_chunks, kMTiles * kMTiles), kThreads, intra_smem, stream>>>(
        a, static_cast<const T*>(Bm), static_cast<const T*>(Cm), ws, T_len, H, N);
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
        static_cast<T*>(y), s1, w, n0, n_out, n1, T_len, H, P, n_tiles);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(int N, const void* x, const float* a, const void* Bm, const void* Cm,
               const float* s0, void* y, float* s1, const float* w, const float* n0,
               float* n_out, float* n1, float* ws, int b, int T_len, int H, int P,
               cudaStream_t s) {
    switch (N) {
#define REPRO_SSD_CASE(n)                                                                  \
    case n:                                                                                \
        return launch<T, n / kWarps>(x, a, Bm, Cm, s0, y, s1, w, n0, n_out, n1, ws, b,     \
                                     T_len, H, P, s);
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

}  // namespace

// x, y: [b,T,H,P] and B, C: [b,T,H,N] of one dtype (ReproDtype), B and C
// 16-byte aligned; a: [b,T,H] fp32; s0 (may be null: zeros), s1: [b,H,N,P]
// fp32. Normalizer chain when w is not null: w: [b,T,H], n0 (may be null),
// n_out: [b,T,H], n1: [b,H,N], all fp32. ws: workspace of
// b*H*ceil(T/64)*64*66 fp32, 16-byte aligned. All contiguous; N a power of
// two in [8, 512].
extern "C" int ssd_scan_fwd(const void* x, const float* a, const void* Bm, const void* Cm,
                            const float* s0, void* y, float* s1, const float* w,
                            const float* n0, float* n_out, float* n1, float* ws, int dtype,
                            int b, int T_len, int H, int N, int P, void* stream) {
    if (b <= 0 || T_len <= 0 || H <= 0 || P <= 0 || (P + kTile - 1) / kTile >= 65535 ||
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
                                 P, s);
    if (dtype == REPRO_BF16)
        return dispatch_n<__nv_bfloat16>(N, x, a, Bm, Cm, s0, y, s1, w, n0, n_out, n1, ws, b,
                                         T_len, H, P, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
