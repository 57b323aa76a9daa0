// Tiles, copies and register micro-tile products shared by the fp32 flash
// attention kernels on the CUDA cores: the forward (flash_attention.cu) and
// the backward (flash_attention_bwd.cu). Both run one block of 16 warps per
// SM on 64-row query tiles and 64-key tiles, copy tiles in by 16-byte
// cp.async, and build every tile product from float4 shared-memory reads
// into register micro-tiles (see the note at the top of
// flash_attention_bwd.cu for why).
#pragma once

#include "common.cuh"

namespace {

constexpr int BQ = 64;                   // query rows per tile
constexpr int BK = 64;                   // keys per tile
constexpr int NT = 512;                  // threads per block: 16 warps
constexpr int WARPS = NT / 32;

// Floats a tile row holds at head dim HD: HD itself where it is 32, 64, 128
// or 192 (the warp maps split a row into 32-float groups that divide 16
// warps; the forward runs hd 192 as three groups of 64 columns), else the
// next of those widths: hd 80 runs in hd 128's tiles. Only HD columns are
// copied in; the forward zeroes the rest once (zero_pad), so they add
// nothing to q . k, and never stores them.
template <int HD>
constexpr int LW = HD <= 32 ? 32 : HD <= 64 ? 64 : HD <= 128 ? 128 : 192;

// 64 x LW tiles of q and do: row r's 16-byte chunk c sits at chunk c ^ (r & 7).
// Returns the float offset of column col (a multiple of 4).
template <int HD>
__device__ __forceinline__ int q_at(int r, int col) {
    return r * LW<HD> + (((col >> 2) ^ (r & 7)) << 2);
}

// k and v tiles: rows padded to LW + 4 floats, so consecutive rows start 4
// banks apart (8 rows read at one column hit 32 banks) and a thread's k and
// v rows are read at constant offsets.
template <int HD>
constexpr int KS = LW<HD> + 4;

// 64 x 64 score tiles. [i][j] (P and dS of the dk/dv kernel, the forward's
// partial scores): column j at j ^ 8 (i & 3); [j][i] (dS^T of the dq
// kernel, the forward's P^T): column i at i ^ 4 (j & 7). Both keep 4-float
// groups together and let the stores of a warp (4 rows x 8 columns of the S
// grid) hit 32 banks.
__device__ __forceinline__ int p_at(int i, int j) { return i * BK + (j ^ ((i & 3) << 3)); }
__device__ __forceinline__ int dst_at(int j, int i) { return j * BQ + (i ^ ((j & 7) << 2)); }

struct Mask {
    int T_len, S_len, causal, window, q_offset;
    __device__ __forceinline__ bool visible(int t, int s) const {
        const int qpos = t + q_offset;
        return t < T_len && s < S_len && (!causal || s <= qpos) &&
               (window <= 0 || s > qpos - window);
    }
    // The forward's tile-level pruning: no (row, key) pair of the two tiles
    // is visible.
    __device__ __forceinline__ bool skip(int q0, int k0) const {
        const int rows = min(BQ, T_len - q0);
        const int q_first = q0 + q_offset, q_last = q0 + rows - 1 + q_offset;
        const int k_last = min(k0 + BK, S_len) - 1;
        return (causal && k0 > q_last) || (window > 0 && k_last <= q_first - window);
    }
};

// The first key tile at or after kt that the query tile at q0 sees; nk when
// none is left.
__device__ __forceinline__ int next_key_tile(int kt, int nk, const Mask& mask, int q0) {
    while (kt < nk && mask.skip(q0, kt * BK)) {
        if (mask.causal && kt * BK > q0 + min(BQ, mask.T_len - q0) - 1 + mask.q_offset)
            return nk;                   // every later tile is past the causal edge
        ++kt;
    }
    return kt;
}

// blockIdx.x, read anew at each use: the offsets derived from it are
// recomputed (a few integer instructions a pass) rather than held in
// registers through the pass loop, which leaves the products 128 registers
// a thread without spills.
__device__ __forceinline__ int block_x() {
    int x;
    asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(x));
    return x;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 64 rows x HD floats from global (row stride `stride`) into a q/do tile
// (swizzled) or a k/v tile (PADDED), by cp.async; rows past `valid` are
// zero-filled (nothing is read). Columns HD..LW-1 are not written.
template <int HD, bool PADDED>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long stride,
                                          int valid) {
    static_assert(HD % 4 == 0 && HD <= LW<HD>, "rows are copied in 16-byte chunks");
    constexpr int CH = HD / 4;
#pragma unroll
    for (int id = threadIdx.x; id < 64 * CH; id += NT) {
        const int r = id / CH, c = id % CH;
        const bool ok = r < valid;
        cp_async16(dst + (PADDED ? r * KS<HD> + 4 * c : q_at<HD>(r, 4 * c)),
                   ok ? src + r * stride + 4 * c : src, ok);
    }
}

// Zero columns HD..LW-1 of the 64 rows of a q/do tile (swizzled) or a k/v
// tile (PADDED); nothing when the tile is HD wide. load_tile never writes
// them, so once per buffer is enough.
template <int HD, bool PADDED>
__device__ __forceinline__ void zero_pad(float* dst) {
    constexpr int CH = HD / 4, PAD = LW<HD> / 4 - CH;
    if constexpr (PAD > 0) {
        for (int id = threadIdx.x; id < 64 * PAD; id += NT) {
            const int r = id / PAD, c = CH + id % PAD;
            *reinterpret_cast<float4*>(dst + (PADDED ? r * KS<HD> + 4 * c : q_at<HD>(r, 4 * c))) =
                make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }
}

// acc[r][c] += sum_d A[ty + 16r][d] * B[tx + 16c][d], A a q/do tile, B a
// k/v tile: a 64 x 64 product by the 256 threads of one half, 4 x 4 each.
// The lanes read the same d-chunk at once: the swizzle spreads A's 4 rows,
// the padding B's 8, over the banks. The thread's A rows share one swizzle
// (16r = 0 mod 8). B is read one row at a time, which keeps the product
// within 128 registers without spills. With NU = 4, the sum runs over the
// 16-byte chunks u0 .. u0 + 3 (u0 = 0 or 4) of every 32 floats of d only:
// half of d, which the forward's two halves split. Where the tile is wider
// than HD, the sum stops after the 32-float group that holds column HD - 1:
// the groups past it are zeros.
template <int HD, int NU = 8>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[4][4], const float* A,
                                              const float* Bm, int ty, int tx, int u0 = 0) {
    constexpr int W = LW<HD>;
    const float* a_row = A + ty * W;
    const int sa4 = ((ty & 7) ^ u0) << 2;          // chunk u0 + u sits at (u ^ u0 ^ (ty & 7))
    const float* b_row = Bm + tx * KS<HD> + 4 * u0;
#pragma unroll 2
    for (int m = 0; m < (HD + 31) / 32; ++m) {
#pragma unroll
        for (int u = 0; u < NU; ++u) {
            float4 a[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
                a[r] = *reinterpret_cast<const float4*>(a_row + ((u << 2) ^ sa4) + 16 * r * W +
                                                        32 * m);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float4 b =
                    *reinterpret_cast<const float4*>(b_row + 16 * c * KS<HD> + 32 * m + 4 * u);
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    float x = acc[r][c];
                    x = fmaf(a[r].x, b.x, x);
                    x = fmaf(a[r].y, b.y, x);
                    x = fmaf(a[r].z, b.z, x);
                    acc[r][c] = fmaf(a[r].w, b.w, x);
                }
            }
        }
    }
}

// N contiguous floats (N = 1, 2, 4 or 8; 4-aligned groups stay together in
// every layout here) from shared memory.
template <int N>
__device__ __forceinline__ void load_vec(float (&out)[N], const float* src) {
    if constexpr (N == 1) {
        out[0] = src[0];
    } else if constexpr (N == 2) {
        const float2 x = *reinterpret_cast<const float2*>(src);
        out[0] = x.x, out[1] = x.y;
    } else {
#pragma unroll
        for (int h = 0; h < N / 4; ++h) {
            const float4 x = *reinterpret_cast<const float4*>(src + 4 * h);
            out[4 * h] = x.x, out[4 * h + 1] = x.y, out[4 * h + 2] = x.z, out[4 * h + 3] = x.w;
        }
    }
}

// acc[m][4 g + n] += sum_k A[k][a0 + m] * B[k][4 td + GS g + n], k = 0..63,
// g < G column groups GS = LW / G floats apart (G > 1 only for a k/v tile:
// the forward's hd 192 as three groups of 64): A a score tile (P, dS: [i][j]
// with j at j ^ 8 (i & 3); TRANSPOSED, dS^T or P^T: [j][i] with i at
// i ^ 4 (j & 7)), B a q/do tile or (PADDED) a k/v tile. All lanes read row
// k together, so every load is of one row; A's M values serve all G groups.
template <int HD, int M, bool TRANSPOSED, bool PADDED, int G = 1>
__device__ __forceinline__ void cols_by_rows(float (&acc)[M][4 * G], const float* A,
                                             const float* Bm, int a0, int td) {
    static_assert(G == 1 || PADDED, "column groups only in a k/v tile");
    constexpr int BS = PADDED ? KS<HD> : LW<HD>;
    constexpr int GS = LW<HD> / G;
    int oa[8], ob[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
        oa[u] = u * 64 + (TRANSPOSED ? (a0 ^ (u << 2)) : (a0 ^ ((u & 3) << 3)));
        ob[u] = u * BS + (PADDED ? 4 * td : (td ^ u) << 2);
    }
#pragma unroll 2
    for (int k8 = 0; k8 < 64; k8 += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            float a[M];
            load_vec<M>(a, A + oa[u] + k8 * 64);
#pragma unroll
            for (int g = 0; g < G; ++g) {
                const float4 b =
                    *reinterpret_cast<const float4*>(Bm + ob[u] + k8 * BS + g * GS);
#pragma unroll
                for (int m = 0; m < M; ++m) {
                    acc[m][4 * g] = fmaf(a[m], b.x, acc[m][4 * g]);
                    acc[m][4 * g + 1] = fmaf(a[m], b.y, acc[m][4 * g + 1]);
                    acc[m][4 * g + 2] = fmaf(a[m], b.z, acc[m][4 * g + 2]);
                    acc[m][4 * g + 3] = fmaf(a[m], b.w, acc[m][4 * g + 3]);
                }
            }
        }
    }
}

}  // namespace
