// Causal / sliding-window GQA flash attention, backward, fp32, on the CUDA
// cores: dq, dk, dv from q, k, v, o, the forward's per-row log-sum-exp (lse)
// and do.
//
// The Pallas TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call at flash_attention.py:121) has no VJP: the JAX package trains
// through its jnp attention instead. This is the backward of the port's own
// forward (flash_attention.cu), in the same contract: q [B,T,H,hd], k/v
// [B,S,KV,hd], query row t at absolute position t + q_offset, KV head =
// q head / (H/KV), scale 1/sqrt(hd), causal and window masks, any T and S.
// With s = scale * q.k and P = exp(s - lse):
//   D  = rowsum(do * o)                  (flash_bwd_delta_kernel)
//   dv = P^T do,  dS = P * (do v^T - D)
//   dk = scale * dS^T q                  (flash_bwd_dkdv_kernel)
//   dq = scale * dS k                    (flash_bwd_dq_kernel)
// A row with no visible key has lse = +inf (flash_attention.cu), so its P,
// and with it its share of every gradient, is 0.
//
// Where a GPU flash backward usually adds dq from every key tile with float
// atomics, here two kernels each own what they write, so the sums run in a
// fixed order and the result is the same on every run:
// - dk/dv: one block per (batch, KV head, 64-key tile). It holds its k and v
//   tile in shared memory and loops over the group's query heads and every
//   64-row query tile that sees one of its keys, so GQA's sum over the group
//   stays in the block's registers.
// - dq: one block per (batch * head, 64-row query tile), looping over the key
//   tiles its rows can see, as the forward does.
// Each recomputes S and dP (the dq kernel does not store P); the work is
// ~3.5x the forward's two products where the least is 2.5x.
//
// What bounds it on the H100: operations. In fp32 there are no tensor cores
// to use (TF32 would not hold fp32's tolerance), so the bound is 67 TFLOP/s
// of FMAs. Every product is built from 4 x (hd/16 or 4) register micro-tiles
// read out of padded (bank-conflict-free) shared memory, as in the forward.

#include "common.cuh"

namespace {

constexpr int BQ = 64;                   // query rows per tile
constexpr int BK = 64;                   // keys per tile
constexpr int NT = 256;                  // threads per block: a 16 x 16 grid
constexpr int WARPS = NT / 32;

template <int HD>
struct Layout {                          // shared-memory layout, in floats
    static constexpr int RS = HD + 1;    // padded row stride of q, do, k, v tiles
    static constexpr int SS = BK + 1;    // padded row stride of P and dS tiles
    static constexpr int q = 0;
    static constexpr int dout = q + BQ * RS;
    static constexpr int k = dout + BQ * RS;
    static constexpr int v = k + BK * RS;
    static constexpr int p = v + BK * RS;
    static constexpr int ds = p + BQ * SS;
    static constexpr int lse = ds + BQ * SS;
    static constexpr int delta = lse + BQ;
    static constexpr size_t bytes = (delta + BQ) * sizeof(float);
};

struct Mask {
    int T_len, S_len, causal, window, q_offset;
    __device__ __forceinline__ bool visible(int t, int s) const {
        const int qpos = t + q_offset;
        return t < T_len && s < S_len && (!causal || s <= qpos) &&
               (window <= 0 || s > qpos - window);
    }
    // The forward's tile-level pruning: no (row, key) pair of the two tiles
    // is visible.
    __device__ __forceinline__ bool skip(int q0, int rows, int k0) const {
        const int q_first = q0 + q_offset, q_last = q0 + rows - 1 + q_offset;
        const int k_last = min(k0 + BK, S_len) - 1;
        return (causal && k0 > q_last) || (window > 0 && k_last <= q_first - window);
    }
};

// rows x HD floats from global (row stride `stride`) into shared memory
// (row stride RS); rows past `valid` are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long stride,
                                          int valid) {
    for (int i = threadIdx.x; i < 64 * HD; i += NT) {
        const int r = i / HD, c = i % HD;
        dst[r * Layout<HD>::RS + c] = r < valid ? src[r * stride + c] : 0.f;
    }
}

// acc[r][c] += sum_d A[4ty + r][d] * B[tx + 16c][d]: a 64 x 64 product of
// two row-major tiles, each thread making a 4 x 4 micro-tile.
template <int HD>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[4][4], const float* A,
                                              const float* Bm, int ty, int tx) {
    constexpr int RS = Layout<HD>::RS;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = A[(4 * ty + r) * RS + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = Bm[(tx + 16 * c) * RS + d];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
}

// S = q k^T and dP = do v^T for a (query tile, key tile) pair, then
// P = exp(scale * S - lse) and dS = P * (dP - D) where visible (else 0), at
// rows 4ty + r, keys tx + 16c. The caller stores what it needs.
template <int HD>
__device__ __forceinline__ void scores(float (&p)[4][4], float (&ds)[4][4], const float* smem,
                                       const Mask& mask, int q0, int k0, float scale, int ty,
                                       int tx) {
    using L = Layout<HD>;
    float s[4][4] = {}, dp[4][4] = {};
    rows_dot_rows<HD>(s, smem + L::q, smem + L::k, ty, tx);
    rows_dot_rows<HD>(dp, smem + L::dout, smem + L::v, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int row = 4 * ty + r;
        const float lse = smem[L::lse + row], delta = smem[L::delta + row];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const bool ok = mask.visible(q0 + row, k0 + tx + 16 * c);
            p[r][c] = ok ? expf(s[r][c] * scale - lse) : 0.f;
            ds[r][c] = p[r][c] * (dp[r][c] - delta);
        }
    }
}

// lse and D of the query tile's rows; rows past T get no weight.
template <int HD>
__device__ __forceinline__ void load_row_stats(float* smem, const float* lse,
                                               const float* delta, int rows) {
    using L = Layout<HD>;
    for (int r = threadIdx.x; r < BQ; r += NT) {
        smem[L::lse + r] = r < rows ? lse[r] : CUDART_INF_F;
        smem[L::delta + r] = r < rows ? delta[r] : 0.f;
    }
}

// D[b, h, t] = sum_d do[b, t, h, d] * o[b, t, h, d]: one warp per row.
template <int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                       float* __restrict__ delta, long long n_rows, int T_len, int H) {
    const long long row = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
    if (row >= n_rows) return;
    const int lane = threadIdx.x & 31;
    float acc = 0.f;
#pragma unroll
    for (int c = lane; c < HD; c += 32) acc = fmaf(dout[row * HD + c], o[row * HD + c], acc);
    acc = warp_sum(acc);
    if (lane == 0) {                     // row = (b * T + t) * H + h
        const long long bt = row / H;
        const int h = static_cast<int>(row % H);
        const long long b = bt / T_len, t = bt % T_len;
        delta[(b * H + h) * T_len + t] = acc;
    }
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int H, int KV,
                      Mask mask, float scale) {
    using L = Layout<HD>;
    constexpr int DPT = HD / 16;         // output dims per thread
    extern __shared__ float smem[];
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const int b = blockIdx.y / KV, kvh = blockIdx.y % KV, group = H / KV;
    const int T_len = mask.T_len, S_len = mask.S_len;
    const int k0 = blockIdx.x * BK, keys = min(BK, S_len - k0);
    const long long q_stride = static_cast<long long>(H) * HD;
    const long long kv_stride = static_cast<long long>(KV) * HD;
    const long long kv_off = (static_cast<long long>(b) * S_len + k0) * kv_stride + kvh * HD;

    load_tile<HD>(smem + L::k, k + kv_off, kv_stride, keys);
    load_tile<HD>(smem + L::v, v + kv_off, kv_stride, keys);

    float dk_acc[4][DPT] = {}, dv_acc[4][DPT] = {};
    for (int g = 0; g < group; ++g) {
        const int h = kvh * group + g;
        const long long row_stats = (static_cast<long long>(b) * H + h) * T_len;
        for (int q0 = 0; q0 < T_len; q0 += BQ) {
            const int rows = min(BQ, T_len - q0);
            if (mask.skip(q0, rows, k0)) continue;
            const long long q_off = (static_cast<long long>(b) * T_len + q0) * q_stride + h * HD;
            __syncthreads();                 // the last tile's readers are done
            load_tile<HD>(smem + L::q, q + q_off, q_stride, rows);
            load_tile<HD>(smem + L::dout, dout + q_off, q_stride, rows);
            load_row_stats<HD>(smem, lse + row_stats + q0, delta + row_stats + q0, rows);
            __syncthreads();

            float p[4][4], ds[4][4];
            scores<HD>(p, ds, smem, mask, q0, k0, scale, ty, tx);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    smem[L::p + (4 * ty + r) * L::SS + tx + 16 * c] = p[r][c];
                    smem[L::ds + (4 * ty + r) * L::SS + tx + 16 * c] = ds[r][c];
                }
            __syncthreads();

            // dv[j][d] += P[i][j] do[i][d]; dk[j][d] += dS[i][j] q[i][d], at keys
            // j = 4ty + r and dims d = tx + 16c.
#pragma unroll 4
            for (int i = 0; i < BQ; ++i) {
                float pv[4], dsv[4], dov[DPT], qv[DPT];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    pv[r] = smem[L::p + i * L::SS + 4 * ty + r];
                    dsv[r] = smem[L::ds + i * L::SS + 4 * ty + r];
                }
#pragma unroll
                for (int c = 0; c < DPT; ++c) {
                    dov[c] = smem[L::dout + i * L::RS + tx + 16 * c];
                    qv[c] = smem[L::q + i * L::RS + tx + 16 * c];
                }
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < DPT; ++c) {
                        dv_acc[r][c] = fmaf(pv[r], dov[c], dv_acc[r][c]);
                        dk_acc[r][c] = fmaf(dsv[r], qv[c], dk_acc[r][c]);
                    }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int j = 4 * ty + r;
        if (j >= keys) continue;
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
            const long long at = kv_off + j * kv_stride + tx + 16 * c;
            dk[at] = dk_acc[r][c] * scale;
            dv[at] = dv_acc[r][c];
        }
    }
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int H, int KV, Mask mask, float scale) {
    using L = Layout<HD>;
    constexpr int DPT = HD / 16;
    extern __shared__ float smem[];
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / (H / KV);
    const int T_len = mask.T_len, S_len = mask.S_len;
    const int q0 = blockIdx.x * BQ, rows = min(BQ, T_len - q0);
    const long long q_stride = static_cast<long long>(H) * HD;
    const long long kv_stride = static_cast<long long>(KV) * HD;
    const long long q_off = (static_cast<long long>(b) * T_len + q0) * q_stride + h * HD;
    const long long row_stats = (static_cast<long long>(b) * H + h) * T_len + q0;

    load_tile<HD>(smem + L::q, q + q_off, q_stride, rows);
    load_tile<HD>(smem + L::dout, dout + q_off, q_stride, rows);
    load_row_stats<HD>(smem, lse + row_stats, delta + row_stats, rows);

    float dq_acc[4][DPT] = {};
    for (int k0 = 0; k0 < S_len; k0 += BK) {
        if (mask.causal && k0 > q0 + rows - 1 + mask.q_offset) break;
        if (mask.skip(q0, rows, k0)) continue;
        const long long kv_off = (static_cast<long long>(b) * S_len + k0) * kv_stride + kvh * HD;
        __syncthreads();                     // the last tile's readers are done
        load_tile<HD>(smem + L::k, k + kv_off, kv_stride, min(BK, S_len - k0));
        load_tile<HD>(smem + L::v, v + kv_off, kv_stride, min(BK, S_len - k0));
        __syncthreads();

        float p[4][4], ds[4][4];
        scores<HD>(p, ds, smem, mask, q0, k0, scale, ty, tx);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) smem[L::ds + (4 * ty + r) * L::SS + tx + 16 * c] = ds[r][c];
        __syncthreads();

        // dq[i][d] += dS[i][j] k[j][d], at rows i = 4ty + r and dims d = tx + 16c.
#pragma unroll 4
        for (int j = 0; j < BK; ++j) {
            float dsv[4], kv[DPT];
#pragma unroll
            for (int r = 0; r < 4; ++r) dsv[r] = smem[L::ds + (4 * ty + r) * L::SS + j];
#pragma unroll
            for (int c = 0; c < DPT; ++c) kv[c] = smem[L::k + j * L::RS + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < DPT; ++c) dq_acc[r][c] = fmaf(dsv[r], kv[c], dq_acc[r][c]);
        }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int i = 4 * ty + r;
        if (i >= rows) continue;
#pragma unroll
        for (int c = 0; c < DPT; ++c) dq[q_off + i * q_stride + tx + 16 * c] = dq_acc[r][c] * scale;
    }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* o, const float* lse,
           const float* dout, float* dq, float* dk, float* dv, float* delta, int B, int H,
           int KV, Mask mask, float scale, cudaStream_t s) {
    constexpr size_t smem = Layout<HD>::bytes;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long n_rows = static_cast<long long>(B) * mask.T_len * H;
    flash_bwd_delta_kernel<HD><<<static_cast<unsigned>((n_rows + WARPS - 1) / WARPS), NT, 0, s>>>(
        o, dout, delta, n_rows, mask.T_len, H);
    dim3 kv_grid((mask.S_len + BK - 1) / BK, B * KV);
    flash_bwd_dkdv_kernel<HD><<<kv_grid, NT, smem, s>>>(q, k, v, dout, lse, delta, dk, dv, H, KV,
                                                        mask, scale);
    dim3 q_grid((mask.T_len + BQ - 1) / BQ, B * H);
    flash_bwd_dq_kernel<HD><<<q_grid, NT, smem, s>>>(q, k, v, dout, lse, delta, dq, H, KV, mask,
                                                     scale);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq: [B,T,H,hd]; k, v, dk, dv: [B,S,KV,hd]; lse (from
// flash_attention_fwd) and delta (scratch): [B,H,T]; all contiguous fp32.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* lse, const void* dout, void* dq, void* dk,
                                   void* dv, void* delta, int B, int T_len, int S_len, int H,
                                   int KV, int hd, int causal, int window, int q_offset,
                                   float scale, void* stream) {
    if (B <= 0 || T_len <= 0 || S_len <= 0 || KV <= 0 || H % KV != 0 || B * H > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const Mask mask{T_len, S_len, causal, window, q_offset};
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    auto w = [](void* p) { return static_cast<float*>(p); };
    auto s = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 32: return launch<32>(f(q), f(k), f(v), f(o), f(lse), f(dout), w(dq), w(dk), w(dv),
                                   w(delta), B, H, KV, mask, scale, s);
        case 64: return launch<64>(f(q), f(k), f(v), f(o), f(lse), f(dout), w(dq), w(dk), w(dv),
                                   w(delta), B, H, KV, mask, scale, s);
        case 128: return launch<128>(f(q), f(k), f(v), f(o), f(lse), f(dout), w(dq), w(dk),
                                     w(dv), w(delta), B, H, KV, mask, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
