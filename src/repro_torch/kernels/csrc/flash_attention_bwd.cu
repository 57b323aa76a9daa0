// Causal / sliding-window GQA flash attention, backward, in fp32 on the CUDA
// cores: dq, dk, dv from q, k, v, o, the forward's per-row log-sum-exp (lse)
// and do. The bf16 backward runs on the tensor cores in
// flash_attention_bwd_sm90.cu.
//
// The Pallas TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call at flash_attention.py:121) has no VJP: the JAX package trains
// through its jnp attention instead. This is the backward of the port's own
// forward (flash_attention.cu), in the same contract: q [B,T,H,hd], k/v
// [B,S,KV,hd], query row t at absolute position t + q_offset, KV head =
// q head / (H/KV), scale 1/sqrt(hd), causal and window masks, any T and S,
// hd 32, 64 or 128. With s = scale * q.k and P = exp(s - lse):
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
// Each recomputes S and dP: 7 tile products where a backward needs 5 (dq
// could be summed per key tile in the dk/dv pass instead, at T^2/64 floats
// of scratch: a later lever).
//
// What bounds it on the H100: operations. In fp32 there are no tensor cores
// to use (TF32 would not hold fp32's tolerance), so the bound is 67 TFLOP/s
// of FMAs, 128 a clock per SM: the FMA issue alone fills every scheduler,
// so every other instruction, and every stall, is lost FMA time. The design:
// - Loads never stall a product. Tiles come in by cp.async, 16 bytes a
//   thread, double-buffered: the next q/do tile (dk/dv) or k/v tile (dq) is
//   in flight while the current one's products run.
// - 16-byte shared loads without bank conflicts. q and do tiles are stored
//   unpadded with each 16-byte chunk of row r at chunk c ^ (r & 7); k and v
//   rows are padded to hd + 4 floats. So a float4 read along the rows of
//   several threads (the q.k and do.v products) and one read along a single
//   row (the P^T do, dS^T q and dS k products) both hit distinct banks.
//   Each thread reads float4 operands into 4x4 (q.k, do.v, and dS k at hd
//   128) or 8x4 (P^T do, dS^T q at hd 128) register micro-tiles: 2 or 2.7
//   FMAs per word it loads. The lanes of a warp form a 4 x 8 grid over the
//   micro-tiles, so a warp's load has at most 128 distinct bytes and costs
//   one shared-memory wavefront: 8 to 10.7 FMAs per wavefront, above the 4
//   that keep the FMA pipes fed.
// - 16 warps per block, one block per SM (227 KB of shared memory at hd 128
//   for dk/dv: k, v, two q and two do buffers, P and dS; 212.5 KB for dq),
//   128 registers a thread and no spills. The two halves of a block split
//   each step: warps 0-7 make S (then P and dv), warps 8-15 dP (then dk),
//   so no thread holds more than one accumulator of 32 floats, and no
//   kernel reserves a tile it does not use.
// - Heaviest tiles first: the grids put the tile index in y, so the block
//   scheduler starts every key tile 0 (the most query tiles under the causal
//   mask) before any key tile 1, and every last query tile before the
//   others, and the lighter tiles fill the SMs that finish early.
// The tiles, copies and micro-tile products live in flash_tiles.cuh, which
// the forward (flash_attention.cu) builds on too.

#include <cstdint>

#include "flash_tiles.cuh"

namespace {

template <int HD>
struct DkdvLayout {                      // shared memory, in floats
    static_assert(LW<HD> == HD, "the backward takes hd 32, 64 or 128");
    static constexpr int qtile = BQ * HD, ktile = BK * KS<HD>;
    static constexpr int k = 0, v = ktile;
    static constexpr int q = 2 * ktile, dout = q + 2 * qtile;  // 2 buffers each
    static constexpr int p = dout + 2 * qtile, ds = p + BQ * BK;
    static constexpr int stats = ds + BQ * BK;  // 2 buffers of lse[64], D[64]
    static constexpr size_t bytes = (stats + 4 * BQ) * sizeof(float);  // 227 KB at hd 128
};

template <int HD>
struct DqLayout {
    static constexpr int qtile = BQ * HD, ktile = BK * KS<HD>;
    static constexpr int q = 0, dout = qtile;
    static constexpr int k = 2 * qtile, v = k + 2 * ktile;     // 2 buffers each
    static constexpr int dst = v + 2 * ktile;
    static constexpr int stats = dst + BQ * BK;  // lse[64], D[64]
    static constexpr size_t bytes = (stats + 2 * BQ) * sizeof(float);
};

// lse[64] then D[64] of a query tile's rows; rows past `rows` are zero
// (the mask gives them no weight).
__device__ __forceinline__ void load_row_stats(float* dst, const float* lse, const float* delta,
                                               int rows) {
    const int t = threadIdx.x;
    if (t < 2 * BQ) {
        const int r = t % BQ;
        const float* src = t < BQ ? lse : delta;
        cp_async4(dst + t, r < rows ? src + r : src, r < rows);
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
    for (int c = lane; c < HD; c += 32)
        acc = fmaf(dout[row * HD + c], o[row * HD + c], acc);
    acc = warp_sum(acc);
    if (lane == 0) {                     // row = (b * T + t) * H + h
        const long long bt = row / H;
        const int h = static_cast<int>(row % H);
        const long long b = bt / T_len, t = bt % T_len;
        delta[(b * H + h) * T_len + t] = acc;
    }
}

// Four consecutive outputs from the accumulators: one 16-byte store.
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// The first pass at or after p (pass = group head * nq + query tile) whose
// query tile sees a key of the tile at k0; n_pass when none is left.
__device__ __forceinline__ int next_pass(int p, int n_pass, int nq, const Mask& mask, int k0) {
    while (p < n_pass && mask.skip((p % nq) * BQ, k0)) ++p;
    return p;
}

template <int HD>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int H, int KV,
                      Mask mask, float scale) {
    using L = DkdvLayout<HD>;
    constexpr int M = HD / 16;           // keys per thread in the dv / dk product
    extern __shared__ __align__(16) float smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int role = warp >> 3, rw = warp & 7;  // role 0: S, P, dv; role 1: dP, dS, dk
    const int ty = (rw >> 1) * 4 + (lane >> 3), tx = (rw & 1) * 8 + (lane & 7);
    const int tj = (rw / (HD / 32)) * 4 + (lane >> 3), td = (rw % (HD / 32)) * 8 + (lane & 7);
    const int T_len = mask.T_len, S_len = mask.S_len;
    const int k0 = blockIdx.y * BK, nq = (T_len + BQ - 1) / BQ, n_pass = (H / KV) * nq;
    const long long q_stride = static_cast<long long>(H) * HD;
    const long long kv_stride = static_cast<long long>(KV) * HD;
    auto kv_off = [&]() {                // of key k0 in k, v, dk and dv
        const int bx = block_x();
        return (static_cast<long long>(bx / KV) * S_len + k0) * kv_stride + (bx % KV) * HD;
    };

    auto load_pass = [&](int p, int buf) {
        const int bx = block_x(), b = bx / KV;
        const int h = (bx % KV) * (H / KV) + p / nq, q0 = (p % nq) * BQ;
        const int rows = min(BQ, T_len - q0);
        const long long q_off = (static_cast<long long>(b) * T_len + q0) * q_stride + h * HD;
        const long long stats = (static_cast<long long>(b) * H + h) * T_len + q0;
        load_tile<HD, false>(smem + L::q + buf * L::qtile, q + q_off, q_stride, rows);
        load_tile<HD, false>(smem + L::dout + buf * L::qtile, dout + q_off, q_stride, rows);
        load_row_stats(smem + L::stats + buf * 2 * BQ, lse + stats, delta + stats, rows);
    };

    load_tile<HD, true>(smem + L::k, k + kv_off(), kv_stride, min(BK, S_len - k0));
    load_tile<HD, true>(smem + L::v, v + kv_off(), kv_stride, min(BK, S_len - k0));
    int p = next_pass(0, n_pass, nq, mask, k0);
    if (p < n_pass) load_pass(p, 0);
    cp_async_commit();

    float acc[M][4] = {};                // role 0: dv, role 1: dk (unscaled)
    for (int buf = 0; p < n_pass; buf ^= 1) {
        cp_async_wait_all();
        __syncthreads();                 // pass p landed; pass p - 1's readers are done
        const int pn = next_pass(p + 1, n_pass, nq, mask, k0);
        if (pn < n_pass) load_pass(pn, buf ^ 1);
        cp_async_commit();

        const int q0 = (p % nq) * BQ;
        const float* qt = smem + L::q + buf * L::qtile;
        const float* dot = smem + L::dout + buf * L::qtile;
        const float* stats = smem + L::stats + buf * 2 * BQ;
        float* ps = smem + L::p;
        float* dss = smem + L::ds;

        // A: S = q k^T (role 0) or dP = do v^T (role 1), rows ty + 16r,
        // keys tx + 16c.
        float s[4][4] = {};
        rows_dot_rows<HD>(s, role ? dot : qt, smem + (role ? L::v : L::k), ty, tx);

        // B: role 1 stores dP - D; role 0 turns it into dS = P (dP - D) and
        // stores P beside it.
        if (role) {
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    dss[p_at(ty + 16 * r, tx + 16 * c)] = s[r][c] - stats[BQ + ty + 16 * r];
        }
        __syncthreads();
        if (!role) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = ty + 16 * r;
                const float row_lse = stats[i];
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int j = tx + 16 * c, at = p_at(i, j);
                    const float pr =
                        mask.visible(q0 + i, k0 + j) ? expf(s[r][c] * scale - row_lse) : 0.f;
                    ps[at] = pr;
                    dss[at] = pr * dss[at];
                }
            }
        }
        __syncthreads();

        // C: dv[j][d] += P[i][j] do[i][d] (role 0), dk[j][d] += dS[i][j] q[i][d]
        // (role 1), at keys tj * M + m and dims 4 td + n.
        cols_by_rows<HD, M, false, false>(acc, role ? dss : ps, role ? qt : dot, tj * M, td);
        p = pn;
    }
    cp_async_wait_all();                 // a block with no pass still has k and v in flight

    float* out = (role ? dk : dv) + kv_off();
    const float mul = role ? scale : 1.f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
        const int j = tj * M + m;
        if (j < min(BK, S_len - k0))
            store4(out + j * kv_stride + 4 * td, acc[m][0] * mul, acc[m][1] * mul,
                   acc[m][2] * mul, acc[m][3] * mul);
    }
}

template <int HD>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int H, int KV, Mask mask, float scale) {
    using L = DqLayout<HD>;
    constexpr int M = HD / 32;           // query rows per thread in the dq product
    extern __shared__ __align__(16) float smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int role = warp >> 3, rw = warp & 7;  // role 0: S, P, dS; role 1: dP
    const int ty = (rw >> 1) * 4 + (lane >> 3), tx = (rw & 1) * 8 + (lane & 7);
    const int ti = (warp / (HD / 32)) * 4 + (lane >> 3), td = (warp % (HD / 32)) * 8 + (lane & 7);
    const int T_len = mask.T_len, S_len = mask.S_len;
    const int nqt = (T_len + BQ - 1) / BQ, q0 = (nqt - 1 - blockIdx.y) * BQ;
    const int rows = min(BQ, T_len - q0), nk = (S_len + BK - 1) / BK;
    const long long q_stride = static_cast<long long>(H) * HD;
    const long long kv_stride = static_cast<long long>(KV) * HD;
    auto q_off = [&]() {                 // of row q0 in q, do and dq
        const int bx = block_x();
        return (static_cast<long long>(bx / H) * T_len + q0) * q_stride + (bx % H) * HD;
    };
    const long long stats = static_cast<long long>(blockIdx.x) * T_len + q0;

    auto load_keys = [&](int kt, int buf) {
        const int bx = block_x(), k0 = kt * BK;
        const long long kv_off = (static_cast<long long>(bx / H) * S_len + k0) * kv_stride +
                                 (bx % H) / (H / KV) * HD;
        load_tile<HD, true>(smem + L::k + buf * L::ktile, k + kv_off, kv_stride, min(BK, S_len - k0));
        load_tile<HD, true>(smem + L::v + buf * L::ktile, v + kv_off, kv_stride, min(BK, S_len - k0));
    };

    load_tile<HD, false>(smem + L::q, q + q_off(), q_stride, rows);
    load_tile<HD, false>(smem + L::dout, dout + q_off(), q_stride, rows);
    load_row_stats(smem + L::stats, lse + stats, delta + stats, rows);
    int kt = next_key_tile(0, nk, mask, q0);
    if (kt < nk) load_keys(kt, 0);
    cp_async_commit();

    const float* st = smem + L::stats;
    float* dst = smem + L::dst;
    float acc[M][4] = {};
    for (int buf = 0; kt < nk; buf ^= 1) {
        cp_async_wait_all();
        __syncthreads();                 // key tile kt landed; the last tile's readers are done
        const int ktn = next_key_tile(kt + 1, nk, mask, q0);
        if (ktn < nk) load_keys(ktn, buf ^ 1);
        cp_async_commit();

        const int k0 = kt * BK;
        const float* kt_s = smem + L::k + buf * L::ktile;

        // A: S (role 0) or dP (role 1) at rows ty + 16r, keys tx + 16c.
        float s[4][4] = {};
        rows_dot_rows<HD>(s, smem + (role ? L::dout : L::q),
                          role ? smem + L::v + buf * L::ktile : kt_s, ty, tx);

        // B: role 1 stores dP - D transposed; role 0 turns it into dS^T.
        if (role) {
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    dst[dst_at(tx + 16 * c, ty + 16 * r)] = s[r][c] - st[BQ + ty + 16 * r];
        }
        __syncthreads();
        if (!role) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = ty + 16 * r;
                const float row_lse = st[i];
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int j = tx + 16 * c, at = dst_at(j, i);
                    const float pr =
                        mask.visible(q0 + i, k0 + j) ? expf(s[r][c] * scale - row_lse) : 0.f;
                    dst[at] = pr * dst[at];
                }
            }
        }
        __syncthreads();

        // C: dq[i][d] += dS[i][j] k[j][d], all 16 warps, at rows ti * M + m
        // and dims 4 td + n.
        cols_by_rows<HD, M, true, true>(acc, dst, kt_s, ti * M, td);
        kt = ktn;
    }
    cp_async_wait_all();

#pragma unroll
    for (int m = 0; m < M; ++m) {
        const int i = ti * M + m;
        if (i < rows)
            store4(dq + q_off() + i * q_stride + 4 * td, acc[m][0] * scale, acc[m][1] * scale,
                   acc[m][2] * scale, acc[m][3] * scale);
    }
}

template <int HD>
cudaError_t set_smem() {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(DkdvLayout<HD>::bytes));
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(DqLayout<HD>::bytes));
    return err;
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* o, const float* lse,
           const float* dout, float* dq, float* dk, float* dv, float* delta, int B, int H,
           int KV, Mask mask, float scale, cudaStream_t s) {
    const cudaError_t err = set_smem<HD>();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long n_rows = static_cast<long long>(B) * mask.T_len * H;
    flash_bwd_delta_kernel<HD><<<static_cast<unsigned>((n_rows + WARPS - 1) / WARPS), NT, 0,
                                 s>>>(o, dout, delta, n_rows, mask.T_len, H);
    const dim3 kv_grid(B * KV, (mask.S_len + BK - 1) / BK);
    flash_bwd_dkdv_kernel<HD><<<kv_grid, NT, DkdvLayout<HD>::bytes, s>>>(
        q, k, v, dout, lse, delta, dk, dv, H, KV, mask, scale);
    const dim3 q_grid(B * H, (mask.T_len + BQ - 1) / BQ);
    flash_bwd_dq_kernel<HD><<<q_grid, NT, DqLayout<HD>::bytes, s>>>(
        q, k, v, dout, lse, delta, dq, H, KV, mask, scale);
    return static_cast<int>(cudaGetLastError());
}

template <int HD>
int occupancy(int* out) {
    cudaError_t err = set_smem<HD>();
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, flash_bwd_dkdv_kernel<HD>,
                                                            NT, DkdvLayout<HD>::bytes);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, flash_bwd_dq_kernel<HD>,
                                                            NT, DqLayout<HD>::bytes);
    out[0] = static_cast<int>(DkdvLayout<HD>::bytes);
    out[2] = static_cast<int>(DqLayout<HD>::bytes);
    return static_cast<int>(err);
}

}  // namespace

// q, o, dout, dq: [B,T,H,hd]; k, v, dk, dv: [B,S,KV,hd]; lse (from the
// forward) and delta (scratch): fp32 [B,H,T]; all contiguous fp32, the six
// [B,*,*,hd] tensors 16-byte aligned.
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
    auto d = static_cast<float*>(delta);
    auto s = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 32: return launch<32>(f(q), f(k), f(v), f(o), f(lse), f(dout), w(dq), w(dk), w(dv),
                                   d, B, H, KV, mask, scale, s);
        case 64: return launch<64>(f(q), f(k), f(v), f(o), f(lse), f(dout), w(dq), w(dk), w(dv),
                                   d, B, H, KV, mask, scale, s);
        case 128: return launch<128>(f(q), f(k), f(v), f(o), f(lse), f(dout), w(dq), w(dk),
                                     w(dv), d, B, H, KV, mask, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// out[0..3] = dynamic shared memory of the dk/dv kernel (bytes), its blocks
// per SM, the same two of the dq kernel, at head dim hd.
extern "C" int flash_attention_bwd_occupancy(int hd, int* out) {
    switch (hd) {
        case 32: return occupancy<32>(out);
        case 64: return occupancy<64>(out);
        case 128: return occupancy<128>(out);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
