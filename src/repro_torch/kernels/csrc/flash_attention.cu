// Causal / sliding-window GQA flash attention (forward), fp32, on the CUDA
// cores. bf16 tensors take the tensor-core kernel of flash_attention_sm90.cu;
// this one serves fp32, where TF32 tensor cores would not hold fp32's
// tolerance.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (wrapper `flash_attention`, pallas_call at flash_attention.py:121). Same
// contract: q [B,T,H,hd], k/v [B,S,KV,hd], query row t sits at absolute
// position t + q_offset, KV head = q head / (H/KV), scale 1/sqrt(hd), online
// softmax with an fp32 (acc, m, l) state, KV tiles that are fully masked for
// the whole query tile are skipped, and a row whose l stays 0 gives 0.
//
// Where the TPU kernel walks KV blocks along a sequential third grid axis and
// carries (acc, m, l) in VMEM scratch from one grid step to the next, blocks
// here run in no order, so one block owns one (batch*head, query tile) and
// loops over the KV tiles itself, staging each in shared memory. Unlike the
// TPU wrapper (which asserts T % block_q == 0), any T and S are taken: rows
// past T are zero-filled and never written, keys past S are masked.
//
// Masked scores take no part in the softmax (p = 0), so a row with no valid
// key ends with l == 0 and gives 0 whatever the tiling; for every row with a
// valid key the result equals the TPU kernel's.
//
// For training, the fp32 entry also writes each row's log-sum-exp, lse =
// m + log(l) in scaled-score natural-log units, fp32 [B,H,T], which the
// backward (flash_attention_bwd.cu) reads to rebuild P = exp(s - lse). The
// pointer may be null (serving passes null and writes nothing more). A row
// with no valid key writes +inf: exp(s - inf) = 0, so the backward gives it
// no weight.
//
// What bounds it on the H100: operations. At T = S ~ 1000 and hd = 128 it
// does ~T/2 * 4 flops per byte of q, k, v and o, far above the card's ~295
// flops/byte, and in fp32 there are no tensor cores to spend them on: the
// bound is 67 TFLOP/s of FMAs, where every instruction other than an FMA,
// and every stall, is lost FMA time. The design is the backward dq kernel's
// (flash_tiles.cuh holds what they share) without its dP product:
// - One block of 16 warps per (batch * head, 64-row query tile), one block
//   per SM (212.5 KB of shared memory at hd 128), 128 registers a thread.
//   The grid puts the query tile in y, last tile first, so the blocks that
//   see the most key tiles under the causal mask start first.
// - Loads never stall a product: the q tile (swizzled) and each visible k/v
//   tile (rows padded to hd + 4) come in by 16-byte cp.async, k and v
//   double-buffered, so the next visible tile is in flight while the
//   current one's products run.
// - Three barriers a key tile. A: S = q k^T, both halves of the block on
//   the same 4x4 register micro-tiles, each over half of d (16-byte chunks
//   0-3 and 4-7 of every 32 floats), and each stores its partial. B: each
//   warp owns 4 rows (8 lanes a row, 8 keys a lane): S = (partial 0 +
//   partial 1) * scale, masked, the running max m, P = exp(S - m), the row
//   sum l and alpha = exp(m_old - m), m and l kept in the lanes' registers;
//   P is stored transposed, alpha in shared memory. C: all 16 warps run
//   acc = alpha acc + P V on 4x4 (hd 128) micro-tiles of o, each thread's
//   accumulator [hd/32][4]. The sums run in a fixed order: two calls give
//   the same bits.
// - hd 80 (zamba2's shared block) does not split into the warps' 32-float
//   groups, so it runs in hd 128's tiles and warp map (flash_tiles.cuh, LW):
//   20 of 32 chunks a row are copied in, the other 12 zeroed once before the
//   loop in q and in both k/v buffers, S summed over the first 96 floats of
//   d only, P V over all 128 (the pad columns of o are never stored). The
//   global strides stay H*80 and KV*80; the shared memory and the one block
//   per SM are hd 128's.
// - hd 192 (nemotron-4-340b): double-buffered k and v tiles would take
//   ~293 KB of shared memory (q 48 KB, four k/v tiles of 49 KB, the partial
//   S 32 KB, P^T 16 KB) against a block's 227 KB. So at hd 192 k and v are
//   single-buffered, 194.5 KB in all, and reloaded as soon as their last
//   reader is done: the next k tile after phase A (it flies under B and
//   C), the next v tile after phase C (it flies under the next A and B);
//   cp.async groups are waited for one at a time, and a fourth barrier per
//   key tile guards v. Phase C runs hd 64's warp map over three 64-column
//   groups of o (FwdLayout::G): each thread holds 2 rows x 12 columns, 24
//   floats, and each P^T value it reads serves 12 products.

#include "flash_tiles.cuh"

namespace {

constexpr float NEG_INF = -1e30f;        // as the TPU kernel's NEG_INF

template <int HD>
struct FwdLayout {                       // shared memory, in floats
    static constexpr int NBUF = LW<HD> > 128 ? 1 : 2;         // k and v buffers each
    static constexpr int G = LW<HD> > 128 ? 3 : 1;            // column groups of o
    static constexpr int qtile = BQ * LW<HD>, ktile = BK * KS<HD>;
    static constexpr int q = 0;
    static constexpr int k = qtile, v = k + NBUF * ktile;
    static constexpr int s = v + NBUF * ktile;                // the halves' partial S
    static constexpr int pt = s + 2 * BQ * BK;                // P^T
    static constexpr int stats = pt + BQ * BK;                // alpha[64], l[64]
    static constexpr size_t bytes = (stats + 2 * BQ) * sizeof(float);
};

// Max and sum over the 8 lanes that hold one row in phase B.
__device__ __forceinline__ float max8(float x) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

__device__ __forceinline__ float sum8(float x) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

template <int HD>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int H, int KV, Mask mask, float scale) {
    using L = FwdLayout<HD>;
    constexpr int W = LW<HD>;            // floats of a tile row
    constexpr int G = L::G, MW = W / G;  // P V: G groups of MW columns of o
    constexpr int M = MW / 32;           // query rows per thread in the P V product
    extern __shared__ __align__(16) float smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int role = warp >> 3, rw = warp & 7;  // role r sums S over its half of d
    const int ty = (rw >> 1) * 4 + (lane >> 3), tx = (rw & 1) * 8 + (lane & 7);
    const int si = warp * 4 + (lane >> 3), sj = lane & 7;  // phase B: row si, keys sj + 8c
    const int ti = (warp / (MW / 32)) * 4 + (lane >> 3), td = (warp % (MW / 32)) * 8 + (lane & 7);
    const int T_len = mask.T_len, S_len = mask.S_len;
    const int nqt = (T_len + BQ - 1) / BQ, q0 = (nqt - 1 - blockIdx.y) * BQ;
    const int rows = min(BQ, T_len - q0), nk = (S_len + BK - 1) / BK;
    const long long q_stride = static_cast<long long>(H) * HD;
    const long long kv_stride = static_cast<long long>(KV) * HD;
    auto q_off = [&]() {                 // of row q0 in q and o
        const int bx = block_x();
        return (static_cast<long long>(bx / H) * T_len + q0) * q_stride + (bx % H) * HD;
    };

    // key tile kt of k (tile = L::k) or v (L::v) into buffer buf
    auto load_keys = [&](int tile, const float* src, int kt, int buf) {
        const int bx = block_x(), k0 = kt * BK;
        const long long kv_off = (static_cast<long long>(bx / H) * S_len + k0) * kv_stride +
                                 (bx % H) / (H / KV) * HD;
        load_tile<HD, true>(smem + tile + buf * L::ktile, src + kv_off, kv_stride,
                            min(BK, S_len - k0));
    };

    zero_pad<HD, false>(smem + L::q);
    for (int b = 0; b < L::NBUF; ++b) {
        zero_pad<HD, true>(smem + L::k + b * L::ktile);
        zero_pad<HD, true>(smem + L::v + b * L::ktile);
    }
    load_tile<HD, false>(smem + L::q, q + q_off(), q_stride, rows);
    int kt = next_key_tile(0, nk, mask, q0);
    if (kt < nk) load_keys(L::k, k, kt, 0);
    if constexpr (L::NBUF == 1) cp_async_commit();           // q and k, then v apart
    if (kt < nk) load_keys(L::v, v, kt, 0);
    cp_async_commit();

    const float* part = smem + L::s;     // role r's partial at part + r * BQ * BK
    float* pt = smem + L::pt;
    float* alpha_s = smem + L::stats;
    float* l_s = alpha_s + BQ;
    float m_row = NEG_INF, l_row = 0.f;  // row si's running max and sum
    float acc[M][4 * G] = {};
    for (int buf = 0; kt < nk; buf = (buf + 1) % L::NBUF) {
        const int ktn = next_key_tile(kt + 1, nk, mask, q0);
        if constexpr (L::NBUF == 2) {
            cp_async_wait_all();
            __syncthreads();             // key tile kt landed; the last tile's readers are done
            if (ktn < nk) {
                load_keys(L::k, k, ktn, buf ^ 1);
                load_keys(L::v, v, ktn, buf ^ 1);
            }
            cp_async_commit();
        } else {
            cp_async_wait<1>();          // k of tile kt landed (its v may be in flight)
            __syncthreads();
        }

        const int k0 = kt * BK;

        // A: role r's partial S over chunks 4r..4r+3 of every 32 floats of d,
        // at rows ty + 16r', keys tx + 16c.
        {
            float s[4][4] = {};
            rows_dot_rows<HD, 4>(s, smem + L::q, smem + L::k + buf * L::ktile, ty, tx, 4 * role);
            float* mine = smem + L::s + role * BQ * BK;
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) mine[p_at(ty + 16 * r, tx + 16 * c)] = s[r][c];
        }
        __syncthreads();
        if constexpr (L::NBUF == 1) {    // every reader of k is done: load the next
            if (ktn < nk) load_keys(L::k, k, ktn, 0);
            cp_async_commit();
        }

        // B: online softmax of row si over keys sj + 8c; P^T and alpha out.
        {
            float sv[8];
            float mx = -CUDART_INF_F;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const int j = sj + 8 * c, at = p_at(si, j);
                const float x = (part[at] + part[BQ * BK + at]) * scale;
                sv[c] = mask.visible(q0 + si, k0 + j) ? x : -CUDART_INF_F;
                mx = fmaxf(mx, sv[c]);
            }
            const float m_new = fmaxf(m_row, max8(mx));   // finite: m_row >= NEG_INF
            float psum = 0.f;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const float p = expf(sv[c] - m_new);     // 0 where masked
                pt[dst_at(sj + 8 * c, si)] = p;
                psum += p;
            }
            const float alpha = expf(m_row - m_new);
            m_row = m_new;
            l_row = alpha * l_row + sum8(psum);
            if (sj == 0) alpha_s[si] = alpha;
        }
        if constexpr (L::NBUF == 1) cp_async_wait<1>();   // v of tile kt landed
        __syncthreads();

        // C: acc = alpha acc + P V, all 16 warps, at rows ti * M + m and
        // dims 4 td + n.
        {
            float al[M];
            load_vec<M>(al, alpha_s + ti * M);
#pragma unroll
            for (int m = 0; m < M; ++m)
#pragma unroll
                for (int n = 0; n < 4 * G; ++n) acc[m][n] *= al[m];
            cols_by_rows<HD, M, true, true, G>(acc, pt, smem + L::v + buf * L::ktile, ti * M,
                                               td);
        }
        if constexpr (L::NBUF == 1) {    // every reader of v is done: load the next
            __syncthreads();
            if (ktn < nk) load_keys(L::v, v, ktn, 0);
            cp_async_commit();
        }
        kt = ktn;
    }
    cp_async_wait_all();                 // a block with no visible tile still has q in flight

    if (sj == 0) {
        l_s[si] = l_row;
        if (lse != nullptr && si < rows)
            lse[static_cast<long long>(blockIdx.x) * T_len + q0 + si] =
                l_row == 0.f ? CUDART_INF_F : m_row + logf(l_row);
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < M; ++m) {
        const int i = ti * M + m;
        const float safe = i < rows && l_s[i] != 0.f ? l_s[i] : 1.f;
#pragma unroll
        for (int g = 0; g < G; ++g) {
            const int col = 4 * td + MW * g;
            if (i < rows && col < HD)
                *reinterpret_cast<float4*>(o + q_off() + i * q_stride + col) =
                    make_float4(acc[m][4 * g] / safe, acc[m][4 * g + 1] / safe,
                                acc[m][4 * g + 2] / safe, acc[m][4 * g + 3] / safe);
        }
    }
}

template <int HD>
cudaError_t set_smem() {
    return cudaFuncSetAttribute(flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(FwdLayout<HD>::bytes));
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, float* lse, int B, int H,
           int KV, Mask mask, float scale, cudaStream_t stream) {
    const cudaError_t err = set_smem<HD>();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(B * H, (mask.T_len + BQ - 1) / BQ);
    flash_fwd_kernel<HD><<<grid, NT, FwdLayout<HD>::bytes, stream>>>(q, k, v, o, lse, H, KV,
                                                                     mask, scale);
    return static_cast<int>(cudaGetLastError());
}

template <int HD>
int occupancy(int* out) {
    cudaError_t err = set_smem<HD>();
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, flash_fwd_kernel<HD>, NT,
                                                            FwdLayout<HD>::bytes);
    out[0] = static_cast<int>(FwdLayout<HD>::bytes);
    return static_cast<int>(err);
}

}  // namespace

// q, o: [B,T,H,hd]; k, v: [B,S,KV,hd]; all contiguous fp32, q, k, v and o
// 16-byte aligned. lse: fp32 [B,H,T] or null.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int T_len, int S_len, int H, int KV, int hd,
                                   int causal, int window, int q_offset, float scale,
                                   void* stream) {
    if (B <= 0 || T_len <= 0 || S_len <= 0 || KV <= 0 || H % KV != 0 || B * H > 65535 ||
        (T_len + BQ - 1) / BQ > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const Mask mask{T_len, S_len, causal, window, q_offset};
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    auto w = [](void* p) { return static_cast<float*>(p); };
    auto s = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 32: return launch<32>(f(q), f(k), f(v), w(o), w(lse), B, H, KV, mask, scale, s);
        case 64: return launch<64>(f(q), f(k), f(v), w(o), w(lse), B, H, KV, mask, scale, s);
        case 80: return launch<80>(f(q), f(k), f(v), w(o), w(lse), B, H, KV, mask, scale, s);
        case 128: return launch<128>(f(q), f(k), f(v), w(o), w(lse), B, H, KV, mask, scale, s);
        case 192: return launch<192>(f(q), f(k), f(v), w(o), w(lse), B, H, KV, mask, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// out[0..1] = dynamic shared memory of the forward kernel (bytes) and its
// blocks per SM, at head dim hd.
extern "C" int flash_attention_fwd_occupancy(int hd, int* out) {
    switch (hd) {
        case 32: return occupancy<32>(out);
        case 64: return occupancy<64>(out);
        case 80: return occupancy<80>(out);
        case 128: return occupancy<128>(out);
        case 192: return occupancy<192>(out);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
