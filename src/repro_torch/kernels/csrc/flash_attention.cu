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
// past T are neither loaded nor written, keys past S are masked.
//
// Masked scores take no part in the softmax (p = 0), so a row with no valid
// key ends with l == 0 and gives 0 whatever the tiling; for every row with a
// valid key the result equals the TPU kernel's.
//
// For training, the fp32 entry also writes each row's log-sum-exp, lse =
// m + log(l) in scaled-score units, fp32 [B,H,T], which the backward
// (flash_attention_bwd.cu) reads to rebuild P = exp(s - lse). The pointer may
// be null (serving passes null and writes nothing more). A row with no valid
// key writes +inf: exp(s - inf) = 0, so the backward gives it no weight.
//
// What bounds it on the H100: operations. At T = S ~ 1000 and hd = 128 it
// does ~T/2 * 4 flops per byte of q, k, v and o, far above the card's ~295
// flops/byte, and in fp32 there are no tensor cores to spend them on: the
// bound is 67 TFLOP/s of FMAs. A 64x64 score tile is built from register
// micro-tiles read out of padded (bank-conflict-free) shared memory, and each
// warp then owns 8 query rows for the softmax and the P*V update, so the two
// phases need only a warp barrier between them.

#include "common.cuh"

namespace {

constexpr int BQ = 64;                   // query rows per block
constexpr int BK = 64;                   // keys per KV tile
constexpr int NT = 256;                  // threads per block (8 warps)
constexpr int RPW = BQ / (NT / 32);      // query rows owned by one warp
constexpr float NEG_INF = -1e30f;        // as the TPU kernel's NEG_INF

template <int HD>
struct Layout {                          // shared-memory layout, in floats
    static constexpr int QS = HD + 1;    // padded row strides
    static constexpr int KS = HD + 1;
    static constexpr int VS = HD;
    static constexpr int SS = BK + 1;
    static constexpr int q = 0;
    static constexpr int k = q + BQ * QS;
    static constexpr int v = k + BK * KS;
    static constexpr int s = v + BK * VS;
    static constexpr size_t bytes = (s + BQ * SS) * sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int T_len, int S_len, int H,
                 int KV, int causal, int window, int q_offset, float scale) {
    using L = Layout<HD>;
    constexpr int DPL = HD / 32;         // output dims owned by one lane
    extern __shared__ float smem[];
    float* Qs = smem + L::q;
    float* Ks = smem + L::k;
    float* Vs = smem + L::v;
    float* Ss = smem + L::s;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int kvh = h / (H / KV);
    const int q0 = blockIdx.x * BQ;
    const int rows = min(BQ, T_len - q0);
    const long long q_stride = static_cast<long long>(H) * HD;    // between positions
    const long long kv_stride = static_cast<long long>(KV) * HD;
    const T* qb = q + (static_cast<long long>(b) * T_len * H + h) * HD;
    const T* kb = k + (static_cast<long long>(b) * S_len * KV + kvh) * HD;
    const T* vb = v + (static_cast<long long>(b) * S_len * KV + kvh) * HD;
    T* ob = o + (static_cast<long long>(b) * T_len * H + h) * HD;

    for (int i = tid; i < BQ * HD; i += NT) {
        const int r = i / HD, c = i % HD;
        Qs[r * L::QS + c] = r < rows ? to_float(qb[(q0 + r) * q_stride + c]) : 0.f;
    }

    // Per-row state of this warp's rows; every lane holds the same values.
    float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
        m[rr] = NEG_INF;
        l[rr] = 0.f;
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) acc[rr][dd] = 0.f;
    }

    const int q_first = q0 + q_offset;               // absolute positions
    const int q_last = q0 + rows - 1 + q_offset;
    const int n_tiles = (S_len + BK - 1) / BK;
    for (int kt = 0; kt < n_tiles; ++kt) {
        const int k0 = kt * BK;
        const int k_last = min(k0 + BK, S_len) - 1;
        // Tile-level pruning, the TPU kernel's `live` (the same for the block).
        if (causal && k0 > q_last) break;
        if (window > 0 && k_last <= q_first - window) continue;

        __syncthreads();                             // last tile's readers are done
        for (int i = tid; i < BK * HD; i += NT) {
            const int r = i / HD, c = i % HD;
            const bool in = k0 + r < S_len;
            Ks[r * L::KS + c] = in ? to_float(kb[(k0 + r) * kv_stride + c]) : 0.f;
            Vs[r * L::VS + c] = in ? to_float(vb[(k0 + r) * kv_stride + c]) : 0.f;
        }
        __syncthreads();

        // Scores: thread (ty, tx) makes rows 4ty..4ty+3 x columns tx + 16c.
        {
            const int ty = tid >> 4, tx = tid & 15;
            float sacc[4][4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) sacc[r][c] = 0.f;
#pragma unroll 8
            for (int d = 0; d < HD; ++d) {
                float qv[4], kv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) qv[r] = Qs[(4 * ty + r) * L::QS + d];
#pragma unroll
                for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * L::KS + d];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) sacc[r][c] = fmaf(qv[r], kv[c], sacc[r][c]);
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) Ss[(4 * ty + r) * L::SS + tx + 16 * c] = sacc[r][c] * scale;
        }
        __syncthreads();

        // Online softmax and P*V, each warp on its own RPW rows.
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr) {
            const int r = warp * RPW + rr;
            const int qpos = q0 + r + q_offset;
            float sv[2];
            bool ok[2];
            float mx = NEG_INF;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int j = lane + 32 * c, kpos = k0 + j;
                ok[c] = kpos < S_len && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
                sv[c] = Ss[r * L::SS + j];
                if (ok[c]) mx = fmaxf(mx, sv[c]);
            }
            mx = warp_max(mx);
            const float m_new = fmaxf(m[rr], mx);
            float psum = 0.f;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const float p = ok[c] ? expf(sv[c] - m_new) : 0.f;
                Ss[r * L::SS + lane + 32 * c] = p;
                psum += p;
            }
            psum = warp_sum(psum);
            const float alpha = expf(m[rr] - m_new);
            m[rr] = m_new;
            l[rr] = alpha * l[rr] + psum;
#pragma unroll
            for (int dd = 0; dd < DPL; ++dd) acc[rr][dd] *= alpha;
        }
        __syncwarp();                                // P rows written by this warp

        for (int j = 0; j < BK; ++j) {
            float vv[DPL];
#pragma unroll
            for (int dd = 0; dd < DPL; ++dd) vv[dd] = Vs[j * L::VS + lane + 32 * dd];
#pragma unroll
            for (int rr = 0; rr < RPW; ++rr) {
                const float p = Ss[(warp * RPW + rr) * L::SS + j];
#pragma unroll
                for (int dd = 0; dd < DPL; ++dd) acc[rr][dd] = fmaf(p, vv[dd], acc[rr][dd]);
            }
        }
    }

#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
        const int r = warp * RPW + rr;
        if (r >= rows) continue;
        const float safe = l[rr] == 0.f ? 1.f : l[rr];
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd)
            ob[(q0 + r) * q_stride + lane + 32 * dd] = from_float<T>(acc[rr][dd] / safe);
        if (lse != nullptr && lane == 0)
            lse[static_cast<long long>(blockIdx.y) * T_len + q0 + r] =
                l[rr] == 0.f ? CUDART_INF_F : m[rr] + logf(l[rr]);
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int T_len,
           int S_len, int H, int KV, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
    auto kernel = flash_fwd_kernel<T, HD>;
    constexpr size_t smem = Layout<HD>::bytes;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((T_len + BQ - 1) / BQ, B * H);
    kernel<<<grid, NT, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                       static_cast<const T*>(v), static_cast<T*>(o), lse, T_len,
                                       S_len, H, KV, causal, window, q_offset, scale);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: [B,T,H,hd]; k, v: [B,S,KV,hd]; all contiguous fp32. lse: fp32
// [B,H,T] or null.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int T_len, int S_len, int H, int KV, int hd,
                                   int causal, int window, int q_offset, float scale,
                                   void* stream) {
    if (B <= 0 || T_len <= 0 || S_len <= 0 || KV <= 0 || H % KV != 0 || B * H > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    auto l = static_cast<float*>(lse);
    switch (hd) {
        case 32: return launch<float, 32>(q, k, v, o, l, B, T_len, S_len, H, KV, causal, window, q_offset, scale, s);
        case 64: return launch<float, 64>(q, k, v, o, l, B, T_len, S_len, H, KV, causal, window, q_offset, scale, s);
        case 128: return launch<float, 128>(q, k, v, o, l, B, T_len, S_len, H, KV, causal, window, q_offset, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
