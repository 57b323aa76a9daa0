// sLSTM time scan for Hopper: a persistent cooperative kernel with the
// recurrent weights spread over the shared memory of many SMs.
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
// The TPU kernel pins a head's R_h [dh, 4dh] in one core's VMEM for the whole
// scan. At xlstm-1.3b's dh = 512 that is 2 MiB of bf16 per head, and an SM
// has 227 KB of shared memory. So R_h is cut by units instead: block
// (head, g) owns the 16 units [16g, 16g+16) of one head, keeps their 4 gate
// columns of R_h in shared memory (dh x 64; 64 KB in bf16 at dh = 512) for
// the whole scan, and updates their (c, n, m, h) in registers. Each step needs
// all of h_{t-1} of its head, written by the head's other blocks: h goes
// through a double-buffered fp32 array in device memory (L2), and the head's
// dh/16 blocks meet at a barrier (an atomic counter per head) once per step.
// That barrier needs every block resident at once, so the kernel is launched
// cooperatively (cudaLaunchCooperativeKernel), which refuses a grid that
// cannot be co-resident instead of hanging. xlstm-1.3b: 4 heads x 32 blocks
// = 128 blocks on 132 SMs.
//
// What bounds it on the H100: the sequential chain, not the card's rates.
// The work per step (2 * B * 4dh * dh flops per head, 8.4 MFLOP at B=1,
// 4 heads, dh=512) is microseconds of one SM; spread over 128 SMs it takes
// well under a microsecond, and each step then waits on the read of h, the
// barrier and its memory fences. The bound this repository states is
// max(flops / 67 TFLOP/s, bytes / 3.35 TB/s); the kernel sits above it by
// the per-step latency times T.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnits = 16;                // units per block
constexpr int kCols = 4 * kUnits;         // gate columns per block
constexpr int kSplit = kThreads / kCols;  // threads sharing one column's dot
constexpr int kMaxBatch = kThreads / kUnits;
constexpr float kIClamp = 15.f;
constexpr float kMInit = -1e30f;

template <typename TR>
size_t smem_bytes(int B, int dh) {
    return sizeof(TR) * static_cast<size_t>(dh) * kCols         // R slice
           + sizeof(float) * static_cast<size_t>(B) * dh         // h_{t-1}
           + sizeof(float) * static_cast<size_t>(kSplit) * B * kCols;  // partial dots
}

__device__ __forceinline__ float log_sigmoid(float x) {
    return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// TW: type of wx and hs; TR: type of r. Grid: nh * (dh / kUnits) blocks.
template <typename TW, typename TR>
__global__ void __launch_bounds__(kThreads)
slstm_scan_kernel(const TW* __restrict__ wx, const TR* __restrict__ r,
                  const float* __restrict__ bias, TW* __restrict__ hs,
                  float* __restrict__ c_out, float* __restrict__ n_out,
                  float* __restrict__ m_out, float* __restrict__ h_out,
                  float* hbuf, int* counters, int B, int T_len, int nh, int dh) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    TR* r_s = reinterpret_cast<TR*>(smem_raw);                        // [dh][kCols]
    float* h_s = reinterpret_cast<float*>(r_s + static_cast<size_t>(dh) * kCols);  // [B][dh]
    float* part = h_s + B * dh;                                       // [kSplit][B][kCols]

    const int tid = threadIdx.x;
    const int groups = dh / kUnits;
    const int head = blockIdx.x / groups;
    const int u0 = (blockIdx.x % groups) * kUnits;
    const int gd = 4 * dh;

    // this block's columns of R_h: column c is gate c / kUnits, unit u0 + c % kUnits
    for (int i = tid; i < dh * kCols; i += kThreads) {
        const int d = i / kCols, c = i - d * kCols;
        r_s[i] = r[(static_cast<long long>(head) * dh + d) * gd + (c / kUnits) * dh + u0 +
                   c % kUnits];
    }
    for (int i = tid; i < B * dh; i += kThreads) h_s[i] = 0.f;

    // the cell thread of (batch row bi, unit u0 + j), if this thread is one
    const bool cell = tid < B * kUnits;
    const int bi = tid / kUnits, j = tid % kUnits;
    float bq[4] = {0.f, 0.f, 0.f, 0.f};
    float c = 0.f, n = 0.f, m = kMInit, h = 0.f;
    if (cell) {
#pragma unroll
        for (int q = 0; q < 4; ++q) bq[q] = bias[head * gd + q * dh + u0 + j];
    }
    // dot-product thread: column col, rows [k0, k0 + dh / kSplit)
    const int col = tid % kCols;
    const int rows = dh / kSplit;
    const int k0 = (tid / kCols) * rows;
    __syncthreads();

    for (int t = 0; t < T_len; ++t) {
        float wq[4] = {0.f, 0.f, 0.f, 0.f};
        if (cell) {  // loaded now, used after the dot products
            const long long g = ((static_cast<long long>(bi) * T_len + t) * nh + head) * gd + u0 + j;
#pragma unroll
            for (int q = 0; q < 4; ++q) wq[q] = to_float(wx[g + q * dh]);
        }
        for (int b = 0; b < B; ++b) {
            const float* hb = h_s + b * dh + k0;
            const TR* rc = r_s + static_cast<size_t>(k0) * kCols + col;
            float acc = 0.f;
#pragma unroll 8
            for (int d = 0; d < rows; ++d) acc = fmaf(hb[d], to_float(rc[d * kCols]), acc);
            part[((tid / kCols) * B + b) * kCols + col] = acc;
        }
        __syncthreads();

        const int nxt = (t + 1) & 1;
        if (cell) {
            float pre[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                float rec = 0.f;
#pragma unroll
                for (int k = 0; k < kSplit; ++k) rec += part[(k * B + bi) * kCols + q * kUnits + j];
                pre[q] = wq[q] + rec + bq[q];
            }
            const float i_log = fminf(pre[0], kIClamp);
            const float f_log = log_sigmoid(pre[1]);
            const float m_new = fmaxf(f_log + m, i_log);
            const float ig = expf(i_log - m_new);
            const float fg = expf(f_log + m - m_new);
            c = fg * c + ig * tanhf(pre[2]);
            n = fg * n + ig;
            m = m_new;
            h = (1.f / (1.f + expf(-pre[3]))) * c / fmaxf(n, 1.f);
            const long long hb = (static_cast<long long>(bi) * nh + head) * dh + u0 + j;
            hbuf[static_cast<long long>(nxt) * B * nh * dh + hb] = h;
            hs[((static_cast<long long>(bi) * T_len + t) * nh + head) * dh + u0 + j] =
                from_float<TW>(h);
        }
        if (t + 1 == T_len) break;

        // every block of this head has written h_t before any reads it
        __syncthreads();
        if (tid == 0) {
            __threadfence();
            atomicAdd(counters + head, 1);
            const int target = (t + 1) * groups;
            while (*static_cast<volatile int*>(counters + head) < target) {
            }
            __threadfence();
        }
        __syncthreads();
        const float* src = hbuf + static_cast<long long>(nxt) * B * nh * dh;
        for (int i = tid; i < B * dh; i += kThreads) {
            const int b = i / dh, d = i - b * dh;
            h_s[i] = __ldcg(src + (static_cast<long long>(b) * nh + head) * dh + d);
        }
        __syncthreads();
    }

    if (cell) {
        const long long o = (static_cast<long long>(bi) * nh + head) * dh + u0 + j;
        c_out[o] = c;
        n_out[o] = n;
        m_out[o] = m;
        h_out[o] = h;
    }
}

template <typename TW, typename TR>
int launch(const void* wx, const void* r, const float* bias, void* hs, float* c_out,
           float* n_out, float* m_out, float* h_out, float* hbuf, int* counters, int B,
           int T_len, int nh, int dh, cudaStream_t stream) {
    auto kernel = slstm_scan_kernel<TW, TR>;
    const size_t smem = smem_bytes<TR>(B, dh);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const TW* wx_p = static_cast<const TW*>(wx);
    const TR* r_p = static_cast<const TR*>(r);
    TW* hs_p = static_cast<TW*>(hs);
    void* args[] = {&wx_p, &r_p, &bias, &hs_p, &c_out, &n_out, &m_out, &h_out,
                    &hbuf, &counters, &B, &T_len, &nh, &dh};
    const dim3 grid(nh * (dh / kUnits)), block(kThreads);
    // refuses (cudaErrorCooperativeLaunchTooLarge) a grid that cannot be
    // resident all at once, which the per-step barrier needs
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid, block, args,
                                      smem, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

template <typename TW>
int dispatch_r(int r_dtype, const void* wx, const void* r, const float* bias, void* hs,
               float* c_out, float* n_out, float* m_out, float* h_out, float* hbuf,
               int* counters, int B, int T_len, int nh, int dh, cudaStream_t s) {
    if (r_dtype == REPRO_F32)
        return launch<TW, float>(wx, r, bias, hs, c_out, n_out, m_out, h_out, hbuf, counters, B,
                                 T_len, nh, dh, s);
    if (r_dtype == REPRO_BF16)
        return launch<TW, __nv_bfloat16>(wx, r, bias, hs, c_out, n_out, m_out, h_out, hbuf,
                                         counters, B, T_len, nh, dh, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// wx: [B,T,nh,4dh] and hs: [B,T,nh,dh] of one dtype (wx_dtype); r: [nh,dh,4dh]
// (r_dtype); bias: [nh,4dh] fp32; c/n/m/h_out: [B,nh,dh] fp32; hbuf:
// [2,B,nh,dh] fp32 scratch; counters: [nh] int32, zero. All contiguous;
// dh a multiple of 16 and B <= 16.
extern "C" int slstm_scan_fwd(const void* wx, const void* r, const float* bias, void* hs,
                              float* c_out, float* n_out, float* m_out, float* h_out,
                              float* hbuf, int* counters, int wx_dtype, int r_dtype, int B,
                              int T_len, int nh, int dh, void* stream) {
    if (B <= 0 || B > kMaxBatch || T_len <= 0 || nh <= 0 || dh <= 0 || dh % kUnits != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    if (wx_dtype == REPRO_F32)
        return dispatch_r<float>(r_dtype, wx, r, bias, hs, c_out, n_out, m_out, h_out, hbuf,
                                 counters, B, T_len, nh, dh, s);
    if (wx_dtype == REPRO_BF16)
        return dispatch_r<__nv_bfloat16>(r_dtype, wx, r, bias, hs, c_out, n_out, m_out, h_out,
                                         hbuf, counters, B, T_len, nh, dh, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
