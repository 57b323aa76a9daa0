// Backward of the sLSTM time scan for Hopper: time walked in reverse, one
// launch of a step kernel per time step, fp32 on the CUDA cores.
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
// the walk recomputes nothing. slstm_bwd_step_kernel runs step t: block k
// of head h owns units [16k, 16k + 16); it stages dpre_{t+1} of the whole
// head (B x 4dh fp32) in shared memory, each warp takes two of its units'
// rows of R_h (row d holds the 4dh weights from h[d]) and sums R_h[d, :] .
// dpre_{t+1} with each lane on 8 adjacent columns (one 16-byte load of a
// bf16 row) and a warp sum, then one thread per (batch row, unit) runs the
// local backward, writes dpre_t (= dwx_t) and keeps (dc, dn, dm) in a carry
// buffer it alone reads and writes. The next launch sees dpre_t whole: the
// kernel boundary is the step's barrier (no grid barrier, no atomics).
// slstm_bwd_bias_kernel then sums db over batch and time in order. dR =
// sum_t h_{t-1}^T dpre_t has no counterpart in the TPU kernel's body; the
// wrapper takes it as one fp32 product over the stacked steps.
//
// What bounds it: the chain of T dependent steps. A step is 2 B 4dh dh flops
// per head (8.4 MFLOP at B=1, 4 heads, dh=512) and reads R from L2; the
// launch of each step, a few microseconds, is most of its time. A simple
// first design: a persistent cluster walk as the forward's would remove the
// launches.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kUnits = 16;        // units per block (slstm_scan.py BWD_UNITS)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBatch = 16;
constexpr float kIClamp = 15.f;
constexpr float kMInit = -1e30f;
constexpr int kMaxSmem = 232448;
static_assert(kUnits % kWarps == 0 && kMaxBatch * kUnits <= kThreads, "the step's thread map");

__device__ __forceinline__ float log_sigmoid(float x) {
    return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// JAX's share of the gradient of max(x, y) that goes to x.
__device__ __forceinline__ float tie(float x, float y) {
    return x > y ? 1.f : (x == y ? 0.5f : 0.f);
}

__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// 8 adjacent values of a row of R in device memory, exactly as fp32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = bf16_lo(u.x), v[1] = bf16_hi(u.x), v[2] = bf16_lo(u.y), v[3] = bf16_hi(u.y);
    v[4] = bf16_lo(u.z), v[5] = bf16_hi(u.z), v[6] = bf16_lo(u.w), v[7] = bf16_hi(u.w);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

size_t step_smem(int B, int dh) {
    return sizeof(float) * (static_cast<size_t>(B) * 4 * dh + B * kUnits);
}

// Step t of the reverse walk. TR: r's type; TW: dhs's (wx's) type.
// Grid: nh * dh / kUnits blocks, block k of head h owns units [16k, 16k+16).
template <typename TR, typename TW>
__global__ void __launch_bounds__(kThreads)
slstm_bwd_step_kernel(const TR* __restrict__ r, const float* __restrict__ pre,
                      const float* __restrict__ steps, const TW* __restrict__ dhs,
                      float* __restrict__ carry, float* __restrict__ dpre, int B, int T_len,
                      int nh, int dh, int t) {
    extern __shared__ __align__(16) float smem[];
    const int gd = 4 * dh, per_head = dh / kUnits;
    const int head = blockIdx.x / per_head, u0 = (blockIdx.x % per_head) * kUnits;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float* next = smem;                         // dpre_{t+1} of the head, [B][4dh]
    float* rec = smem + B * gd;                 // R_h dpre_{t+1} for the block's units, [B][kUnits]
    const bool has_next = t + 1 < T_len;
    if (has_next) {
        for (int i = 4 * tid; i < B * gd; i += 4 * kThreads) {
            const int b = i / gd, e = i - b * gd;
            *reinterpret_cast<float4*>(next + i) = *reinterpret_cast<const float4*>(
                dpre + ((static_cast<long long>(b) * T_len + t + 1) * nh + head) * gd + e);
        }
    }
    __syncthreads();
#pragma unroll
    for (int uu = 0; uu < kUnits / kWarps; ++uu) {
        const int u = warp * (kUnits / kWarps) + uu;
        float acc[kMaxBatch];
#pragma unroll
        for (int b = 0; b < kMaxBatch; ++b) acc[b] = 0.f;
        if (has_next) {
            const TR* row = r + (static_cast<long long>(head) * dh + u0 + u) * gd;
            for (int e0 = 8 * lane; e0 < gd; e0 += 8 * 32) {
                float rv[8];
                load8(row + e0, rv);
#pragma unroll
                for (int b = 0; b < kMaxBatch; ++b) {
                    if (b >= B) break;
                    const float4 x0 = *reinterpret_cast<const float4*>(next + b * gd + e0);
                    const float4 x1 = *reinterpret_cast<const float4*>(next + b * gd + e0 + 4);
                    float s = acc[b];
                    s = fmaf(rv[0], x0.x, s);
                    s = fmaf(rv[1], x0.y, s);
                    s = fmaf(rv[2], x0.z, s);
                    s = fmaf(rv[3], x0.w, s);
                    s = fmaf(rv[4], x1.x, s);
                    s = fmaf(rv[5], x1.y, s);
                    s = fmaf(rv[6], x1.z, s);
                    s = fmaf(rv[7], x1.w, s);
                    acc[b] = s;
                }
            }
        }
#pragma unroll
        for (int b = 0; b < kMaxBatch; ++b) {
            if (b >= B) break;
            const float v = warp_sum(acc[b]);
            if (lane == 0) rec[b * kUnits + u] = v;
        }
    }
    __syncthreads();
    if (tid >= B * kUnits) return;
    const int b = tid / kUnits, u = tid - b * kUnits, d = u0 + u;
    const long long bt = static_cast<long long>(b) * T_len + t;
    const long long plane = static_cast<long long>(B) * T_len * nh * dh;
    const float* p = pre + (bt * nh + head) * gd + d;
    const float pi = p[0], pf = p[dh], pz = p[2 * dh], po = p[3 * dh];
    float c = 0.f, n = 0.f, m = kMInit;
    if (t > 0) {
        const long long o = ((bt - 1) * nh + head) * dh + d;
        c = steps[o];
        n = steps[plane + o];
        m = steps[2 * plane + o];
    }
    const long long ci = (static_cast<long long>(b) * nh + head) * dh + d;
    const long long cplane = static_cast<long long>(B) * nh * dh;
    const float dc_new = carry[ci], dn_new = carry[cplane + ci], dm_new = carry[2 * cplane + ci];
    const float g = to_float(dhs[(bt * nh + head) * dh + d]) + rec[b * kUnits + u];

    // the step again, as the forward computes it
    const float i_log = fminf(pi, kIClamp);
    const float f_log = log_sigmoid(pf);
    const float a = f_log + m;
    const float m_new = fmaxf(a, i_log);
    const float ig = expf(i_log - m_new);
    const float fg = expf(a - m_new);
    const float z = tanhf(pz);
    const float o = 1.f / (1.f + expf(-po));
    const float c_new = fg * c + ig * z;
    const float n_new = fg * n + ig;
    const float nn = fmaxf(n_new, 1.f);

    const float d_o = g * c_new / nn;
    const float dc_t = dc_new + g * o / nn;
    const float dn_t = dn_new - g * o * c_new / (nn * nn) * tie(n_new, 1.f);
    const float dfg = dc_t * c + dn_t * n;
    const float dig = dc_t * z + dn_t;
    const float t_ig = dig * ig, t_fg = dfg * fg;
    const float dm_t = dm_new - t_ig - t_fg;
    const float share = tie(a, i_log);
    const float da = t_fg + dm_t * share;
    const float di = (t_ig + dm_t * (1.f - share)) * tie(-pi, -kIClamp);
    float* q = dpre + (bt * nh + head) * gd + d;
    q[0] = di;
    q[dh] = da * (1.f / (1.f + expf(pf)));     // d log_sigmoid(f) / df = sigmoid(-f)
    q[2 * dh] = dc_t * ig * (1.f - z * z);
    q[3 * dh] = d_o * o * (1.f - o);
    carry[ci] = dc_t * fg;
    carry[cplane + ci] = dn_t * fg;
    carry[2 * cplane + ci] = da;
}

// db[h][e] = sum over b, then t, of dpre[b][t][h][e].
__global__ void __launch_bounds__(kThreads)
slstm_bwd_bias_kernel(const float* __restrict__ dpre, float* __restrict__ db, int B, int T_len,
                      int nh, int gd) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= nh * gd) return;
    float sum = 0.f;
    for (long long bt = 0; bt < static_cast<long long>(B) * T_len; ++bt)
        sum += dpre[bt * nh * gd + i];
    db[i] = sum;
}

template <typename TR, typename TW>
int walk(const void* r, const float* pre, const float* steps, const void* dhs, float* carry,
         float* dpre, float* db, int B, int T_len, int nh, int dh, cudaStream_t s) {
    auto kernel = slstm_bwd_step_kernel<TR, TW>;
    const size_t smem = step_smem(B, dh);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    for (int t = T_len - 1; t >= 0; --t) {
        kernel<<<nh * dh / kUnits, kThreads, smem, s>>>(
            static_cast<const TR*>(r), pre, steps, static_cast<const TW*>(dhs), carry, dpre, B,
            T_len, nh, dh, t);
        if (t == T_len - 1 && (err = cudaGetLastError()) != cudaSuccess)
            return static_cast<int>(err);
    }
    slstm_bwd_bias_kernel<<<(nh * 4 * dh + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        dpre, db, B, T_len, nh, 4 * dh);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r: [nh,dh,4dh] (r_dtype); pre: [B,T,nh,4dh] and steps: [4,B,T,nh,dh] fp32
// (the forward's pre_out and steps_out); dhs: [B,T,nh,dh] (wx_dtype);
// carry: [3,B,nh,dh] fp32, the final state's (dc, dn, dm) on entry; dpre
// (= dwx): [B,T,nh,4dh] fp32; db: [nh,4dh] fp32. All contiguous.
extern "C" int slstm_scan_bwd(const void* r, const float* pre, const float* steps,
                              const void* dhs, float* carry, float* dpre, float* db,
                              int wx_dtype, int r_dtype, int B, int T_len, int nh, int dh,
                              void* stream) {
    if (B < 1 || B > kMaxBatch || T_len < 1 || nh < 1 || dh < kUnits || dh % kUnits ||
        step_smem(B, dh) > kMaxSmem)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    auto by_w = [&](auto tr) {
        using TR = decltype(tr);
        if (wx_dtype == REPRO_F32)
            return walk<TR, float>(r, pre, steps, dhs, carry, dpre, db, B, T_len, nh, dh, s);
        if (wx_dtype == REPRO_BF16)
            return walk<TR, __nv_bfloat16>(r, pre, steps, dhs, carry, dpre, db, B, T_len, nh,
                                           dh, s);
        return static_cast<int>(cudaErrorInvalidValue);
    };
    if (r_dtype == REPRO_F32) return by_w(float{});
    if (r_dtype == REPRO_BF16) return by_w(__nv_bfloat16{});
    return static_cast<int>(cudaErrorInvalidValue);
}
