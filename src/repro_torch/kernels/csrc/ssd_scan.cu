// SSD linear recurrence (Mamba-2 / mLSTM) for Hopper, with state in and out
// and an optional normalizer chain.
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
// column whose input is w. The normalizer runs in the same launch as one
// extra column block per (batch, head), so an mLSTM layer is one launch.
//
// The TPU kernel keeps the whole [N, P] state in VMEM. At the mLSTM widths
// (N = 512, P = 1024) that is 2 MiB per head, far beyond the 227 KB of shared
// memory of an SM. Output columns are independent in P, so P is tiled: one
// block owns one (batch*head, 32-column tile) and walks time in order; its
// [N, 32] slice of the state lives in registers (8 warps, warp w holds rows
// [w*N/8, (w+1)*N/8) for the 32 columns of its lanes). At b=1, H=4, P=1024
// that is 4 x 33 blocks, one wave on 132 SMs. Time is staged in passes of 16
// steps: B, C, x and exp(a) of a pass are copied into shared memory, every
// thread advances its state slice step by step and leaves a partial y (its
// rows' share of C_t . S_t) in shared memory, and the 8 warps' partials are
// summed after the pass. Rows of B and C are read by all lanes of a warp at
// once (a broadcast), four at a time.
//
// What bounds it on the H100: operations. Per step and head it does 2*N*P
// multiply-adds (update and output) on N*P state values it never writes
// back until the end: ~4 flops per input byte at the mLSTM widths, and far
// more counted against HBM since B and C are re-read from L2 by each column
// tile. This first version runs fp32 FMAs on the CUDA cores; the chunked
// (matrix) form on the tensor cores is the next step for speed.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;     // state columns per block: one per lane
constexpr int kSteps = 16;    // time steps staged per pass

__host__ __device__ constexpr size_t smem_bytes(int N) {
    return sizeof(float) * (2 * kSteps * static_cast<size_t>(N)  // B, C
                            + kSteps * kTile                     // x
                            + kSteps                             // exp(a)
                            + kSteps * kWarps * kTile);          // partial y
}

template <int V> struct Vec;
template <> struct Vec<1> { using type = float; };
template <> struct Vec<2> { using type = float2; };
template <> struct Vec<4> { using type = float4; };

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[V]) {
    const auto v = *reinterpret_cast<const typename Vec<V>::type*>(p);
    if constexpr (V == 1) {
        out[0] = v;
    } else if constexpr (V == 2) {
        out[0] = v.x; out[1] = v.y;
    } else {
        out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    }
}

// T: element type of x, y, B and C. NPW = N / kWarps state rows per thread.
// blockIdx.x = batch*head; blockIdx.y = column tile, the last one (when w is
// given) being the normalizer chain.
template <typename T, int NPW>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s1,
                const float* __restrict__ w, const float* __restrict__ n0,
                float* __restrict__ n_out, float* __restrict__ n1,
                int T_len, int H, int P, int n_tiles) {
    constexpr int N = NPW * kWarps;
    constexpr int V = NPW >= 4 ? 4 : NPW;
    extern __shared__ __align__(16) float smem[];
    float* b_s = smem;                          // [kSteps][N]
    float* c_s = b_s + kSteps * N;              // [kSteps][N]
    float* x_s = c_s + kSteps * N;              // [kSteps][kTile]
    float* e_s = x_s + kSteps * kTile;          // [kSteps]
    float* part = e_s + kSteps;                 // [kSteps][kWarps][kTile]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
    const long long bc0 = (static_cast<long long>(bi) * T_len * H + h) * N;
    const long long ldbc = static_cast<long long>(H) * N;
    const int r0 = warp * NPW;                  // this thread's first state row

    float S[NPW];
#pragma unroll
    for (int i = 0; i < NPW; ++i)
        S[i] = (init != nullptr && lane < cols) ? init[st0 + (r0 + i) * lds + lane] : 0.f;

    for (int t0 = 0; t0 < T_len; t0 += kSteps) {
        const int steps = min(kSteps, T_len - t0);
        // ---- stage the pass; steps past T are zeros (and decay 1) ----
        for (int i = tid; i < kSteps * N; i += kThreads) {
            const int s = i / N, n = i - s * N;
            const bool ok = s < steps;
            const long long g = bc0 + (t0 + s) * ldbc + n;
            b_s[i] = ok ? to_float(Bm[g]) : 0.f;
            c_s[i] = ok ? to_float(Cm[g]) : 0.f;
        }
        for (int i = tid; i < kSteps * kTile; i += kThreads) {
            const int s = i / kTile, c = i - s * kTile;
            float v = 0.f;
            if (s < steps && c < cols) {
                const long long g = xy0 + (t0 + s) * ld + c;
                v = norm ? w[g] : to_float(x[g]);
            }
            x_s[i] = v;
        }
        if (tid < kSteps)
            e_s[tid] = tid < steps ? expf(a[(static_cast<long long>(bi) * T_len + t0 + tid) * H + h])
                                   : 1.f;
        __syncthreads();

        // ---- advance the state slice one step at a time ----
        for (int s = 0; s < steps; ++s) {
            const float e = e_s[s];
            const float xv = x_s[s * kTile + lane];
            const float* brow = b_s + s * N + r0;
            const float* crow = c_s + s * N + r0;
            float acc = 0.f;
#pragma unroll
            for (int i = 0; i < NPW; i += V) {
                float bv[V], cv[V];
                load_vec<V>(brow + i, bv);
                load_vec<V>(crow + i, cv);
#pragma unroll
                for (int v = 0; v < V; ++v) {
                    S[i + v] = fmaf(e, S[i + v], bv[v] * xv);
                    acc = fmaf(cv[v], S[i + v], acc);
                }
            }
            part[(s * kWarps + warp) * kTile + lane] = acc;
        }
        __syncthreads();

        // ---- y of the pass: sum the warps' partials ----
        for (int i = tid; i < steps * kTile; i += kThreads) {
            const int s = i / kTile, c = i - s * kTile;
            if (c >= cols) continue;
            float sum = 0.f;
#pragma unroll
            for (int k = 0; k < kWarps; ++k) sum += part[(s * kWarps + k) * kTile + c];
            const long long g = xy0 + (t0 + s) * ld + c;
            if (norm)
                n_out[g] = sum;
            else
                y[g] = from_float<T>(sum);
        }
        // the next pass's staging touches no partial; its compute runs only
        // after the barrier that ends that staging
    }

    if (lane < cols) {
#pragma unroll
        for (int i = 0; i < NPW; ++i) fin[st0 + (r0 + i) * lds + lane] = S[i];
    }
}

template <typename T, int NPW>
int launch(const void* x, const float* a, const void* Bm, const void* Cm, const float* s0,
           void* y, float* s1, const float* w, const float* n0, float* n_out, float* n1,
           int b, int T_len, int H, int P, cudaStream_t stream) {
    auto kernel = ssd_scan_kernel<T, NPW>;
    const size_t smem = smem_bytes(NPW * kWarps);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_tiles = (P + kTile - 1) / kTile;
    dim3 grid(b * H, n_tiles + (w != nullptr ? 1 : 0));
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), a, static_cast<const T*>(Bm), static_cast<const T*>(Cm), s0,
        static_cast<T*>(y), s1, w, n0, n_out, n1, T_len, H, P, n_tiles);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(int N, const void* x, const float* a, const void* Bm, const void* Cm,
               const float* s0, void* y, float* s1, const float* w, const float* n0,
               float* n_out, float* n1, int b, int T_len, int H, int P, cudaStream_t s) {
    switch (N) {
#define REPRO_SSD_CASE(n)                                                                  \
    case n:                                                                                \
        return launch<T, n / kWarps>(x, a, Bm, Cm, s0, y, s1, w, n0, n_out, n1, b, T_len, H, \
                                     P, s);
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

// x, y: [b,T,H,P] and B, C: [b,T,H,N] of one dtype (ReproDtype); a: [b,T,H]
// fp32; s0 (may be null: zeros), s1: [b,H,N,P] fp32. Normalizer chain when w
// is not null: w: [b,T,H], n0 (may be null), n_out: [b,T,H], n1: [b,H,N], all
// fp32. All contiguous; N a power of two in [8, 512].
extern "C" int ssd_scan_fwd(const void* x, const float* a, const void* Bm, const void* Cm,
                            const float* s0, void* y, float* s1, const float* w,
                            const float* n0, float* n_out, float* n1, int dtype, int b,
                            int T_len, int H, int N, int P, void* stream) {
    if (b <= 0 || T_len <= 0 || H <= 0 || P <= 0 || (P + kTile - 1) / kTile >= 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    if (w != nullptr && (n_out == nullptr || n1 == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == REPRO_F32)
        return dispatch_n<float>(N, x, a, Bm, Cm, s0, y, s1, w, n0, n_out, n1, b, T_len, H, P, s);
    if (dtype == REPRO_BF16)
        return dispatch_n<__nv_bfloat16>(N, x, a, Bm, Cm, s0, y, s1, w, n0, n_out, n1, b, T_len,
                                         H, P, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
