// Backward of the SSD linear recurrence (Mamba-2 / mLSTM) for Hopper, fp32 on
// the CUDA cores, in the chunked form of the forward (ssd_scan.cu).
//
// It replaces no TPU kernel: repro/kernels/ssd_scan.py::_ssd_kernel
// (pallas_call at ssd_scan.py:82) has no VJP, and the JAX package trains
// through autodiff of its jnp `ssd_chunked`. This is the backward of the
// port's forward, per (batch, head), B and C per group (head h reads group
// h / (H/G)):
//
//     S_t = exp(a_t) S_{t-1} + B_t x_t^T        y_t = S_t^T C_t
//
// With G_t the gradient of S_t (its own y_t's and every later step's),
// G_t = C_t dy_t^T + exp(a_{t+1}) G_{t+1} from the final state's gradient:
//
//     dx_t = G_t^T B_t    dB_t = G_t x_t    dC_t = S_t dy_t
//     da_t = exp(a_t) <S_{t-1}, G_t>
//
// The mLSTM normalizer (Sn_t = exp(a_t) Sn_{t-1} + w_t B_t, n_t = C_t . Sn_t)
// is the same recurrence with one more column: the wrapper appends w to x
// and dn to dy (Pe = P + 1 columns), so dw comes out as dx's last column and
// its terms join dB, dC and da without a path of their own.
//
// Chunks of L = 64 steps, as the forward's. In a chunk, with A_u the sum of
// a over its steps 0..u (each exponent summed in order over exactly the
// steps it spans), Dm[u][r] = exp(A_u - A_r) for u >= r, ea_u = exp(A_u),
// eb_r = exp(A_{L-1} - A_r), etot = ea_{L-1}, S_prev the state before the
// chunk and Gin the gradient that flows into its last state from later
// chunks (exp(a) times the next chunk's first G):
//
//     dx_s = eb_s Gin^T B_s + sum_{u>=s} Dm[u][s] (C_u.B_s) dy_u
//     dB_s = eb_s Gin x_s   + sum_{u>=s} Dm[u][s] (dy_u.x_s) C_u
//     dC_u = ea_u S_prev dy_u + sum_{r<=u} Dm[u][r] (x_r.dy_u) B_r
//     da_s = etot <S_prev, Gin> + sum_{u>=s} ea_u C_u.(S_prev dy_u)
//            + sum_{r<s} eb_r B_r.(Gin x_r)
//            + sum_{u>=s} sum_{r<s} Dm[u][r] (C_u.B_r)(dy_u.x_r)
//
// (da is the gradient of exp(a_s) wherever it multiplies a state; every
// exponent above is <= 0, so no term overflows however strong the decay.)
// The chunks' S_prev and Gin come from one ordered pass over the chunks,
// both directions, as the forward's chunk-parallel path carries S:
//   ssd_bwd_decay_kernel   per (batch*head, chunk): Dm, ea, eb, etot;
//   ssd_bwd_gram_kernel    C B^T per (batch*group, chunk), dy x^T per
//                          (batch*head, chunk), each 64 x 64;
//   ssd_bwd_state_kernel   per (batch*head, chunk, 64 x 64 tile of [N, Pe]):
//                          dS = sum_r eb_r B_r x_r^T, dG = sum_u ea_u C_u dy_u^T;
//   ssd_bwd_pass_kernel    per (batch*head, 1024 state values): S_prev_c =
//                          etot S_prev_{c-1} + dS_{c-1} forward, Gin_c =
//                          dG_{c+1} + etot_{c+1} Gin_{c+1} backward (from the
//                          final state's gradient), written over dS and dG,
//                          and each chunk's partial <S_prev, Gin>;
//   ssd_bwd_dx_kernel      per (batch*head, chunk, 64 columns of Pe);
//   ssd_bwd_dbc_kernel     per (batch*head, chunk, 64 columns of N), dB and
//                          dC per head, with each tile's partial of the two
//                          dot terms of da;
//   ssd_bwd_da_kernel      per (batch*head, chunk);
//   ssd_bwd_group_sum_kernel  dB and dC summed over each group's heads in
//                          head order (only where a group has several heads:
//                          zamba2's one group of 80).
// Every output has one owner and every sum a fixed order (no atomics), so
// two calls give the same bits.
//
// Each product is a 64 x 64 output tile of 256 threads, 4 x 4 outputs a
// thread, its operands staged 16 deep in shared memory from device memory
// (zeros past T, N and Pe), one float4 of each operand feeding 16 FMAs. A
// simple first design: scalar loads, no cp.async or tensor cores.
// Bound: operations. A chunk costs ~5 products of L N Pe FMAs (dS, dG,
// Gin^T B, Gin x, S_prev dy) and ~4 of L^2 (N or Pe): ~12 N Pe flops per
// step and head, three times the forward's; the state scratch (S_prev and
// Gin, 2 N Pe floats per chunk and head) moves far fewer bytes.

#include "common.cuh"

namespace {

constexpr int kL = 64;                     // time steps per chunk (kChunk of ssd_scan.cu)
constexpr int kT = 64;                     // a product's output tile: kT x kT
constexpr int kK = 16;                     // depth of one staged round
constexpr int kThreads = 256;              // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = kT + 4;               // a staged row: float4-aligned, fewer conflicts
constexpr int kDec = kL * kL + 4 * kL;     // per (batch*head, chunk): Dm, ea, eb, etot
constexpr int kEa = kL * kL, kEb = kL * kL + kL, kEtot = kL * kL + 2 * kL;
constexpr int kPassElems = 4 * kThreads;   // state values of one pass block
static_assert(kK * kT % kThreads == 0 && kT == 16 * 4, "the tile's thread map");

struct Dims {
    int b, T, H, G, N, Pe, rep, nc, ntn, ntp, npass;
    long long np;  // N * Pe
};

Dims make_dims(int b, int T, int H, int G, int N, int Pe) {
    Dims d;
    d.b = b; d.T = T; d.H = H; d.G = G; d.N = N; d.Pe = Pe;
    d.rep = G > 0 ? H / G : 0;
    d.nc = (T + kL - 1) / kL;
    d.ntn = (N + kT - 1) / kT;
    d.ntp = (Pe + kT - 1) / kT;
    d.np = static_cast<long long>(N) * Pe;
    d.npass = static_cast<int>((d.np + kPassElems - 1) / kPassElems);
    return d;
}

long long round4(long long n) { return (n + 3) / 4 * 4; }

// The workspace's regions, in floats, each a multiple of 4 (16 bytes).
struct Work {
    long long dec, cb, xd, sp, gi, dot, kq, total;
};

Work work_sizes(const Dims& d) {
    const long long bh = static_cast<long long>(d.b) * d.H, bhc = bh * d.nc;
    Work w;
    w.dec = round4(bhc * kDec);
    w.cb = round4(static_cast<long long>(d.b) * d.G * d.nc * kL * kL);
    w.xd = round4(bhc * kL * kL);
    w.sp = round4(bhc * d.np);
    w.gi = w.sp;
    w.dot = round4(bhc * d.npass);
    w.kq = round4(bhc * 2 * d.ntn * kL);
    w.total = w.dec + w.cb + w.xd + w.sp + w.gi + w.dot + w.kq;
    return w;
}

// acc[i][j] += sum_{k < K} A(4 ty + i, k) * Bm(4 tx + j, k) for this thread's
// 4 x 4 outputs of a 64 x 64 tile (ty = tid / 16, tx = tid % 16). fa(i, k)
// and fb(j, k) give the operands in tile-local rows (0 outside them). A_K /
// B_K: k is the operand's contiguous index in memory (neighbouring threads
// then load neighbouring k; else neighbouring rows). Sums run in k order.
template <bool A_K, bool B_K, typename FA, typename FB>
__device__ __forceinline__ void tile_gemm(float (&acc)[4][4], int K, FA fa, FB fb, float* As,
                                          float* Bs) {
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    for (int k0 = 0; k0 < K; k0 += kK) {
#pragma unroll
        for (int q = 0; q < kK * kT / kThreads; ++q) {
            const int e = tid + q * kThreads;
            const int ia = A_K ? e / kK : e % kT, ka = A_K ? e % kK : e / kT;
            As[ka * kPad + ia] = k0 + ka < K ? fa(ia, k0 + ka) : 0.f;
            const int jb = B_K ? e / kK : e % kT, kb = B_K ? e % kK : e / kT;
            Bs[kb * kPad + jb] = k0 + kb < K ? fb(jb, k0 + kb) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kK; ++k) {
            const float4 av = *reinterpret_cast<const float4*>(As + k * kPad + 4 * ty);
            const float4 bv = *reinterpret_cast<const float4*>(Bs + k * kPad + 4 * tx);
            const float ar[4] = {av.x, av.y, av.z, av.w};
            const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
        }
        __syncthreads();
    }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// Dm[u][r] = exp(a_{r+1} + ... + a_u) for u >= r (0 above the diagonal),
// ea_u = exp(a_0 + ... + a_u), eb_r = Dm[L-1][r], etot = ea_{L-1}; a = 0
// past T (decay 1 over the padding). Thread r sums each exponent in order.
__global__ void __launch_bounds__(kL)
ssd_bwd_decay_kernel(const float* __restrict__ a, float* __restrict__ dec, Dims d) {
    const int c = blockIdx.x, bh = blockIdx.y, b = bh / d.H, h = bh % d.H;
    const int r = threadIdx.x, t = c * kL + r;
    __shared__ float as[kL];
    as[r] = t < d.T ? a[(static_cast<long long>(b) * d.T + t) * d.H + h] : 0.f;
    __syncthreads();
    float* D = dec + (static_cast<long long>(bh) * d.nc + c) * kDec;
    float s = 0.f;
    for (int u = 0; u < kL; ++u) {
        if (u > r) s += as[u];
        D[u * kL + r] = u < r ? 0.f : expf(s);
    }
    D[kEb + r] = expf(s);
    float e = 0.f;
    for (int u = 0; u <= r; ++u) e += as[u];
    D[kEa + r] = expf(e);
    if (r == kL - 1) D[kEtot] = expf(e);
}

// out[item][c] = X Y^T over the chunk's rows (zero past T): [u][r] = X_u . Y_r.
// Row t of item i starts at (i / per) * s_b + (i % per) * s_i + t * s_t.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_gram_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                    float* __restrict__ out, int T, int nc, int per, long long s_b,
                    long long s_i, long long s_t, int K) {
    __shared__ __align__(16) float As[kK * kPad];
    __shared__ __align__(16) float Bs[kK * kPad];
    const int c = blockIdx.x, item = blockIdx.y, t0 = c * kL;
    const long long base = (item / per) * s_b + (item % per) * s_i;
    auto fx = [&](int i, int k) { return t0 + i < T ? X[base + (t0 + i) * s_t + k] : 0.f; };
    auto fy = [&](int j, int k) { return t0 + j < T ? Y[base + (t0 + j) * s_t + k] : 0.f; };
    float acc[4][4];
    zero(acc);
    tile_gemm<true, true>(acc, K, fx, fy, As, Bs);
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float* o = out + (static_cast<long long>(item) * nc + c) * kL * kL;
#pragma unroll
    for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(o + (4 * ty + i) * kL + 4 * tx) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// Store a thread's 4 x 4 outputs at rows r0 + 4 ty + i (< nr), columns
// c0 + 4 tx + j (< ncol), row r at out(r) + column.
template <typename F>
__device__ __forceinline__ void store_tile(const float (&acc)[4][4], int r0, int nr, int c0,
                                           int ncol, F row_ptr) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = r0 + 4 * ty + i;
        if (r >= nr) continue;
        float* p = row_ptr(r);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = c0 + 4 * tx + j;
            if (col < ncol) p[col] = acc[i][j];
        }
    }
}

// mode 0: dS[n][p] = sum_r B_r[n] eb_r x_r[p]; mode 1: dG[n][p] = sum_u
// C_u[n] ea_u dy_u[p]; one 64 x 64 tile of [N, Pe] per block.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_kernel(const float* __restrict__ x, const float* __restrict__ B,
                     const float* __restrict__ C, const float* __restrict__ dy,
                     const float* __restrict__ dec, float* __restrict__ sp,
                     float* __restrict__ gi, Dims d) {
    __shared__ __align__(16) float As[kK * kPad];
    __shared__ __align__(16) float Bs[kK * kPad];
    __shared__ float wsh[kL];
    const int tn = blockIdx.x / d.ntp, tp = blockIdx.x % d.ntp, c = blockIdx.y;
    const int mode = blockIdx.z & 1, bh = blockIdx.z >> 1, b = bh / d.H, h = bh % d.H;
    const int g = h / d.rep, t0 = c * kL, n0 = tn * kT, p0 = tp * kT;
    const float* D = dec + (static_cast<long long>(bh) * d.nc + c) * kDec;
    if (threadIdx.x < kL) wsh[threadIdx.x] = D[(mode == 0 ? kEb : kEa) + threadIdx.x];
    __syncthreads();
    const float* bc = mode == 0 ? B : C;        // [b, T, G, N]
    const float* xy = mode == 0 ? x : dy;       // [b, T, H, Pe]
    auto fa = [&](int i, int k) {               // (n, step k)
        const int t = t0 + k, n = n0 + i;
        return t < d.T && n < d.N
                   ? bc[((static_cast<long long>(b) * d.T + t) * d.G + g) * d.N + n] * wsh[k]
                   : 0.f;
    };
    auto fb = [&](int j, int k) {               // (p, step k)
        const int t = t0 + k, p = p0 + j;
        return t < d.T && p < d.Pe
                   ? xy[((static_cast<long long>(b) * d.T + t) * d.H + h) * d.Pe + p]
                   : 0.f;
    };
    float acc[4][4];
    zero(acc);
    tile_gemm<false, false>(acc, kL, fa, fb, As, Bs);
    float* out = (mode == 0 ? sp : gi) + (static_cast<long long>(bh) * d.nc + c) * d.np;
    store_tile(acc, n0, d.N, p0, d.Pe,
               [&](int n) { return out + static_cast<long long>(n) * d.Pe; });
}

// The ordered pass over the chunks, 4 state values a thread: S_prev forward
// (from S_0 or zeros) over dS, Gin backward (from the final state's
// gradient or zeros) over dG, and per chunk this block's partial of
// <S_prev, Gin>, summed in a fixed order.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_pass_kernel(float* __restrict__ sp, float* __restrict__ gi,
                    const float* __restrict__ s0, const float* __restrict__ dsf,
                    const float* __restrict__ dec, float* __restrict__ dot, Dims d) {
    __shared__ float red[kThreads / 32];
    const int bh = blockIdx.y, blk = blockIdx.x, lane = threadIdx.x & 31,
              warp = threadIdx.x >> 5;
    const long long e0 = static_cast<long long>(blk) * kPassElems + 4 * threadIdx.x;
    const bool ok = e0 < d.np;                  // np % 4 == 0
    const long long head = static_cast<long long>(bh) * d.nc;
    auto etot = [&](int c) { return dec[(head + c) * kDec + kEtot]; };
    float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok && s0 != nullptr) S = *reinterpret_cast<const float4*>(s0 + bh * d.np + e0);
    for (int c = 0; c < d.nc; ++c) {
        if (!ok) break;
        float4* p = reinterpret_cast<float4*>(sp + (head + c) * d.np + e0);
        const float4 v = *p;
        const float et = etot(c);
        *p = S;
        S = make_float4(fmaf(et, S.x, v.x), fmaf(et, S.y, v.y), fmaf(et, S.z, v.z),
                        fmaf(et, S.w, v.w));
    }
    float4 Gc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok && dsf != nullptr) Gc = *reinterpret_cast<const float4*>(dsf + bh * d.np + e0);
    for (int c = d.nc - 1; c >= 0; --c) {
        float part = 0.f;
        if (ok) {
            float4* q = reinterpret_cast<float4*>(gi + (head + c) * d.np + e0);
            const float4 v = *q;
            const float4 s = *reinterpret_cast<const float4*>(sp + (head + c) * d.np + e0);
            const float et = etot(c);
            *q = Gc;
            part = s.x * Gc.x;
            part = fmaf(s.y, Gc.y, part);
            part = fmaf(s.z, Gc.z, part);
            part = fmaf(s.w, Gc.w, part);
            Gc = make_float4(fmaf(et, Gc.x, v.x), fmaf(et, Gc.y, v.y), fmaf(et, Gc.z, v.z),
                             fmaf(et, Gc.w, v.w));
        }
        part = warp_sum(part);
        if (lane == 0) red[warp] = part;
        __syncthreads();
        if (threadIdx.x == 0) {
            float sum = 0.f;
            for (int w = 0; w < kThreads / 32; ++w) sum += red[w];
            dot[(head + c) * d.npass + blk] = sum;
        }
        __syncthreads();
    }
}

// dx_s = eb_s Gin^T B_s + sum_{u>=s} Dm[u][s] CB[u][s] dy_u, one 64-column
// tile of Pe per block.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dx_kernel(const float* __restrict__ B, const float* __restrict__ dy,
                  const float* __restrict__ gi, const float* __restrict__ dec,
                  const float* __restrict__ cb, float* __restrict__ dx, Dims d) {
    __shared__ __align__(16) float As[kK * kPad];
    __shared__ __align__(16) float Bs[kK * kPad];
    const int tp = blockIdx.x, c = blockIdx.y, bh = blockIdx.z, b = bh / d.H, h = bh % d.H;
    const int g = h / d.rep, t0 = c * kL, p0 = tp * kT;
    const float* D = dec + (static_cast<long long>(bh) * d.nc + c) * kDec;
    const float* Gin = gi + (static_cast<long long>(bh) * d.nc + c) * d.np;
    const float* CB = cb + ((static_cast<long long>(b) * d.G + g) * d.nc + c) * kL * kL;
    auto hrow = [&](int t) { return ((static_cast<long long>(b) * d.T + t) * d.H + h) * d.Pe; };
    auto grow = [&](int t) { return ((static_cast<long long>(b) * d.T + t) * d.G + g) * d.N; };
    float acc[4][4];
    zero(acc);
    tile_gemm<true, false>(
        acc, d.N,
        [&](int i, int k) {                     // B_s[n]
            return t0 + i < d.T ? B[grow(t0 + i) + k] : 0.f;
        },
        [&](int j, int k) {                     // Gin[n][p]
            return p0 + j < d.Pe ? Gin[static_cast<long long>(k) * d.Pe + p0 + j] : 0.f;
        },
        As, Bs);
    const int ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float e = D[kEb + 4 * ty + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
    }
    tile_gemm<false, false>(
        acc, kL,
        [&](int i, int k) { return D[k * kL + i] * CB[k * kL + i]; },  // Dm[u][s] CB[u][s]
        [&](int j, int k) {                     // dy_u[p]
            return t0 + k < d.T && p0 + j < d.Pe ? dy[hrow(t0 + k) + p0 + j] : 0.f;
        },
        As, Bs);
    store_tile(acc, t0, d.T, p0, d.Pe, [&](int t) { return dx + hrow(t); });
}

// Per head, one 64-column tile of N per block. mode 0: dB_s = eb_s Gin x_s +
// sum_{u>=s} Dm[u][s] XD[u][s] C_u, with the tile's partial of
// B_s.(Gin x_s); mode 1: dC_u = ea_u S_prev dy_u + sum_{r<=u} Dm[u][r]
// XD[u][r] B_r, with the tile's partial of C_u.(S_prev dy_u).
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dbc_kernel(const float* __restrict__ x, const float* __restrict__ B,
                   const float* __restrict__ C, const float* __restrict__ dy,
                   const float* __restrict__ sp, const float* __restrict__ gi,
                   const float* __restrict__ dec, const float* __restrict__ xd,
                   float* __restrict__ dBh, float* __restrict__ dCh,
                   float* __restrict__ kq, Dims d) {
    __shared__ __align__(16) float As[kK * kPad];
    __shared__ __align__(16) float Bs[kK * kPad];
    const int tn = blockIdx.x, c = blockIdx.y, mode = blockIdx.z & 1, bh = blockIdx.z >> 1;
    const int b = bh / d.H, h = bh % d.H, g = h / d.rep, t0 = c * kL, n0 = tn * kT;
    const long long bhc = static_cast<long long>(bh) * d.nc + c;
    const float* D = dec + bhc * kDec;
    const float* XD = xd + bhc * kL * kL;       // [u][r] = dy_u . x_r
    const float* St = (mode == 0 ? gi : sp) + bhc * d.np;   // Gin or S_prev, [N][Pe]
    const float* xy = mode == 0 ? x : dy;                    // x_s or dy_u rows
    const float* own = mode == 0 ? B : C;       // the row's own B_s or C_u
    const float* other = mode == 0 ? C : B;     // C_u or B_r of the sum
    auto hrow = [&](int t) { return ((static_cast<long long>(b) * d.T + t) * d.H + h) * d.Pe; };
    auto grow = [&](int t) { return ((static_cast<long long>(b) * d.T + t) * d.G + g) * d.N; };
    float acc[4][4];
    zero(acc);
    tile_gemm<true, true>(
        acc, d.Pe,
        [&](int i, int k) { return t0 + i < d.T ? xy[hrow(t0 + i) + k] : 0.f; },
        [&](int j, int k) {
            return n0 + j < d.N ? St[static_cast<long long>(n0 + j) * d.Pe + k] : 0.f;
        },
        As, Bs);
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {               // the tile's partial of the row's dot term
        const int s = 4 * ty + i, t = t0 + s;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + 4 * tx + j;
            if (t < d.T && n < d.N) part = fmaf(own[grow(t) + n], acc[i][j], part);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        if (tx == 0) kq[((bhc * 2 + mode) * d.ntn + tn) * kL + s] = part;
        const float e = D[(mode == 0 ? kEb : kEa) + s];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
    }
    auto fo = [&](int j, int k) {               // C_u[n] or B_r[n]
        return t0 + k < d.T && n0 + j < d.N ? other[grow(t0 + k) + n0 + j] : 0.f;
    };
    if (mode == 0)                              // A(s, u) = Dm[u][s] XD[u][s]
        tile_gemm<false, false>(
            acc, kL, [&](int i, int k) { return D[k * kL + i] * XD[k * kL + i]; }, fo, As, Bs);
    else                                        // A(u, r) = Dm[u][r] XD[u][r]
        tile_gemm<true, false>(
            acc, kL, [&](int i, int k) { return D[i * kL + k] * XD[i * kL + k]; }, fo, As, Bs);
    float* out = mode == 0 ? dBh : dCh;         // [b, T, H, N]
    store_tile(acc, t0, d.T, n0, d.N, [&](int t) {
        return out + ((static_cast<long long>(b) * d.T + t) * d.H + h) * d.N;
    });
}

// da_s = etot <S_prev, Gin> + sum_{u>=s} ea_u q_u + sum_{r<s} eb_r k_r +
// sum_{u>=s} sum_{r<s} Dm[u][r] CB[u][r] XD[u][r]; thread s, the partials
// of q, k and <S_prev, Gin> summed in order.
__global__ void __launch_bounds__(kL)
ssd_bwd_da_kernel(const float* __restrict__ dec, const float* __restrict__ cb,
                  const float* __restrict__ xd, const float* __restrict__ dot,
                  const float* __restrict__ kq, float* __restrict__ da, Dims d) {
    __shared__ float R[kL][kL + 1];             // R[u][j] = sum_{r < min(j, u)} W[u][r]
    __shared__ float qs[kL], ks[kL];
    __shared__ float tot;
    const int c = blockIdx.x, bh = blockIdx.y, b = bh / d.H, h = bh % d.H, g = h / d.rep;
    const int s = threadIdx.x;
    const long long bhc = static_cast<long long>(bh) * d.nc + c;
    const float* D = dec + bhc * kDec;
    const float* CB = cb + ((static_cast<long long>(b) * d.G + g) * d.nc + c) * kL * kL;
    const float* XD = xd + bhc * kL * kL;
    float q = 0.f, k = 0.f;
    for (int tn = 0; tn < d.ntn; ++tn) {
        k += kq[((bhc * 2 + 0) * d.ntn + tn) * kL + s];
        q += kq[((bhc * 2 + 1) * d.ntn + tn) * kL + s];
    }
    qs[s] = D[kEa + s] * q;
    ks[s] = D[kEb + s] * k;
    float run = 0.f;
    for (int j = 0; j < kL; ++j) {              // row u = s
        R[s][j] = run;
        if (j < s) run = fmaf(D[s * kL + j] * CB[s * kL + j], XD[s * kL + j], run);
    }
    if (s == 0) {
        float sum = 0.f;
        for (int i = 0; i < d.npass; ++i) sum += dot[bhc * d.npass + i];
        tot = D[kEtot] * sum;
    }
    __syncthreads();
    float v = tot;
    for (int u = s; u < kL; ++u) v += qs[u] + R[u][s];
    for (int r = 0; r < s; ++r) v += ks[r];
    const int t = c * kL + s;
    if (t < d.T) da[(static_cast<long long>(b) * d.T + t) * d.H + h] = v;
}

// dB, dC [b, T, G, N] = per-head [b, T, H, N] summed over each group's heads
// in head order.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_group_sum_kernel(const float* __restrict__ dBh, const float* __restrict__ dCh,
                         float* __restrict__ dB, float* __restrict__ dC, Dims d) {
    const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long total = static_cast<long long>(d.b) * d.T * d.G * d.N;
    if (i >= total) return;
    const int n = static_cast<int>(i % d.N);
    const long long rest = i / d.N;
    const int g = static_cast<int>(rest % d.G);
    const long long bt = rest / d.G;
    const float* src = (blockIdx.y == 0 ? dBh : dCh) + (bt * d.H + g * d.rep) * d.N + n;
    float sum = 0.f;
    for (int j = 0; j < d.rep; ++j) sum += src[static_cast<long long>(j) * d.N];
    (blockIdx.y == 0 ? dB : dC)[i] = sum;
}

bool valid(const Dims& d) {
    return d.b > 0 && d.T > 0 && d.H > 0 && d.G > 0 && d.H % d.G == 0 && d.N > 0 && d.Pe > 0 &&
           d.np % 4 == 0 && static_cast<long long>(d.b) * d.H * 2 <= 65535 && d.nc <= 65535 &&
           static_cast<long long>(d.ntn) * d.ntp <= 2147483647LL;
}

}  // namespace

// Floats of workspace ssd_scan_bwd needs for these sizes (Pe = P, or P + 1
// with the normalizer's column).
extern "C" int ssd_scan_bwd_workspace(int b, int T, int H, int G, int N, int Pe,
                                      long long* floats) {
    const Dims d = make_dims(b, T, H, G, N, Pe);
    if (!valid(d)) return static_cast<int>(cudaErrorInvalidValue);
    *floats = work_sizes(d).total;
    return 0;
}

// x, dy, dx: [b, T, H, Pe]; a, da: [b, T, H]; B, C, dB, dC: [b, T, G, N];
// dBh, dCh: [b, T, H, N] (the per-head sums; pass dB and dC themselves when
// G == H); s0 (initial state) and dsf (final state's gradient): [b, H, N,
// Pe] or null (zeros); ws: ssd_scan_bwd_workspace's floats. All fp32,
// contiguous, 16-byte aligned.
extern "C" int ssd_scan_bwd(const float* x, const float* a, const float* B, const float* C,
                            const float* dy, const float* s0, const float* dsf, float* ws,
                            float* dx, float* da, float* dBh, float* dCh, float* dB, float* dC,
                            int b, int T, int H, int G, int N, int Pe, void* stream) {
    const Dims d = make_dims(b, T, H, G, N, Pe);
    if (!valid(d)) return static_cast<int>(cudaErrorInvalidValue);
    const Work w = work_sizes(d);
    float* dec = ws;
    float* cb = dec + w.dec;
    float* xd = cb + w.cb;
    float* sp = xd + w.xd;
    float* gi = sp + w.sp;
    float* dot = gi + w.gi;
    float* kq = dot + w.dot;
    const auto s = static_cast<cudaStream_t>(stream);
    const int bh = b * H;
    ssd_bwd_decay_kernel<<<dim3(d.nc, bh), kL, 0, s>>>(a, dec, d);
    ssd_bwd_gram_kernel<<<dim3(d.nc, b * G), kThreads, 0, s>>>(
        C, B, cb, T, d.nc, G, static_cast<long long>(T) * G * N, N,
        static_cast<long long>(G) * N, N);
    ssd_bwd_gram_kernel<<<dim3(d.nc, bh), kThreads, 0, s>>>(
        dy, x, xd, T, d.nc, H, static_cast<long long>(T) * H * Pe, Pe,
        static_cast<long long>(H) * Pe, Pe);
    ssd_bwd_state_kernel<<<dim3(d.ntn * d.ntp, d.nc, 2 * bh), kThreads, 0, s>>>(
        x, B, C, dy, dec, sp, gi, d);
    ssd_bwd_pass_kernel<<<dim3(d.npass, bh), kThreads, 0, s>>>(sp, gi, s0, dsf, dec, dot, d);
    ssd_bwd_dx_kernel<<<dim3(d.ntp, d.nc, bh), kThreads, 0, s>>>(B, dy, gi, dec, cb, dx, d);
    ssd_bwd_dbc_kernel<<<dim3(d.ntn, d.nc, 2 * bh), kThreads, 0, s>>>(
        x, B, C, dy, sp, gi, dec, xd, dBh, dCh, kq, d);
    ssd_bwd_da_kernel<<<dim3(d.nc, bh), kL, 0, s>>>(dec, cb, xd, dot, kq, da, d);
    if (d.rep > 1) {
        const long long total = static_cast<long long>(b) * T * G * N;
        ssd_bwd_group_sum_kernel<<<dim3(static_cast<unsigned>((total + kThreads - 1) / kThreads),
                                        2),
                                   kThreads, 0, s>>>(dBh, dCh, dB, dC, d);
    }
    return static_cast<int>(cudaGetLastError());
}
