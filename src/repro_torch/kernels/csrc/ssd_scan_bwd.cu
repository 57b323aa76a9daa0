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
//   ssd_bwd_state_kernel   per (batch*head, chunk, strip of 128 (N > 64) or
//                          64 rows of [N, Pe]):
//                          dS = sum_r eb_r B_r x_r^T, dG = sum_u ea_u C_u dy_u^T;
//   ssd_bwd_pass_kernel    per (batch*head, 1024 state values): S_prev_c =
//                          etot S_prev_{c-1} + dS_{c-1} forward, Gin_c =
//                          dG_{c+1} + etot_{c+1} Gin_{c+1} backward (from the
//                          final state's gradient), written over dS and dG,
//                          and each chunk's partial <S_prev, Gin>;
//   ssd_bwd_dx_kernel      per (batch*head, chunk, 64 columns of Pe);
//   ssd_bwd_dbc_kernel     per (batch*head, chunk, 128 (N > 64) or 64
//                          columns of N), dB and
//                          dC per head, with each tile's partial of the two
//                          dot terms of da;
//   ssd_bwd_da_kernel      per (batch*head, chunk);
//   ssd_bwd_group_sum_kernel  dB and dC summed over each group's heads in
//                          head order (only where a group has several heads:
//                          zamba2's one group of 80).
// Every output has one owner and every sum a fixed order (no atomics), so
// two calls give the same bits.
//
// The tile products (C B^T and dy x^T, dS and dG, dx's and dB/dC's pairs:
// ~47 GFLOP of the call at xlstm's mLSTM shape) are fp32 FMAs on the CUDA
// cores, 8 x 8 or 8 x 4 sums a thread (4 x 4 in the Gram products, whose
// 64 x 64 tiles are too few to fill the card otherwise): the narrower
// thread tile where more warps a block measured faster. Their operands arrive in
// shared memory by cp.async, 16 bytes a copy where the rows allow it (the
// wrapper pads x, dy and dx to a multiple of 4 columns) and 4 bytes where
// they do not: the [N, Pe] state scratch at Pe = 1025 (its rows keep the
// pass's layout), and operands whose k runs along memory but are staged
// across it (the scratch in dbc, Y in the Gram products). Gram, dx and dbc
// run `product`: kBK = 16 k a round through a ring of kStages slots, the
// next rounds' copies in flight while a round's FMAs run, one block
// barrier a round. The state kernel, with only the chunk's 64 steps to sum,
// keeps its A in shared memory for a whole strip of [N, Pe] and streams the
// strip's tiles of x or dy through two buffers. Index arithmetic is done
// once per block, outside the copies. Operand scaling happens in shared
// memory, once per value: the state kernel's B eb and C ea by the thread
// that copied the value, once its copy has landed; dx's Dm o CB and dbc's
// Dm o XD as a resident 64 x 64 operand.
// Bound: operations on the CUDA cores. A chunk costs ~5 products of L N Pe
// FMAs (dS, dG, Gin^T B, Gin x, S_prev dy) and ~4 of L^2 (N or Pe): ~12 N Pe
// flops per step and head, three times the forward's. The state scratch
// (S_prev and Gin, 2 N Pe floats per chunk and head) is written by the state
// kernel, walked by the pass and read by dx and dbc: the pass alone is bound
// by its bytes. No tensor cores: TF32 products (even split in three) change
// the bits. Every output starts at 0 and adds its k in increasing order by
// fmaf, each operand product one fp32 multiply, the scaling between dx's and
// dbc's two products where it was: the bits of this file's first design
// (64 x 64 tiles of 4 x 4 sums, operands staged by scalar loads).

#include "common.cuh"

namespace {

constexpr int kL = 64;                     // time steps per chunk (kChunk of ssd_scan.cu)
constexpr int kT = 64;                     // columns of a da partial (kq); a narrow tile
constexpr int kBK = 16;                    // k of one staged round
constexpr int kStages = 3;                 // rounds in a product's ring
constexpr int kStateTN = 4;                // the state kernel's 8 x 4 sums a thread
constexpr int kDxTN = 4;                   // dx's 8 x 4
constexpr int kKP = kBK + 4;               // a K-major staged row: 16 floats + 16 bytes
constexpr int kA2 = kL + 4;                // a resident 64 x 64 operand's row
constexpr int kThreads = 256;              // pass and group-sum blocks
constexpr int kDec = kL * kL + 4 * kL;     // per (batch*head, chunk): Dm, ea, eb, etot
constexpr int kEa = kL * kL, kEb = kL * kL + kL, kEtot = kL * kL + 2 * kL;
constexpr int kPassElems = 4 * kThreads;   // state values of one pass block

struct Dims {
    int b, T, H, G, N, Pe, pe4, rep, nc, ntn, ntp, npass;
    long long np;  // N * Pe
};

Dims make_dims(int b, int T, int H, int G, int N, int Pe) {
    Dims d;
    d.b = b; d.T = T; d.H = H; d.G = G; d.N = N; d.Pe = Pe;
    d.pe4 = (Pe + 3) / 4 * 4;
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

// cp.async of 16 (4) bytes from src into shared memory, of which the first
// `bytes` are read and the rest zero-filled (nothing is read at 0).
__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One operand of a product: element (i, k) at p[k * ld + i] (I-contiguous)
// or p[i * ld + k] (K-contiguous), 0 for i >= ni or k >= nk. vec: p and ld
// on 16-byte boundaries.
struct Opnd {
    const float* p;
    int ld, ni, nk;
    bool vec;
};

// Round k0 .. k0+kBK-1 of an I-contiguous operand into s[k][W + 4], this
// thread's share of NT: 4 values of i a copy where vec allows, else 1.
template <int W, int NT>
__device__ __forceinline__ void stage_i(float* s, const Opnd& o, int k0) {
    static_assert(W * kBK % (4 * NT) == 0, "whole 16-byte copies a thread");
    const float* src = o.p + static_cast<long long>(k0) * o.ld;
    if (o.vec) {
#pragma unroll
        for (int q = 0; q < W * kBK / (4 * NT); ++q) {
            const int c = threadIdx.x + q * NT, k = c / (W / 4), i = 4 * (c % (W / 4));
            const int n = k0 + k < o.nk ? min(max(o.ni - i, 0), 4) : 0;
            cp16(s + k * (W + 4) + i, n ? src + k * o.ld + i : o.p, 4 * n);
        }
    } else {                                    // thread: column tid % W, rows a pass NT / W
        static_assert(NT % W == 0, "whole rows a pass");
        const int i = threadIdx.x % W, k1 = threadIdx.x / W;
        const bool in = i < o.ni;
        src += k1 * o.ld + i;
        s += k1 * (W + 4) + i;
#pragma unroll
        for (int q = 0; q < kBK * W / NT; ++q) {
            const bool ok = in && k0 + k1 + q * (NT / W) < o.nk;
            cp4(s + q * (NT / W) * (W + 4), ok ? src + q * (NT / W) * o.ld : o.p, ok ? 4 : 0);
        }
    }
}

// This thread's 16-byte copies of stage_i's round in s (o.vec), each value
// times w[k].
template <int W, int NT>
__device__ __forceinline__ void scale_i(float* s, const float* w) {
#pragma unroll
    for (int q = 0; q < W * kBK / (4 * NT); ++q) {
        const int c = threadIdx.x + q * NT, k = c / (W / 4), i = 4 * (c % (W / 4));
        float4* p = reinterpret_cast<float4*>(s + k * (W + 4) + i);
        float4 v = *p;
        const float e = w[k];
        v.x *= e; v.y *= e; v.z *= e; v.w *= e;
        *p = v;
    }
}

// Round k0 .. k0+kBK-1 of a K-contiguous operand (o.vec) into s[i][kKP]
// (K-major), W rows, 4 values of k a copy.
template <int W, int NT>
__device__ __forceinline__ void stage_k(float* s, const Opnd& o, int k0) {
    static_assert(W * kBK % (4 * NT) == 0, "whole 16-byte copies a thread");
    const float* src = o.p + k0;
#pragma unroll
    for (int q = 0; q < W * kBK / (4 * NT); ++q) {
        const int c = threadIdx.x + q * NT, i = c / (kBK / 4), k = 4 * (c % (kBK / 4));
        const int n = i < o.ni ? min(max(o.nk - k0 - k, 0), 4) : 0;
        cp16(s + i * kKP + k, n ? src + i * o.ld + k : o.p, 4 * n);
    }
}

// Round k0 .. k0+kBK-1 of a K-contiguous operand across memory into
// s[k][W + 4], 4 bytes a copy: a warp's copy takes 8 consecutive k of 4
// rows (32-byte reads), its shared writes land in 32 distinct banks.
template <int W, int NT>
__device__ __forceinline__ void stage_t(float* s, const Opnd& o, int k0) {
    constexpr int R = NT / 8;                   // rows a pass: (k % 8, row) = (tid % 8, tid / 8)
    static_assert(kBK % 8 == 0 && NT % 8 == 0 && W % R == 0, "the copies' lane map");
    const int kl = threadIdx.x % 8, i0 = threadIdx.x / 8;
    const float* src = o.p + k0 + kl + i0 * o.ld;
    s += kl * (W + 4) + i0;
#pragma unroll
    for (int kh = 0; kh < kBK; kh += 8) {
        const bool kok = k0 + kl + kh < o.nk;
#pragma unroll
        for (int j = 0; j < W; j += R) {
            const bool ok = kok && i0 + j < o.ni;
            cp4(s + kh * (W + 4) + j, ok ? src + kh + j * o.ld : o.p, ok ? 4 : 0);
        }
    }
}

// A BM x BN output tile of NT = BM/TM x BN/TN threads, TM x TN sums each
// (8 x 8, or 4 x 4 where a tile must spread over more threads): thread
// (ty, tx) = (tid / TX, tid % TX). Columns 4 tx + c % 4 + BN/2 (c / 4) (8
// lanes read 128 contiguous bytes of an I-major row); rows the same way (AK
// false), or ty + TY r where A is K-major (AK).
template <int BM, int BN, int TM, int TN, bool AK>
struct Map {
    static constexpr int TX = BN / TN, TY = BM / TM;
    static_assert(TM % 4 == 0 && TN % 4 == 0 && TM <= 8 && TN <= 8, "4 x 4 to 8 x 8 a thread");
    int ty, tx;
    __device__ Map() : ty(threadIdx.x / TX), tx(threadIdx.x % TX) {}
    __device__ int row(int r) const { return AK ? ty + TY * r : 4 * ty + r % 4 + BM / 2 * (r / 4); }
    __device__ int col(int c) const { return 4 * tx + c % 4 + BN / 2 * (c / 4); }
};

// A thread's TW values of an I-major row of W: at 4 t (and W/2 + 4 t).
template <int W, int TW>
__device__ __forceinline__ void frag(float (&v)[TW], const float* row, int t) {
#pragma unroll
    for (int h = 0; h < TW / 4; ++h) {
        const float4 f = *reinterpret_cast<const float4*>(row + W / 2 * h + 4 * t);
        v[4 * h] = f.x; v[4 * h + 1] = f.y; v[4 * h + 2] = f.z; v[4 * h + 3] = f.w;
    }
}

// acc[r][c] += A(row(r), k) B(col(c), k) for k = 0, 1, .. up to K rounded up
// to kBK (the operands are 0 past their ends), one fmaf each, in that order.
// A is K-major (rows of AP floats, read 2 k at a time), B I-major in ring
// slots of kBK x (BN + 4) from sb. stage(slot, k0) issues this thread's
// copies of round k0 into ring slot `slot`; a_at(st) gives round st's A.
// Returns with every copy landed and the ring free.
template <int BM, int BN, int TM, int TN, int AP, typename Stage, typename AAt>
__device__ __forceinline__ void product(float (&acc)[TM][TN], int K, const float* sb, Stage stage,
                                        AAt a_at) {
    constexpr int SB = kBK * (BN + 4);
    const Map<BM, BN, TM, TN, true> m;
    const int rounds = (K + kBK - 1) / kBK;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < rounds) stage(s, s * kBK);
        cp_commit();
    }
    for (int st = 0; st < rounds; ++st) {
        cp_wait<kStages - 2>();
        __syncthreads();
        const int nx = st + kStages - 1;
        if (nx < rounds) stage(nx % kStages, nx * kBK);
        cp_commit();
        const float* a = a_at(st);
        const float* b = sb + (st % kStages) * SB;
#pragma unroll
        for (int k = 0; k < kBK; k += 2) {
            float2 av[TM];
#pragma unroll
            for (int r = 0; r < TM; ++r)
                av[r] = *reinterpret_cast<const float2*>(a + m.row(r) * AP + k);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float bv[TN];
                frag<BN, TN>(bv, b + (k + h) * (BN + 4), m.tx);
#pragma unroll
                for (int r = 0; r < TM; ++r) {
                    const float ar = h ? av[r].y : av[r].x;
#pragma unroll
                    for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(ar, bv[c], acc[r][c]);
                }
            }
        }
    }
    cp_wait<0>();
    __syncthreads();
}

// Dynamic shared memory of the kernels whose A is K-major (gram, dx, dbc):
// the first product's ring, or the second's B ring and its resident A.
constexpr int pair_bytes(int BN) {
    const int first = kStages * (kL * kKP + kBK * (BN + 4));
    const int second = kStages * kBK * (BN + 4) + kL * kA2;
    return 4 * (first > second ? first : second);
}
// The state kernel's: its resident A and weights, then one buffer of x or dy
// a 64-column tile of Pe (two where Pe has several).
constexpr int state_bytes(int BM, int tiles) {
    return 4 * (kL * (BM + 4) + kL + (tiles > 1 ? 2 : 1) * kL * (kT + 4));
}
static_assert(pair_bytes(2 * kT) <= 48 * 1024, "within the default dynamic shared memory");

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

// out[item][c] = X Y^T over the chunk's rows (zero past T): [u][r] = X_u . Y_r,
// k < K. Row t of item i starts at (i / per) * s_b + (i % per) * s_i + t * s_t.
constexpr int kGramThreads = 256;          // 4 x 4 sums a thread: one block an SM at xlstm

__global__ void __launch_bounds__(kGramThreads)
ssd_bwd_gram_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                    float* __restrict__ out, int T, int nc, int per, long long s_b,
                    long long s_i, int s_t, int K) {
    constexpr int NT = kGramThreads, SA = kL * kKP, SB = kBK * (kT + 4);
    extern __shared__ float4 smem[];
    float* ra = reinterpret_cast<float*>(smem);
    float* rb = ra + kStages * SA;
    const int c = blockIdx.x, item = blockIdx.y, t0 = c * kL;
    const long long base =
        (item / per) * s_b + (item % per) * s_i + static_cast<long long>(t0) * s_t;
    const Opnd A{X + base, s_t, T - t0, K, true};                   // (u, k)
    const Opnd B{Y + base, s_t, T - t0, K, false};                  // (r, k)
    float acc[4][4] = {};
    product<kL, kT, 4, 4, kKP>(
        acc, K, rb,
        [&](int slot, int k0) {
            stage_k<kL, NT>(ra + slot * SA, A, k0);
            stage_t<kT, NT>(rb + slot * SB, B, k0);
        },
        [&](int st) { return ra + (st % kStages) * SA; });
    const Map<kL, kT, 4, 4, true> m;
    float* o = out + (static_cast<long long>(item) * nc + c) * kL * kL;
#pragma unroll
    for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(o + m.row(r) * kL + m.col(0)) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// mode 0: dS[n][p] = sum_r B_r[n] eb_r x_r[p]; mode 1: dG[n][p] = sum_u
// C_u[n] ea_u dy_u[p]; one BM-row strip of [N, Pe] per block (BM = 128 where
// N > 64). Its A (B eb or C ea over the chunk's 64 steps) is copied and
// scaled once and stays in shared memory; the strip's 64-column tiles of x or
// dy stream through two buffers, the next tile's copies in flight while a
// tile's FMAs run. A tile's sums leave through its buffer, 64 rows at a
// time, a row by consecutive lanes (rows of Pe = 1025 floats are not 16-byte
// aligned); then the buffer takes the tile after next.
__host__ __device__ constexpr int state_threads(int BM) { return BM * kT / (8 * kStateTN); }

template <int BM>
__global__ void __launch_bounds__(state_threads(BM))
ssd_bwd_state_kernel(const float* __restrict__ x, const float* __restrict__ B,
                     const float* __restrict__ C, const float* __restrict__ dy,
                     const float* __restrict__ dec, float* __restrict__ sp,
                     float* __restrict__ gi, Dims d) {
    constexpr int NT = state_threads(BM), TN = kStateTN, AP = BM + 4, XP = kT + 4;
    extern __shared__ float4 smem[];
    float* as = reinterpret_cast<float*>(smem);         // [kL][AP]
    float* wsh = as + kL * AP;                          // [kL]
    float* xs = wsh + kL;                               // 2 x [kL][XP]
    const int tn = blockIdx.x, c = blockIdx.y;
    const int mode = blockIdx.z & 1, bh = blockIdx.z >> 1, b = bh / d.H, h = bh % d.H;
    const int g = h / d.rep, t0 = c * kL, n0 = tn * BM;
    const long long bhc = static_cast<long long>(bh) * d.nc + c;
    const long long row0 = static_cast<long long>(b) * d.T + t0;
    const float* D = dec + bhc * kDec + (mode == 0 ? kEb : kEa);
    const Opnd A{(mode == 0 ? B : C) + (row0 * d.G + g) * d.N + n0, d.G * d.N, d.N - n0,
                 d.T - t0, true};                                       // (n, step)
    const float* xy = (mode == 0 ? x : dy) + (row0 * d.H + h) * d.pe4;
    auto stage_x = [&](int tp) {                                        // (p, step)
        const Opnd X{xy + tp * kT, d.H * d.pe4, d.pe4 - tp * kT, d.T - t0, true};
#pragma unroll
        for (int k0 = 0; k0 < kL; k0 += kBK)
            stage_i<kT, NT>(xs + (tp & 1) * kL * XP + k0 * XP, X, k0);
    };
    if (threadIdx.x < kL / 4) cp16(wsh + 4 * threadIdx.x, D + 4 * threadIdx.x, 16);
#pragma unroll
    for (int k0 = 0; k0 < kL; k0 += kBK) stage_i<BM, NT>(as + k0 * AP, A, k0);
    cp_commit();
    stage_x(0);
    cp_commit();
    if (d.ntp > 1) stage_x(1);
    cp_commit();
    cp_wait<2>();                               // A and the weights landed
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < kL; k0 += kBK) scale_i<BM, NT>(as + k0 * AP, wsh + k0);
    const Map<BM, kT, 8, TN, false> m;
    float* out = (mode == 0 ? sp : gi) + bhc * d.np;
    for (int tp = 0; tp < d.ntp; ++tp) {
        cp_wait<1>();                           // tile tp landed (one group may follow)
        __syncthreads();
        const float* xt = xs + (tp & 1) * kL * XP;
        float acc[8][TN] = {};
#pragma unroll 4
        for (int k = 0; k < kL; ++k) {
            float av[8], bv[TN];
            frag<BM, 8>(av, as + k * AP, m.ty);
            frag<kT, TN>(bv, xt + k * XP, m.tx);
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[r][j] = fmaf(av[r], bv[j], acc[r][j]);
        }
        float* ot = xs + (tp & 1) * kL * XP;    // [kL][XP]: rows h * 64 .. h * 64 + 63
        const int p0 = tp * kT;
#pragma unroll
        for (int h2 = 0; h2 < BM / kL; ++h2) {
            __syncthreads();                    // the buffer (or its last rows) is free
#pragma unroll
            for (int r = 8 * kL / BM * h2; r < 8 * kL / BM * (h2 + 1); ++r)  // the half's rows
#pragma unroll
                for (int j = 0; j < TN; j += 4)
                    *reinterpret_cast<float4*>(ot + (m.row(r) - kL * h2) * XP + m.col(j)) =
                        make_float4(acc[r][j], acc[r][j + 1], acc[r][j + 2], acc[r][j + 3]);
            __syncthreads();
            float* o = out + static_cast<long long>(n0 + kL * h2) * d.Pe + p0;
            for (int e = threadIdx.x; e < kL * kT; e += NT) {
                const int r = e / kT, q = e % kT;
                if (n0 + kL * h2 + r < d.N && p0 + q < d.Pe) o[r * d.Pe + q] = ot[r * XP + q];
            }
        }
        __syncthreads();                        // the tile's buffer is free
        if (tp + 2 < d.ntp) stage_x(tp + 2);
        cp_commit();
    }
}

// dx_s = eb_s Gin^T B_s + sum_{u>=s} Dm[u][s] CB[u][s] dy_u, one 64-column
// tile of Pe per block; dx's pad columns Pe .. pe4 get zeros.
constexpr int kDxThreads = kL * kT / (8 * kDxTN);

__global__ void __launch_bounds__(kDxThreads, 384 / kDxThreads)
ssd_bwd_dx_kernel(const float* __restrict__ B, const float* __restrict__ dy,
                  const float* __restrict__ gi, const float* __restrict__ dec,
                  const float* __restrict__ cb, float* __restrict__ dx, Dims d) {
    constexpr int NT = kDxThreads, TN = kDxTN, SA = kL * kKP, SB = kBK * (kT + 4);
    extern __shared__ float4 smem[];
    float* sm = reinterpret_cast<float*>(smem);
    const int tp = blockIdx.x, c = blockIdx.y, bh = blockIdx.z, b = bh / d.H, h = bh % d.H;
    const int g = h / d.rep, t0 = c * kL, p0 = tp * kT;
    const long long bhc = static_cast<long long>(bh) * d.nc + c;
    const long long row0 = static_cast<long long>(b) * d.T + t0;
    const float* D = dec + bhc * kDec;
    const float* CB = cb + ((static_cast<long long>(b) * d.G + g) * d.nc + c) * kL * kL;
    const Opnd Bs{B + (row0 * d.G + g) * d.N, d.G * d.N, d.T - t0, d.N, true};  // (s, n)
    const Opnd Gin{gi + bhc * d.np + p0, d.Pe, d.Pe - p0, d.N, d.Pe % 4 == 0};         // (p, n)
    float acc[8][TN] = {};
    float* ra = sm;
    float* rb = sm + kStages * SA;
    product<kL, kT, 8, TN, kKP>(
        acc, d.N, rb,
        [&](int slot, int k0) {
            stage_k<kL, NT>(ra + slot * SA, Bs, k0);
            stage_i<kT, NT>(rb + slot * SB, Gin, k0);
        },
        [&](int st) { return ra + (st % kStages) * SA; });
    const Map<kL, kT, 8, TN, true> m;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
        const float e = D[kEb + m.row(r)];
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[r][j] *= e;
    }
    float* rb2 = sm;                            // the second product's B ring, then A
    float* a2 = sm + kStages * SB;              // A(s, u) = Dm[u][s] CB[u][s] as [s][u]
    for (int e = threadIdx.x; e < kL * kL; e += NT) a2[(e % kL) * kA2 + e / kL] = D[e] * CB[e];
    const Opnd Dy{dy + (row0 * d.H + h) * d.pe4 + p0, d.H * d.pe4, d.pe4 - p0, d.T - t0,
                  true};                                                  // (p, u)
    product<kL, kT, 8, TN, kA2>(
        acc, kL, rb2, [&](int slot, int k0) { stage_i<kT, NT>(rb2 + slot * SB, Dy, k0); },
        [&](int st) { return a2 + st * kBK; });
#pragma unroll
    for (int r = 0; r < 8; ++r) {
        const int t = t0 + m.row(r);
        if (t >= d.T) continue;
        float* o = dx + ((static_cast<long long>(b) * d.T + t) * d.H + h) * d.pe4 + p0;
#pragma unroll
        for (int h2 = 0; h2 < TN / 4; ++h2)
            if (p0 + m.col(4 * h2) < d.pe4)
                *reinterpret_cast<float4*>(o + m.col(4 * h2)) = make_float4(
                    acc[r][4 * h2], acc[r][4 * h2 + 1], acc[r][4 * h2 + 2], acc[r][4 * h2 + 3]);
    }
}

// Per head, one BN-column tile of N per block (BN = 128 where N > 64).
// mode 0: dB_s = eb_s Gin x_s + sum_{u>=s} Dm[u][s] XD[u][s] C_u, with each
// 64-column tile's partial of B_s.(Gin x_s); mode 1: dC_u = ea_u S_prev dy_u
// + sum_{r<=u} Dm[u][r] XD[u][r] B_r, with the partials of C_u.(S_prev dy_u).
// A partial sums a lane's 4 consecutive columns by fmaf, then the 16 lanes
// of a 64-column tile by an xor tree (8, 4, 2, 1). 8 x 8 sums a thread at
// 128 columns, 8 x 4 at 64: 128 threads either way.
template <int BN, int TN>
__global__ void __launch_bounds__(kL * BN / (8 * TN), 3)
ssd_bwd_dbc_kernel(const float* __restrict__ x, const float* __restrict__ B,
                   const float* __restrict__ C, const float* __restrict__ dy,
                   const float* __restrict__ sp, const float* __restrict__ gi,
                   const float* __restrict__ dec, const float* __restrict__ xd,
                   float* __restrict__ dBh, float* __restrict__ dCh,
                   float* __restrict__ kq, Dims d) {
    constexpr int NT = kL * BN / (8 * TN), TX = BN / TN, SA = kL * kKP, SB = kBK * (BN + 4);
    static_assert(BN == kT || BN == 2 * kT, "one or two da partials a row");
    static_assert(TX >= 16, "a 64-column tile's 16 column groups in 16 lanes");
    extern __shared__ float4 smem[];
    float* sm = reinterpret_cast<float*>(smem);
    const int tb = blockIdx.x, c = blockIdx.y, mode = blockIdx.z & 1, bh = blockIdx.z >> 1;
    const int b = bh / d.H, h = bh % d.H, g = h / d.rep, t0 = c * kL, n0 = tb * BN;
    const long long bhc = static_cast<long long>(bh) * d.nc + c;
    const long long row0 = static_cast<long long>(b) * d.T + t0;
    const float* D = dec + bhc * kDec;
    const float* XD = xd + bhc * kL * kL;       // [u][r] = dy_u . x_r
    const float* St = (mode == 0 ? gi : sp) + bhc * d.np;   // Gin or S_prev, [N][Pe]
    const float* own = (mode == 0 ? B : C) + (row0 * d.G + g) * d.N;   // B_s or C_u, row s
    const float* other = mode == 0 ? C : B;     // C_u or B_r of the sum
    const Opnd Xy{(mode == 0 ? x : dy) + (row0 * d.H + h) * d.pe4, d.H * d.pe4, d.T - t0, d.Pe,
                  true};                                                  // (s, p)
    const Opnd S{St + static_cast<long long>(n0) * d.Pe, d.Pe, d.N - n0, d.Pe, false};  // (n, p)
    float acc[8][TN] = {};
    float* ra = sm;
    float* rb = sm + kStages * SA;
    product<kL, BN, 8, TN, kKP>(
        acc, d.Pe, rb,
        [&](int slot, int k0) {
            stage_k<kL, NT>(ra + slot * SA, Xy, k0);
            stage_t<BN, NT>(rb + slot * SB, S, k0);
        },
        [&](int st) { return ra + (st % kStages) * SA; });
    const Map<kL, BN, 8, TN, true> m;
#pragma unroll
    for (int r = 0; r < 8; ++r) {               // the tiles' partials of the row's dot term
        const int s = m.row(r), t = t0 + s;
        float part[TN / 4];                     // column group h2: 4 tx + BN/2 h2 ..
#pragma unroll
        for (int h2 = 0; h2 < TN / 4; ++h2) {
            part[h2] = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int n = n0 + m.col(4 * h2 + j);
                if (t < d.T && n < d.N)
                    part[h2] = fmaf(own[s * d.G * d.N + n], acc[r][4 * h2 + j], part[h2]);
            }
        }
#pragma unroll
        for (int h2 = 0; h2 < TN / 4; ++h2) {   // a tile's 16 groups in lanes tx % 16
            float v = part[h2];
#pragma unroll
            for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
            const int tile = tb * (BN / kT) + m.col(4 * h2) / kT;
            if (m.tx % 16 == 0 && tile < d.ntn) kq[((bhc * 2 + mode) * d.ntn + tile) * kL + s] = v;
        }
        const float e = D[(mode == 0 ? kEb : kEa) + s];
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[r][j] *= e;
    }
    float* rb2 = sm;                            // the second product's B ring, then A
    float* a2 = sm + kStages * kBK * (BN + 4);  // mode 0: A(s, u) = Dm[u][s] XD[u][s] as
    for (int e = threadIdx.x; e < kL * kL; e += NT) {   // [s][u]; mode 1: A(u, r) as [u][r]
        const int u = e / kL, v = e % kL;
        a2[mode == 0 ? v * kA2 + u : u * kA2 + v] = D[e] * XD[e];
    }
    const Opnd O{other + (row0 * d.G + g) * d.N + n0, d.G * d.N, d.N - n0, d.T - t0,
                 true};                                                   // (n, u or r)
    product<kL, BN, 8, TN, kA2>(
        acc, kL, rb2, [&](int slot, int k0) { stage_i<BN, NT>(rb2 + slot * SB, O, k0); },
        [&](int st) { return a2 + st * kBK; });
    float* out = mode == 0 ? dBh : dCh;         // [b, T, H, N]
#pragma unroll
    for (int r = 0; r < 8; ++r) {
        const int t = t0 + m.row(r);
        if (t >= d.T) continue;
        float* o = out + ((static_cast<long long>(b) * d.T + t) * d.H + h) * d.N + n0;
#pragma unroll
        for (int h2 = 0; h2 < TN / 4; ++h2) {
            const int n = m.col(4 * h2);
            if (n0 + n < d.N)
                *reinterpret_cast<float4*>(o + n) = make_float4(
                    acc[r][4 * h2], acc[r][4 * h2 + 1], acc[r][4 * h2 + 2], acc[r][4 * h2 + 3]);
        }
    }
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
    return d.b > 0 && d.T > 0 && d.H > 0 && d.G > 0 && d.H % d.G == 0 && d.N > 0 &&
           d.N % 4 == 0 && d.Pe > 0 && static_cast<long long>(d.b) * d.H * 2 <= 65535 &&
           d.nc <= 65535 &&
           static_cast<long long>(d.ntn) * d.ntp <= 2147483647LL;
}

// The state kernel's largest dynamic shared memory, above the default 48 KB.
template <int BM>
cudaError_t state_allow() {
    return cudaFuncSetAttribute(ssd_bwd_state_kernel<BM>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, state_bytes(BM, 2));
}

// out[0..3]: dynamic shared memory of a block (bytes), blocks per SM,
// registers a thread and local (spill) bytes a thread.
template <typename Kernel>
cudaError_t occupancy_of(Kernel kernel, int threads, int bytes, int* out) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, kernel, threads, bytes);
    out[0] = bytes;
    out[2] = attr.numRegs;
    out[3] = static_cast<int>(attr.localSizeBytes);
    return err;
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

// x, dy, dx: [b, T, H, Pe4], Pe4 = Pe rounded up to a multiple of 4 (x's and
// dy's columns Pe .. Pe4 zero; dx's are written as zeros); a, da: [b, T, H];
// B, C, dB, dC: [b, T, G, N]; dBh, dCh: [b, T, H, N] (the per-head sums;
// pass dB and dC themselves when G == H); s0 (initial state) and dsf (final
// state's gradient): [b, H, N, Pe] or null (zeros); ws:
// ssd_scan_bwd_workspace's floats. All fp32, contiguous, 16-byte aligned;
// N a multiple of 4.
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
    const int bh = b * H, pe4 = d.pe4;
    const bool wide = N > kT;                   // 128-row (-column) state and dbc tiles
    const int ntw = (N + 2 * kT - 1) / (2 * kT);
    ssd_bwd_decay_kernel<<<dim3(d.nc, bh), kL, 0, s>>>(a, dec, d);
    ssd_bwd_gram_kernel<<<dim3(d.nc, b * G), kGramThreads, pair_bytes(kT), s>>>(
        C, B, cb, T, d.nc, G, static_cast<long long>(T) * G * N, N, G * N, N);
    ssd_bwd_gram_kernel<<<dim3(d.nc, bh), kGramThreads, pair_bytes(kT), s>>>(
        dy, x, xd, T, d.nc, H, static_cast<long long>(T) * H * pe4, pe4, H * pe4, Pe);
    const int sbytes = state_bytes(wide ? 2 * kT : kT, d.ntp);
    const cudaError_t err = wide ? state_allow<2 * kT>() : state_allow<kT>();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (wide)
        ssd_bwd_state_kernel<2 * kT><<<dim3(ntw, d.nc, 2 * bh), state_threads(2 * kT), sbytes, s>>>(
            x, B, C, dy, dec, sp, gi, d);
    else
        ssd_bwd_state_kernel<kT><<<dim3(d.ntn, d.nc, 2 * bh), state_threads(kT), sbytes, s>>>(
            x, B, C, dy, dec, sp, gi, d);
    ssd_bwd_pass_kernel<<<dim3(d.npass, bh), kThreads, 0, s>>>(sp, gi, s0, dsf, dec, dot, d);
    ssd_bwd_dx_kernel<<<dim3(d.ntp, d.nc, bh), kDxThreads, pair_bytes(kT), s>>>(B, dy, gi, dec,
                                                                              cb, dx, d);
    if (wide)                                   // 128 threads either way
        ssd_bwd_dbc_kernel<2 * kT, 8><<<dim3(ntw, d.nc, 2 * bh), 128, pair_bytes(2 * kT), s>>>(
            x, B, C, dy, sp, gi, dec, xd, dBh, dCh, kq, d);
    else
        ssd_bwd_dbc_kernel<kT, 4><<<dim3(d.ntn, d.nc, 2 * bh), 128, pair_bytes(kT), s>>>(
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

// out[4 i .. 4 i + 3] for the products i = gram, state, dx, dbc as a call
// with this N and Pe launches them: dynamic shared memory of a block (bytes),
// blocks per SM, registers a thread and local (spill) bytes a thread; for
// the build log.
extern "C" int ssd_scan_bwd_occupancy(int N, int Pe, int* out) {
    const bool wide = N > kT;
    const int sbytes = state_bytes(wide ? 2 * kT : kT, (Pe + kT - 1) / kT);
    cudaError_t err = wide ? state_allow<2 * kT>() : state_allow<kT>();
    if (err == cudaSuccess)
        err = occupancy_of(ssd_bwd_gram_kernel, kGramThreads, pair_bytes(kT), out);
    if (err == cudaSuccess)
        err = wide ? occupancy_of(ssd_bwd_state_kernel<2 * kT>, state_threads(2 * kT), sbytes,
                                  out + 4)
                   : occupancy_of(ssd_bwd_state_kernel<kT>, state_threads(kT), sbytes, out + 4);
    if (err == cudaSuccess)
        err = occupancy_of(ssd_bwd_dx_kernel, kDxThreads, pair_bytes(kT), out + 8);
    if (err == cudaSuccess)
        err = wide ? occupancy_of(ssd_bwd_dbc_kernel<2 * kT, 8>, 128, pair_bytes(2 * kT), out + 12)
                   : occupancy_of(ssd_bwd_dbc_kernel<kT, 4>, 128, pair_bytes(kT), out + 12);
    return static_cast<int>(err);
}
