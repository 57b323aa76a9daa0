// Causal / sliding-window GQA flash attention (forward), bf16, on Hopper's
// tensor cores: wgmma for both products, TMA for every tile.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (wrapper `flash_attention`, pallas_call at flash_attention.py:121) for bf16
// tensors; fp32 tensors keep the CUDA-core kernel of flash_attention.cu, since
// TF32 would not hold fp32's tolerance. Same contract: q [B,T,H,hd], k/v
// [B,S,KV,hd], hd in {32, 64, 80, 128, 192}, query row t at absolute position
// t + q_offset, KV head = h / (H/KV), scale 1/sqrt(hd), online softmax with an
// fp32 (acc, m, l) state, KV tiles fully masked for the block are skipped (the
// TPU kernel's `live`), a row whose l stays 0 gives 0. Any T and S: query rows
// past T are zero-filled by TMA and never written, keys past S are masked (a
// zero-filled key would score 0, not -inf).
//
// What bounds it on the H100: operations once T >= ~300. A causal T x T pass
// does ~T/2 * 4 flops per byte of q, k, v and o, against the card's ~295
// flops per byte in bf16 (989 TFLOP/s over 3.35 TB/s).
//
// Design: a block owns 64 query rows of one (batch, head), the M of one
// consumer warpgroup's wgmma, and two blocks share an SM (82 KB of shared
// memory each at hd = 128; hd 192 has a kernel of its own, below). Against 128-row
// blocks of two warpgroups this halves the longest block's work under
// causal and lets the block scheduler pair a long query tile with a short
// one on each SM (the A/B on the H100 is in PERF.md section 6).
// - Q is loaded once by TMA; K and V tiles of 64 keys go through a two-stage
//   ring in shared memory, so the copy of tile j+1 runs under the math of
//   tile j. Each TMA box is one swizzle atom wide (hd*2 bytes up to 128), and
//   the wgmma descriptors read it with the same swizzle: 128B for hd >= 64
//   (hd = 128 is two atoms side by side, hd = 192 three), 64B for hd = 32.
//   The tensor maps are 4-d (hd, heads, positions, batch), so the per-head
//   strides H*hd and KV*hd and the ragged ends are the TMA unit's business.
// - S = Q K^T is m64n64k16 with both operands in shared memory (K [keys, hd]
//   is already K-major). O += P V is m64n{hd}k16 with P in registers,
//   converted to bf16 from the S accumulator fragment, and V read as stored
//   through the instruction's transpose flag.
// - The softmax runs on the accumulator fragment (each thread holds two rows,
//   a quad of threads a whole row): row max and sum by quad shuffles, exp2f
//   with scale*log2(e) folded in. Only tiles that cross the causal diagonal,
//   a window edge or S are masked element by element.
// - Query tiles run heaviest first under causal (blockIdx.y reversed, heads
//   along x), so the long rows do not land in the last wave.
// - KV tiles masked for every row of the block are neither loaded nor
//   computed: the loop runs over [kt_begin, kt_end) only.
// - hd 80 (zamba2's shared block) is not a whole number of 64-column swizzle
//   atoms, so it runs hd 128's layout: two atoms of Q, K and V in shared
//   memory. The tensor maps keep the true extent (80 columns, rows H*80*2
//   and KV*80*2 bytes apart), so the second atom's box reads 16 real columns
//   and TMA fills the other 48 with zeros; its full box still counts on the
//   barrier, as rows past T do. Q K^T runs 5 k16 slices (the zeros past
//   column 80 would add nothing), P V is m64n128k16 and only 80 columns of o
//   are stored: 1.6x the tensor-core work of P V that hd 80 needs.
// - hd 192 (nemotron-4-340b, GQA 96:8) is three 64-column atoms: Q K^T runs
//   12 k16 slices, P V is one m64n192k16 (96 accumulator registers a
//   thread). It has a kernel of its own (flash_fwd_sm90_hd192_kernel, below):
//   the same 64-row blocks and arithmetic, K and V single-buffered so that
//   three blocks (12 warps) share an SM, and O stored by TMA from shared
//   memory. With a two-stage ring (121 KB) one block of one warpgroup held
//   an SM and nothing ran under its softmax: 1.72x SDPA. Measured against
//   it on the H100 (PERF.md section 6): 128-row blocks of two consumer
//   warpgroups and a producer warp with setmaxnreg (ptxas kept the
//   consumers at the 168 registers of the launch, and spilled), and 64-row
//   blocks two an SM with V single-buffered. Three small blocks won: one
//   block's softmax, waits and Q load run under the others' products, and
//   the TMA store took most of a per-block cost that 4-byte stores of O
//   had left exposed.
// Rounding P to bf16 before P V is the one departure from the TPU kernel,
// which keeps P in fp32: about one bf16 ulp of the output.
// - For training, the kernel also writes each row's log-sum-exp (lse, fp32
//   [B,H,T]) for the backward (flash_attention_bwd.cu): the softmax's max and
//   sum are already in registers after the quad shuffles, so it costs one
//   logf and one 4-byte store per row. The softmax runs in base 2 with
//   scale*log2(e) folded into m; lse is written in the backward's units,
//   natural log of the scaled scores: m*ln(2) + log(l), and +inf for a row
//   whose l is 0 (no visible key). Serving passes a null lse and writes none.
// - Training at hd <= 128 also passes o_lo, and the kernel writes there what
//   rounding O to bf16 dropped, bf16(o - bf16(o)) from the same fp32 value:
//   the backward's D = rowsum(do * o) then reads o + o_lo, about 16 bits of
//   the fp32 output where bf16 O alone holds 8. D is subtracted from every
//   dP of its row, so an error in it does not average out over the keys: it
//   adds D's error times the row's mean key to dq. With whisper's QKV biases
//   (a large common part of v, hence of o and dP, that dP - D cancels),
//   D from bf16 O made the reduced model's dq-side gradients (ln_x, the
//   query projections) up to 3.1x as far from the fp32 result as JAX's bf16
//   gradients are (tests/test_torch_frontend_train.py). One more 4-byte
//   store a thread per 2 columns, as O's.
//
// Left for later, at hd <= 128: the next tile's Q K^T issued under this
// tile's softmax (FA3's intra-warpgroup overlap), a persistent grid, the TMA
// store of O that hd 192 has.

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BQ = 64;      // query rows per block: one warpgroup's wgmma M
constexpr int BK = 64;      // keys per KV tile
constexpr int NT = 128;     // threads per block: one consumer warpgroup
constexpr int STAGES = 2;   // K/V ring depth

template <int HD>
struct Cfg {
    static constexpr int W = HD == 80 ? 128 : HD;           // columns of a tile in shared memory
    static constexpr int SW = W * 2 < 128 ? W * 2 : 128;    // swizzle = atom row bytes
    static constexpr int ATOM = SW / 2;                     // columns per atom
    static constexpr int NATOM = W / ATOM;
    static constexpr int KSLICES = (HD + 15) / 16;          // k16 slices of Q K^T
    static constexpr int Q_BYTES = BQ * W * 2;
    static constexpr int KV_BYTES = BK * W * 2;             // one K or V tile
    static constexpr int q = 0;                             // byte offsets, 1024-aligned
    static constexpr int k = q + Q_BYTES;
    static constexpr int v = k + STAGES * KV_BYTES;
    static constexpr int bar = v + STAGES * KV_BYTES;       // q barrier, then one per stage
    static constexpr int bytes = bar + 8 * (1 + STAGES) + 1024;  // + alignment slack
    static constexpr int BLOCKS = HD <= 128 ? 2 : 1;        // per SM (launch bounds)
};

template <int HD>
__global__ void __launch_bounds__(NT, Cfg<HD>::BLOCKS)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                      __nv_bfloat16* __restrict__ o_lo, float* __restrict__ lse, int T_len,
                      int S_len, int H, int KV, int causal, int window, int q_offset,
                      float scale_log2) {
    using C = Cfg<HD>;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t Qs = base + C::q, Ks = base + C::k, Vs = base + C::v;
    const uint32_t qbar = base + C::bar;
    auto full = [&](int s) { return qbar + 8 * (1 + s); };

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / (H / KV);
    const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
    const int q0 = qt * BQ;

    // Live KV tiles of the block (the TPU kernel's `live`); every tile in
    // [kt_begin, kt_end) has a visible key for some row of the block.
    const int n_kt = (S_len + BK - 1) / BK;
    const int q_first = q0 + q_offset;
    const int q_last = min(q0 + BQ, T_len) - 1 + q_offset;
    int kt_end = n_kt, kt_begin = 0;
    if (causal) kt_end = q_last < 0 ? 0 : min(n_kt, q_last / BK + 1);
    if (window > 0) kt_begin = max(0, (q_first - window + 1) / BK);

    auto load_kv = [&](int stage, int kt) {
        mbar_expect_tx(full(stage), 2 * C::KV_BYTES);
#pragma unroll
        for (int a = 0; a < C::NATOM; ++a) {
            const uint32_t off = stage * C::KV_BYTES + a * BK * C::SW;
            tma_load_4d(Ks + off, &kmap, full(stage), a * C::ATOM, kvh, kt * BK, b);
            tma_load_4d(Vs + off, &vmap, full(stage), a * C::ATOM, kvh, kt * BK, b);
        }
    };
    if (tid == 0) {
        mbar_init(qbar, 1);
        for (int s = 0; s < STAGES; ++s) mbar_init(full(s), 1);
        mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0) {
        mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
        for (int a = 0; a < C::NATOM; ++a)
            tma_load_4d(Qs + a * BQ * C::SW, &qmap, qbar, a * C::ATOM, h, q0, b);
        for (int s = 0; s < STAGES && kt_begin + s < kt_end; ++s) load_kv(s, kt_begin + s);
    }

    // This thread's two rows (block-local r and r + 8) and their positions.
    const int r0 = warp * 16 + (lane >> 2);
    const int p0 = q0 + r0 + q_offset, p1 = p0 + 8;
    const int col = 2 * (lane & 3);

    float acc[C::W / 2];
#pragma unroll
    for (int i = 0; i < C::W / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // m in log2 units

    mbar_wait(qbar, 0);
    for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
        const int stage = it % STAGES;
        mbar_wait(full(stage), (it / STAGES) & 1);
        const int k0 = kt * BK;
        float s[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::KSLICES; ++kk) {
            const int atom = kk * 16 / C::ATOM;        // K-major: 32 bytes per k16
            const uint32_t off = (kk * 16 % C::ATOM) * 2;
            const uint64_t da = smem_desc<C::SW>(
                Qs + atom * BQ * C::SW + off, 16, 8 * C::SW);
            const uint64_t db = smem_desc<C::SW>(
                Ks + stage * C::KV_BYTES + atom * BK * C::SW + off, 16, 8 * C::SW);
            wgmma_ss_n64(s, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(s);

        const bool whole = k0 + BK <= S_len && (!causal || k0 + BK - 1 <= q_first) &&
                           (window <= 0 || k0 > q_first + BQ - 1 - window);
        if (!whole) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int key = k0 + 8 * i + col + (e & 1);
                    const int pos = e < 2 ? p0 : p1;
                    const bool ok = key < S_len && (!causal || key <= pos) &&
                                    (window <= 0 || key > pos - window);
                    if (!ok) s[4 * i + e] = -INFINITY;
                }
        }

        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
            mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float n0 = fmaxf(m0, mx0 * scale_log2), n1 = fmaxf(m1, mx1 * scale_log2);
        const float ref0 = n0 == -INFINITY ? 0.f : n0;   // a row with no key yet
        const float ref1 = n1 == -INFINITY ? 0.f : n1;
        const float alpha0 = exp2f(m0 - ref0), alpha1 = exp2f(m1 - ref1);
        m0 = n0;
        m1 = n1;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            s[4 * i] = exp2f(fmaf(s[4 * i], scale_log2, -ref0));
            s[4 * i + 1] = exp2f(fmaf(s[4 * i + 1], scale_log2, -ref0));
            s[4 * i + 2] = exp2f(fmaf(s[4 * i + 2], scale_log2, -ref1));
            s[4 * i + 3] = exp2f(fmaf(s[4 * i + 3], scale_log2, -ref1));
            ps0 += s[4 * i] + s[4 * i + 1];
            ps1 += s[4 * i + 2] + s[4 * i + 3];
        }
        l0 = l0 * alpha0 + ps0;       // this thread's part of the row sum
        l1 = l1 * alpha1 + ps1;

        uint32_t pa[4][4];            // P as the A fragment of four k16 slices
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
            pa[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
            pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
            pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
            pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
        }
        reg_fence(acc);
#pragma unroll
        for (int i = 0; i < C::W / 8; ++i) {
            acc[4 * i] *= alpha0;
            acc[4 * i + 1] *= alpha0;
            acc[4 * i + 2] *= alpha1;
            acc[4 * i + 3] *= alpha1;
        }
        reg_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
            const uint64_t db = smem_desc<C::SW>(
                Vs + stage * C::KV_BYTES + kc * 16 * C::SW, BK * C::SW, 8 * C::SW);
            wgmma_rs(acc, pa[kc], db);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(acc);
        __syncthreads();                              // every warp left this stage
        if (tid == 0 && kt + STAGES < kt_end) load_kv(stage, kt + STAGES);
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = l0 == 0.f ? 0.f : 1.f / l0, inv1 = l1 == 0.f ? 0.f : 1.f / l1;
    const long long row_stride = static_cast<long long>(H) * HD;
    __nv_bfloat16* o0 = o + (static_cast<long long>(b) * T_len + q0 + r0) * row_stride + h * HD;
    __nv_bfloat16* o1 = o0 + 8 * row_stride;
    const bool w0 = q0 + r0 < T_len, w1 = q0 + r0 + 8 < T_len;
    if (lse != nullptr && (lane & 3) == 0) {      // one thread of the quad per row
        constexpr float LN2 = 0.6931471805599453f;
        float* row = lse + (static_cast<long long>(b) * H + h) * T_len + q0 + r0;
        if (w0) row[0] = l0 == 0.f ? CUDART_INF_F : m0 * LN2 + logf(l0);
        if (w1) row[8] = l1 == 0.f ? CUDART_INF_F : m1 * LN2 + logf(l1);
    }
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
        if (w0)
            *reinterpret_cast<uint32_t*>(o0 + 8 * i + col) =
                pack_bf16(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
        if (w1)
            *reinterpret_cast<uint32_t*>(o1 + 8 * i + col) =
                pack_bf16(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
    }
    if (o_lo != nullptr) {                        // training: O's rounding residual
        const long long off = o0 - o;
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) {
            if (w0)
                *reinterpret_cast<uint32_t*>(o_lo + off + 8 * i + col) =
                    pack_residual(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
            if (w1)
                *reinterpret_cast<uint32_t*>(o_lo + off + 8 * row_stride + 8 * i + col) =
                    pack_residual(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
        }
    }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* o_lo, float* lse, int B,
           int T_len, int S_len, int H, int KV, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
    using C = Cfg<HD>;
    CUtensorMap qmap, kmap, vmap;
    if (!make_map(&qmap, q, B, T_len, H, HD, BQ, C::ATOM, C::SW) ||
        !make_map(&kmap, k, B, S_len, KV, HD, BK, C::ATOM, C::SW) ||
        !make_map(&vmap, v, B, S_len, KV, HD, BK, C::ATOM, C::SW))
        return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = flash_fwd_sm90_kernel<HD>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           C::bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(B * H, (T_len + BQ - 1) / BQ);
    kernel<<<grid, NT, C::bytes, stream>>>(qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o),
                                           static_cast<__nv_bfloat16*>(o_lo), lse, T_len, S_len,
                                           H, KV, causal, window, q_offset,
                                           scale * 1.4426950408889634f);
    return static_cast<int>(cudaGetLastError());
}

// ---- hd 192: 64-row blocks, three an SM, O stored by TMA ------------------
// The arithmetic of the kernel above on the same 64-row blocks (the same
// tiles in the same order, the same softmax, P rounded to bf16 before P V),
// so both give the same bits; the layout around it differs:
// - K and V are single-buffered: Q, K and V take 24 KB each, so three blocks
//   (12 warps) share an SM where a two-stage ring fitted one, and one block's
//   softmax and waits run under another's products. The next K tile is
//   loaded as soon as every warp's S = Q K^T is done with this one, the next
//   V tile once P V is.
// - O goes through shared memory (Q's tile, no longer read) in the layout of
//   the tensor map's boxes and is stored by TMA, 128-byte rows a box, where
//   the kernel above stores 4 bytes a thread; rows past T are not written.
constexpr int H192_BLOCKS = 3;                  // per SM (launch bounds)

template <int HD>
struct H192Cfg {
    static constexpr int SW = 128, ATOM = 64, NATOM = HD / ATOM;
    static constexpr int KSLICES = HD / 16;
    static constexpr int TILE = 64 * HD * 2;                // a Q, K or V tile of 64 rows
    static constexpr int q = 0, k = TILE, v = 2 * TILE;     // byte offsets, 1024-aligned
    static constexpr int bar = 3 * TILE;                    // Q, K and V barriers
    static constexpr int bytes = bar + 8 * 3 + 1024;        // + alignment slack
};

// One tile of the online softmax on the S fragment, as the kernel above
// runs it: the mask (edge tiles only), the new row max (m in log2 units),
// P = exp2(S scale log2(e) - m), this thread's part of the row sums, the
// factor alpha for the accumulator, and P as the bf16 A fragment of P V.
__device__ __forceinline__ void softmax_tile(float (&s)[32], bool whole, int k0, int p0, int p1,
                                             int col, int S_len, int causal, int window,
                                             float scale_log2, float& m0, float& m1, float& l0,
                                             float& l1, float& alpha0, float& alpha1,
                                             uint32_t (&pa)[4][4]) {
    if (!whole) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = k0 + 8 * i + col + (e & 1);
                const int pos = e < 2 ? p0 : p1;
                const bool ok = key < S_len && (!causal || key <= pos) &&
                                (window <= 0 || key > pos - window);
                if (!ok) s[4 * i + e] = -INFINITY;
            }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0 * scale_log2), n1 = fmaxf(m1, mx1 * scale_log2);
    const float ref0 = n0 == -INFINITY ? 0.f : n0;   // a row with no key yet
    const float ref1 = n1 == -INFINITY ? 0.f : n1;
    alpha0 = exp2f(m0 - ref0);
    alpha1 = exp2f(m1 - ref1);
    m0 = n0;
    m1 = n1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        s[4 * i] = exp2f(fmaf(s[4 * i], scale_log2, -ref0));
        s[4 * i + 1] = exp2f(fmaf(s[4 * i + 1], scale_log2, -ref0));
        s[4 * i + 2] = exp2f(fmaf(s[4 * i + 2], scale_log2, -ref1));
        s[4 * i + 3] = exp2f(fmaf(s[4 * i + 3], scale_log2, -ref1));
        ps0 += s[4 * i] + s[4 * i + 1];
        ps1 += s[4 * i + 2] + s[4 * i + 3];
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
        pa[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
        pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
        pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
        pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
    }
}

// The normalised O fragment (acc * inv) in bf16 into a 64-row tile of NATOM
// 64-column atoms in shared memory, as TMA lays out a box with a 128-byte
// swizzle: row r at r * 128 of its atom, 16-byte chunk c at c ^ (r % 8).
template <int NATOM>
__device__ __forceinline__ void store_o(uint32_t tile, const float (&acc)[NATOM * 32], float inv0,
                                        float inv1, int r0, int col) {
#pragma unroll
    for (int i = 0; i < NATOM * 8; ++i) {
        const uint32_t a = tile + (i / 8) * 64 * 128 + r0 * 128 + (((i % 8) ^ (r0 & 7)) * 16) +
                           col * 2;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a),
                     "r"(pack_bf16(acc[4 * i] * inv0, acc[4 * i + 1] * inv0))
                     : "memory");
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a + 8 * 128),
                     "r"(pack_bf16(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1))
                     : "memory");
    }
}

template <int HD>
__global__ void __launch_bounds__(NT, H192_BLOCKS)
flash_fwd_sm90_hd192_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap omap, float* __restrict__ lse,
                            int T_len, int S_len, int H, int KV, int causal, int window,
                            int q_offset, float scale_log2) {
    using C = H192Cfg<HD>;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t Qs = base + C::q, Ks = base + C::k, Vs = base + C::v;
    const uint32_t qbar = base + C::bar, kbar = qbar + 8, vbar = qbar + 16;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / (H / KV);
    const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
    const int q0 = qt * BQ;

    // Live KV tiles of the block, as in the kernel above.
    const int n_kt = (S_len + BK - 1) / BK;
    const int q_first = q0 + q_offset;
    const int q_last = min(q0 + BQ, T_len) - 1 + q_offset;
    int kt_end = n_kt, kt_begin = 0;
    if (causal) kt_end = q_last < 0 ? 0 : min(n_kt, q_last / BK + 1);
    if (window > 0) kt_begin = max(0, (q_first - window + 1) / BK);

    auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar, int head, int row0) {
        mbar_expect_tx(bar, C::TILE);
#pragma unroll
        for (int a = 0; a < C::NATOM; ++a)
            tma_load_4d(dst + a * BQ * C::SW, map, bar, a * C::ATOM, head, row0, b);
    };
    if (tid == 0) {
        mbar_init(qbar, 1);
        mbar_init(kbar, 1);
        mbar_init(vbar, 1);
        mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0) {
        load(Qs, &qmap, qbar, h, q0);
        if (kt_begin < kt_end) {
            load(Ks, &kmap, kbar, kvh, kt_begin * BK);
            load(Vs, &vmap, vbar, kvh, kt_begin * BK);
        }
    }

    // This thread's two rows (block-local r and r + 8) and their positions.
    const int r0 = warp * 16 + (lane >> 2);
    const int p0 = q0 + r0 + q_offset, p1 = p0 + 8;
    const int col = 2 * (lane & 3);

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // m in log2 units

    mbar_wait(qbar, 0);
    for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
        const int k0 = kt * BK;
        float s[32];
        mbar_wait(kbar, it & 1);
        uint64_t qd = smem_desc<C::SW>(Qs, 16, 8 * C::SW);
        const uint64_t kd = smem_desc<C::SW>(Ks, 16, 8 * C::SW);
        asm volatile("" : "+l"(qd));                 // 12 offsets of one base, not 12 registers
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::KSLICES; ++kk) {
            // the descriptor's address field is the low 14 bits, in 16-byte units
            const uint32_t off = (kk * 16 / C::ATOM) * BQ * C::SW + (kk * 16 % C::ATOM) * 2;
            wgmma_ss_n64(s, qd + (off >> 4), kd + (off >> 4), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(s);
        __syncthreads();                              // every warp's S is done with K
        if (tid == 0 && kt + 1 < kt_end) load(Ks, &kmap, kbar, kvh, k0 + BK);

        const bool whole = k0 + BK <= S_len && (!causal || k0 + BK - 1 <= q_first) &&
                           (window <= 0 || k0 > q_first + BQ - 1 - window);
        float alpha0, alpha1;
        uint32_t pa[4][4];
        softmax_tile(s, whole, k0, p0, p1, col, S_len, causal, window, scale_log2, m0, m1, l0, l1,
                     alpha0, alpha1, pa);
        reg_fence(acc);
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) {
            acc[4 * i] *= alpha0;
            acc[4 * i + 1] *= alpha0;
            acc[4 * i + 2] *= alpha1;
            acc[4 * i + 3] *= alpha1;
        }
        reg_fence(acc);
        mbar_wait(vbar, it & 1);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
            wgmma_rs(acc, pa[kc],
                     smem_desc<C::SW>(Vs + kc * 16 * C::SW, BK * C::SW, 8 * C::SW));
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(acc);
        __syncthreads();                              // every warp's P V is done with V
        if (tid == 0 && kt + 1 < kt_end) load(Vs, &vmap, vbar, kvh, k0 + BK);
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = l0 == 0.f ? 0.f : 1.f / l0, inv1 = l1 == 0.f ? 0.f : 1.f / l1;
    if (lse != nullptr && (lane & 3) == 0) {      // one thread of the quad per row
        constexpr float LN2 = 0.6931471805599453f;
        float* row = lse + (static_cast<long long>(b) * H + h) * T_len + q0 + r0;
        if (q0 + r0 < T_len) row[0] = l0 == 0.f ? CUDART_INF_F : m0 * LN2 + logf(l0);
        if (q0 + r0 + 8 < T_len) row[8] = l1 == 0.f ? CUDART_INF_F : m1 * LN2 + logf(l1);
    }
    store_o<C::NATOM>(Qs, acc, inv0, inv1, r0, col);
    fence_async_shared();
    __syncthreads();                                  // the whole tile is written
    if (tid == 0) {
#pragma unroll
        for (int a = 0; a < C::NATOM; ++a)
            tma_store_4d(&omap, Qs + a * BQ * C::SW, a * C::ATOM, h, q0, b);
        tma_store_commit_wait_read();
    }
}

template <int HD>
cudaError_t hd192_prepare() {
    return cudaFuncSetAttribute(flash_fwd_sm90_hd192_kernel<HD>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, H192Cfg<HD>::bytes);
}

template <int HD>
int launch_hd192(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                 int T_len, int S_len, int H, int KV, int causal, int window, int q_offset,
                 float scale, cudaStream_t stream) {
    using C = H192Cfg<HD>;
    CUtensorMap qmap, kmap, vmap, omap;
    if (!make_map(&qmap, q, B, T_len, H, HD, BQ, C::ATOM, C::SW) ||
        !make_map(&kmap, k, B, S_len, KV, HD, BK, C::ATOM, C::SW) ||
        !make_map(&vmap, v, B, S_len, KV, HD, BK, C::ATOM, C::SW) ||
        !make_map(&omap, o, B, T_len, H, HD, BQ, C::ATOM, C::SW))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = hd192_prepare<HD>();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(B * H, (T_len + BQ - 1) / BQ);
    flash_fwd_sm90_hd192_kernel<HD><<<grid, NT, C::bytes, stream>>>(
        qmap, kmap, vmap, omap, lse, T_len, S_len, H, KV, causal, window, q_offset,
        scale * 1.4426950408889634f);
    return static_cast<int>(cudaGetLastError());
}

// out[0..3]: dynamic shared memory of a block (bytes), blocks per SM,
// registers a thread at launch and local (spill) bytes a thread.
template <typename Kernel>
int occupancy_of(Kernel kernel, int threads, int bytes, int* out) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, kernel, threads, bytes);
    out[0] = bytes;
    out[2] = attr.numRegs;
    out[3] = static_cast<int>(attr.localSizeBytes);
    return static_cast<int>(err);
}

template <int HD>
int occupancy(int* out) {
    auto kernel = flash_fwd_sm90_kernel<HD>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<HD>::bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    return occupancy_of(kernel, NT, Cfg<HD>::bytes, out);
}

template <int HD>
int occupancy_hd192(int* out) {
    const cudaError_t err = hd192_prepare<HD>();
    if (err != cudaSuccess) return static_cast<int>(err);
    return occupancy_of(flash_fwd_sm90_hd192_kernel<HD>, NT, H192Cfg<HD>::bytes, out);
}

}  // namespace

// q, o, o_lo: [B,T,H,hd]; k, v: [B,S,KV,hd]; all contiguous bf16, 16-byte
// aligned. o_lo: O's bf16 rounding residual, or null to write none (serving;
// hd 192, which has no backward, takes null only). lse: fp32 [B,H,T], or
// null to write none (serving).
extern "C" int flash_attention_sm90_fwd(const void* q, const void* k, const void* v, void* o,
                                        void* o_lo, void* lse, int B, int T_len, int S_len,
                                        int H, int KV, int hd, int causal, int window,
                                        int q_offset, float scale, void* stream) {
    if (B <= 0 || T_len <= 0 || S_len <= 0 || KV <= 0 || H % KV != 0 ||
        (T_len + BQ - 1) / BQ > 65535 || (hd == 192 && o_lo != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    auto l = static_cast<float*>(lse);
    switch (hd) {
        case 32: return launch<32>(q, k, v, o, o_lo, l, B, T_len, S_len, H, KV, causal, window, q_offset, scale, s);
        case 64: return launch<64>(q, k, v, o, o_lo, l, B, T_len, S_len, H, KV, causal, window, q_offset, scale, s);
        case 80: return launch<80>(q, k, v, o, o_lo, l, B, T_len, S_len, H, KV, causal, window, q_offset, scale, s);
        case 128: return launch<128>(q, k, v, o, o_lo, l, B, T_len, S_len, H, KV, causal, window, q_offset, scale, s);
        case 192: return launch_hd192<192>(q, k, v, o, l, B, T_len, S_len, H, KV, causal, window, q_offset, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// out[0..3] = dynamic shared memory of one block (bytes), blocks per SM,
// registers a thread at launch and local (spill) bytes a thread, of the
// kernel that head dim hd launches, for the build log.
extern "C" int flash_attention_sm90_occupancy(int hd, int* out) {
    switch (hd) {
        case 32: return occupancy<32>(out);
        case 64: return occupancy<64>(out);
        case 80: return occupancy<80>(out);
        case 128: return occupancy<128>(out);
        case 192: return occupancy_hd192<192>(out);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
