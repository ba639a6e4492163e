// Flash-attention backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// There is no TPU kernel to replace: the Pallas package has a forward only
// (src/repro/kernels/flash_attention/kernel.py), and the reference's
// backward is plain JAX, `_bwd` of src/repro/models/layers/flash_core.py:119,
// which XLA compiles.  This file computes the same function as that `_bwd`
// (and as the port's plain version, `flash_attention_bwd` of
// src/repro_torch/models/layers/flash_core.py) in the head-major layout of
// the forward kernel (flash_attention_fwd.cu):
//
//   q (b, h, sq, dqk), k (b, kvh, sk, dqk), v (b, kvh, sk, dv), out and dout
//   (b, h, sq, dv), lse (b, h, sq) f32 as the forward writes it; q head i
//   reads kv head i / (h / kvh); scale = dqk^-0.5; a masked score is -1e30
//   (causal needs sq == sk), so its P is exactly 0.
//
//   delta = rowsum(dout * out)          (f32)
//   P     = exp(S scale - lse)
//   dS    = P * (dout V^T - delta) * scale
//   dV    = sum over the g q heads of a kv head of P^T dout
//   dK    = sum over the g q heads of dS^T Q
//   dQ    = dS K
//
// dq, dk and dv come back in the types of q, k and v.  One call is three
// launches, as the reference has its two passes: `flash_bwd_delta` writes
// delta and lse * log2(e) into the caller's scratch, padded to a multiple of
// 128 rows (+inf and 0 past sq, so that a row past sq reads P = 0 and never
// exp of an out-of-range lse); then a dk/dv pass over key tiles and a dq pass
// over q tiles.  Each output element is written once by one CTA: no atomics,
// no reduction across CTAs, so two calls give the same bits.  That costs two
// more products than an atomic dq (seven against five: S and dP are taken in
// both passes) and keeps the gradients equal under every remat policy.
//
// What bounds it on an H100.  At phi4's training shape (b=1, h=24, kvh=8,
// s=4096, d=128, bf16, causal) the five products of the function are 2.5x
// the forward's: 257.8 GFLOP, 0.261 ms at 989 TFLOP/s, against some 125 MB
// of compulsory traffic (0.037 ms at 3.35 TB/s): the tensor cores bound it.
// The two passes do 3.5x the forward's products.  Two kernel families, each
// built at the forward's instances (DQK, DV) = 32, 64, 80, 96, 128 and 160
// (square) and (192, 128); a call takes the smallest that holds both of its
// head dims, so every width up to 160 is taken, and a qk width up to 192
// beside a v width up to 128.  The true widths (`wqk`, `wv`) are the tensor
// maps' extents and the columns stored:
//
// - bf16: the Hopper passes (`flash_bwd_dkdv_hopper`,
//   `flash_bwd_dq_hopper`).  Two warpgroups of 64 rows each run `wgmma` on
//   operands in 128-byte-swizzled shared memory (64-byte at the instances
//   32, 80, 96 and 160, whose rows are cut into 32-element boxes, as the
//   forward cuts them; TMA's zero fill pads a row past its true width, and
//   the pad columns of dQ, dK and dV are not stored), fed by TMA through a ring of stages with a full
//   and an empty mbarrier each; 4-D tensor maps over the caller's strides, so
//   the models' transposed (b, s, h, d) views go in with no copy.  Thread 0
//   also issues every load: without a warp of its own for the loads, a CTA
//   is eight warps, two on each of the SM's four schedulers, and ptxas gives
//   a thread up to 255 registers.  The forward's layout (a third warpgroup
//   that loads, `setmaxnreg` 24 / 240) read 168 registers a thread in ptxas
//   whatever `setmaxnreg` asked, and at 168 the dk/dv pass spilled and ptxas
//   serialised its `wgmma`s (C7512): 0.65 against 0.45 ms at phi4's dims,
//   1.26 against 0.50 at (192, 128) (H100 at 700 W).
//   * dk/dv pass: a CTA owns one (batch, kv head, tile of 128 keys), 64 keys
//     a warpgroup.  K and V of the tile are loaded once; the g q heads' q
//     tiles (Q, dout, and their rows' lse and delta by a 1-D bulk copy)
//     stream through a ring of up to four stages.  FA-3's arrangement: S^T =
//     K Q^T and dP^T = V dout^T are `wgmma` with both operands in shared
//     memory, so that P^T and dS^T land in registers in the accumulator
//     layout, which is the A fragment of the register-A `wgmma` for dV +=
//     P^T dout and dK += dS^T Q (dout and Q read MN-major).  dK and dV stay
//     in registers until the one store (227 registers a thread at d = 128).
//     q tiles are 64 rows, 32 at (192, 128), where the dK accumulator is 192
//     wide and 64-row S^T and dP^T tiles beside it fill all 255 registers.
//   * dq pass: a CTA owns one (batch, q head, tile of 128 q rows), 64 a
//     warpgroup; Q and dout are loaded once, K and V tiles of 64 keys stream
//     through the ring.  S = Q K^T and dP = dout V^T from shared memory, P
//     from each row's lse in registers, dS rounded to bf16 as the A fragment
//     of dQ += dS K (K read MN-major).
//   P and dS are rounded to bf16 as tensor-core operands, as FA-2 and FA-3
//   do and as the reference rounds dq's dS; sums are f32.  Both passes
//   number their CTAs heavy first under a causal mask (the first key tiles,
//   the last q tiles) and skip tiles wholly above the diagonal.
// - f32: `flash_bwd_dkdv_fma` and
//   `flash_bwd_dq_fma`, full-precision FMAs on the CUDA cores (no TF32: the
//   reference upcasts before its products, and a float32 train step is held
//   to 2e-5); the same two passes with 16 x 16 threads over 64 x 64 tiles in
//   shared memory.  A correctness path, not a fast one.
//
// `flash_attention_bwd_path(dtype, dqk, dv)` says which family takes a call;
// the wrapper's `kernel_bwd_path` is the same table.  No path falls back to
// another: a tensor map that cannot be encoded is an error code.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRowPad = 128;  // the scratch's rows (lse * log2(e), delta) are padded to a multiple of this

struct BwdParams {
    const void* q;
    const void* k;
    const void* v;
    const void* o;
    const void* dout;
    void* dq;
    void* dk;
    void* dv;
    const float* lse;  // (b, h, sq) contiguous, natural log
    float* lse2;       // (b, h, sq_pad): lse * log2(e), +inf past sq
    float* delta;      // (b, h, sq_pad): rowsum(dout * out), 0 past sq
    int b, h, kvh, sq, sk, sq_pad;
    int wqk, wv;  // the true head dims: the tensor maps' extents and the columns stored
    // element strides of (batch, head, seq); the head dim is contiguous
    long long q_sb, q_sh, q_ss;
    long long k_sb, k_sh, k_ss;
    long long v_sb, v_sh, v_ss;
    long long o_sb, o_sh, o_ss;
    long long do_sb, do_sh, do_ss;
    long long dq_sb, dq_sh, dq_ss;
    long long dk_sb, dk_sh, dk_ss;
    long long dv_sb, dv_sh, dv_ss;
    float scale;
    int causal;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// delta = rowsum(dout * out) in f32 and lse * log2(e), one warp a row of the
// padded (b, h, sq_pad) scratch
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta(const BwdParams p, int dv) {
    const long long row_id = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (row_id >= static_cast<long long>(p.b) * p.h * p.sq_pad) return;
    const int row = static_cast<int>(row_id % p.sq_pad);
    const int bh = static_cast<int>(row_id / p.sq_pad);
    const int batch = bh / p.h;
    const int head = bh - batch * p.h;
    float acc = 0.f;
    if (row < p.sq) {
        const T* o = static_cast<const T*>(p.o) + batch * p.o_sb + head * p.o_sh + row * p.o_ss;
        const T* d = static_cast<const T*>(p.dout) + batch * p.do_sb + head * p.do_sh + row * p.do_ss;
        for (int c = lane; c < dv; c += 32) acc = fmaf(to_f32(o[c]), to_f32(d[c]), acc);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) {
        p.delta[row_id] = acc;
        p.lse2[row_id] = row < p.sq ? p.lse[static_cast<long long>(bh) * p.sq + row] * kLog2e : INFINITY;
    }
}

// ---------------------------------------------------------------------------
// f32: full-precision FMAs on the CUDA cores.  256 threads as 16 x 16; tiles of 64 q rows and 64 keys; a
// thread (ty, tx) owns rows ty + 16 i of a tile's left operand and columns
// tx + 16 c of its right one.
// ---------------------------------------------------------------------------

constexpr int kFmaTile = 64;

template <int DQK, int DV>
constexpr int fma_smem_bytes() {
    // two (rows, DQK) tiles, two (rows, DV) tiles, two (64, 65) tiles, two rows of 64 floats
    return (2 * kFmaTile * (DQK + 1) + 2 * kFmaTile * (DV + 1) + 2 * kFmaTile * (kFmaTile + 1) + 2 * kFmaTile) * 4;
}

// 64 rows of `padded` elements from row `row0` of a (b, head, s, width)
// tensor, rows `ld` apart: the first `width` of each row from memory, the
// rest and rows past `limit` zeros
__device__ __forceinline__ void fma_load_rows(float* dst, const float* src, long long stride, int row0, int limit,
                                              int width, int padded, int ld) {
    for (int idx = threadIdx.x; idx < kFmaTile * padded; idx += 256) {
        const int r = idx / padded;
        const int c = idx - r * padded;
        const int grow = row0 + r;
        dst[r * ld + c] = (grow < limit && c < width) ? src[(long long)grow * stride + c] : 0.f;
    }
}

// dK and dV of one (batch, kv head, tile of 64 keys), over the g q heads and
// every live q tile
template <int DQK, int DV>
__global__ void __launch_bounds__(256) flash_bwd_dkdv_fma(const BwdParams p) {
    constexpr int BK = kFmaTile, BQ = kFmaTile;
    constexpr int LDQ = DQK + 1, LDV = DV + 1, LDP = BQ + 1;  // odd strides: conflict-free column walks
    constexpr int R = BK / 16;   // keys a thread
    constexpr int C = BQ / 16;   // q rows a thread (scores)
    constexpr int CK = DQK / 16;  // dK columns a thread
    constexpr int CV = DV / 16;   // dV columns a thread
    static_assert(DQK % 16 == 0 && DV % 16 == 0, "head dims are multiples of 16");

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* sK = reinterpret_cast<float*>(smem_raw);
    float* sQ = sK + BK * LDQ;
    float* sV = sQ + BQ * LDQ;
    float* sO = sV + BK * LDV;  // dout
    float* sP = sO + BQ * LDV;
    float* sS = sP + BK * LDP;  // dS
    float* sL = sS + BK * LDP;  // lse of the tile's rows
    float* sD = sL + BQ;        // delta

    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
    const int bkv = p.b * p.kvh;
    const int k0 = (blockIdx.x / bkv) * BK;  // tile 0 meets every q row under a causal mask: the heaviest first
    const int batch = (blockIdx.x % bkv) / p.kvh;
    const int kvhead = (blockIdx.x % bkv) - batch * p.kvh;
    const int g = p.h / p.kvh;

    fma_load_rows(sK, static_cast<const float*>(p.k) + batch * p.k_sb + kvhead * p.k_sh, p.k_ss, k0, p.sk, p.wqk, DQK, LDQ);
    fma_load_rows(sV, static_cast<const float*>(p.v) + batch * p.v_sb + kvhead * p.v_sh, p.v_ss, k0, p.sk, p.wv, DV, LDV);

    float dk[R][CK], dv[R][CV];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int c = 0; c < CK; ++c) dk[i][c] = 0.f;
#pragma unroll
        for (int c = 0; c < CV; ++c) dv[i][c] = 0.f;
    }

    const int n_qt = (p.sq + BQ - 1) / BQ;
    const int first = p.causal ? k0 / BQ : 0;  // q tiles before it lie wholly above the diagonal
    for (int hq = 0; hq < g; ++hq) {
        const int head = kvhead * g + hq;
        const long long bh = static_cast<long long>(batch) * p.h + head;
        for (int qt = first; qt < n_qt; ++qt) {
            const int q0 = qt * BQ;
            __syncthreads();  // the tile before is done with sQ, sO, sP, sS
            fma_load_rows(sQ, static_cast<const float*>(p.q) + batch * p.q_sb + head * p.q_sh, p.q_ss, q0, p.sq, p.wqk, DQK, LDQ);
            fma_load_rows(sO, static_cast<const float*>(p.dout) + batch * p.do_sb + head * p.do_sh, p.do_ss, q0, p.sq, p.wv, DV, LDV);
            for (int r = threadIdx.x; r < BQ; r += 256) {
                sL[r] = (q0 + r < p.sq) ? p.lse[bh * p.sq + q0 + r] : INFINITY;
                sD[r] = p.delta[bh * p.sq_pad + q0 + r];
            }
            __syncthreads();

            // S^T and dP^T: keys ty + 16 i, q rows tx + 16 c
            float s[R][C], dp[R][C];
#pragma unroll
            for (int i = 0; i < R; ++i) {
#pragma unroll
                for (int c = 0; c < C; ++c) s[i][c] = dp[i][c] = 0.f;
            }
#pragma unroll 4
            for (int d = 0; d < DQK; ++d) {
                float kv[R], qv[C];
#pragma unroll
                for (int i = 0; i < R; ++i) kv[i] = sK[(ty + 16 * i) * LDQ + d];
#pragma unroll
                for (int c = 0; c < C; ++c) qv[c] = sQ[(tx + 16 * c) * LDQ + d];
#pragma unroll
                for (int i = 0; i < R; ++i) {
#pragma unroll
                    for (int c = 0; c < C; ++c) s[i][c] = fmaf(kv[i], qv[c], s[i][c]);
                }
            }
#pragma unroll 4
            for (int e = 0; e < DV; ++e) {
                float vv[R], ov[C];
#pragma unroll
                for (int i = 0; i < R; ++i) vv[i] = sV[(ty + 16 * i) * LDV + e];
#pragma unroll
                for (int c = 0; c < C; ++c) ov[c] = sO[(tx + 16 * c) * LDV + e];
#pragma unroll
                for (int i = 0; i < R; ++i) {
#pragma unroll
                    for (int c = 0; c < C; ++c) dp[i][c] = fmaf(vv[i], ov[c], dp[i][c]);
                }
            }
#pragma unroll
            for (int i = 0; i < R; ++i) {
                const int key = k0 + ty + 16 * i;
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    const int row = q0 + tx + 16 * c;
                    const bool live = key < p.sk && !(p.causal && key > row);
                    const float pv = live ? expf(fmaf(s[i][c], p.scale, -sL[tx + 16 * c])) : 0.f;
                    sP[(ty + 16 * i) * LDP + tx + 16 * c] = pv;
                    sS[(ty + 16 * i) * LDP + tx + 16 * c] = pv * (dp[i][c] - sD[tx + 16 * c]) * p.scale;
                }
            }
            __syncthreads();

            // dV += P^T dout, dK += dS^T Q: keys ty + 16 i, columns tx + 16 c
#pragma unroll 4
            for (int r = 0; r < BQ; ++r) {
                float pv[R], sv[R];
#pragma unroll
                for (int i = 0; i < R; ++i) {
                    pv[i] = sP[(ty + 16 * i) * LDP + r];
                    sv[i] = sS[(ty + 16 * i) * LDP + r];
                }
#pragma unroll
                for (int c = 0; c < CV; ++c) {
                    const float ov = sO[r * LDV + tx + 16 * c];
#pragma unroll
                    for (int i = 0; i < R; ++i) dv[i][c] = fmaf(pv[i], ov, dv[i][c]);
                }
#pragma unroll
                for (int c = 0; c < CK; ++c) {
                    const float qv = sQ[r * LDQ + tx + 16 * c];
#pragma unroll
                    for (int i = 0; i < R; ++i) dk[i][c] = fmaf(sv[i], qv, dk[i][c]);
                }
            }
        }
    }

    float* gdk = static_cast<float*>(p.dk) + batch * p.dk_sb + kvhead * p.dk_sh;
    float* gdv = static_cast<float*>(p.dv) + batch * p.dv_sb + kvhead * p.dv_sh;
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int key = k0 + ty + 16 * i;
        if (key < p.sk) {
#pragma unroll
            for (int c = 0; c < CK; ++c) {
                if (tx + 16 * c < p.wqk) gdk[(long long)key * p.dk_ss + tx + 16 * c] = dk[i][c];
            }
#pragma unroll
            for (int c = 0; c < CV; ++c) {
                if (tx + 16 * c < p.wv) gdv[(long long)key * p.dv_ss + tx + 16 * c] = dv[i][c];
            }
        }
    }
}

// dQ of one (batch, q head, tile of 64 q rows), over every live key tile
template <int DQK, int DV>
__global__ void __launch_bounds__(256) flash_bwd_dq_fma(const BwdParams p) {
    constexpr int BQ = kFmaTile, BK = kFmaTile;
    constexpr int LDQ = DQK + 1, LDV = DV + 1, LDP = BK + 1;
    constexpr int R = BQ / 16;    // q rows a thread
    constexpr int C = BK / 16;    // keys a thread (scores)
    constexpr int CQ = DQK / 16;  // dQ columns a thread

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* sQ = reinterpret_cast<float*>(smem_raw);
    float* sK = sQ + BQ * LDQ;
    float* sO = sK + BK * LDQ;  // dout
    float* sV = sO + BQ * LDV;
    float* sS = sV + BK * LDV;  // dS
    float* sL = sS + BQ * LDP;
    float* sD = sL + BQ;

    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
    const int bhs = p.b * p.h;
    const int n_qt = (p.sq + BQ - 1) / BQ;
    const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / bhs) * BQ;  // the last q tiles see the most keys: first
    const int batch = (blockIdx.x % bhs) / p.h;
    const int head = (blockIdx.x % bhs) - batch * p.h;
    const int kvhead = head / (p.h / p.kvh);
    const long long bh = static_cast<long long>(batch) * p.h + head;

    fma_load_rows(sQ, static_cast<const float*>(p.q) + batch * p.q_sb + head * p.q_sh, p.q_ss, q0, p.sq, p.wqk, DQK, LDQ);
    fma_load_rows(sO, static_cast<const float*>(p.dout) + batch * p.do_sb + head * p.do_sh, p.do_ss, q0, p.sq, p.wv, DV, LDV);
    for (int r = threadIdx.x; r < BQ; r += 256) {
        sL[r] = (q0 + r < p.sq) ? p.lse[bh * p.sq + q0 + r] : INFINITY;
        sD[r] = p.delta[bh * p.sq_pad + q0 + r];
    }

    float dq[R][CQ];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int c = 0; c < CQ; ++c) dq[i][c] = 0.f;
    }

    int n_kt = (p.sk + BK - 1) / BK;
    if (p.causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);  // none wholly above the diagonal
    const float* gK = static_cast<const float*>(p.k) + batch * p.k_sb + kvhead * p.k_sh;
    const float* gV = static_cast<const float*>(p.v) + batch * p.v_sb + kvhead * p.v_sh;
    for (int j = 0; j < n_kt; ++j) {
        const int k0 = j * BK;
        __syncthreads();  // the tile before is done with sK, sV, sS (and, the first time, Q has landed)
        fma_load_rows(sK, gK, p.k_ss, k0, p.sk, p.wqk, DQK, LDQ);
        fma_load_rows(sV, gV, p.v_ss, k0, p.sk, p.wv, DV, LDV);
        __syncthreads();

        // S and dP: q rows ty + 16 i, keys tx + 16 c
        float s[R][C], dp[R][C];
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
            for (int c = 0; c < C; ++c) s[i][c] = dp[i][c] = 0.f;
        }
#pragma unroll 4
        for (int d = 0; d < DQK; ++d) {
            float qv[R], kv[C];
#pragma unroll
            for (int i = 0; i < R; ++i) qv[i] = sQ[(ty + 16 * i) * LDQ + d];
#pragma unroll
            for (int c = 0; c < C; ++c) kv[c] = sK[(tx + 16 * c) * LDQ + d];
#pragma unroll
            for (int i = 0; i < R; ++i) {
#pragma unroll
                for (int c = 0; c < C; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
            }
        }
#pragma unroll 4
        for (int e = 0; e < DV; ++e) {
            float ov[R], vv[C];
#pragma unroll
            for (int i = 0; i < R; ++i) ov[i] = sO[(ty + 16 * i) * LDV + e];
#pragma unroll
            for (int c = 0; c < C; ++c) vv[c] = sV[(tx + 16 * c) * LDV + e];
#pragma unroll
            for (int i = 0; i < R; ++i) {
#pragma unroll
                for (int c = 0; c < C; ++c) dp[i][c] = fmaf(ov[i], vv[c], dp[i][c]);
            }
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const int row = q0 + ty + 16 * i;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int key = k0 + tx + 16 * c;
                const bool live = key < p.sk && !(p.causal && key > row);
                const float pv = live ? expf(fmaf(s[i][c], p.scale, -sL[ty + 16 * i])) : 0.f;
                sS[(ty + 16 * i) * LDP + tx + 16 * c] = pv * (dp[i][c] - sD[ty + 16 * i]) * p.scale;
            }
        }
        __syncthreads();

        // dQ += dS K: q rows ty + 16 i, columns tx + 16 c
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            float sv[R];
#pragma unroll
            for (int i = 0; i < R; ++i) sv[i] = sS[(ty + 16 * i) * LDP + kk];
#pragma unroll
            for (int c = 0; c < CQ; ++c) {
                const float kv = sK[kk * LDQ + tx + 16 * c];
#pragma unroll
                for (int i = 0; i < R; ++i) dq[i][c] = fmaf(sv[i], kv, dq[i][c]);
            }
        }
    }

    float* gdq = static_cast<float*>(p.dq) + batch * p.dq_sb + head * p.dq_sh;
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row < p.sq) {
#pragma unroll
            for (int c = 0; c < CQ; ++c) {
                if (tx + 16 * c < p.wqk) gdq[(long long)row * p.dq_ss + tx + 16 * c] = dq[i][c];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// bf16: the Hopper passes.
// Most helpers below are copies of flash_attention_fwd.cu's: the two
// sources are built apart, so that the forward's object code does not move
// with this file (its time moves with code that never runs).
// ---------------------------------------------------------------------------

constexpr int kHThreads = 256;      // two warpgroups; thread 0 also issues every TMA load
constexpr int kHRows = 128;         // keys (dk/dv pass) or q rows (dq pass) a CTA: 64 a warpgroup
constexpr int kSmemLimit = 232448;  // shared memory a block may have on an H100
constexpr long long kWaitTrapCycles = 1LL << 34;  // ~8 s at 2 GHz: a lost barrier traps, not hangs

// The shared-memory layout of both passes at (DQK, DV).  Every tile is cut
// into boxes of kBox elements a row, one TMA load each, with the swizzle of
// that span: 64-element boxes with 128-byte swizzle where both head dims are
// multiples of 64, else 32-element boxes with 64-byte swizzle; the row pads
// to 80's 96 (the tensor map's extent stays the true width, and TMA fills
// the rest with zeros).
template <int DQK, int DV>
struct BwdCfg {
    static constexpr int kBox = (DQK % 64 == 0 && DV % 64 == 0) ? 64 : 32;
    static constexpr int kRowBytes = 2 * kBox;
    static constexpr int kDQK = (DQK + kBox - 1) / kBox * kBox;  // padded widths
    static constexpr int kDV = (DV + kBox - 1) / kBox * kBox;
    // dk/dv pass: K and V of 128 keys once, then q tiles of kBQ rows (Q, dout,
    // and their lse and delta) through a ring.  32 rows where dK is wider
    // than 128: the accumulators must fit 240 registers.
    static constexpr int kBQ = kDQK > 128 ? 32 : 64;
    static constexpr int kKVBytes = kHRows * (kDQK + kDV) * 2;
    static constexpr int kQTileBytes = kBQ * kDQK * 2;
    static constexpr int kOTileBytes = kBQ * kDV * 2;
    static constexpr int kKVFit =
        (kSmemLimit - 1024 - kKVBytes - 8 * (1 + 2 * 4)) / (kQTileBytes + kOTileBytes + 2 * kBQ * 4);
    static constexpr int kKVStages = kKVFit >= 4 ? 4 : kKVFit;
    static constexpr int kKVSmem =
        1024 + kKVBytes + kKVStages * (kQTileBytes + kOTileBytes + 2 * kBQ * 4) + 8 * (1 + 2 * kKVStages);
    // dq pass: Q and dout of 128 rows once, then key tiles of kBN keys (K, V)
    // through a ring
    static constexpr int kBN = 64;
    static constexpr int kQOBytes = kHRows * (kDQK + kDV) * 2;
    static constexpr int kKTileBytes = kBN * kDQK * 2;
    static constexpr int kVTileBytes = kBN * kDV * 2;
    static constexpr int kQFit = (kSmemLimit - 1024 - kQOBytes - 8 * (1 + 2 * 4)) / (kKTileBytes + kVTileBytes);
    static constexpr int kQStages = kQFit >= 4 ? 4 : kQFit;
    static constexpr int kQSmem = 1024 + kQOBytes + kQStages * (kKTileBytes + kVTileBytes) + 8 * (1 + 2 * kQStages);
    static_assert(kKVStages >= 2 && kKVSmem <= kSmemLimit, "the dk/dv pass's tiles do not fit shared memory");
    static_assert(kQStages >= 2 && kQSmem <= kSmemLimit, "the dq pass's tiles do not fit shared memory");
    static_assert(kDQK % 16 == 0 && kDV % 16 == 0 && kBox % 16 == 0, "k-steps of 16");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    return done != 0;
}

// Waits for the phase of `bar` with parity `parity` to complete.  A wait
// that outlasts kWaitTrapCycles is a lost barrier: it traps, and the launch
// fails where the caller synchronises, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    if (mbar_try_wait(bar, parity)) return;
    const long long start = clock64();
    while (!mbar_try_wait(bar, parity)) {
        if (clock64() - start > kWaitTrapCycles) __trap();
    }
}

// One TMA box of a 4-D (d, s, head, batch) tensor map into shared memory;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// wgmma shared-memory descriptor of an operand whose rows are ROW_BYTES
// (128 or 64) swizzled as TMA wrote them: start address, leading and stride
// byte offsets (in 16-byte units), and the layout in bits 62-63 (1: 128-byte
// swizzle, 2: 64-byte).  The stride offset is that of eight rows, one
// swizzle pattern: 8 ROW_BYTES.
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t swizzled_desc(uint32_t addr, uint32_t lbo) {
    static_assert(ROW_BYTES == 128 || ROW_BYTES == 64, "no such swizzle");
    constexpr uint64_t layout = ROW_BYTES == 128 ? 1 : 2;
    constexpr uint32_t sbo = 8 * ROW_BYTES;
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
           (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The wgmma writes its accumulators and reads its register operands
// asynchronously: these empty statements pin every use of them after the
// wait (and before the next wgmma), where the compiler cannot move them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
    }
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// The accumulator of an m64nN product, rounded to bf16 in pairs: the
// fragments of two neighbouring 8-column chunks are the A fragment of one
// k-step of a product whose k runs over those N columns.
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (&f)[KS][4], const float (&s)[KS * 8]) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
        f[ks][0] = pack_bf16(s[8 * ks], s[8 * ks + 1]);
        f[ks][1] = pack_bf16(s[8 * ks + 2], s[8 * ks + 3]);
        f[ks][2] = pack_bf16(s[8 * ks + 4], s[8 * ks + 5]);
        f[ks][3] = pack_bf16(s[8 * ks + 6], s[8 * ks + 7]);
    }
}

// d (64 x 32, f32) (+)= A (64 x 16, shared, K-major) * B (32 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, f32) (+)= A (64 x 16, shared, K-major) * B (64 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 32, f32) += A (64 x 16, registers) * B (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 96, f32) += A (64 x 16, registers) * B (16 x 96, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 160, f32) += A (64 x 16, registers) * B (16 x 160, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[80], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
        "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 192, f32) += A (64 x 16, registers) * B (16 x 192, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// S (64 x N) = A B^T over `steps` k-steps of 16, both operands K-major in
// swizzled shared memory: A's boxes `a_box` bytes apart, B's `b_box` apart
// (a k-step is 32 bytes of a box row; the leading offset is not read)
template <int ROW, int STEPS, int N>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t a, uint32_t a_box, uint32_t b,
                                         uint32_t b_box) {
    constexpr int PER_BOX = ROW / 32;
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk) {
        const uint32_t off = (kk % PER_BOX) * 32;
        wgmma_ss(acc, swizzled_desc<ROW>(a + (kk / PER_BOX) * a_box + off, 16),
                 swizzled_desc<ROW>(b + (kk / PER_BOX) * b_box + off, 16), kk > 0);
    }
}

// D (64 x W) += A B over KS k-steps of 16 rows of B, A from registers, B
// MN-major in swizzled shared memory: rows of `ROW` bytes, its boxes
// `b_box` bytes apart (the leading offset steps from one box to the next)
template <int ROW, int KS, int N>
__device__ __forceinline__ void issue_rs(float (&acc)[N], const uint32_t (&f)[KS][4], uint32_t b,
                                         uint32_t b_box) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) wgmma_rs(acc, f[ks], swizzled_desc<ROW>(b + ks * 16 * ROW, b_box));
}

// Stores the rows row_a and row_a + 8 of a (64 x 2N) accumulator, `width`
// columns of which (a multiple of 8) are stored, in bf16 to a (seq, width)
// slice with row stride `ss`.
template <int N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long ss, const float (&acc)[N], int row_a,
                                           int limit, int tq, int width) {
    if (row_a < limit) {
        __nv_bfloat16* r = base + (long long)row_a * ss + tq * 2;
#pragma unroll
        for (int c = 0; c < N / 4; ++c) {
            if (c * 8 < width) {
                *reinterpret_cast<__nv_bfloat162*>(r + c * 8) = __floats2bfloat162_rn(acc[4 * c], acc[4 * c + 1]);
            }
        }
    }
    if (row_a + 8 < limit) {
        __nv_bfloat16* r = base + (long long)(row_a + 8) * ss + tq * 2;
#pragma unroll
        for (int c = 0; c < N / 4; ++c) {
            if (c * 8 < width) {
                *reinterpret_cast<__nv_bfloat162*>(r + c * 8) =
                    __floats2bfloat162_rn(acc[4 * c + 2], acc[4 * c + 3]);
            }
        }
    }
}

// dK and dV of one (batch, kv head, tile of 128 keys)
template <int DQK, int DV>
__global__ void __launch_bounds__(kHThreads, 1)
    flash_bwd_dkdv_hopper(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                          const BwdParams p) {
    using Cfg = BwdCfg<DQK, DV>;
    constexpr int STAGES = Cfg::kKVStages;
    constexpr int BK = kHRows;
    constexpr int BQ = Cfg::kBQ;
    constexpr int BOX = Cfg::kBox;
    constexpr int ROW = Cfg::kRowBytes;
    constexpr int QK_BOXES = Cfg::kDQK / BOX;
    constexpr int V_BOXES = Cfg::kDV / BOX;

    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
    const uint32_t sK = smem_u32(smem);
    const uint32_t sV = sK + BK * Cfg::kDQK * 2;
    const uint32_t sQ = sV + BK * Cfg::kDV * 2;       // stage s at sQ + s * kQTileBytes
    const uint32_t sO = sQ + STAGES * Cfg::kQTileBytes;  // dout, stage s at sO + s * kOTileBytes
    const uint32_t stats = sO + STAGES * Cfg::kOTileBytes;  // stage s: BQ lse * log2(e), then BQ delta
    const float* stats_f = reinterpret_cast<const float*>(smem + (stats - sK));
    const uint32_t bars = stats + STAGES * 2 * BQ * 4;
    const uint32_t full_kv = bars;
    auto full = [&](int s) { return bars + 8u * (1 + s); };
    auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };

    const int bkv = p.b * p.kvh;
    const int k0 = (static_cast<int>(blockIdx.x) / bkv) * BK;  // tile 0 meets every q row under a causal mask: the heaviest first
    const int batch = (static_cast<int>(blockIdx.x) % bkv) / p.kvh;
    const int kvhead = (static_cast<int>(blockIdx.x) % bkv) - batch * p.kvh;
    const int g = p.h / p.kvh;
    const int n_qt = (p.sq + BQ - 1) / BQ;
    const int first = p.causal ? k0 / BQ : 0;  // q tiles before it lie wholly above the diagonal
    const int per_head = n_qt - first;
    const int n_uses = g * per_head;  // (q head, q tile) pairs through the ring

    if (threadIdx.x == 0) {
        mbar_init(full_kv, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), 8);  // one arrival from each warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // Thread 0 also issues every TMA load: K and V once, the first STAGES q
    // tiles, then at the top of tile u the tile u - 1 + STAGES into the stage
    // that tile u - 1 freed.  A tile late, so that the other warpgroup has
    // most likely freed it and the wait seldom holds this one back (a thread
    // that loaded every free stage without waiting, at the top of each tile,
    // read 0.93 against 0.79 ms at phi4's dims, H100 at 700 W).
    auto load_tile = [&](int u) {
        const int s = u % STAGES;
        const int head = kvhead * g + u / per_head;
        const int q0 = (first + u % per_head) * BQ;
        // a box's columns past the head dim are zero-filled and counted
        mbar_expect_tx(full(s), Cfg::kQTileBytes + Cfg::kOTileBytes + 2 * BQ * 4);
#pragma unroll
        for (int x = 0; x < QK_BOXES; ++x) {
            tma_load_4d(sQ + s * Cfg::kQTileBytes + x * BQ * ROW, &tm_q, full(s), x * BOX, q0, head, batch);
        }
#pragma unroll
        for (int x = 0; x < V_BOXES; ++x) {
            tma_load_4d(sO + s * Cfg::kOTileBytes + x * BQ * ROW, &tm_do, full(s), x * BOX, q0, head, batch);
        }
        const long long row0 = (static_cast<long long>(batch) * p.h + head) * p.sq_pad + q0;
        bulk_load(stats + s * 2 * BQ * 4, p.lse2 + row0, BQ * 4, full(s));
        bulk_load(stats + s * 2 * BQ * 4 + BQ * 4, p.delta + row0, BQ * 4, full(s));
    };
    if (threadIdx.x == 0) {
        tma_prefetch(&tm_q);
        tma_prefetch(&tm_k);
        tma_prefetch(&tm_v);
        tma_prefetch(&tm_do);
        mbar_expect_tx(full_kv, Cfg::kKVBytes);
#pragma unroll
        for (int x = 0; x < QK_BOXES; ++x) tma_load_4d(sK + x * BK * ROW, &tm_k, full_kv, x * BOX, k0, kvhead, batch);
#pragma unroll
        for (int x = 0; x < V_BOXES; ++x) tma_load_4d(sV + x * BK * ROW, &tm_v, full_kv, x * BOX, k0, kvhead, batch);
        for (int u = 0; u < min(STAGES, n_uses); ++u) load_tile(u);
    }

    {
        const int wg = threadIdx.x / 128;  // keys [k0 + 64 wg, k0 + 64 wg + 64)
        const int t = threadIdx.x & 127;
        const int lane = t & 31;
        const int tq = lane & 3;  // accumulator column pair within each 8
        const int wkey0 = k0 + wg * 64;
        const int key_a = wkey0 + (t >> 5) * 16 + (lane >> 2);  // and key_a + 8
        const uint32_t k_rows = sK + wg * 64 * ROW;
        const uint32_t v_rows = sV + wg * 64 * ROW;
        const float scale_log2 = p.scale * kLog2e;
        // keys past sk, or (causal) keys past a row of the tile: mask
        const bool edge_keys = wkey0 + 63 >= p.sk;

        float dva[Cfg::kDV / 2], dka[Cfg::kDQK / 2];
#pragma unroll
        for (int i = 0; i < Cfg::kDV / 2; ++i) dva[i] = 0.f;
#pragma unroll
        for (int i = 0; i < Cfg::kDQK / 2; ++i) dka[i] = 0.f;

        mbar_wait(full_kv, 0);
        for (int u = 0; u < n_uses; ++u) {
            if (threadIdx.x == 0 && u >= 1 && u - 1 + STAGES < n_uses) {
                mbar_wait(empty((u - 1) % STAGES), ((u - 1) / STAGES) & 1);
                load_tile(u - 1 + STAGES);
            }
            const int s = u % STAGES;
            const int q0 = (first + u % per_head) * BQ;
            mbar_wait(full(s), (u / STAGES) & 1);
            // every key of this warpgroup past sk, or past every row of the tile: P is 0
            if (wkey0 >= p.sk || (p.causal && wkey0 > q0 + BQ - 1)) {
                if (lane == 0) mbar_arrive(empty(s));
                continue;
            }
            const uint32_t q_tile = sQ + s * Cfg::kQTileBytes;
            const uint32_t o_tile = sO + s * Cfg::kOTileBytes;
            const float* lse2 = stats_f + s * 2 * BQ;
            const float* delta = lse2 + BQ;

            float sacc[BQ / 2], dpacc[BQ / 2];
            wgmma_fence();
            issue_ss<ROW, Cfg::kDQK / 16, BQ>(sacc, k_rows, BK * ROW, q_tile, BQ * ROW);  // S^T = K Q^T
            wgmma_commit();
            issue_ss<ROW, Cfg::kDV / 16, BQ>(dpacc, v_rows, BK * ROW, o_tile, BQ * ROW);  // dP^T = V dout^T
            wgmma_commit();
            wgmma_wait<1>();
            fence_regs(sacc);
            const bool masked = edge_keys || (p.causal && wkey0 + 63 > q0);
#pragma unroll
            for (int i = 0; i < BQ / 2; ++i) {
                const int c = (i / 4) * 8 + tq * 2 + (i & 1);  // the q row, from q0
                float pv = ex2(fmaf(sacc[i], scale_log2, -lse2[c]));
                if (masked) {
                    const int key = key_a + ((i & 2) ? 8 : 0);
                    if (key >= p.sk || (p.causal && key > q0 + c)) pv = 0.f;
                }
                sacc[i] = pv;
            }
            wgmma_wait<0>();
            fence_regs(dpacc);
#pragma unroll
            for (int i = 0; i < BQ / 2; ++i) {
                const int c = (i / 4) * 8 + tq * 2 + (i & 1);
                dpacc[i] = sacc[i] * (dpacc[i] - delta[c]) * p.scale;
            }
            uint32_t pf[BQ / 16][4], df[BQ / 16][4];
            pack_a(pf, sacc);
            pack_a(df, dpacc);
            wgmma_fence();
            issue_rs<ROW>(dva, pf, o_tile, BQ * ROW);  // dV += P^T dout
            issue_rs<ROW>(dka, df, q_tile, BQ * ROW);  // dK += dS^T Q
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dva);
            fence_regs(dka);
            fence_regs(pf);
            fence_regs(df);
            if (lane == 0) mbar_arrive(empty(s));
        }

        __nv_bfloat16* gdk = static_cast<__nv_bfloat16*>(p.dk) + batch * p.dk_sb + kvhead * p.dk_sh;
        __nv_bfloat16* gdv = static_cast<__nv_bfloat16*>(p.dv) + batch * p.dv_sb + kvhead * p.dv_sh;
        store_rows(gdk, p.dk_ss, dka, key_a, p.sk, tq, p.wqk);
        store_rows(gdv, p.dv_ss, dva, key_a, p.sk, tq, p.wv);
    }
}

// dQ of one (batch, q head, tile of 128 q rows)
template <int DQK, int DV>
__global__ void __launch_bounds__(kHThreads, 1)
    flash_bwd_dq_hopper(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                        const BwdParams p) {
    using Cfg = BwdCfg<DQK, DV>;
    constexpr int STAGES = Cfg::kQStages;
    constexpr int BM = kHRows;
    constexpr int BN = Cfg::kBN;
    constexpr int BOX = Cfg::kBox;
    constexpr int ROW = Cfg::kRowBytes;
    constexpr int QK_BOXES = Cfg::kDQK / BOX;
    constexpr int V_BOXES = Cfg::kDV / BOX;

    extern __shared__ unsigned char smem_raw[];
    const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t sO = sQ + BM * Cfg::kDQK * 2;          // dout
    const uint32_t sK = sO + BM * Cfg::kDV * 2;           // stage s at sK + s * kKTileBytes
    const uint32_t sV = sK + STAGES * Cfg::kKTileBytes;   // stage s at sV + s * kVTileBytes
    const uint32_t bars = sV + STAGES * Cfg::kVTileBytes;
    const uint32_t full_q = bars;
    auto full = [&](int s) { return bars + 8u * (1 + s); };
    auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };

    const int bhs = p.b * p.h;
    const int n_qt = (p.sq + BM - 1) / BM;
    const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / bhs) * BM;  // the last q tiles see the most keys: first
    const int batch = (static_cast<int>(blockIdx.x) % bhs) / p.h;
    const int head = (static_cast<int>(blockIdx.x) % bhs) - batch * p.h;
    const int kvhead = head / (p.h / p.kvh);
    int n_kt = (p.sk + BN - 1) / BN;
    if (p.causal) n_kt = min(n_kt, (q0 + BM - 1) / BN + 1);  // none wholly above the diagonal

    if (threadIdx.x == 0) {
        mbar_init(full_q, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), 8);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // Thread 0 also issues every TMA load, as in the dk/dv pass: Q and dout
    // once, the first STAGES key tiles, then a tile late into each freed stage.
    auto load_tile = [&](int j) {
        const int s = j % STAGES;
        mbar_expect_tx(full(s), Cfg::kKTileBytes + Cfg::kVTileBytes);
#pragma unroll
        for (int x = 0; x < QK_BOXES; ++x) {
            tma_load_4d(sK + s * Cfg::kKTileBytes + x * BN * ROW, &tm_k, full(s), x * BOX, j * BN, kvhead, batch);
        }
#pragma unroll
        for (int x = 0; x < V_BOXES; ++x) {
            tma_load_4d(sV + s * Cfg::kVTileBytes + x * BN * ROW, &tm_v, full(s), x * BOX, j * BN, kvhead, batch);
        }
    };
    if (threadIdx.x == 0) {
        tma_prefetch(&tm_q);
        tma_prefetch(&tm_k);
        tma_prefetch(&tm_v);
        tma_prefetch(&tm_do);
        mbar_expect_tx(full_q, Cfg::kQOBytes);
#pragma unroll
        for (int x = 0; x < QK_BOXES; ++x) tma_load_4d(sQ + x * BM * ROW, &tm_q, full_q, x * BOX, q0, head, batch);
#pragma unroll
        for (int x = 0; x < V_BOXES; ++x) tma_load_4d(sO + x * BM * ROW, &tm_do, full_q, x * BOX, q0, head, batch);
        for (int j = 0; j < min(STAGES, n_kt); ++j) load_tile(j);
    }

    {
        const int wg = threadIdx.x / 128;  // q rows [q0 + 64 wg, q0 + 64 wg + 64)
        const int t = threadIdx.x & 127;
        const int lane = t & 31;
        const int tq = lane & 3;
        const int wrow0 = q0 + wg * 64;
        const int row_a = wrow0 + (t >> 5) * 16 + (lane >> 2);  // and row_a + 8
        const uint32_t q_rows = sQ + wg * 64 * ROW;
        const uint32_t o_rows = sO + wg * 64 * ROW;
        const float scale_log2 = p.scale * kLog2e;
        // the scratch is padded past sq: +inf and 0 there, so those rows read P = 0
        const long long bh = static_cast<long long>(batch) * p.h + head;
        const float l_a = p.lse2[bh * p.sq_pad + row_a], l_b = p.lse2[bh * p.sq_pad + row_a + 8];
        const float d_a = p.delta[bh * p.sq_pad + row_a], d_b = p.delta[bh * p.sq_pad + row_a + 8];

        float dqa[Cfg::kDQK / 2];
#pragma unroll
        for (int i = 0; i < Cfg::kDQK / 2; ++i) dqa[i] = 0.f;

        mbar_wait(full_q, 0);
        for (int j = 0; j < n_kt; ++j) {
            if (threadIdx.x == 0 && j >= 1 && j - 1 + STAGES < n_kt) {
                mbar_wait(empty((j - 1) % STAGES), ((j - 1) / STAGES) & 1);
                load_tile(j - 1 + STAGES);
            }
            const int s = j % STAGES;
            const int k0 = j * BN;
            mbar_wait(full(s), (j / STAGES) & 1);
            // every row of this warpgroup past sq, or before every key of the tile: P is 0
            if (wrow0 >= p.sq || (p.causal && k0 > wrow0 + 63)) {
                if (lane == 0) mbar_arrive(empty(s));
                continue;
            }
            const uint32_t k_tile = sK + s * Cfg::kKTileBytes;
            const uint32_t v_tile = sV + s * Cfg::kVTileBytes;

            float sacc[BN / 2], dpacc[BN / 2];
            wgmma_fence();
            issue_ss<ROW, Cfg::kDQK / 16, BN>(sacc, q_rows, BM * ROW, k_tile, BN * ROW);  // S = Q K^T
            wgmma_commit();
            issue_ss<ROW, Cfg::kDV / 16, BN>(dpacc, o_rows, BM * ROW, v_tile, BN * ROW);  // dP = dout V^T
            wgmma_commit();
            wgmma_wait<1>();
            fence_regs(sacc);
            const bool masked = k0 + BN > p.sk || (p.causal && k0 + BN - 1 > wrow0);
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) {
                const bool lower = (i & 2) != 0;
                float pv = ex2(fmaf(sacc[i], scale_log2, -(lower ? l_b : l_a)));
                if (masked) {
                    const int key = k0 + (i / 4) * 8 + tq * 2 + (i & 1);
                    const int row = row_a + (lower ? 8 : 0);
                    if (key >= p.sk || (p.causal && key > row)) pv = 0.f;
                }
                sacc[i] = pv;
            }
            wgmma_wait<0>();
            fence_regs(dpacc);
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) dpacc[i] = sacc[i] * (dpacc[i] - ((i & 2) ? d_b : d_a)) * p.scale;
            uint32_t df[BN / 16][4];
            pack_a(df, dpacc);
            wgmma_fence();
            issue_rs<ROW>(dqa, df, k_tile, BN * ROW);  // dQ += dS K
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dqa);
            fence_regs(df);
            if (lane == 0) mbar_arrive(empty(s));
        }

        __nv_bfloat16* gdq = static_cast<__nv_bfloat16*>(p.dq) + batch * p.dq_sb + head * p.dq_sh;
        store_rows(gdq, p.dq_ss, dqa, row_a, p.sq, tq, p.wqk);
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Return codes of the C entry besides cudaError_t, as in the forward's.
constexpr int kErrNotBuilt = -1;
constexpr int kErrNoEncoder = -2;
constexpr int kErrTensorMap = -3;
constexpr int kErrWidth = -4;

// The instances, as the forward's (`instance_of` there): the square widths
// 32, 64, 80, 96, 128 and 160 and (192, 128); a call takes the smallest that
// holds both head dims.  Returns the instance's dqk, 0 for none.
constexpr int kSquares[] = {32, 64, 80, 96, 128, 160};

int instance_of(int dqk, int dv) {
    if (dqk < 1 || dv < 1) return 0;
    const int w = dqk > dv ? dqk : dv;
    for (int sq : kSquares) {
        if (w <= sq) return sq;
    }
    return (dqk <= 192 && dv <= 128) ? 192 : 0;
}

// Path ids, as kernel.py names them: 0 "fma", 1 "wgmma".
int path_of(int dtype, int dqk, int dv) {
    if (instance_of(dqk, dv) == 0 || (dtype != 0 && dtype != 1)) return kErrNotBuilt;
    return dtype;
}

int sq_padded(int sq) { return (sq + kRowPad - 1) / kRowPad * kRowPad; }

cudaError_t set_smem(const void* kernel, int smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int DQK, int DV>
int launch_fma(const BwdParams& p, cudaStream_t stream) {
    constexpr int smem = fma_smem_bytes<DQK, DV>();
    cudaError_t err = set_smem(reinterpret_cast<const void*>(flash_bwd_dkdv_fma<DQK, DV>), smem);
    if (err == cudaSuccess) err = set_smem(reinterpret_cast<const void*>(flash_bwd_dq_fma<DQK, DV>), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_kt = (p.sk + kFmaTile - 1) / kFmaTile;
    flash_bwd_dkdv_fma<DQK, DV><<<n_kt * p.b * p.kvh, 256, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_qt = (p.sq + kFmaTile - 1) / kFmaTile;
    flash_bwd_dq_fma<DQK, DV><<<n_qt * p.b * p.h, 256, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime so that the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
    static EncodeTiled fn = [] {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
                cudaSuccess ||
            found != cudaDriverEntryPointSuccess) {
            return static_cast<EncodeTiled>(nullptr);
        }
        return reinterpret_cast<EncodeTiled>(ptr);
    }();
    return fn;
}

// A 4-D (d, s, head, batch) bf16 map over strided memory, boxes of `box` x
// `rows` with the swizzle of a `box`-element row (64: 128 bytes, 32: 64);
// rows past `s` and columns past `d` read as zeros.  The stride of an axis of
// extent 1 is never followed, so it is replaced by a valid one.
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* base, int d, int s, int heads,
                int batch, long long ss, long long sh, long long sb, int box, int rows) {
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)heads, (cuuint64_t)batch};
    cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
    cuuint64_t packed = (cuuint64_t)d * 2;
    for (int i = 0; i < 3; ++i) {
        if (dims[i + 1] == 1) strides[i] = packed;
        packed = strides[i] * dims[i + 1];
    }
    const cuuint32_t box_dims[4] = {(cuuint32_t)box, (cuuint32_t)rows, 1, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUtensorMapSwizzle swizzle = box == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                  box_dims, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQK, int DV>
int launch_hopper(const BwdParams& p, cudaStream_t stream) {
    using Cfg = BwdCfg<DQK, DV>;
    const EncodeTiled encode = encoder();
    if (encode == nullptr) return kErrNoEncoder;
    constexpr int box = Cfg::kBox;
    // the dk/dv pass: K and V tiles of 128 keys, Q and dout tiles of kBQ rows;
    // the dq pass: Q and dout tiles of 128 rows, K and V tiles of kBN keys
    CUtensorMap kv_q, kv_k, kv_v, kv_do, q_q, q_k, q_v, q_do;
    const bool ok =
        encode_map(encode, &kv_q, p.q, p.wqk, p.sq, p.h, p.b, p.q_ss, p.q_sh, p.q_sb, box, Cfg::kBQ) &&
        encode_map(encode, &kv_k, p.k, p.wqk, p.sk, p.kvh, p.b, p.k_ss, p.k_sh, p.k_sb, box, kHRows) &&
        encode_map(encode, &kv_v, p.v, p.wv, p.sk, p.kvh, p.b, p.v_ss, p.v_sh, p.v_sb, box, kHRows) &&
        encode_map(encode, &kv_do, p.dout, p.wv, p.sq, p.h, p.b, p.do_ss, p.do_sh, p.do_sb, box, Cfg::kBQ) &&
        encode_map(encode, &q_q, p.q, p.wqk, p.sq, p.h, p.b, p.q_ss, p.q_sh, p.q_sb, box, kHRows) &&
        encode_map(encode, &q_k, p.k, p.wqk, p.sk, p.kvh, p.b, p.k_ss, p.k_sh, p.k_sb, box, Cfg::kBN) &&
        encode_map(encode, &q_v, p.v, p.wv, p.sk, p.kvh, p.b, p.v_ss, p.v_sh, p.v_sb, box, Cfg::kBN) &&
        encode_map(encode, &q_do, p.dout, p.wv, p.sq, p.h, p.b, p.do_ss, p.do_sh, p.do_sb, box, kHRows);
    if (!ok) return kErrTensorMap;
    cudaError_t err = set_smem(reinterpret_cast<const void*>(flash_bwd_dkdv_hopper<DQK, DV>), Cfg::kKVSmem);
    if (err == cudaSuccess) err = set_smem(reinterpret_cast<const void*>(flash_bwd_dq_hopper<DQK, DV>), Cfg::kQSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_kt = (p.sk + kHRows - 1) / kHRows;
    flash_bwd_dkdv_hopper<DQK, DV><<<n_kt * p.b * p.kvh, kHThreads, Cfg::kKVSmem, stream>>>(kv_q, kv_k, kv_v, kv_do, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_qt = (p.sq + kHRows - 1) / kHRows;
    flash_bwd_dq_hopper<DQK, DV><<<n_qt * p.b * p.h, kHThreads, Cfg::kQSmem, stream>>>(q_q, q_k, q_v, q_do, p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Which family takes (dtype, qk head dim, v head dim): 0 the FMA passes, 1
// the wgmma passes, -1 none.  kernel.py's `kernel_bwd_path` is the same
// table; a card test holds the two together.
extern "C" int flash_attention_bwd_path(int dtype, int dqk, int dv) { return path_of(dtype, dqk, dv); }

// Returns a cudaError_t as int (0 on success), -1 for head dims or a type
// that this file does not build, -2 when libcuda has no tensor-map
// encoder, -3 when a tensor map cannot be encoded for these pointers and
// strides, -4 for a bf16 head dim that is not a multiple of 8.  `dtype`: 0 = float32, 1 = bfloat16.  q, k and dq, dk rows are
// `dqk` wide, v, out, dout and dv rows `dv` wide.  Strides are in elements,
// (batch, head, seq) of q, k, v, out, dout, dq, dk, dv in that order; the
// head dim must be contiguous, and for bf16 every row must start on a
// 16-byte boundary.  `lse` is (b, h, sq) contiguous; `scratch` holds 2 b h
// sq_pad floats (lse * log2(e) and delta, sq padded to a multiple of 128;
// kernel.py's `scratch_floats`).  Three launches go
// onto `stream`; nothing is allocated and nothing synchronises.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                   const float* lse, void* dq, void* dk, void* dv, float* scratch, int dtype,
                                   int b, int h, int kvh, int sq, int sk, int dqk, int dv_dim,
                                   const long long* strides, float scale, int causal, void* stream) {
    const int path = path_of(dtype, dqk, dv_dim);
    if (path < 0) return kErrNotBuilt;
    if (path == 1 && (dqk % 8 != 0 || dv_dim % 8 != 0)) return kErrWidth;
    BwdParams p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.o = o;
    p.dout = dout;
    p.dq = dq;
    p.dk = dk;
    p.dv = dv;
    p.lse = lse;
    p.b = b;
    p.h = h;
    p.kvh = kvh;
    p.sq = sq;
    p.sk = sk;
    p.sq_pad = sq_padded(sq);
    p.wqk = dqk;
    p.wv = dv_dim;
    p.lse2 = scratch;
    p.delta = scratch + static_cast<long long>(b) * h * p.sq_pad;
    long long* fields[24] = {&p.q_sb,  &p.q_sh,  &p.q_ss,  &p.k_sb,  &p.k_sh,  &p.k_ss,  &p.v_sb,  &p.v_sh,
                             &p.v_ss,  &p.o_sb,  &p.o_sh,  &p.o_ss,  &p.do_sb, &p.do_sh, &p.do_ss, &p.dq_sb,
                             &p.dq_sh, &p.dq_ss, &p.dk_sb, &p.dk_sh, &p.dk_ss, &p.dv_sb, &p.dv_sh, &p.dv_ss};
    for (int i = 0; i < 24; ++i) *fields[i] = strides[i];
    p.scale = scale;
    p.causal = causal;
    cudaStream_t s = static_cast<cudaStream_t>(stream);

    const long long rows = static_cast<long long>(b) * h * p.sq_pad;
    const int blocks = static_cast<int>((rows * 32 + 255) / 256);
    if (dtype == 0) {
        flash_bwd_delta<float><<<blocks, 256, 0, s>>>(p, dv_dim);
    } else {
        flash_bwd_delta<__nv_bfloat16><<<blocks, 256, 0, s>>>(p, dv_dim);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    if (path == 1) {
        switch (instance_of(dqk, dv_dim)) {
            case 32: return launch_hopper<32, 32>(p, s);
            case 64: return launch_hopper<64, 64>(p, s);
            case 80: return launch_hopper<80, 80>(p, s);
            case 96: return launch_hopper<96, 96>(p, s);
            case 128: return launch_hopper<128, 128>(p, s);
            case 160: return launch_hopper<160, 160>(p, s);
            default: return launch_hopper<192, 128>(p, s);
        }
    }
    switch (instance_of(dqk, dv_dim)) {
        case 32: return launch_fma<32, 32>(p, s);
        case 64: return launch_fma<64, 64>(p, s);
        case 80: return launch_fma<80, 80>(p, s);
        case 96: return launch_fma<96, 96>(p, s);
        case 128: return launch_fma<128, 128>(p, s);
        case 160: return launch_fma<160, 160>(p, s);
        default: return launch_fma<192, 128>(p, s);
    }
}
