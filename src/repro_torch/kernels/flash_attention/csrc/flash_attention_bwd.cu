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
// dq, dk and dv come back in the types of q, k and v.  P and dS are rounded
// to bf16 as tensor-core operands, as FA-2 and FA-3 do and as the reference
// rounds dq's dS (once, at every instance); sums are f32.  `flash_bwd_delta`
// first writes delta and lse * log2(e) into the caller's scratch, padded to a
// multiple of 128 rows (+inf and 0 past sq, so that a row past sq reads P = 0).
//
// What bounds it on an H100.  At phi4's training shape (b=1, h=24, kvh=8,
// s=4096, d=128, bf16, causal) the five products of the function are 2.5x
// the forward's: 257.8 GFLOP, 0.261 ms at 989 TFLOP/s, against some 125 MB
// of compulsory traffic (0.037 ms at 3.35 TB/s): the tensor cores bound it.
// Three of the products, S^T, dP^T and dQ, take both operands from shared
// memory at 64 x 64 (and dQ 64 x DQK) a warpgroup, which reads 128 bytes a
// clock of shared memory at the tensor cores' rate: what else passes
// through shared memory (the TMA loads, dS^T, dQ's shares) slows them.
//
// Paths, a static table by instance (`path_of`; kernel.py's
// `kernel_bwd_path`).  Both families are built at the forward's instances
// (DQK, DV) = 32, 64, 80, 96, 128 and 160 (square) and (192, 128); a call
// takes the smallest that holds both of its head dims.  The true widths
// (`wqk`, `wv`) are the tensor maps' extents and the columns stored (TMA's
// zero fill pads a row; 80's rows pad to 96, cut into 32-element boxes with
// 64-byte swizzle, as at 32, 96 and 160; 64, 128 and (192, 128) take
// 64-element boxes with 128-byte swizzle).  No path falls back to another:
// a tensor map that cannot be encoded is an error code.
//
// - "wgmma1", bf16 at every instance: the one pass, `flash_bwd_hopper`,
//   then `flash_bwd_dq_convert`.
//   * Work.  An item is one key tile (128 keys) of one (batch, kv head)
//     against the q heads of one group of its g q heads and every q tile (64
//     rows) the mask leaves.  Items are numbered heavy first: key tile 0
//     (which meets every q row under a causal mask) of every (batch, kv
//     head, group), then key tile 1, and so on.  A persistent grid of
//     min(SMs, items) CTAs, one an SM (the shared memory admits no second),
//     takes them in rounds of gridDim.x, every other round in reverse, and
//     each CTA walks its items in increasing number.  The rule that sizes
//     the items (`groups_of`): G, the groups a kv head's g q heads are split
//     into, is the fewest (a divisor of g) for which the heaviest item is no
//     heavier than the whole work spread evenly over 132 SMs.  phi4's
//     training shape takes G = 1 (256 items, two a CTA, 192 q tiles each);
//     a model = 2 rank's 12 / 4 heads take G = 3 (384 items of one head),
//     where G = 1 left 128 items of up to 192 tiles for 132 SMs.  MLA's 16
//     heads (g = 1) take 512 items of one head, 128 q tiles a CTA.
//   * A CTA: a producer warpgroup and two consumer warpgroups
//     (`setmaxnreg`: 24 and 240 registers a thread).  Thread 0 issues the
//     TMA loads: an item's first q tiles, then K and V of its 128 keys once
//     the item before is done with them, then the rest of its q tiles (Q,
//     dout, and their rows' lse and delta by 1-D bulk copies) through a ring
//     of stages (2 at 128, 160 and (192, 128), 3 at 80 and 96, 4 below).
//     Warps 1 and 2 write dQ (below).  Consumer wg holds keys [64 wg, 64 wg
//     + 64) of the tile.  A q tile: S^T = K Q^T and dP^T = V dout^T
//     (`wgmma`, both operands in shared memory, 64 x 64), P^T and dS^T in
//     registers in the accumulator layout, which is the A fragment of dV +=
//     P^T dout and dK += dS^T Q (register A, dout and Q read MN-major); dK
//     and dV stay in registers over the item.  dS^T also goes to shared
//     memory (two buffers of 128 keys x 64 rows, 128-byte swizzled); once
//     both halves are in (a named barrier), the consumer of the tile's
//     parity takes the tile's dQ share, dS (read MN-major) times all 128
//     keys of K, 64 x DQK in f32, and hands it on (below), while the other
//     consumer goes on to the next tile's S^T and dP^T: taking the shares in
//     turns lets one consumer's exps run beside the other's products.  Below
//     128 a consumer also issues the next tile's S^T and dP^T before its
//     share (at 128 those 64 registers do not fit beside dK, dV and the
//     share).
//   * Above 128 (160 and (192, 128)).  dK and dV are 160 registers a thread
//     at both, so the tile keeps that and no more: (1) S^T is taken whole
//     and dP^T in two halves of 32 q rows (an m64n32 product, 16 registers
//     each), the first issued with S^T and each running while the exps of
//     its half of S^T are taken; each half of dS is P (f32) times dP - delta
//     (f32), rounded once, as below 128.  So at most 160 + 32 + 16 are live
//     where S^T and dP^T together (224) left ptxas too few of 240 for the
//     wgmma pipeline (C7512: every wgmma serialised, and 956 bytes of
//     spills).  Rounding dP - delta to bf16 pairs instead, which frees as
//     many registers, put a second rounding into dS and 2.6x the relative
//     error into dq (PERF.md).  (2) The share is taken in slices of 64
//     columns (32 registers; 160's last slice 32 columns), each handed on
//     as it is done, through two buffers of 64 rows x 64 columns (16 KB
//     each, where two shares of the whole width would need 80 or 96 KB).
//     Shared memory, of 232,448 bytes a block: K and V 81,920, two stages
//     of 41,472, dS^T 32,768, the dQ buffers 32,768, barriers and
//     alignment: 231,552 at both (and at 128).  A third dQ buffer in place
//     of the second dS^T buffer spilled more and ran slower (PERF.md).
//   * The hand-over and the order of dQ's adds.  A share is one slice below
//     128 and 3 above; slice m of a CTA's walk (tile n's slice j is n S + j)
//     goes to buffer m % 2, once that buffer's writer has read slice m - 2
//     out of it, so that the consumer writing the next slice waits on the
//     slice before the last and not on the last (a buffer a consumer, as
//     below 128, left each slice waiting on the bulk copy's read of the one
//     before).  Below 128 buffer m % 2 is the consumer's own.  Warp 1 + w
//     writes buffer w's slices.  Each (batch, q head, q tile, slice) has an
//     f32 accumulator in the scratch and a counter, zeroed every call by
//     `flash_bwd_delta`.  A slice's shares come from key tiles 0, 1, ...,
//     in that order: the share of key tile k waits until its counter reads
//     k, is stored (k = 0: the accumulator needs no memset) or added (a bulk
//     reduce-add, `cp.reduce.async.bulk ... .add.f32`, from shared memory),
//     and when the add is complete the counter moves to k + 1.  Every add meets the same
//     partial sum, so two calls give the same bits.  `flash_bwd_dq_convert`
//     then writes dq in q's type.  (The last share could write dq itself,
//     but it waits for every share before it, and at phi4's shape those
//     waits held the consumers for 0.19 ms of a 0.80 ms call, where the
//     convert launch takes 0.044 ms.)  Where G > 1, dK and dV of a key tile
//     are summed over its G items in the order of their groups the same
//     way, by the consumers, through a second accumulator and counter.
//   * It cannot hang.  Every wait on another CTA is on an item with a
//     smaller number: a slice's earlier key tiles, a key tile's earlier
//     groups.  The CTAs are all resident at once (at most one an SM), each
//     walks its items in increasing number, and nothing in a CTA waits on
//     its own later items (a consumer waits only on a buffer's earlier
//     slices, each written out by its writer after earlier key tiles' adds);
//     so the unfinished item with the smallest number never waits, and the
//     call ends.  A wait on a counter or a barrier that outlasts about 8 s
//     traps, and the call fails where the caller synchronises, instead of
//     hanging the card.
//   * Registers (`nvcc -cubin -Xptxas -v`, sm_90a): 168 a thread at every
//     instance (ptxas prints the launch's share, 65,536 / 384, down to a
//     multiple of 8, whatever `setmaxnreg` asks; the consumers' 240 show
//     only as the absence of spills).  Spill stores and loads: 36 bytes at
//     32, 64, 80 and 96, 44 at 128 (the producer's, at 24), 84 and 108-120
//     at 160 and (192, 128), and no C75xx note.  The registers hold only
//     while ptxas can keep the warpgroups' code apart: a version whose dQ
//     writers stopped on a
//     value read from shared memory spilled 4,476 bytes at 128 and 2,188 at
//     96, the consumers held to 168 as well.  A wgmma, or a wait on one, in
//     a branch on data makes ptxas serialise every wgmma of the kernel
//     (C7518, C7520): the loop peels an item's last tile instead.
// - "fma", float32: `flash_bwd_dkdv_fma` and `flash_bwd_dq_fma`,
//   full-precision FMAs on the CUDA cores (no TF32: the reference upcasts
//   before its products, and a float32 train step is held to 2e-5); the
//   same two passes with 16 x 16 threads over 64 x 64 tiles in shared
//   memory.  A correctness path, not a fast one.
//
// 4-D tensor maps (d, s, head, batch) over the caller's strides, so the
// models' transposed (b, s, h, d) views go in with no copy.

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
    // the one pass (`flash_bwd_hopper`); the layout is `layout_of`'s
    unsigned* ctr;       // every counter, zeroed by `flash_bwd_delta`: first dQ's, then dK/dV's
    long long n_ctr;
    unsigned* dkv_ctr;   // (b, kvh, n_kt), where G > 1
    float* dq_acc;       // (b, h, n_qt) blocks of 64 x DQK f32, each in the consumers' fragment order
    float* dkv_acc;      // (b, kvh, n_kt) blocks of 128 x (DQK + DV) f32, where G > 1
    int n_qt, n_kt;      // q tiles of 64 rows, key tiles of 128
    int groups, hpg;     // G groups of hpg q heads a kv head: an item's heads
    int n_items;         // n_kt * b * kvh * G
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
    // the one pass's counters start every call at 0: this launch runs on the
    // stream before it every time, in a captured graph too
    for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x; i < p.n_ctr;
         i += static_cast<long long>(gridDim.x) * 256) {
        p.ctr[i] = 0u;
    }
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
// bf16: the Hopper one pass.
// Most helpers below are copies of flash_attention_fwd.cu's: the two
// sources are built apart, so that the forward's object code does not move
// with this file (its time moves with code that never runs).
// ---------------------------------------------------------------------------

constexpr int kHRows = 128;         // keys a key tile: 64 a consumer warpgroup
constexpr int kSmemLimit = 232448;  // shared memory a block may have on an H100
constexpr long long kWaitTrapCycles = 1LL << 34;  // ~8 s at 2 GHz: a lost barrier traps, not hangs

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

// ---------------------------------------------------------------------------
// bf16, one pass: `flash_bwd_hopper`
// ---------------------------------------------------------------------------

constexpr int kOThreads = 384;     // a producer warpgroup and two consumer warpgroups
constexpr int kOBQ = 64;           // q rows a tile
constexpr int kItemSMs = 132;      // the H100's SMs: the rule that sizes the items counts on them
// registers a thread after setmaxnreg: 168 each at launch (384 threads);
// 128 x 24 + 256 x 240 = 64,512, the CTA's 384 x 168
constexpr int kOProducerRegs = 24;
constexpr int kOConsumerRegs = 240;

// The one pass's shared memory at (DQK, DV).  Every tile is cut into boxes of
// kBox elements a row, one TMA load each, with the swizzle of that span:
// 64-element boxes with 128-byte swizzle where both head dims are multiples
// of 64, else 32-element boxes with 64-byte swizzle; the row pads to 80's 96
// (the tensor map's extent stays the true width, and TMA fills the rest with
// zeros).  K and V of 128 keys, a ring of q tiles (Q, dout, their lse *
// log2(e) and delta), two buffers of dS^T (128 keys x 64 q rows, bf16,
// 128-byte swizzle) and two of dQ slices (64 rows x kDQS columns f32, filled
// in turns; up to 128 one a consumer warpgroup), then the barriers.  A dQ share is taken in kSlices
// slices: one of the whole width up to 128, slices of 64 columns above it,
// where a share of the whole width fits neither the registers beside dK and
// dV nor, twice, the shared memory.
template <int DQK, int DV>
struct OneCfg {
    static constexpr int kBox = (DQK % 64 == 0 && DV % 64 == 0) ? 64 : 32;
    static constexpr int kRowBytes = 2 * kBox;
    static constexpr int kDQK = (DQK + kBox - 1) / kBox * kBox;  // padded widths
    static constexpr int kDV = (DV + kBox - 1) / kBox * kBox;
    static constexpr int kKVBytes = kHRows * (kDQK + kDV) * 2;
    static constexpr int kQTileBytes = kOBQ * kDQK * 2;
    static constexpr int kOTileBytes = kOBQ * kDV * 2;
    static constexpr int kStatBytes = 2 * kOBQ * 4;
    static constexpr int kStageBytes = kQTileBytes + kOTileBytes + kStatBytes;
    static constexpr int kDSBytes = kHRows * kOBQ * 2;
    static constexpr int kDQS = kDQK > 128 ? 64 : kDQK;  // a dQ slice's columns
    static constexpr int kSlices = (kDQK + kDQS - 1) / kDQS;
    static constexpr int kDQBytes = kOBQ * kDQS * 4;
    static constexpr int kBarBytes = 8 * 16;
    static constexpr int kDQBufs = 2;  // one a consumer warpgroup, each with a writer warp
    // the next tile's S^T and dP^T issued before this tile's dQ share: at 128
    // they would keep 64 registers live beside dK, dV and the share (256)
    static constexpr bool kEarly = kDQK < 128;
    // S^T, then dP^T in halves: above 128 dK and dV hold (kDQK + kDV) / 2
    // = 160 registers, and both products' 64 beside them left ptxas too few
    // of 240 for the wgmma pipeline (C7512, 956 bytes of spills)
    static constexpr bool kSerialSdP = kDQK + kDV > 256;
    static constexpr int kFixed = 1024 + kKVBytes + 2 * kDSBytes + kDQBufs * kDQBytes + kBarBytes;
    static constexpr int kFit = (kSmemLimit - kFixed) / kStageBytes;
    static constexpr int kStages = kFit >= 4 ? 4 : kFit;
    static constexpr int kSmem = kFixed + kStages * kStageBytes;
    static_assert(kDQK % 16 == 0 && kDV % 16 == 0 && kDQS % kBox == 0, "k-steps of 16, slices of whole boxes");
    static_assert(kSlices <= 3 && (kSlices == 1 || !kEarly), "one to three slices, the early issue on one");
    static_assert(kStages >= 2 && kSmem <= kSmemLimit, "the one pass's tiles do not fit shared memory");
};

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// the two consumer warpgroups only (the producer's never takes part)
__device__ __forceinline__ void consumers_sync(int id) {
    asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence_async_global() {
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* ptr) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(ptr) : "memory");
    return v;
}

__device__ __forceinline__ void add_release(unsigned* ptr) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(ptr) : "memory");
}

// Waits until the counter reads at least `want`.  As with mbar_wait, a wait
// that outlasts kWaitTrapCycles traps instead of hanging the card.
__device__ __forceinline__ void wait_count(const unsigned* ptr, unsigned want) {
    if (ld_acquire(ptr) >= want) return;
    const long long start = clock64();
    while (ld_acquire(ptr) < want) {
        if (clock64() - start > kWaitTrapCycles) __trap();
        __nanosleep(32);
    }
}

// `bytes` of shared memory stored to, or added (f32) onto, global memory by
// the bulk copy engine, as one bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(src), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void bulk_add_f32(void* dst, uint32_t src, uint32_t bytes) {
    asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(dst),
                 "r"(src), "r"(bytes)
                 : "memory");
}

// d (64 x 32, f32) (+)= A (64 x 16, shared, MN-major) * B (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, f32) (+)= A (64 x 16, shared, MN-major) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 96, f32) (+)= A (64 x 16, shared, MN-major) * B (16 x 96, shared, MN-major)
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[48], uint64_t desc_a, uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "%48, %49, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128, f32) (+)= A (64 x 16, shared, MN-major) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// One work item: the key tile `kt` of (batch, kv head) against the q heads of
// group `gi` (hpg heads) and every live q tile of theirs.
struct OneItem {
    int kt, batch, kvhead, gi, first, per_head, n_uses;
};

// Items are numbered heavy first: key tile 0 (which meets every q row under a
// causal mask) of every (batch, kv head, group), then key tile 1, and so on;
// the groups of one (batch, kv head, key tile) are neighbours.
__device__ __forceinline__ OneItem one_item(const BwdParams& p, int r) {
    OneItem it;
    const int per_kt = p.b * p.kvh * p.groups;
    it.kt = r / per_kt;
    const int rem = r - it.kt * per_kt;
    const int bkv = rem / p.groups;
    it.gi = rem - bkv * p.groups;
    it.batch = bkv / p.kvh;
    it.kvhead = bkv - it.batch * p.kvh;
    it.first = p.causal ? min(2 * it.kt, p.n_qt) : 0;  // q tiles before it lie wholly above the diagonal
    it.per_head = p.n_qt - it.first;
    it.n_uses = p.hpg * it.per_head;
    return it;
}

// The u-th (q head, q tile) of an item: q tiles from the last down, the
// item's heads inner, so that every item of a (batch, head group) reaches a
// q tile at about the same time and the adds to it queue only briefly.
__device__ __forceinline__ void one_walk(const BwdParams& p, const OneItem& it, int u, int& head, int& qt) {
    const int jj = u / p.hpg;
    qt = p.n_qt - 1 - jj;
    head = it.kvhead * (p.h / p.kvh) + it.gi * p.hpg + (u - jj * p.hpg);
}

// The persistent grid's k-th item of this CTA: rounds of gridDim.x items, one
// to a CTA, every other round in reverse, so the CTAs' loads even out.
__device__ __forceinline__ int one_number(int k) {
    return static_cast<int>(k * gridDim.x + ((k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x));
}

template <bool B>
struct Flag {
    static constexpr bool value = B;
};

template <int J>
struct Index {
    static constexpr int value = J;
};

struct OneSmem {
    uint32_t sK, sV, sQ, sO, sDS, sDQ, stats, bars;
    const float* stats_f;
    float* dq_f;
};

// One consumer warpgroup (wg 0 or 1, warp-uniform: keys [64 wg, 64 wg + 64)
// of a key tile).  The two take a tile's dQ share in turns: the warpgroup of
// the share's parity multiplies dS (both halves) by K, a slice of columns at
// a time, and hands each slice on, while the other goes on to the next
// tile's S^T and dP^T, so that the tensor cores have the one's products
// while the other takes its exps.
template <int DQK, int DV>
__device__ __forceinline__ void one_consumer(const OneSmem& L, const BwdParams& p, int wg) {
    using Cfg = OneCfg<DQK, DV>;
    constexpr int STAGES = Cfg::kStages;
    constexpr int NBUF = Cfg::kDQBufs;
    constexpr int BK = kHRows;
    constexpr int BQ = kOBQ;
    constexpr int ROW = Cfg::kRowBytes;
    const int t = threadIdx.x & 127;
    const int ctid = threadIdx.x - 128;  // 0..255 over both consumers
    const int lane = t & 31;
    const int tq = lane & 3;                      // accumulator column pair within each 8
    const int loc = (t >> 5) * 16 + (lane >> 2);  // accumulator row (and loc + 8) within 64
    const uint32_t k_rows = L.sK + wg * 64 * ROW;
    const uint32_t v_rows = L.sV + wg * 64 * ROW;
    const float scale_log2 = p.scale * kLog2e;
    auto full = [&](int s) { return L.bars + 8u * (2 + s); };
    auto empty = [&](int s) { return L.bars + 8u * (2 + STAGES + s); };
    auto dq_full = [&](int i) { return L.bars + 8u * (2 + 2 * STAGES + i); };
    auto dq_empty = [&](int i) { return L.bars + 8u * (2 + 2 * STAGES + NBUF + i); };

    float dva[Cfg::kDV / 2], dka[Cfg::kDQK / 2];
    float sacc[BQ / 2], dpacc[BQ / 2];
    int use = 0;  // q tiles through the ring so far, and dQ shares handed on (one a tile)

    for (int k = 0;; ++k) {
        const int r = one_number(k);
        if (r >= p.n_items) break;
        const OneItem it = one_item(p, r);
        const int wkey0 = it.kt * BK + wg * 64;
        const int key_a = wkey0 + loc;  // and key_a + 8
        const bool edge_keys = wkey0 + 63 >= p.sk;
#pragma unroll
        for (int i = 0; i < Cfg::kDV / 2; ++i) dva[i] = 0.f;
#pragma unroll
        for (int i = 0; i < Cfg::kDQK / 2; ++i) dka[i] = 0.f;
        mbar_wait(L.bars, k & 1);  // K and V of this item

        // S^T = K Q^T and dP^T = V dout^T of the u-th tile, a group each,
        // issued whatever the mask: a warpgroup whose keys the mask takes
        // wholly gets P = 0 below
        auto issue_sdp = [&](int u) {
            const int n = use + u;
            const int s = n % STAGES;
            mbar_wait(full(s), (n / STAGES) & 1);
            wgmma_fence();
            issue_ss<ROW, Cfg::kDQK / 16, BQ>(sacc, k_rows, BK * ROW, L.sQ + s * Cfg::kQTileBytes, BQ * ROW);
            wgmma_commit();
            issue_ss<ROW, Cfg::kDV / 16, BQ>(dpacc, v_rows, BK * ROW, L.sO + s * Cfg::kOTileBytes, BQ * ROW);
            wgmma_commit();
        };

        // One tile.  Below 128 the next tile's S^T and dP^T are issued
        // before this tile's dQ share (EARLY), so the tensor cores have them
        // while the share is taken and handed on; the loop peels the last
        // tile (LAST), which has none, so that no wgmma sits in a branch on
        // data: ptxas then serialises every wgmma of the kernel (C7518,
        // C7520).
        auto tile = [&](int u, auto last_flag) {
            constexpr bool LAST = decltype(last_flag)::value;
            constexpr bool EARLY = Cfg::kEarly && !LAST;
            const int n = use + u;  // this tile's number through the ring, and its dQ share's
            const int s = n % STAGES;
            int head, qt;
            one_walk(p, it, u, head, qt);
            const int q0 = qt * BQ;
            const uint32_t q_tile = L.sQ + s * Cfg::kQTileBytes;
            const uint32_t o_tile = L.sO + s * Cfg::kOTileBytes;
            const uint32_t ds = L.sDS + (n & 1) * Cfg::kDSBytes;
            const float* lse2 = L.stats_f + s * 2 * BQ;
            const float* delta = lse2 + BQ;

            uint32_t pf[BQ / 16][4], df[BQ / 16][4];
            // keys past sk, or (causal) keys past a row of the tile: mask
            const bool masked = edge_keys || (p.causal && wkey0 + 63 > q0);
            auto take_p = [&](auto lo, auto hi) {  // P in sacc[lo, hi)
#pragma unroll
                for (int i = decltype(lo)::value; i < decltype(hi)::value; ++i) {
                    const int c = (i / 4) * 8 + tq * 2 + (i & 1);  // the q row, from q0
                    float pv = ex2(fmaf(sacc[i], scale_log2, -lse2[c]));
                    if (masked) {
                        const int key = key_a + ((i & 2) ? 8 : 0);
                        if (key >= p.sk || (p.causal && key > q0 + c)) pv = 0.f;
                    }
                    sacc[i] = pv;
                }
            };
            if constexpr (Cfg::kSerialSdP) {
                // S^T, then dP^T in two halves of BQ / 2 q rows (16 registers
                // each), each running while the exps of its half of S^T are
                // taken: P meets each half of dP - delta in f32, as below 128
                float dph[BQ / 4];
                mbar_wait(full(s), (n / STAGES) & 1);
                wgmma_fence();
                issue_ss<ROW, Cfg::kDQK / 16, BQ>(sacc, k_rows, BK * ROW, q_tile, BQ * ROW);
                wgmma_commit();
                issue_ss<ROW, Cfg::kDV / 16, BQ / 2>(dph, v_rows, BK * ROW, o_tile, BQ * ROW);
                wgmma_commit();
                wgmma_wait<1>();
                fence_regs(sacc);
                take_p(Index<0>{}, Index<BQ / 4>{});
                auto half = [&](auto index) {
                    constexpr int HF = decltype(index)::value;
                    wgmma_wait<0>();
                    fence_regs(dph);
#pragma unroll
                    for (int j = 0; j < BQ / 8; ++j) {
                        const int i = HF * (BQ / 8) + j;  // the pair's number in the tile's accumulator
                        const int c = (i / 2) * 8 + tq * 2;
                        pf[i / 4][i % 4] = pack_bf16(sacc[2 * i], sacc[2 * i + 1]);
                        df[i / 4][i % 4] = pack_bf16(sacc[2 * i] * (dph[2 * j] - delta[c]) * p.scale,
                                                     sacc[2 * i + 1] * (dph[2 * j + 1] - delta[c + 1]) * p.scale);
                    }
                };
                half(Index<0>{});
                wgmma_fence();
                issue_ss<ROW, Cfg::kDV / 16, BQ / 2>(dph, v_rows, BK * ROW, o_tile + (BQ / 2) * ROW, BQ * ROW);
                wgmma_commit();
                take_p(Index<BQ / 4>{}, Index<BQ / 2>{});
                half(Index<1>{});
            } else {
                if constexpr (!Cfg::kEarly) issue_sdp(u);
                wgmma_wait<1>();  // dP^T runs while the exps of S^T are taken
                fence_regs(sacc);
                take_p(Index<0>{}, Index<BQ / 2>{});
                wgmma_wait<0>();
                fence_regs(dpacc);
#pragma unroll
                for (int i = 0; i < BQ / 2; ++i) {
                    const int c = (i / 4) * 8 + tq * 2 + (i & 1);
                    dpacc[i] = sacc[i] * (dpacc[i] - delta[c]) * p.scale;
                }
                pack_a(pf, sacc);
                pack_a(df, dpacc);
            }
            // dS^T into this warpgroup's 64 rows of the buffer, 128-byte
            // swizzled as a wgmma operand: row r's 16-byte chunk c at c ^ (r & 7)
            {
                const uint32_t row_a = ds + (wg * 64 + loc) * 128;
                const uint32_t sw = static_cast<uint32_t>(loc & 7);
#pragma unroll
                for (int ks = 0; ks < BQ / 16; ++ks) {
                    const uint32_t c0 = ((2 * ks) ^ sw) * 16 + tq * 4;
                    const uint32_t c1 = ((2 * ks + 1) ^ sw) * 16 + tq * 4;
                    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(row_a + c0), "r"(df[ks][0]) : "memory");
                    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(row_a + 8 * 128 + c0), "r"(df[ks][1]) : "memory");
                    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(row_a + c1), "r"(df[ks][2]) : "memory");
                    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(row_a + 8 * 128 + c1), "r"(df[ks][3]) : "memory");
                }
            }
            fence_async_shared();
            wgmma_fence();
            issue_rs<ROW>(dva, pf, o_tile, BQ * ROW);  // dV += P^T dout
            issue_rs<ROW>(dka, df, q_tile, BQ * ROW);  // dK += dS^T Q
            wgmma_commit();
            consumers_sync(1);  // both halves of dS^T are in the buffer
            wgmma_wait<0>();
            fence_regs(dva);
            fence_regs(dka);
            fence_regs(pf);
            fence_regs(df);
            if (lane == 0) mbar_arrive(empty(s));  // dV and dK are done with the stage
            if ((n & 1) != wg) {
                if constexpr (EARLY) issue_sdp(u + 1);
            } else {
                // the tile's dQ share, in kSlices slices of kDQS columns: dS
                // (64 x 128 keys, the buffer read MN-major) times K's columns
                // (MN-major, boxes BK * ROW apart), each to the next buffer
                // in turn (slice m of the CTA's walk to buffer m % NBUF) for
                // that buffer's writer to store or add
                auto slice = [&](auto index) {
                    constexpr int J = decltype(index)::value;
                    constexpr int C0 = J * Cfg::kDQS;
                    constexpr int W = Cfg::kDQK - C0 < Cfg::kDQS ? Cfg::kDQK - C0 : Cfg::kDQS;
                    float dqa[W / 2];
                    wgmma_fence();
#pragma unroll
                    for (int ks = 0; ks < BK / 16; ++ks) {
                        wgmma_ss_tt(dqa, swizzled_desc<128>(ds + ks * 16 * 128, BK * 128),
                                    swizzled_desc<ROW>(L.sK + (C0 / Cfg::kBox) * BK * ROW + ks * 16 * ROW, BK * ROW),
                                    ks > 0);
                    }
                    wgmma_commit();
                    if constexpr (EARLY) {
                        issue_sdp(u + 1);
                        wgmma_wait<2>();  // the share is done; the next S^T and dP^T may still run
                    } else {
                        wgmma_wait<0>();
                    }
                    fence_regs(dqa);
                    const int m = n * Cfg::kSlices + J;  // the slice's number in the CTA's walk
                    const int buf = m % NBUF;            // below 128: this warpgroup's, wg
                    if (m >= NBUF) mbar_wait(dq_empty(buf), (m / NBUF - 1) & 1);
                    float4* dst = reinterpret_cast<float4*>(L.dq_f + buf * BQ * Cfg::kDQS);
#pragma unroll
                    for (int f = 0; f < W / 8; ++f) {
                        dst[f * 128 + t] = make_float4(dqa[4 * f], dqa[4 * f + 1], dqa[4 * f + 2], dqa[4 * f + 3]);
                    }
                    fence_async_shared();
                    __syncwarp();
                    if (lane == 0) mbar_arrive(dq_full(buf));
                };
                slice(Index<0>{});
                if constexpr (Cfg::kSlices > 1) slice(Index<1>{});
                if constexpr (Cfg::kSlices > 2) slice(Index<2>{});
            }
            if (LAST && lane == 0) mbar_arrive(L.bars + 8);  // done with K and V
        };
        if constexpr (Cfg::kEarly) issue_sdp(0);
        for (int u = 0; u + 1 < it.n_uses; ++u) tile(u, Flag<false>{});
        tile(it.n_uses - 1, Flag<true>{});
        use += it.n_uses;

        // dK and dV of the item: stored, or, where a kv head's q heads are
        // split over G items, summed over them in the order of their groups
        __nv_bfloat16* gdk = static_cast<__nv_bfloat16*>(p.dk) + it.batch * p.dk_sb + it.kvhead * p.dk_sh;
        __nv_bfloat16* gdv = static_cast<__nv_bfloat16*>(p.dv) + it.batch * p.dv_sb + it.kvhead * p.dv_sh;
        if (p.groups > 1) {
            const long long kv = (static_cast<long long>(it.batch) * p.kvh + it.kvhead) * p.n_kt + it.kt;
            float4* acc = reinterpret_cast<float4*>(p.dkv_acc + kv * BK * (Cfg::kDQK + Cfg::kDV));
            float4* acc_v = acc + BK * Cfg::kDQK / 4;
            if (it.gi > 0) {
                if (lane == 0) wait_count(p.dkv_ctr + kv, static_cast<unsigned>(it.gi));
                __syncwarp();
#pragma unroll
                for (int f = 0; f < Cfg::kDQK / 8; ++f) {
                    const float4 a = __ldcg(acc + f * 256 + ctid);
                    dka[4 * f] += a.x;
                    dka[4 * f + 1] += a.y;
                    dka[4 * f + 2] += a.z;
                    dka[4 * f + 3] += a.w;
                }
#pragma unroll
                for (int f = 0; f < Cfg::kDV / 8; ++f) {
                    const float4 a = __ldcg(acc_v + f * 256 + ctid);
                    dva[4 * f] += a.x;
                    dva[4 * f + 1] += a.y;
                    dva[4 * f + 2] += a.z;
                    dva[4 * f + 3] += a.w;
                }
            }
            if (it.gi < p.groups - 1) {
#pragma unroll
                for (int f = 0; f < Cfg::kDQK / 8; ++f) {
                    __stcg(acc + f * 256 + ctid, make_float4(dka[4 * f], dka[4 * f + 1], dka[4 * f + 2], dka[4 * f + 3]));
                }
#pragma unroll
                for (int f = 0; f < Cfg::kDV / 8; ++f) {
                    __stcg(acc_v + f * 256 + ctid, make_float4(dva[4 * f], dva[4 * f + 1], dva[4 * f + 2], dva[4 * f + 3]));
                }
                __threadfence();
                consumers_sync(2);
                if (ctid == 0) add_release(p.dkv_ctr + kv);
                continue;
            }
        }
        store_rows(gdk, p.dk_ss, dka, key_a, p.sk, tq, p.wqk);
        store_rows(gdv, p.dv_ss, dva, key_a, p.sk, tq, p.wv);
    }
}

// dQ, dK and dV in one pass over key tiles: a persistent grid of at most one
// CTA an SM, each walking its items (`one_number`) in increasing number.
template <int DQK, int DV>
__global__ void __launch_bounds__(kOThreads, 1)
    flash_bwd_hopper(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                     const BwdParams p) {
    using Cfg = OneCfg<DQK, DV>;
    constexpr int STAGES = Cfg::kStages;
    constexpr int NBUF = Cfg::kDQBufs;
    constexpr int BK = kHRows;
    constexpr int BQ = kOBQ;
    constexpr int BOX = Cfg::kBox;
    constexpr int ROW = Cfg::kRowBytes;
    constexpr int QK_BOXES = Cfg::kDQK / BOX;
    constexpr int V_BOXES = Cfg::kDV / BOX;

    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
    OneSmem L;
    L.sK = smem_u32(smem);
    L.sV = L.sK + BK * Cfg::kDQK * 2;
    L.sQ = L.sV + BK * Cfg::kDV * 2;               // stage s at sQ + s * kQTileBytes
    L.sO = L.sQ + STAGES * Cfg::kQTileBytes;       // dout, stage s at sO + s * kOTileBytes
    L.sDS = L.sO + STAGES * Cfg::kOTileBytes;      // two dS^T buffers
    L.sDQ = L.sDS + 2 * Cfg::kDSBytes;             // NBUF dQ shares
    L.stats = L.sDQ + NBUF * Cfg::kDQBytes;        // stage s: BQ lse * log2(e), then BQ delta
    L.bars = L.stats + STAGES * Cfg::kStatBytes;
    L.stats_f = reinterpret_cast<const float*>(smem + (L.stats - L.sK));
    L.dq_f = reinterpret_cast<float*>(smem + (L.sDQ - L.sK));
    // barriers: K/V full and empty, the stages' full and empty, the dQ buffers' full and empty
    const uint32_t full_kv = L.bars, empty_kv = L.bars + 8;
    auto full = [&](int s) { return L.bars + 8u * (2 + s); };
    auto empty = [&](int s) { return L.bars + 8u * (2 + STAGES + s); };
    auto dq_full = [&](int i) { return L.bars + 8u * (2 + 2 * STAGES + i); };
    auto dq_empty = [&](int i) { return L.bars + 8u * (2 + 2 * STAGES + NBUF + i); };

    if (threadIdx.x == 0) {
        mbar_init(full_kv, 1);
        mbar_init(empty_kv, 8);  // one arrival from each consumer warp
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), 8);
        }
        for (int i = 0; i < NBUF; ++i) {
            mbar_init(dq_full(i), 4);  // the warps of the consumer that wrote the slice
            mbar_init(dq_empty(i), 1);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // one role a warpgroup, warp-uniform as setmaxnreg needs it; the branches
    // never meet again
    const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    if (role == 0) {
        setmaxnreg_dec<kOProducerRegs>();
        if (threadIdx.x == 0) {
            // ---- loads: per item its first stages, K and V, the other stages
            tma_prefetch(&tm_q);
            tma_prefetch(&tm_k);
            tma_prefetch(&tm_v);
            tma_prefetch(&tm_do);
            int use = 0;
            for (int k = 0;; ++k) {
                const int r = one_number(k);
                if (r >= p.n_items) break;
                const OneItem it = one_item(p, r);
                auto load_tile = [&](int u) {
                    const int s = (use + u) % STAGES;
                    int head, qt;
                    one_walk(p, it, u, head, qt);
                    const int q0 = qt * BQ;
                    mbar_wait(empty(s), (((use + u) / STAGES) & 1) ^ 1);
                    // a box's columns past the head dim are zero-filled and counted
                    mbar_expect_tx(full(s), Cfg::kStageBytes);
#pragma unroll
                    for (int x = 0; x < QK_BOXES; ++x) {
                        tma_load_4d(L.sQ + s * Cfg::kQTileBytes + x * BQ * ROW, &tm_q, full(s), x * BOX, q0, head,
                                    it.batch);
                    }
#pragma unroll
                    for (int x = 0; x < V_BOXES; ++x) {
                        tma_load_4d(L.sO + s * Cfg::kOTileBytes + x * BQ * ROW, &tm_do, full(s), x * BOX, q0, head,
                                    it.batch);
                    }
                    const long long row0 = (static_cast<long long>(it.batch) * p.h + head) * p.sq_pad + q0;
                    bulk_load(L.stats + s * Cfg::kStatBytes, p.lse2 + row0, BQ * 4, full(s));
                    bulk_load(L.stats + s * Cfg::kStatBytes + BQ * 4, p.delta + row0, BQ * 4, full(s));
                };
                const int early = min(STAGES, it.n_uses);
                for (int u = 0; u < early; ++u) load_tile(u);
                mbar_wait(empty_kv, (k & 1) ^ 1);  // the item before is done with K and V
                mbar_expect_tx(full_kv, Cfg::kKVBytes);
#pragma unroll
                for (int x = 0; x < QK_BOXES; ++x) {
                    tma_load_4d(L.sK + x * BK * ROW, &tm_k, full_kv, x * BOX, it.kt * BK, it.kvhead, it.batch);
                }
#pragma unroll
                for (int x = 0; x < V_BOXES; ++x) {
                    tma_load_4d(L.sV + x * BK * ROW, &tm_v, full_kv, x * BOX, it.kt * BK, it.kvhead, it.batch);
                }
                for (int u = early; u < it.n_uses; ++u) load_tile(u);
                use += it.n_uses;
            }
        } else if ((threadIdx.x & 31) == 0 && threadIdx.x / 32 <= NBUF) {
            // ---- dQ: warp 1 + w writes buffer w's slices (slice m of this
            // CTA's walk where m % NBUF is w; below 128 a slice is a share,
            // and buffer w consumer w's).  A slice is stored (key tile 0's)
            // or added onto its accumulator once its counter reads its key
            // tile; when the add is complete the counter moves on.
            const int w = threadIdx.x / 32 - 1;
            int m = 0;  // dQ slices of this CTA's walk so far
            for (int k = 0;; ++k) {
                const int r = one_number(k);
                if (r >= p.n_items) break;
                const OneItem it = one_item(p, r);
                for (int u = 0; u < it.n_uses; ++u) {
                    int head, qt;
                    one_walk(p, it, u, head, qt);
                    const long long tile = (static_cast<long long>(it.batch) * p.h + head) * p.n_qt + qt;
#pragma unroll
                    for (int j = 0; j < Cfg::kSlices; ++j, ++m) {
                        if (m % NBUF != w) continue;
                        // slice j: the float4s [j kDQS / 8, ...) of the tile's block, which
                        // is in the consumers' fragment order, 8 columns a float4
                        unsigned* ctr = p.ctr + tile * Cfg::kSlices + j;
                        float* acc = p.dq_acc + tile * BQ * Cfg::kDQK + j * BQ * Cfg::kDQS;
                        const uint32_t src = L.sDQ + w * Cfg::kDQBytes;
                        const uint32_t bytes = BQ * min(Cfg::kDQS, Cfg::kDQK - j * Cfg::kDQS) * 4;
                        if (it.kt > 0) wait_count(ctr, static_cast<unsigned>(it.kt));
                        mbar_wait(dq_full(w), (m / NBUF) & 1);
                        if (it.kt > 0) {
                            fence_async_global();
                            bulk_add_f32(acc, src, bytes);
                        } else {
                            bulk_store(acc, src, bytes);
                        }
                        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
                        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
                        mbar_arrive(dq_empty(w));
                        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
                        fence_async_global();
                        add_release(ctr);
                    }
                }
            }
        }
    } else {
        setmaxnreg_inc<kOConsumerRegs>();
        one_consumer<DQK, DV>(L, p, role - 1);
    }
}

// dq of one (batch, q head, tile of 64 rows) in q's type, from the tile's
// accumulator, which is in the consumers' fragment order (thread t's float4
// f: rows (t / 32) 16 + (t % 32) / 4 and 8 below, columns 8 f + 2 (t % 4) and
// the next).  The tile goes through shared memory, so that both the reads
// and the writes (8 columns, 16 bytes, a thread) are whole rows.
template <int DQK, int DV>
__global__ void __launch_bounds__(128) flash_bwd_dq_convert(const BwdParams p) {
    using Cfg = OneCfg<DQK, DV>;
    constexpr int F = Cfg::kDQK / 8;  // float4s a thread, and 8-column chunks a row
    __shared__ float4 frag[F * 128];
    const long long tile = blockIdx.x;
    const int qt = static_cast<int>(tile % p.n_qt);
    const long long bh = tile / p.n_qt;
    const int batch = static_cast<int>(bh / p.h);
    const int head = static_cast<int>(bh - static_cast<long long>(batch) * p.h);
    const float4* acc = reinterpret_cast<const float4*>(p.dq_acc + tile * kOBQ * Cfg::kDQK);
#pragma unroll
    for (int f = 0; f < F; ++f) frag[f * 128 + threadIdx.x] = __ldcs(acc + f * 128 + threadIdx.x);
    __syncthreads();
    __nv_bfloat16* gdq = static_cast<__nv_bfloat16*>(p.dq) + batch * p.dq_sb + head * p.dq_sh;
#pragma unroll
    for (int i = 0; i < F / 2; ++i) {
        const int chunk = i * 128 + threadIdx.x;
        const int r = chunk / F, f = chunk - r * F;  // row r of the tile, columns 8 f ..
        const int row = qt * kOBQ + r;
        if (row >= p.sq || f * 8 >= p.wqk) continue;
        const int owner = (r / 16) * 32 + (r % 8) * 4;  // the thread that held the row, at column pair 0
        const bool lower = (r % 16) >= 8;
        uint32_t packed[4];
#pragma unroll
        for (int pair = 0; pair < 4; ++pair) {
            const float4 v = frag[f * 128 + owner + pair];
            packed[pair] = lower ? pack_bf16(v.z, v.w) : pack_bf16(v.x, v.y);
        }
        *reinterpret_cast<uint4*>(gdq + (long long)row * p.dq_ss + f * 8) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
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

// Path ids, as kernel.py names them: 0 "fma", 1 "wgmma1" (the one pass, at
// every instance).
int path_of(int dtype, int dqk, int dv) {
    const int inst = instance_of(dqk, dv);
    if (inst == 0 || (dtype != 0 && dtype != 1)) return kErrNotBuilt;
    return dtype == 0 ? 0 : 1;
}

int sq_padded(int sq) { return (sq + kRowPad - 1) / kRowPad * kRowPad; }

// The one pass's padded row width at an instance (80's rows pad to 96)
int padded_width(int inst) { return inst == 80 ? 96 : inst; }

// The dQ slices of a share at that width (OneCfg's kSlices): one up to 128,
// slices of 64 columns above
int slices_of(int width) { return width > 128 ? (width + 63) / 64 : 1; }

// G, the groups a kv head's g q heads are split into: the fewest (a divisor
// of g) such that the heaviest item (key tile 0's, which meets every q tile
// of its heads under a causal mask) is no heavier than the work over
// kItemSMs SMs evens out to.  Over 132 SMs phi4's training shape (b=1, 24 / 8
// heads, 4096 tokens) takes G = 1, a model = 2 rank's (12 / 4 heads) G = 3.
int groups_of(int b, int kvh, int g, int n_qt, int n_kt, int causal) {
    long long per_head = 0;  // q tiles met by the key tiles of one head
    for (int kt = 0; kt < n_kt; ++kt) per_head += causal ? n_qt - 2 * kt : n_qt;
    const long long total = per_head * b * kvh * g;
    for (int G = 1; G < g; ++G) {
        if (g % G == 0 && static_cast<long long>(g / G) * n_qt * kItemSMs <= total) return G;
    }
    return g;
}

// The scratch a call takes, in floats, and where each part lies: lse * log2(e)
// and delta ((b, h, sq_pad) each); for the one pass also the counters (dQ's
// (b, h, n_qt, slices), then dK/dV's (b, kvh, n_kt) where G > 1; padded to 4
// floats), dQ's accumulator (b h n_qt blocks of 64 x the padded dqk) and,
// where G > 1, dK/dV's (b kvh n_kt blocks of 128 x twice the padded width).
// kernel.py's `scratch_floats` is the same sum.
struct Layout {
    long long delta, ctr, n_ctr, dkv_ctr, dq_acc, dkv_acc, total;
    int n_qt, n_kt, groups;
};

Layout layout_of(int path, int b, int h, int kvh, int sq, int sk, int dqk, int dv, int causal) {
    Layout L{};
    const long long rows = static_cast<long long>(b) * h * sq_padded(sq);
    L.delta = rows;
    L.total = 2 * rows;
    if (path != 1) return L;
    const int w = padded_width(instance_of(dqk, dv));
    L.n_qt = (sq + kOBQ - 1) / kOBQ;
    L.n_kt = (sk + kHRows - 1) / kHRows;
    L.groups = groups_of(b, kvh, h / kvh, L.n_qt, L.n_kt, causal);
    const long long dq_blocks = static_cast<long long>(b) * h * L.n_qt;
    const long long dq_ctr = dq_blocks * slices_of(w);
    const long long dkv_n = L.groups > 1 ? static_cast<long long>(b) * kvh * L.n_kt : 0;
    L.ctr = L.total;
    L.n_ctr = dq_ctr + dkv_n;
    L.dkv_ctr = L.ctr + dq_ctr;
    L.dq_acc = L.ctr + (L.n_ctr + 3) / 4 * 4;
    L.dkv_acc = L.dq_acc + dq_blocks * kOBQ * w;
    L.total = L.dkv_acc + dkv_n * kHRows * 2 * w;
    return L;
}

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

// The one pass: flash_bwd_hopper over a persistent grid of at most one CTA
// an SM (its shared memory admits no second), K and V tiles of 128 keys, Q
// and dout tiles of 64 rows
template <int DQK, int DV>
int launch_one(const BwdParams& p, cudaStream_t stream) {
    using Cfg = OneCfg<DQK, DV>;
    const EncodeTiled encode = encoder();
    if (encode == nullptr) return kErrNoEncoder;
    constexpr int box = Cfg::kBox;
    CUtensorMap tq, tk, tv, tdo;
    const bool ok =
        encode_map(encode, &tq, p.q, p.wqk, p.sq, p.h, p.b, p.q_ss, p.q_sh, p.q_sb, box, kOBQ) &&
        encode_map(encode, &tk, p.k, p.wqk, p.sk, p.kvh, p.b, p.k_ss, p.k_sh, p.k_sb, box, kHRows) &&
        encode_map(encode, &tv, p.v, p.wv, p.sk, p.kvh, p.b, p.v_ss, p.v_sh, p.v_sb, box, kHRows) &&
        encode_map(encode, &tdo, p.dout, p.wv, p.sq, p.h, p.b, p.do_ss, p.do_sh, p.do_sb, box, kOBQ);
    if (!ok) return kErrTensorMap;
    cudaError_t err = set_smem(reinterpret_cast<const void*>(flash_bwd_hopper<DQK, DV>), Cfg::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, n_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = p.n_items < n_sm ? p.n_items : n_sm;
    flash_bwd_hopper<DQK, DV><<<grid, kOThreads, Cfg::kSmem, stream>>>(tq, tk, tv, tdo, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_convert<DQK, DV><<<p.b * p.h * p.n_qt, 128, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Which path takes (dtype, qk head dim, v head dim): 0 the FMA passes, 1
// the one pass, -1 none.  kernel.py's
// `kernel_bwd_path` is the same table; a card test holds the two together.
extern "C" int flash_attention_bwd_path(int dtype, int dqk, int dv) { return path_of(dtype, dqk, dv); }

// The floats of scratch a call takes (`layout_of`), -1 for what is not
// built; kernel.py's `scratch_floats` is the same sum, and a card test holds
// the two together.
extern "C" long long flash_attention_bwd_scratch_floats(int dtype, int b, int h, int kvh, int sq, int sk, int dqk,
                                                        int dv, int causal) {
    const int path = path_of(dtype, dqk, dv);
    if (path < 0 || b < 1 || kvh < 1 || h % kvh != 0) return -1;
    return layout_of(path, b, h, kvh, sq, sk, dqk, dv, causal).total;
}

// Returns a cudaError_t as int (0 on success), -1 for head dims or a type
// that this file does not build, -2 when libcuda has no tensor-map
// encoder, -3 when a tensor map cannot be encoded for these pointers and
// strides, -4 for a bf16 head dim that is not a multiple of 8.  `dtype`: 0 = float32, 1 = bfloat16.  q, k and dq, dk rows are
// `dqk` wide, v, out, dout and dv rows `dv` wide.  Strides are in elements,
// (batch, head, seq) of q, k, v, out, dout, dq, dk, dv in that order; the
// head dim must be contiguous, and for bf16 every row must start on a
// 16-byte boundary.  `lse` is (b, h, sq) contiguous; `scratch` holds
// `flash_attention_bwd_scratch_floats` floats (kernel.py's
// `scratch_floats`), 16-byte aligned.  Three launches go onto `stream`
// (delta, then the one pass and dq's convert, or the two FMA passes);
// nothing is allocated and nothing synchronises.
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
    const Layout lay = layout_of(path, b, h, kvh, sq, sk, dqk, dv_dim, causal);
    p.lse2 = scratch;
    p.delta = scratch + lay.delta;
    p.ctr = reinterpret_cast<unsigned*>(scratch + lay.ctr);
    p.n_ctr = lay.n_ctr;
    p.dkv_ctr = reinterpret_cast<unsigned*>(scratch + lay.dkv_ctr);
    p.dq_acc = scratch + lay.dq_acc;
    p.dkv_acc = scratch + lay.dkv_acc;
    p.n_qt = lay.n_qt;
    p.n_kt = lay.n_kt;
    p.groups = lay.groups;
    p.hpg = lay.groups > 0 ? h / kvh / lay.groups : 0;
    p.n_items = lay.n_kt * b * kvh * lay.groups;
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
            case 32: return launch_one<32, 32>(p, s);
            case 64: return launch_one<64, 64>(p, s);
            case 80: return launch_one<80, 80>(p, s);
            case 96: return launch_one<96, 96>(p, s);
            case 128: return launch_one<128, 128>(p, s);
            case 160: return launch_one<160, 160>(p, s);
            default: return launch_one<192, 128>(p, s);
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
