// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `flash_attention_fwd` / `_kernel` of
// src/repro/kernels/flash_attention/kernel.py (the `pl.pallas_call` there).
// Same function: softmax(q k^T / sqrt(d) [causal]) v by online softmax over
// KV tiles with an f32 running max `m`, denominator `l` and accumulator,
// GQA by index (kv head = h / (h / kvh)), final divide by max(l, 1e-30).
// It also writes lse = m + log(max(l, 1e-30)), which the Pallas kernel does
// not, because the backward pass of a later slice recomputes from it.
//
// What changed against the TPU form.  The Pallas grid runs its innermost KV
// axis in order on one core and carries m / l / acc in VMEM scratch from one
// grid step to the next.  Blocks of a CUDA grid run in no order, so here one
// thread block owns one (batch, q head, q tile) for its whole life and the
// KV axis is a loop inside it; m, l and the accumulator never leave
// registers.  The ragged edge (any sq, sk) is masked in the kernel: rows
// past the end are zero-filled on load and never stored, keys past the end
// get -inf and a guard keeps exp(-inf - -inf) out of the sums.
//
// What bounds it on an H100.  At the serving shape (b=4, h=24, kvh=8,
// s=4096, d=128, bf16, causal) the work is 2*b*h*s^2*d = 4.1e11 FLOP against
// 0.27 GB of compulsory traffic: 1500 FLOP per byte, far above the card's
// 295, so the bound is operations: 0.42 ms at 989 TFLOP/s.  The design
// answers with tensor cores for both products (`mma.sync.m16n8k16` bf16 with
// f32 accumulation; the C fragment of q k^T is re-packed in registers as the
// A fragment of p v, so p never touches shared memory), `ldmatrix` fragment
// loads from padded, conflict-free rows, two m-tiles a warp so that each K/V
// fragment read from shared memory feeds two products (with one, shared
// memory bandwidth was the limit), `cp.async` double buffering so the next
// K/V tile streams in during the current tile's products, two blocks an SM
// so one block's softmax overlaps the other's products, and heavy (late)
// causal q tiles launched first.  `wgmma`, TMA and warp specialisation,
// which the card's full rate needs, are left for later.
//
// f32 inputs take a separate kernel that multiplies in full f32 on the CUDA
// cores (no TF32), because the reference upcasts before its dot products and
// is held to 2e-5.  It is a correctness path, not a fast one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegCausal = -1e30f;  // the reference's causal mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    float* lse;  // (b, h, sq) contiguous
    int b, h, kvh, sq, sk;
    // element strides of (batch, head, seq); the head dim is contiguous
    long long q_sb, q_sh, q_ss;
    long long k_sb, k_sh, k_ss;
    long long v_sb, v_sh, v_ss;
    long long o_sb, o_sh, o_ss;
    float scale;
    int causal;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; `valid == false` reads nothing
// and fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
    const int bytes = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
                 "l"(gmem), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                            const void* smem) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
                 : "r"(smem_u32(smem))
                 : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, const void* smem) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
                 : "r"(smem_u32(smem))
                 : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel.  A block is 4 warps and 128 q rows; one warp owns
// 32 q rows, two m-tiles of the mma.  Every K and V fragment a warp loads
// from shared memory feeds two products: a warp reads the whole K and V tile
// whatever its row count, so with one m-tile per warp shared-memory bandwidth
// bounds the kernel.  255 registers a thread, two blocks on an SM.
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;    // warps per block
constexpr int kMTiles = 2;   // 16-row m-tiles per warp
constexpr int kBlockM = kWarps * kMTiles * 16;  // q rows per block
constexpr int kBlockN = 64;  // keys per KV tile

template <int D>
constexpr int bf16_smem_bytes() {
    return (kBlockM + 4 * kBlockN) * (D + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd_bf16(const Params p) {
    constexpr int NWARPS = kWarps;
    constexpr int MT = kMTiles;
    constexpr int WM = MT * 16;  // q rows per warp
    constexpr int BM = kBlockM;
    constexpr int BN = kBlockN;
    constexpr int LDS = D + 8;     // padded row: conflict-free fragment loads
    constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
    constexpr int NTHREADS = NWARPS * 32;
    constexpr int KSTEPS = D / 16;   // k-steps of q k^T
    constexpr int SNT = BN / 8;      // n-tiles of the score tile
    constexpr int ONT = D / 8;       // n-tiles of the output tile
    constexpr int PSTEPS = BN / 16;  // k-steps of p v

    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* sK = sQ + BM * LDS;      // two stages
    __nv_bfloat16* sV = sK + 2 * BN * LDS;  // two stages

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;   // row of the fragment (and g + 8)
    const int t = lane & 3;    // column pair of the fragment
    const int mi = lane >> 3;  // which 8x8 matrix of an ldmatrix.x4 this lane addresses
    const int mr = lane & 7;   // which row of it

    // late q tiles see the most keys under a causal mask: start them first
    const int qtile = gridDim.x - 1 - blockIdx.x;
    const int head = blockIdx.y;
    const int batch = blockIdx.z;
    const int kvhead = head / (p.h / p.kvh);
    const int q0 = qtile * BM;
    const int wrow0 = q0 + warp * WM;  // this warp's first q row

    const __nv_bfloat16* gQ =
        static_cast<const __nv_bfloat16*>(p.q) + batch * p.q_sb + head * p.q_sh;
    const __nv_bfloat16* gK =
        static_cast<const __nv_bfloat16*>(p.k) + batch * p.k_sb + kvhead * p.k_sh;
    const __nv_bfloat16* gV =
        static_cast<const __nv_bfloat16*>(p.v) + batch * p.v_sb + kvhead * p.v_sh;
    __nv_bfloat16* gO = static_cast<__nv_bfloat16*>(p.o) + batch * p.o_sb + head * p.o_sh;

    auto load_rows = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, long long stride,
                         int row0, int nrows, int limit) {
        for (int c = tid; c < nrows * CHUNKS; c += NTHREADS) {
            const int r = c / CHUNKS;
            const int ch = c - r * CHUNKS;
            const int grow = row0 + r;
            const bool valid = grow < limit;
            const __nv_bfloat16* s = src + (long long)(valid ? grow : 0) * stride + ch * 8;
            cp_async_16(dst + r * LDS + ch * 8, s, valid);
        }
    };

    // KV tiles this q tile needs: under the causal mask none above the diagonal
    int n_tiles = (p.sk + BN - 1) / BN;
    if (p.causal) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);

    load_rows(sQ, gQ, p.q_ss, q0, BM, p.sq);
    load_rows(sK, gK, p.k_ss, 0, BN, p.sk);
    load_rows(sV, gV, p.v_ss, 0, BN, p.sk);
    cp_async_commit();

    // Per-lane ldmatrix addresses.  An x4 load brings four 8x8 matrices; lane
    // (mi, mr) gives the address of row mr of matrix mi.
    //   q (A operand, 16 rows x 16 k): matrices (rows 0-7, k 0-7), (rows 8-15,
    //     k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15) = a0..a3
    //   k (B operand of q k^T, two n-tiles x 16 k): (keys 0-7, k 0-7), (keys
    //     0-7, k 8-15), (keys 8-15, k 0-7), (keys 8-15, k 8-15) = b0, b1 of
    //     the first n-tile, then of the second
    //   v (B operand of p v, transposed on load, 16 keys x two n-tiles):
    //     (keys 0-7, d 0-7), (keys 8-15, d 0-7), (keys 0-7, d 8-15), (keys
    //     8-15, d 8-15) = b0, b1 of the first n-tile, then of the second
    const int q_lane = (warp * WM + (mi & 1) * 8 + mr) * LDS + (mi >> 1) * 8;
    const int k_lane = ((mi >> 1) * 8 + mr) * LDS + (mi & 1) * 8;
    const int v_lane = ((mi & 1) * 8 + mr) * LDS + (mi >> 1) * 8;

    float oacc[MT][ONT][4];
    float m_a[MT], m_b[MT];  // running max of rows g and g + 8, in units of log2
    float l_a[MT], l_b[MT];  // per-thread partial denominators; reduced at the end
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        m_a[mt] = m_b[mt] = -INFINITY;
        l_a[mt] = l_b[mt] = 0.f;
#pragma unroll
        for (int i = 0; i < ONT; ++i) {
            oacc[mt][i][0] = oacc[mt][i][1] = oacc[mt][i][2] = oacc[mt][i][3] = 0.f;
        }
    }
    const float scale_log2 = p.scale * kLog2e;

    for (int j = 0; j < n_tiles; ++j) {
        const int stage = j & 1;
        // tile j (and, the first time, q) has landed, and every warp is done
        // with tile j - 1
        cp_async_wait_all();
        __syncthreads();
        if (j + 1 < n_tiles) {
            load_rows(sK + (stage ^ 1) * BN * LDS, gK, p.k_ss, (j + 1) * BN, BN, p.sk);
            load_rows(sV + (stage ^ 1) * BN * LDS, gV, p.v_ss, (j + 1) * BN, BN, p.sk);
            cp_async_commit();
        }
        const int k0 = j * BN;
        // every key of this tile lies above the diagonal for this warp's rows
        if (p.causal && k0 > wrow0 + WM - 1) continue;

        const __nv_bfloat16* kbase = sK + stage * BN * LDS + k_lane;
        const __nv_bfloat16* vbase = sV + stage * BN * LDS + v_lane;

        // ---- s = q k^T ------------------------------------------------------
        float sacc[MT][SNT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int nt = 0; nt < SNT; ++nt) {
                sacc[mt][nt][0] = sacc[mt][nt][1] = sacc[mt][nt][2] = sacc[mt][nt][3] = 0.f;
            }
        }
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
            uint32_t qf[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                ldmatrix_x4(qf[mt][0], qf[mt][1], qf[mt][2], qf[mt][3],
                            sQ + q_lane + mt * 16 * LDS + kk * 16);
            }
#pragma unroll
            for (int np = 0; np < SNT / 2; ++np) {
                uint32_t r0, r1, r2, r3;
                ldmatrix_x4(r0, r1, r2, r3, kbase + np * 16 * LDS + kk * 16);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    mma_bf16(sacc[mt][2 * np], qf[mt], r0, r1);
                    mma_bf16(sacc[mt][2 * np + 1], qf[mt], r2, r3);
                }
            }
        }

        // ---- scale, mask, online softmax --------------------------------------
        const bool edge = (k0 + BN > p.sk) || (p.causal && k0 + BN - 1 > wrow0);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            const int row_a = wrow0 + mt * 16 + g;
            const int row_b = row_a + 8;
#pragma unroll
            for (int nt = 0; nt < SNT; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float s = sacc[mt][nt][e] * scale_log2;
                    if (edge) {
                        const int col = k0 + nt * 8 + t * 2 + (e & 1);
                        const int row = (e & 2) ? row_b : row_a;
                        if (col >= p.sk) {
                            s = -INFINITY;  // never enters the max or the sum
                        } else if (p.causal && col > row) {
                            s = kNegCausal;
                        }
                    }
                    sacc[mt][nt][e] = s;
                }
            }

            float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
            for (int nt = 0; nt < SNT; ++nt) {
                mx_a = fmaxf(mx_a, fmaxf(sacc[mt][nt][0], sacc[mt][nt][1]));
                mx_b = fmaxf(mx_b, fmaxf(sacc[mt][nt][2], sacc[mt][nt][3]));
            }
            mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
            mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
            mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
            mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
            const float mnew_a = fmaxf(m_a[mt], mx_a);
            const float mnew_b = fmaxf(m_b[mt], mx_b);
            // a row that has seen no key yet keeps m = -inf; subtract 0 instead
            // so that exp2(-inf - -inf) never appears
            const float muse_a = (mnew_a == -INFINITY) ? 0.f : mnew_a;
            const float muse_b = (mnew_b == -INFINITY) ? 0.f : mnew_b;
            const float alpha_a = exp2f(m_a[mt] - muse_a);
            const float alpha_b = exp2f(m_b[mt] - muse_b);
            m_a[mt] = mnew_a;
            m_b[mt] = mnew_b;

            float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
            for (int nt = 0; nt < SNT; ++nt) {
                sacc[mt][nt][0] = exp2f(sacc[mt][nt][0] - muse_a);
                sacc[mt][nt][1] = exp2f(sacc[mt][nt][1] - muse_a);
                sacc[mt][nt][2] = exp2f(sacc[mt][nt][2] - muse_b);
                sacc[mt][nt][3] = exp2f(sacc[mt][nt][3] - muse_b);
                sum_a += sacc[mt][nt][0] + sacc[mt][nt][1];
                sum_b += sacc[mt][nt][2] + sacc[mt][nt][3];
            }
            l_a[mt] = l_a[mt] * alpha_a + sum_a;
            l_b[mt] = l_b[mt] * alpha_b + sum_b;
#pragma unroll
            for (int i = 0; i < ONT; ++i) {
                oacc[mt][i][0] *= alpha_a;
                oacc[mt][i][1] *= alpha_a;
                oacc[mt][i][2] *= alpha_b;
                oacc[mt][i][3] *= alpha_b;
            }
        }

        // ---- o += p v, p rounded to bf16 as the reference does ---------------
        // (the C fragments of two neighbouring score n-tiles are the A fragment
        // of one k-step of p v: p never leaves the registers)
#pragma unroll
        for (int ks = 0; ks < PSTEPS; ++ks) {
            uint32_t pf[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                pf[mt][0] = pack_bf16(sacc[mt][2 * ks][0], sacc[mt][2 * ks][1]);
                pf[mt][1] = pack_bf16(sacc[mt][2 * ks][2], sacc[mt][2 * ks][3]);
                pf[mt][2] = pack_bf16(sacc[mt][2 * ks + 1][0], sacc[mt][2 * ks + 1][1]);
                pf[mt][3] = pack_bf16(sacc[mt][2 * ks + 1][2], sacc[mt][2 * ks + 1][3]);
            }
#pragma unroll
            for (int dp = 0; dp < ONT / 2; ++dp) {
                uint32_t r0, r1, r2, r3;
                ldmatrix_x4_trans(r0, r1, r2, r3, vbase + ks * 16 * LDS + dp * 16);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    mma_bf16(oacc[mt][2 * dp], pf[mt], r0, r1);
                    mma_bf16(oacc[mt][2 * dp + 1], pf[mt], r2, r3);
                }
            }
        }
    }

    // ---- epilogue -----------------------------------------------------------
    float* lse = p.lse + ((long long)batch * p.h + head) * p.sq;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        float la = l_a[mt], lb = l_b[mt];
        la += __shfl_xor_sync(0xffffffffu, la, 1);
        la += __shfl_xor_sync(0xffffffffu, la, 2);
        lb += __shfl_xor_sync(0xffffffffu, lb, 1);
        lb += __shfl_xor_sync(0xffffffffu, lb, 2);
        const float den_a = fmaxf(la, 1e-30f);
        const float den_b = fmaxf(lb, 1e-30f);
        const float inv_a = 1.f / den_a;
        const float inv_b = 1.f / den_b;
        const int row_a = wrow0 + mt * 16 + g;
        const int row_b = row_a + 8;
        if (row_a < p.sq) {
            __nv_bfloat16* orow = gO + (long long)row_a * p.o_ss + t * 2;
#pragma unroll
            for (int i = 0; i < ONT; ++i) {
                *reinterpret_cast<__nv_bfloat162*>(orow + i * 8) =
                    __floats2bfloat162_rn(oacc[mt][i][0] * inv_a, oacc[mt][i][1] * inv_a);
            }
            if (t == 0) lse[row_a] = m_a[mt] * kLn2 + logf(den_a);
        }
        if (row_b < p.sq) {
            __nv_bfloat16* orow = gO + (long long)row_b * p.o_ss + t * 2;
#pragma unroll
            for (int i = 0; i < ONT; ++i) {
                *reinterpret_cast<__nv_bfloat162*>(orow + i * 8) =
                    __floats2bfloat162_rn(oacc[mt][i][2] * inv_b, oacc[mt][i][3] * inv_b);
            }
            if (t == 0) lse[row_b] = m_b[mt] * kLn2 + logf(den_b);
        }
    }
}

// ---------------------------------------------------------------------------
// f32: full-precision FMAs on the CUDA cores.  256 threads as 16 x 16; thread
// (ty, tx) owns q rows ty + 16 i, keys tx + 16 j and output columns tx + 16 c.
// ---------------------------------------------------------------------------

constexpr int kF32Block = 64;  // q rows per block and keys per tile

template <int D>
constexpr int f32_smem_bytes() {
    return (3 * kF32Block * (D + 1) + kF32Block * (kF32Block + 1)) * 4;
}

template <int D>
__global__ void __launch_bounds__(256) flash_fwd_f32(const Params p) {
    constexpr int BM = kF32Block;
    constexpr int BN = kF32Block;
    constexpr int LDQ = D + 1;   // odd stride: conflict-free column walks
    constexpr int LDP = BN + 1;
    constexpr int DC = D / 16;   // output columns per thread
    constexpr int R = BM / 16;   // q rows per thread
    constexpr int C = BN / 16;   // keys per thread

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* sQ = reinterpret_cast<float*>(smem_raw);
    float* sK = sQ + BM * LDQ;
    float* sV = sK + BN * LDQ;
    float* sP = sV + BN * LDQ;

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;

    const int qtile = gridDim.x - 1 - blockIdx.x;
    const int head = blockIdx.y;
    const int batch = blockIdx.z;
    const int kvhead = head / (p.h / p.kvh);
    const int q0 = qtile * BM;

    const float* gQ = static_cast<const float*>(p.q) + batch * p.q_sb + head * p.q_sh;
    const float* gK = static_cast<const float*>(p.k) + batch * p.k_sb + kvhead * p.k_sh;
    const float* gV = static_cast<const float*>(p.v) + batch * p.v_sb + kvhead * p.v_sh;
    float* gO = static_cast<float*>(p.o) + batch * p.o_sb + head * p.o_sh;

    auto load_rows = [&](float* dst, const float* src, long long stride, int row0, int limit) {
        for (int idx = tid; idx < BM * D; idx += 256) {
            const int r = idx / D;
            const int c = idx - r * D;
            const int grow = row0 + r;
            dst[r * LDQ + c] = (grow < limit) ? src[(long long)grow * stride + c] : 0.f;
        }
    };

    int n_tiles = (p.sk + BN - 1) / BN;
    if (p.causal) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);

    load_rows(sQ, gQ, p.q_ss, q0, p.sq);

    float oacc[R][DC];
    float m[R], l[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < DC; ++c) oacc[i][c] = 0.f;
    }

    for (int j = 0; j < n_tiles; ++j) {
        const int k0 = j * BN;
        __syncthreads();  // the previous tile's products are done with sK, sV, sP
        load_rows(sK, gK, p.k_ss, k0, p.sk);
        load_rows(sV, gV, p.v_ss, k0, p.sk);
        __syncthreads();

        float s[R][C];
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
            for (int c = 0; c < C; ++c) s[i][c] = 0.f;
        }
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
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

        float alpha[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const int row = q0 + ty + 16 * i;
            float mx = -INFINITY;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int col = k0 + tx + 16 * c;
                float v = s[i][c] * p.scale;
                if (col >= p.sk) {
                    v = -INFINITY;  // never enters the max or the sum
                } else if (p.causal && col > row) {
                    v = kNegCausal;
                }
                s[i][c] = v;
                mx = fmaxf(mx, v);
            }
            // the 16 threads of one row are 16 neighbouring lanes
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
            const float mnew = fmaxf(m[i], mx);
            const float muse = (mnew == -INFINITY) ? 0.f : mnew;
            alpha[i] = expf(m[i] - muse);
            m[i] = mnew;
            float sum = 0.f;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const float pv = expf(s[i][c] - muse);
                sum += pv;
                sP[(ty + 16 * i) * LDP + tx + 16 * c] = pv;
            }
            l[i] = l[i] * alpha[i] + sum;  // partial over this thread's keys
#pragma unroll
            for (int c = 0; c < DC; ++c) oacc[i][c] *= alpha[i];
        }
        __syncthreads();

#pragma unroll 4
        for (int kk = 0; kk < BN; ++kk) {
            float pv[R], vv[DC];
#pragma unroll
            for (int i = 0; i < R; ++i) pv[i] = sP[(ty + 16 * i) * LDP + kk];
#pragma unroll
            for (int c = 0; c < DC; ++c) vv[c] = sV[kk * LDQ + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < R; ++i) {
#pragma unroll
                for (int c = 0; c < DC; ++c) oacc[i][c] = fmaf(pv[i], vv[c], oacc[i][c]);
            }
        }
    }

    float* lse = p.lse + ((long long)batch * p.h + head) * p.sq;
#pragma unroll
    for (int i = 0; i < R; ++i) {
        float li = l[i];
        li += __shfl_xor_sync(0xffffffffu, li, 1);
        li += __shfl_xor_sync(0xffffffffu, li, 2);
        li += __shfl_xor_sync(0xffffffffu, li, 4);
        li += __shfl_xor_sync(0xffffffffu, li, 8);
        const float den = fmaxf(li, 1e-30f);
        const int row = q0 + ty + 16 * i;
        if (row < p.sq) {
#pragma unroll
            for (int c = 0; c < DC; ++c) {
                gO[(long long)row * p.o_ss + tx + 16 * c] = oacc[i][c] / den;
            }
            if (tx == 0) lse[row] = m[i] + logf(den);
        }
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, int threads, int block_m, const Params& p,
                   cudaStream_t stream) {
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
    }
    dim3 grid((p.sq + block_m - 1) / block_m, p.h, p.b);
    kernel<<<grid, threads, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
    return launch(flash_fwd_bf16<D>, bf16_smem_bytes<D>(), kWarps * 32, kBlockM, p, stream);
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
    return launch(flash_fwd_f32<D>, f32_smem_bytes<D>(), 256, kF32Block, p, stream);
}

}  // namespace

// Returns a cudaError_t as int (0 on success), or -1 for a head dim or type
// that this file does not build.  `dtype`: 0 = float32, 1 = bfloat16.
// Strides are in elements; the head dim must be contiguous, and for bf16
// every row must start on a 16-byte boundary.  Nothing is allocated and
// nothing synchronises: the launch goes onto `stream`.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int dtype, int b, int h, int kvh, int sq,
                                   int sk, int d, const long long* strides, float scale,
                                   int causal, void* stream) {
    Params p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.o = o;
    p.lse = lse;
    p.b = b;
    p.h = h;
    p.kvh = kvh;
    p.sq = sq;
    p.sk = sk;
    p.q_sb = strides[0];
    p.q_sh = strides[1];
    p.q_ss = strides[2];
    p.k_sb = strides[3];
    p.k_sh = strides[4];
    p.k_ss = strides[5];
    p.v_sb = strides[6];
    p.v_sh = strides[7];
    p.v_ss = strides[8];
    p.o_sb = strides[9];
    p.o_sh = strides[10];
    p.o_ss = strides[11];
    p.scale = scale;
    p.causal = causal;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == 1) {
        switch (d) {
            case 16: err = launch_bf16<16>(p, s); break;
            case 64: err = launch_bf16<64>(p, s); break;
            case 80: err = launch_bf16<80>(p, s); break;
            case 128: err = launch_bf16<128>(p, s); break;
            default: return -1;
        }
    } else if (dtype == 0) {
        switch (d) {
            case 16: err = launch_f32<16>(p, s); break;
            case 64: err = launch_f32<64>(p, s); break;
            case 80: err = launch_f32<80>(p, s); break;
            case 128: err = launch_f32<128>(p, s); break;
            default: return -1;
        }
    } else {
        return -1;
    }
    return static_cast<int>(err);
}
