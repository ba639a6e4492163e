// Mamba-2 SSD chunked scan, forward, for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `ssd_scan_fwd` / `_kernel` of
// src/repro/kernels/ssd_scan/kernel.py (the `pl.pallas_call` at line 111).
// Same function as the reference `ssd_chunked` (src/repro/models/layers/ssm.py)
// with one B/C group: per (batch, head), chunks of Q tokens in order, a
// (p, n) f32 state carried from chunk to chunk:
//   cum = cumsum(dt * A)                              (within the chunk, f32)
//   y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i) C_i state^T
//   state <- exp(cum_Q) state + sum_j x_j (dt_j exp(cum_Q - cum_j)) B_j^T
// It also takes an initial state and writes the final one (f32), which the
// Pallas kernel does neither of: prefill caches the final state.
//
// What changed against the TPU form.  The Pallas grid (batch, head, chunk)
// runs its chunk axis in order on one core and carries the state in VMEM
// scratch ("arbitrary", kernel.py:125).  CUDA blocks run in no order, so one
// thread block owns one (batch, head) for its whole life and the chunk axis
// is a loop inside it; the state never leaves the block (registers and, as
// the operand of the next chunk's product, shared memory).  x, B, C, y are
// read and written through strides in the models' (b, s, h, p) layout: no
// transposing copy.  Any chunk up to 256 that divides s is taken: rows past
// the chunk's end are zero-filled on load (dt = 0 there, so they add
// nothing) and never stored.
//
// What bounds it on an H100.  At the serving shape (b=4, s=4096, h=64, p=64,
// n=128, chunk 256, bf16) x, dt, B, C are read once and y and the final
// state written once: 0.29 GB, 0.086 ms at 3.35 TB/s.  The chunked form's
// products, C B^T per head and only the j <= i half of the scores, come to
// 8.6e10 FLOP, 0.087 ms at 989 TFLOP/s: the two bounds are about equal.
// What limits this kernel in fact is the chain inside a block: 16 chunks in
// order, each a few dependent products with a block-wide barrier between
// them, on 256 blocks for 132 SMs (one block an SM: 209 KB of shared memory).
// The design answers with tensor cores for all four products
// (`mma.sync.m16n8k16`, bf16 operands, f32 accumulation), fragments by
// `ldmatrix` from padded, conflict-free rows, the C fragments of C B^T
// re-packed in registers as the A operand of the next product (the scores
// never touch shared memory), the y tiles of a chunk dealt to warps in pairs
// (w, 15 - w) so the causal work is even, and the state update overlapping
// the y tiles of other warps.  `wgmma`, TMA and a pipelined load of the next
// chunk are left for later.
//
// Where the bf16 path rounds (the reference rounds only y, at its end):
//   - C B^T: the bf16 inputs as given; exact products, f32 sums.  No rounding.
//   - (C B^T) exp(cum_i - cum_j) dt_j, the A operand of the product with x:
//     f32, split into bf16 hi + lo (two products; the split leaves about
//     2^-17 of the value).
//   - the state, the B operand of C state^T: f32, split into hi + lo.
//   - x_j dt_j exp(cum_Q - cum_j), the A operand of the state update: f32,
//     split into hi + lo.
//   - y: rounded to bf16 once, at the end, as the reference does.
//   Everything else (cumsum, exp, decay, the state itself) is f32.
//
// f32 inputs take a separate kernel that multiplies in full f32 on the CUDA
// cores (no TF32), as the reference upcasts before its products and is held
// to 3e-4.  It is a correctness path, not a fast one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 256;

struct Params {
    const void* x;      // (b, s, h, p)
    const float* dt;    // (b, s, h)
    const float* A;     // (h,)
    const void* B;      // (b, s, n)
    const void* C;      // (b, s, n)
    const float* init;  // (b, h, p, n) contiguous, or null for zeros
    void* y;            // (b, s, h, p)
    float* final_state; // (b, h, p, n) contiguous
    int b, s, h, chunk;
    // element strides; the last dim of x, B, C, y is contiguous
    long long x_sb, x_ss, x_sh;
    long long dt_sb, dt_ss, dt_sh;
    long long B_sb, B_ss;
    long long C_sb, C_ss;
    long long y_sb, y_ss, y_sh;
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

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* smem) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r0), "=r"(r1)
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

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
    return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as a bf16 pair `hi` and the pair of what hi leaves, `lo`: hi + lo
// holds a and b to about 2^-17 of their size.  .x (low half) = a.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    hi = bits(h);
    lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// Inclusive cumsum of dt * A over the chunk's `qp` rows (rows past the
// chunk's end hold dt = 0) into cum, and w_j = dt_j exp(cum_last - cum_j).
// One warp; each lane scans a run of neighbouring rows, then the lanes' totals.
__device__ void chunk_cumsum(const float* sDt, float A, float* sCum, float* sW, int qp, int lane) {
    const int per = (qp + 31) / 32;
    const int r0 = lane * per;
    float run = 0.f;
    for (int k = 0; k < per; ++k) {
        const int r = r0 + k;
        if (r < qp) {
            run += sDt[r] * A;
            sCum[r] = run;
        }
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
    }
    const float before = incl - run;
    const float last = __shfl_sync(0xffffffffu, incl, 31);
    for (int k = 0; k < per; ++k) {
        const int r = r0 + k;
        if (r < qp) {
            const float c = sCum[r] + before;
            sCum[r] = c;
            sW[r] = sDt[r] * expf(last - c);
        }
    }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel.  One block per (head, batch), 8 warps.
// ---------------------------------------------------------------------------

template <int P, int N>
struct Bf16Layout {
    static constexpr int LDX = P + 8;  // padded rows: conflict-free ldmatrix
    static constexpr int LDN = N + 8;
    static __host__ __device__ int bytes(int qp) {
        return (qp * (LDX + 2 * LDN) + 2 * P * LDN) * 2 + 3 * qp * 4;
    }
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_bf16(const Params prm) {
    using L = Bf16Layout<P, N>;
    constexpr int LDX = L::LDX;
    constexpr int LDN = L::LDN;
    constexpr int XCH = P / 8;   // 16-byte pieces of a row of x
    constexpr int NCH = N / 8;   // of a row of B or C
    constexpr int KN = N / 16;   // k-steps over the state dim
    constexpr int PT8 = P / 8;   // n8 tiles of a y tile
    // state tiles: m16 over p, n8 over n, dealt to the warps
    constexpr int PT = P / 16;
    constexpr int WPP = kWarps / PT;                 // warps per p tile
    constexpr int NT8 = N / 8;
    constexpr int NPW = (NT8 + WPP - 1) / WPP;       // n8 tiles per warp
    static_assert(PT >= 1 && PT <= kWarps && kWarps % PT == 0, "head dim");

    const int Q = prm.chunk;
    const int qp = (Q + 15) & ~15;
    const int nqt = qp / 16;  // 16-row tiles of the chunk
    const int nc = prm.s / Q;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* sB = sX + qp * LDX;
    __nv_bfloat16* sC = sB + qp * LDN;
    __nv_bfloat16* sShi = sC + qp * LDN;
    __nv_bfloat16* sSlo = sShi + P * LDN;
    float* sDt = reinterpret_cast<float*>(sSlo + P * LDN);
    float* sCum = sDt + qp;
    float* sW = sCum + qp;

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;   // row of the fragment (and g + 8)
    const int t = lane & 3;    // column pair of the fragment
    const int mi = lane >> 3;  // which 8x8 matrix of an ldmatrix.x4 this lane addresses
    const int mr = lane & 7;   // which row of it

    const int head = blockIdx.x;
    const int batch = blockIdx.y;
    const float A = prm.A[head];

    const __nv_bfloat16* gX =
        static_cast<const __nv_bfloat16*>(prm.x) + batch * prm.x_sb + head * prm.x_sh;
    const __nv_bfloat16* gB = static_cast<const __nv_bfloat16*>(prm.B) + batch * prm.B_sb;
    const __nv_bfloat16* gC = static_cast<const __nv_bfloat16*>(prm.C) + batch * prm.C_sb;
    const float* gDt = prm.dt + batch * prm.dt_sb + head * prm.dt_sh;
    __nv_bfloat16* gY = static_cast<__nv_bfloat16*>(prm.y) + batch * prm.y_sb + head * prm.y_sh;
    const long long state0 = ((long long)batch * prm.h + head) * P * N;

    // this warp's state tiles: rows pm*16.., n8 tiles nb..nb+NPW-1
    const int pm = warp / WPP;
    const int nb = (warp % WPP) * NPW;
    float sacc[NPW][4];
#pragma unroll
    for (int i = 0; i < NPW; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int pr = pm * 16 + g + ((e & 2) ? 8 : 0);
            const int nn = (nb + i) * 8 + t * 2 + (e & 1);
            sacc[i][e] = (prm.init != nullptr && nb + i < NT8) ? prm.init[state0 + pr * N + nn] : 0.f;
        }
    }
    auto store_state_operand = [&]() {
#pragma unroll
        for (int i = 0; i < NPW; ++i) {
            if (nb + i >= NT8) continue;
            const int pr = pm * 16 + g;
            const int nn = (nb + i) * 8 + t * 2;
            uint32_t hi, lo;
            split_bf16(sacc[i][0], sacc[i][1], hi, lo);
            *reinterpret_cast<uint32_t*>(sShi + pr * LDN + nn) = hi;
            *reinterpret_cast<uint32_t*>(sSlo + pr * LDN + nn) = lo;
            split_bf16(sacc[i][2], sacc[i][3], hi, lo);
            *reinterpret_cast<uint32_t*>(sShi + (pr + 8) * LDN + nn) = hi;
            *reinterpret_cast<uint32_t*>(sSlo + (pr + 8) * LDN + nn) = lo;
        }
    };
    store_state_operand();

    // Per-lane ldmatrix offsets.  An x4 load brings four 8x8 matrices; lane
    // (mi, mr) gives the address of row mr of matrix mi.
    //   A operand, rows of C (16 rows x 16 k): a0..a3
    const int a_lane = ((mi & 1) * 8 + mr) * LDN + (mi >> 1) * 8;
    //   B operand stored n-major (B rows for C B^T, state rows for C S^T):
    //   b0, b1 of one n8 tile, then of the next
    const int bn_lane = ((mi >> 1) * 8 + mr) * LDN + (mi & 1) * 8;
    //   B operand stored k-major, transposed on load (x for the product
    //   with x, B for the state update): b0, b1 of one n8 tile, then of the next
    const int bx_lane = ((mi & 1) * 8 + mr) * LDX + (mi >> 1) * 8;
    const int bb_lane = ((mi & 1) * 8 + mr) * LDN + (mi >> 1) * 8;
    //   A operand (x w)^T of the state update, from x transposed on load
    const int xt_lane = ((mi >> 1) * 8 + mr) * LDX + (mi & 1) * 8;

    for (int c = 0; c < nc; ++c) {
        const int t0 = c * Q;
        // every warp is done with the previous chunk's rows and state operand
        __syncthreads();
        for (int idx = tid; idx < qp * XCH; idx += kThreads) {
            const int r = idx / XCH;
            const int ch = idx - r * XCH;
            const bool valid = r < Q;
            cp_async_16(sX + r * LDX + ch * 8, gX + (long long)(t0 + (valid ? r : 0)) * prm.x_ss + ch * 8,
                        valid);
        }
        for (int idx = tid; idx < qp * NCH; idx += kThreads) {
            const int r = idx / NCH;
            const int ch = idx - r * NCH;
            const bool valid = r < Q;
            const long long row = t0 + (valid ? r : 0);
            cp_async_16(sB + r * LDN + ch * 8, gB + row * prm.B_ss + ch * 8, valid);
            cp_async_16(sC + r * LDN + ch * 8, gC + row * prm.C_ss + ch * 8, valid);
        }
        cp_async_commit();
        for (int r = tid; r < qp; r += kThreads) {
            sDt[r] = r < Q ? gDt[(long long)(t0 + r) * prm.dt_ss] : 0.f;
        }
        __syncthreads();
        if (warp == 0) chunk_cumsum(sDt, A, sCum, sW, qp, lane);
        cp_async_wait_all();
        __syncthreads();

        // ---- y: 16-row tiles, warp w takes tiles w and 15 - w ---------------
#pragma unroll 1
        for (int k = 0; k < 2; ++k) {
            const int mt = k == 0 ? warp : 2 * kWarps - 1 - warp;
            if (mt >= nqt) continue;
            const int i0 = mt * 16;
            uint32_t cf[KN][4];
#pragma unroll
            for (int kk = 0; kk < KN; ++kk) {
                ldmatrix_x4(cf[kk][0], cf[kk][1], cf[kk][2], cf[kk][3], sC + i0 * LDN + kk * 16 + a_lane);
            }
            float acc[PT8][4];
#pragma unroll
            for (int i = 0; i < PT8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

            // C state^T, the state as hi + lo, then exp(cum_i) per row
#pragma unroll
            for (int np = 0; np < PT8 / 2; ++np) {
#pragma unroll
                for (int kk = 0; kk < KN; ++kk) {
                    uint32_t r0, r1, r2, r3;
                    ldmatrix_x4(r0, r1, r2, r3, sShi + np * 16 * LDN + kk * 16 + bn_lane);
                    mma_bf16(acc[2 * np], cf[kk], r0, r1);
                    mma_bf16(acc[2 * np + 1], cf[kk], r2, r3);
                    ldmatrix_x4(r0, r1, r2, r3, sSlo + np * 16 * LDN + kk * 16 + bn_lane);
                    mma_bf16(acc[2 * np], cf[kk], r0, r1);
                    mma_bf16(acc[2 * np + 1], cf[kk], r2, r3);
                }
            }
            const int row_a = i0 + g;
            const int row_b = row_a + 8;
            const float cum_a = sCum[row_a];
            const float cum_b = sCum[row_b];
            {
                const float ea = expf(cum_a);
                const float eb = expf(cum_b);
#pragma unroll
                for (int i = 0; i < PT8; ++i) {
                    acc[i][0] *= ea;
                    acc[i][1] *= ea;
                    acc[i][2] *= eb;
                    acc[i][3] *= eb;
                }
            }

            // (C B^T) exp(cum_i - cum_j) dt_j, as hi + lo, times x, for j <= i
#pragma unroll 1
            for (int jt = 0; jt <= mt; ++jt) {
                const int j0 = jt * 16;
                float sc[2][4];
#pragma unroll
                for (int e = 0; e < 4; ++e) sc[0][e] = sc[1][e] = 0.f;
#pragma unroll
                for (int kk = 0; kk < KN; ++kk) {
                    uint32_t r0, r1, r2, r3;
                    ldmatrix_x4(r0, r1, r2, r3, sB + j0 * LDN + kk * 16 + bn_lane);
                    mma_bf16(sc[0], cf[kk], r0, r1);
                    mma_bf16(sc[1], cf[kk], r2, r3);
                }
                const bool diag = jt == mt;
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int j = j0 + nt * 8 + t * 2 + (e & 1);
                        const int i = (e & 2) ? row_b : row_a;
                        const float ci = (e & 2) ? cum_b : cum_a;
                        // above the diagonal the factor is 0, never exp of a positive sum
                        sc[nt][e] = (!diag || j <= i) ? sc[nt][e] * (expf(ci - sCum[j]) * sDt[j]) : 0.f;
                    }
                }
                uint32_t mhi[4], mlo[4];
                split_bf16(sc[0][0], sc[0][1], mhi[0], mlo[0]);
                split_bf16(sc[0][2], sc[0][3], mhi[1], mlo[1]);
                split_bf16(sc[1][0], sc[1][1], mhi[2], mlo[2]);
                split_bf16(sc[1][2], sc[1][3], mhi[3], mlo[3]);
#pragma unroll
                for (int dp = 0; dp < PT8 / 2; ++dp) {
                    uint32_t r0, r1, r2, r3;
                    ldmatrix_x4_trans(r0, r1, r2, r3, sX + j0 * LDX + dp * 16 + bx_lane);
                    mma_bf16(acc[2 * dp], mhi, r0, r1);
                    mma_bf16(acc[2 * dp], mlo, r0, r1);
                    mma_bf16(acc[2 * dp + 1], mhi, r2, r3);
                    mma_bf16(acc[2 * dp + 1], mlo, r2, r3);
                }
            }

            // y rounded to bf16 once, here
            if (row_a < Q) {
                __nv_bfloat16* yrow = gY + (long long)(t0 + row_a) * prm.y_ss + t * 2;
#pragma unroll
                for (int i = 0; i < PT8; ++i) {
                    *reinterpret_cast<__nv_bfloat162*>(yrow + i * 8) =
                        __floats2bfloat162_rn(acc[i][0], acc[i][1]);
                }
            }
            if (row_b < Q) {
                __nv_bfloat16* yrow = gY + (long long)(t0 + row_b) * prm.y_ss + t * 2;
#pragma unroll
                for (int i = 0; i < PT8; ++i) {
                    *reinterpret_cast<__nv_bfloat162*>(yrow + i * 8) =
                        __floats2bfloat162_rn(acc[i][2], acc[i][3]);
                }
            }
        }

        // ---- state <- exp(cum_Q) state + (x w)^T B --------------------------
        {
            const float decay = expf(sCum[qp - 1]);
#pragma unroll
            for (int i = 0; i < NPW; ++i) {
#pragma unroll
                for (int e = 0; e < 4; ++e) sacc[i][e] *= decay;
            }
            if (nb < NT8) {
#pragma unroll 1
                for (int js = 0; js < nqt; ++js) {
                    const int j0 = js * 16;
                    uint32_t xr[4];
                    ldmatrix_x4_trans(xr[0], xr[1], xr[2], xr[3], sX + j0 * LDX + pm * 16 + xt_lane);
                    // a0, a1 hold columns j0 + 2t, +1; a2, a3 columns j0 + 8 + 2t, +1
                    const float w0 = sW[j0 + t * 2], w1 = sW[j0 + t * 2 + 1];
                    const float w8 = sW[j0 + 8 + t * 2], w9 = sW[j0 + 9 + t * 2];
                    uint32_t ahi[4], alo[4];
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float2 v = unpack_bf16(xr[e]);
                        const bool high = e >= 2;
                        split_bf16(v.x * (high ? w8 : w0), v.y * (high ? w9 : w1), ahi[e], alo[e]);
                    }
                    if constexpr (NPW % 2 == 0) {
#pragma unroll
                        for (int i = 0; i < NPW; i += 2) {
                            uint32_t r0, r1, r2, r3;
                            ldmatrix_x4_trans(r0, r1, r2, r3, sB + j0 * LDN + (nb + i) * 8 + bb_lane);
                            mma_bf16(sacc[i], ahi, r0, r1);
                            mma_bf16(sacc[i], alo, r0, r1);
                            mma_bf16(sacc[i + 1], ahi, r2, r3);
                            mma_bf16(sacc[i + 1], alo, r2, r3);
                        }
                    } else {
#pragma unroll
                        for (int i = 0; i < NPW; ++i) {
                            if (nb + i >= NT8) continue;
                            uint32_t r0, r1;
                            ldmatrix_x2_trans(r0, r1, sB + j0 * LDN + (nb + i) * 8 + bb_lane);
                            mma_bf16(sacc[i], ahi, r0, r1);
                            mma_bf16(sacc[i], alo, r0, r1);
                        }
                    }
                }
            }
        }
        // every warp is done reading the state operand before it is replaced
        __syncthreads();
        store_state_operand();
    }

#pragma unroll
    for (int i = 0; i < NPW; ++i) {
        if (nb + i >= NT8) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int pr = pm * 16 + g + ((e & 2) ? 8 : 0);
            const int nn = (nb + i) * 8 + t * 2 + (e & 1);
            prm.final_state[state0 + pr * N + nn] = sacc[i][e];
        }
    }
}

// ---------------------------------------------------------------------------
// f32: full-precision FMAs on the CUDA cores.  One block per (head, batch);
// the state in shared memory; x, B, C read from global memory (L1/L2).
// ---------------------------------------------------------------------------

template <int P, int N>
struct F32Layout {
    static constexpr int LDS = N + 1;  // odd stride: lanes over p read distinct banks
    static __host__ __device__ int bytes(int qp) {
        return (P * LDS + 3 * qp + kWarps * (kMaxChunk + N)) * 4;
    }
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_scan_f32(const Params prm) {
    using L = F32Layout<P, N>;
    constexpr int LDS = L::LDS;

    const int Q = prm.chunk;
    const int qp = (Q + 15) & ~15;
    const int nc = prm.s / Q;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* sS = reinterpret_cast<float*>(smem_raw);
    float* sDt = sS + P * LDS;
    float* sCum = sDt + qp;
    float* sW = sCum + qp;
    float* sRow = sW + qp;  // per warp: one row of (C B^T) L dt, then one row of C

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    float* mrow = sRow + warp * (kMaxChunk + N);
    float* crow = mrow + kMaxChunk;

    const int head = blockIdx.x;
    const int batch = blockIdx.y;
    const float A = prm.A[head];
    const float* gX = static_cast<const float*>(prm.x) + batch * prm.x_sb + head * prm.x_sh;
    const float* gB = static_cast<const float*>(prm.B) + batch * prm.B_sb;
    const float* gC = static_cast<const float*>(prm.C) + batch * prm.C_sb;
    const float* gDt = prm.dt + batch * prm.dt_sb + head * prm.dt_sh;
    float* gY = static_cast<float*>(prm.y) + batch * prm.y_sb + head * prm.y_sh;
    const long long state0 = ((long long)batch * prm.h + head) * P * N;

    for (int e = tid; e < P * N; e += kThreads) {
        sS[(e / N) * LDS + e % N] = prm.init != nullptr ? prm.init[state0 + e] : 0.f;
    }

    for (int c = 0; c < nc; ++c) {
        const float* xc = gX + (long long)c * Q * prm.x_ss;
        const float* bc = gB + (long long)c * Q * prm.B_ss;
        const float* cc = gC + (long long)c * Q * prm.C_ss;
        __syncthreads();
        for (int r = tid; r < qp; r += kThreads) {
            sDt[r] = r < Q ? gDt[(long long)(c * Q + r) * prm.dt_ss] : 0.f;
        }
        __syncthreads();
        if (warp == 0) chunk_cumsum(sDt, A, sCum, sW, qp, lane);
        __syncthreads();

        // y, one row a warp at a time
        for (int i = warp; i < Q; i += kWarps) {
            for (int k = lane; k < N; k += 32) crow[k] = cc[(long long)i * prm.C_ss + k];
            __syncwarp();
            const float ci = sCum[i];
            for (int j = lane; j <= i; j += 32) {
                const float* brow = bc + (long long)j * prm.B_ss;
                float dot = 0.f;
                for (int k = 0; k < N; ++k) dot = fmaf(crow[k], brow[k], dot);
                mrow[j] = dot * (expf(ci - sCum[j]) * sDt[j]);
            }
            __syncwarp();
            const float ei = expf(ci);
            for (int pp = lane; pp < P; pp += 32) {
                float off = 0.f;
                for (int k = 0; k < N; ++k) off = fmaf(crow[k], sS[pp * LDS + k], off);
                float acc = off * ei;
                for (int j = 0; j <= i; ++j) acc = fmaf(mrow[j], xc[(long long)j * prm.x_ss + pp], acc);
                gY[(long long)(c * Q + i) * prm.y_ss + pp] = acc;
            }
            __syncwarp();
        }
        // every warp is done reading the state
        __syncthreads();
        const float decay = expf(sCum[qp - 1]);
        for (int e = tid; e < P * N; e += kThreads) {
            const int pp = e / N;
            const int k = e - pp * N;
            float acc = sS[pp * LDS + k] * decay;
            for (int j = 0; j < Q; ++j) {
                acc = fmaf(xc[(long long)j * prm.x_ss + pp] * sW[j], bc[(long long)j * prm.B_ss + k], acc);
            }
            sS[pp * LDS + k] = acc;
        }
    }
    __syncthreads();
    for (int e = tid; e < P * N; e += kThreads) {
        prm.final_state[state0 + e] = sS[(e / N) * LDS + e % N];
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, int smem_max, const Params& p, cudaStream_t stream) {
    if (smem_max > 48 * 1024) {
        cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
        if (err != cudaSuccess) return err;
    }
    dim3 grid(p.h, p.b);
    kernel<<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int P, int N>
cudaError_t launch_typed(int dtype, const Params& p, cudaStream_t stream) {
    const int qp = (p.chunk + 15) & ~15;
    if (dtype == 1) {
        using L = Bf16Layout<P, N>;
        return launch(ssd_scan_bf16<P, N>, L::bytes(qp), L::bytes(kMaxChunk), p, stream);
    }
    using L = F32Layout<P, N>;
    return launch(ssd_scan_f32<P, N>, L::bytes(qp), L::bytes(kMaxChunk), p, stream);
}

}  // namespace

// Returns a cudaError_t as int (0 on success), or -1 for a shape, chunk or
// type that this file does not build.  `dtype`: 0 = float32, 1 = bfloat16
// (x, B, C and y; dt, A and the states are float32).  Strides are in
// elements: x (batch, seq, head), dt (batch, seq, head), B (batch, seq),
// C (batch, seq), y (batch, seq, head); the last dim of x, B, C, y is
// contiguous, and for bf16 every row of x, B, C starts on a 16-byte boundary.
// `init` may be null (a zero state).  Nothing is allocated and nothing
// synchronises: the launch goes onto `stream`.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A, const void* B,
                            const void* C, const float* init, void* y, float* final_state,
                            int dtype, int b, int s, int h, int p, int n, int chunk,
                            const long long* strides, void* stream) {
    if (chunk < 1 || chunk > kMaxChunk || s % chunk != 0 || (dtype != 0 && dtype != 1)) return -1;
    Params prm;
    prm.x = x;
    prm.dt = dt;
    prm.A = A;
    prm.B = B;
    prm.C = C;
    prm.init = init;
    prm.y = y;
    prm.final_state = final_state;
    prm.b = b;
    prm.s = s;
    prm.h = h;
    prm.chunk = chunk;
    prm.x_sb = strides[0];
    prm.x_ss = strides[1];
    prm.x_sh = strides[2];
    prm.dt_sb = strides[3];
    prm.dt_ss = strides[4];
    prm.dt_sh = strides[5];
    prm.B_sb = strides[6];
    prm.B_ss = strides[7];
    prm.C_sb = strides[8];
    prm.C_ss = strides[9];
    prm.y_sb = strides[10];
    prm.y_ss = strides[11];
    prm.y_sh = strides[12];
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (p == 16 && n == 16) {
        err = launch_typed<16, 16>(dtype, prm, st);
    } else if (p == 32 && n == 16) {
        err = launch_typed<32, 16>(dtype, prm, st);
    } else if (p == 64 && n == 16) {
        err = launch_typed<64, 16>(dtype, prm, st);
    } else if (p == 64 && n == 32) {
        err = launch_typed<64, 32>(dtype, prm, st);
    } else if (p == 64 && n == 128) {
        err = launch_typed<64, 128>(dtype, prm, st);
    } else {
        return -1;
    }
    return static_cast<int>(err);
}
