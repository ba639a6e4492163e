// Mamba-2 SSD chunked scan, forward, for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `ssd_scan_fwd` / `_kernel` of
// src/repro/kernels/ssd_scan/kernel.py (the `pl.pallas_call` at line 111).
// Same function as the reference `ssd_chunked` (src/repro/models/layers/ssm.py)
// with one B/C group: per (batch, head), a (p, n) f32 state carried over the
// sequence, in chunks:
//   cum = cumsum(dt * A)                              (within the chunk, f32)
//   y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i) C_i state^T
//   state <- exp(cum_Q) state + sum_j x_j (dt_j exp(cum_Q - cum_j)) B_j^T
// It also takes an initial state and writes the final one (f32), which the
// Pallas kernel does neither of: prefill caches the final state.
//
// The chunk.  y and the final state do not depend on the chunk length: the
// chunked form is exact for any, and only its rounding moves.  So the bf16
// kernel cuts the sequence into tiles of its own length, kTile = 64 tokens,
// whatever chunk the caller names (the wrapper still holds the caller to a
// chunk that divides s, as the reference does).  At 64 the quadratic part of
// a tile (C B^T and its product with x) is 5 of the 21 tensor-core products
// a token takes, where a chunk of 256 makes it 17 of 33; the rest, C state^T
// and the state update, costs the same per token at any length.  (Tiles of
// 32, measured in clusters of two, were 1.1-1.25x slower than tiles of 64.)
// A ragged last tile is zero-filled on load (dt = 0 there, so it adds
// nothing) and never stored.
//
// The three phases (Dao & Gu, "Transformers are SSMs", 2024, section 6).  Each
// (batch, head) is a thread-block cluster of k CTAs (k from `scan_form` in
// kernel.py); CTA r owns the tiles [r nt / k, (r + 1) nt / k) of the nt tiles.
//   1. Every CTA but the last runs over its tiles from a zero state, doing
//      only the state update, and leaves its segment's own end state S_loc
//      (f32, in its shared memory) and the segment's decay Lambda (the sum of
//      dt * A, f32) to the cluster, then arrives at the cluster barrier.
//   2. The hand-on: CTA r waits at the barrier and reads, through
//      distributed shared memory (`mapa` + `ld.shared::cluster`), the S_loc
//      and Lambda of every CTA before it:
//        S_in(r) = sum_{q<r} exp(Lambda_{q+1} + .. + Lambda_{r-1}) S_loc(q)
//                  + exp(Lambda_0 + .. + Lambda_{r-1}) initial_state,
//      an elementwise pass of p n floats a predecessor, held in registers.
//   3. CTA r runs over its tiles again from S_in(r): for each tile C B^T
//      scaled by the decays, its product with x (y_diag), and C state^T; the
//      state update runs between tiles (and on the last tile only in the
//      last CTA, whose state is the final one).  y is rounded to bf16 once.
// The state-independent part of a CTA's first tile (its loads, the cumsum,
// C B^T) is done before the wait, so the hand-on overlaps it.  All CTAs of a
// cluster are resident together by construction, so no CTA waits on one
// that has not started: nothing here can deadlock.  k = 1 is the sequential
// form: one CTA walks every tile of its (batch, head), and phases 1 and 2
// vanish.  Phase 1 walks a segment's tiles a second time (8 of the 21
// products a token), which is the price of the parallelism over chunks:
// measured on the H100, it pays where the card has fewer than about one
// (batch, head) an SM (b h = 64, mamba2's prefill of one prompt: k = 2 1.45x
// faster than k = 1) and costs where it has more (b h = 256, mamba2's
// 4-prompt prefill: k = 1 1.35x faster than k = 2).  `scan_form` takes k
// accordingly, at most the portable cluster size of 8.  With no initial
// state, k = 2 gives bit for bit what k = 1 gives: the second CTA's entering
// state is the first's S_loc, the very sum the sequential walk forms.
//
// Layout.  P / 16 warps a CTA; warp w owns rows 16w .. 16w + 15 of the state
// (all n columns) in registers for the CTA's whole life, as the accumulator
// of the `mma.sync` state update.  That accumulator's layout is the layout of
// the B operand of C state^T, so warp w computes y[:, 16w .. 16w + 15] for
// all 64 rows straight from its registers: the state never goes through
// shared memory.  C B^T, which every warp needs, is computed once a tile:
// its ten lower 16 x 16 blocks are dealt to the warps, scaled by
// exp(cum_i - cum_j) dt_j (zero above the diagonal), split into bf16 hi + lo
// and left in shared memory for every warp's product with its columns of x.
// x, B and dt come by `cp.async` into two stages (the next tile's under this
// one's products), C into one buffer (the next tile's under this one's
// y_diag and state update), all in padded, conflict-free rows.  The hi and
// lo products of each accumulator are issued apart, so no product waits on
// the one just before it.  Exponentials are `ex2.approx` on a base-2 cumsum.
// Shared memory is 91.7 KB a CTA (99.6 KB in a cluster, where stage 1 also
// holds S_loc for the hand-on), so two CTAs share an SM.
//
// C B^T once for several heads.  With one group every head of a batch has
// the same C B^T.  This design does not share it across heads: a CTA holds
// one head, whose state fills part of each thread's registers, and C B^T is
// 2.5 of the 21 products a token, against 8 for the state update that a
// second head in the CTA would bring with a second state.
//
// What bounds it on an H100.  At the serving shape (b=4, s=4096, h=64, p=64,
// n=128, chunk 256, bf16) x, dt, B, C are read once and y and the final
// state written once: 0.29 GB, 0.086 ms at 3.35 TB/s, the bound; the chunked
// form's products at the tile of 64 (counted per head, `ssd_flops` in
// chip_smoke.py) are 4.7e10 FLOP, 0.048 ms at 989 TFLOP/s.  This kernel
// issues 21 products a token-head of `mma.sync.m16n8k16` (the lo halves
// included) and runs at about a fifth of the bound's rate (PERF.md §6).  With
// two CTAs of four warps an SM, each SM sub-partition has two warps to hide
// the latency of long dependent chains; more warps an SM, or `wgmma`, are the
// next steps.
//
// Where the bf16 path rounds (the reference rounds only y, at its end):
//   - C B^T: the bf16 inputs as given; exact products, f32 sums.  No rounding.
//   - (C B^T) exp(cum_i - cum_j) dt_j, the A operand of the product with x:
//     f32, split into bf16 hi + lo (two products; the split leaves about
//     2^-17 of the value).
//   - the state, the B operand of C state^T: f32, split into hi + lo.
//   - x_j dt_j exp(cum_Q - cum_j), the A operand of the state update: f32,
//     split into hi + lo.
//   - y_diag stays in the f32 accumulator that C state^T is added to.
//   - y: rounded to bf16 once, at the end, as the reference does.
//   Everything else (cumsum, exp, decay, the state itself and its hand-on) is f32.
//
// f32 inputs take a separate kernel that multiplies in full f32 on the CUDA
// cores (no TF32), as the reference upcasts before its products and is held
// to 3e-4.  It is a correctness path, not a fast one; it walks the caller's
// chunks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the f32 kernel: 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 256;
constexpr int kTile = 64;                                 // the bf16 kernel's chunk
static_assert(kTile == 32 || kTile == 64, "one or two rows a lane in the cumsum");
constexpr int kRowTiles = kTile / 16;                     // 16-row tiles of a tile
constexpr int kPairs = kRowTiles * (kRowTiles + 1) / 2;   // lower blocks of C B^T
constexpr int kMaxCluster = 8;  // the portable cluster size

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

// The same for one float.
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem, bool valid) {
    const int bytes = valid ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
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
    asm(
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

// 2^x by the SFU (relative error below 2^-22; 0 below 2^-126).
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// The cluster's hardware barrier, in two halves: arrive (release at cluster
// scope) and, later, wait (acquire at cluster scope) for every thread of
// every CTA of the cluster to have arrived.
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address in CTA `rank`'s shared memory of what `local` is in ours.
__device__ __forceinline__ uint32_t map_cluster(uint32_t local, uint32_t rank) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
    return remote;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t remote) {
    float v;
    asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
    return v;
}

__device__ __forceinline__ float2 ld_cluster_f32x2(uint32_t remote) {
    float2 v;
    asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(remote) : "memory");
    return v;
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
// bf16: tensor-core kernel.  A cluster of k CTAs per (batch, head), P / 16
// warps a CTA, tiles of kTile tokens.
// ---------------------------------------------------------------------------

template <int P, int N>
struct TileLayout {
    static constexpr int kWarps = P / 16;
    static constexpr int kThreads = 32 * kWarps;
    static constexpr int LDX = P + 8;  // padded bf16 rows: conflict-free ldmatrix
    static constexpr int LDN = N + 8;
    static constexpr int LDM = kTile + 8;
    static constexpr int LDS = N + 8;  // f32 rows of the exchanged state
    // a stage: one tile's x, B and dt
    static constexpr int SX = 0;
    static constexpr int SB = SX + kTile * LDX * 2;
    static constexpr int SDT = SB + kTile * LDN * 2;
    static constexpr int STAGE = SDT + kTile * 4;
    static constexpr int EXCHANGE = P * LDS * 4;
    // byte offsets into dynamic shared memory: stage 0, C, C B^T (hi, lo),
    // the warps' cumsums, the segment's decay, then stage 1, which is also
    // where a segment's own end state is left for the cluster
    static constexpr int C = STAGE;
    static constexpr int MHI = C + kTile * LDN * 2;
    static constexpr int MLO = MHI + kTile * LDM * 2;
    static constexpr int CUM = MLO + kTile * LDM * 2;         // per warp: cum, then w
    static constexpr int LAM = CUM + kWarps * 2 * kTile * 4;  // the segment's decay
    static constexpr int S = LAM + 16;                        // stage 1 / the exchanged state
    // stage 1 holds the exchanged state too where the CTAs form clusters
    static constexpr int bytes(bool cluster) { return S + (cluster && EXCHANGE > STAGE ? EXCHANGE : STAGE); }
    static_assert(P % 16 == 0 && N % 16 == 0, "head and state dims are multiples of 16");
    static_assert(SB % 16 == 0 && SDT % 16 == 0 && STAGE % 16 == 0 && MHI % 16 == 0 && MLO % 16 == 0 &&
                      S % 16 == 0,
                  "16-byte aligned regions");
};

template <int P, int N>
__global__ void __launch_bounds__(TileLayout<P, N>::kThreads) ssd_scan_bf16(const Params prm) {
    using L = TileLayout<P, N>;
    constexpr int LDX = L::LDX;
    constexpr int LDN = L::LDN;
    constexpr int LDM = L::LDM;
    constexpr int LDS = L::LDS;
    constexpr int NWARPS = L::kWarps;
    constexpr int NTHREADS = L::kThreads;
    constexpr int XCH = P / 8;   // 16-byte pieces of a row of x
    constexpr int NCH = N / 8;   // of a row of B or C
    constexpr int KN = N / 16;   // k-steps over the state dim
    constexpr int NT8 = N / 8;   // n8 tiles of a warp's state rows
    constexpr int G8 = NT8 < 8 ? NT8 : 8;  // n8 tiles a group of the state update

    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* sC = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::C);
    __nv_bfloat16* sMhi = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::MHI);
    __nv_bfloat16* sMlo = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::MLO);
    float* sLam = reinterpret_cast<float*>(smem_raw + L::LAM);
    float* sS = reinterpret_cast<float*>(smem_raw + L::S);
    auto stage_x = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(smem_raw + (st ? L::S : 0) + L::SX); };
    auto stage_b = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(smem_raw + (st ? L::S : 0) + L::SB); };
    auto stage_dt = [&](int st) { return reinterpret_cast<float*>(smem_raw + (st ? L::S : 0) + L::SDT); };

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;   // row of the fragment (and g + 8)
    const int t = lane & 3;    // column pair of the fragment
    const int mi = lane >> 3;  // which 8x8 matrix of an ldmatrix.x4 this lane addresses
    const int mr = lane & 7;   // which row of it
    float* sCum = reinterpret_cast<float*>(smem_raw + L::CUM) + warp * 2 * kTile;  // this warp's own
    float* sW = sCum + kTile;

    // The cluster spans gridDim.x, so a CTA's rank in it is blockIdx.x.
    const int k = gridDim.x;
    const int rank = blockIdx.x;
    const int head = blockIdx.y;
    const int batch = blockIdx.z;
    const int nt = (prm.s + kTile - 1) / kTile;
    const int first = rank * nt / k;
    const int end = (rank + 1) * nt / k;
    const bool last_cta = rank == k - 1;
    const bool phase1 = k > 1 && !last_cta;
    const float A2 = prm.A[head] * 1.4426950408889634f;  // A log2(e)

    const __nv_bfloat16* gX =
        static_cast<const __nv_bfloat16*>(prm.x) + batch * prm.x_sb + head * prm.x_sh;
    const __nv_bfloat16* gB = static_cast<const __nv_bfloat16*>(prm.B) + batch * prm.B_sb;
    const __nv_bfloat16* gC = static_cast<const __nv_bfloat16*>(prm.C) + batch * prm.C_sb;
    const float* gDt = prm.dt + batch * prm.dt_sb + head * prm.dt_sh;
    __nv_bfloat16* gY = static_cast<__nv_bfloat16*>(prm.y) + batch * prm.y_sb + head * prm.y_sh;
    const long long state0 = ((long long)batch * prm.h + head) * P * N;

    // Per-lane ldmatrix offsets.  An x4 load brings four 8x8 matrices; lane
    // (mi, mr) gives the address of row mr of matrix mi.
    //   A operand from rows of C (16 rows x 16 k)
    const int a_lane = ((mi & 1) * 8 + mr) * LDN + (mi >> 1) * 8;
    //   A operand from rows of (C B^T) scaled, hi or lo
    const int am_lane = ((mi & 1) * 8 + mr) * LDM + (mi >> 1) * 8;
    //   B operand stored n-major (rows of B for C B^T): b0, b1 of one n8 tile, then of the next
    const int bn_lane = ((mi >> 1) * 8 + mr) * LDN + (mi & 1) * 8;
    //   B operand stored k-major, transposed on load (x for the product with
    //   C B^T, B for the state update): b0, b1 of one n8 tile, then of the next
    const int bx_lane = ((mi & 1) * 8 + mr) * LDX + (mi >> 1) * 8;
    const int bb_lane = ((mi & 1) * 8 + mr) * LDN + (mi >> 1) * 8;
    //   A operand (x w)^T of the state update, from x transposed on load
    const int xt_lane = ((mi >> 1) * 8 + mr) * LDX + (mi & 1) * 8;

    // ---- loads (cp.async; rows past the sequence's end read as zeros) -------
    // A tile's x, B and dt into stage `st`; the caller commits.
    auto load_stage = [&](int tile, int st) {
        const int t0 = tile * kTile;
        __nv_bfloat16* sx = stage_x(st);
        __nv_bfloat16* sb = stage_b(st);
        float* sdt = stage_dt(st);
        for (int idx = tid; idx < kTile * XCH; idx += NTHREADS) {
            const int r = idx / XCH;
            const int ch = idx - r * XCH;
            const bool valid = t0 + r < prm.s;
            cp_async_16(sx + r * LDX + ch * 8, gX + (long long)(valid ? t0 + r : 0) * prm.x_ss + ch * 8, valid);
        }
        for (int idx = tid; idx < kTile * NCH; idx += NTHREADS) {
            const int r = idx / NCH;
            const int ch = idx - r * NCH;
            const bool valid = t0 + r < prm.s;
            cp_async_16(sb + r * LDN + ch * 8, gB + (long long)(valid ? t0 + r : 0) * prm.B_ss + ch * 8, valid);
        }
        for (int r = tid; r < kTile; r += NTHREADS) {
            const bool valid = t0 + r < prm.s;
            cp_async_4(sdt + r, gDt + (long long)(valid ? t0 + r : 0) * prm.dt_ss, valid);
        }
    };
    // A tile's C into its one buffer; the caller commits.
    auto load_c = [&](int tile) {
        const int t0 = tile * kTile;
        for (int idx = tid; idx < kTile * NCH; idx += NTHREADS) {
            const int r = idx / NCH;
            const int ch = idx - r * NCH;
            const bool valid = t0 + r < prm.s;
            cp_async_16(sC + r * LDN + ch * 8, gC + (long long)(valid ? t0 + r : 0) * prm.C_ss + ch * 8, valid);
        }
    };

    // ---- this warp's cumsum of dt * A over the tile, and w ------------------
    // In base 2: cum holds log2(e) cumsum(dt A), so each exp is one ex2.  Lane
    // l holds rows R l .. R l + R - 1.  Returns the tile's decay, cum_last.
    auto warp_cumsum = [&](const float* sDt) -> float {
        constexpr int R = kTile / 32;
        float d[R], c[R];
        float run = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            d[r] = sDt[R * lane + r];
            run += d[r] * A2;
            c[r] = run;
        }
        float incl = run;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float o = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += o;
        }
        const float before = incl - run;
        const float last = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
        for (int r = 0; r < R; ++r) {
            c[r] += before;
            sCum[R * lane + r] = c[r];
            sW[R * lane + r] = d[r] * ex2(last - c[r]);
        }
        __syncwarp();
        return last;
    };

    // ---- the state: warp w's rows 16w.., all n8 tiles, in registers ----------
    // sacc[i][e]: row 16w + g (+8 for e >= 2), column 8i + 2t (+1 for odd e)
    float sacc[NT8][4];
#pragma unroll
    for (int i = 0; i < NT8; ++i) sacc[i][0] = sacc[i][1] = sacc[i][2] = sacc[i][3] = 0.f;

    // state <- exp(cum_last) state + (x w)^T B over the tile's rows.  The hi
    // products of a group of n8 tiles go out before its lo products, so no
    // product waits on the one just before it.
    auto state_update = [&](float last, const __nv_bfloat16* sX, const __nv_bfloat16* sB) {
        const float decay = ex2(last);
#pragma unroll
        for (int i = 0; i < NT8; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sacc[i][e] *= decay;
        }
#pragma unroll 1
        for (int js = 0; js < kRowTiles; ++js) {
            const int j0 = js * 16;
            uint32_t xr[4];
            ldmatrix_x4_trans(xr[0], xr[1], xr[2], xr[3], sX + j0 * LDX + warp * 16 + xt_lane);
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
#pragma unroll
            for (int i0 = 0; i0 < NT8; i0 += G8) {
                uint32_t bf[G8 / 2][4];
#pragma unroll
                for (int q = 0; q < G8 / 2; ++q) {
                    ldmatrix_x4_trans(bf[q][0], bf[q][1], bf[q][2], bf[q][3],
                                      sB + j0 * LDN + (i0 + 2 * q) * 8 + bb_lane);
                }
#pragma unroll
                for (int q = 0; q < G8 / 2; ++q) {
                    mma_bf16(sacc[i0 + 2 * q], ahi, bf[q][0], bf[q][1]);
                    mma_bf16(sacc[i0 + 2 * q + 1], ahi, bf[q][2], bf[q][3]);
                }
#pragma unroll
                for (int q = 0; q < G8 / 2; ++q) {
                    mma_bf16(sacc[i0 + 2 * q], alo, bf[q][0], bf[q][1]);
                    mma_bf16(sacc[i0 + 2 * q + 1], alo, bf[q][2], bf[q][3]);
                }
            }
        }
    };

    // ---- C B^T scaled, this warp's share of its lower blocks, as hi + lo ------
    auto scores = [&](const __nv_bfloat16* sB, const float* sDt) {
#pragma unroll 1
        for (int pr = warp; pr < kPairs; pr += NWARPS) {
            int mt = 0;
            while ((mt + 1) * (mt + 2) / 2 <= pr) ++mt;
            const int jt = pr - mt * (mt + 1) / 2;
            // even and odd k-steps into separate sums: four chains, not two
            float sc[2][2][4];
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[0][0][e] = sc[0][1][e] = sc[1][0][e] = sc[1][1][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KN; ++kk) {
                uint32_t a[4], r0, r1, r2, r3;
                ldmatrix_x4(a[0], a[1], a[2], a[3], sC + mt * 16 * LDN + kk * 16 + a_lane);
                ldmatrix_x4(r0, r1, r2, r3, sB + jt * 16 * LDN + kk * 16 + bn_lane);
                mma_bf16(sc[kk & 1][0], a, r0, r1);
                mma_bf16(sc[kk & 1][1], a, r2, r3);
            }
            const int row_a = mt * 16 + g;
            const int row_b = row_a + 8;
            const float cum_a = sCum[row_a];
            const float cum_b = sCum[row_b];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                float v[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int j = jt * 16 + nt * 8 + t * 2 + (e & 1);
                    const int i = (e & 2) ? row_b : row_a;
                    const float ci = (e & 2) ? cum_b : cum_a;
                    const float dot = sc[0][nt][e] + sc[1][nt][e];
                    // above the diagonal the factor is 0, never exp of a positive sum
                    v[e] = (jt < mt || j <= i) ? dot * (ex2(ci - sCum[j]) * sDt[j]) : 0.f;
                }
                const int col = jt * 16 + nt * 8 + t * 2;
                uint32_t hi, lo;
                split_bf16(v[0], v[1], hi, lo);
                *reinterpret_cast<uint32_t*>(sMhi + row_a * LDM + col) = hi;
                *reinterpret_cast<uint32_t*>(sMlo + row_a * LDM + col) = lo;
                split_bf16(v[2], v[3], hi, lo);
                *reinterpret_cast<uint32_t*>(sMhi + row_b * LDM + col) = hi;
                *reinterpret_cast<uint32_t*>(sMlo + row_b * LDM + col) = lo;
            }
        }
    };

    // ---- phase 1: the segment's own end state, from zero ----------------------
    // Its tiles alternate between the stages so that the last is in stage 1,
    // where the end state is left; under the last, phase 3's first tile
    // comes into stage 0.
    if (phase1) {
        const int m = end - first;
        float lam = 0.f;
        load_stage(first, m & 1);
        cp_async_commit();
#pragma unroll 1
        for (int i = 0; i < m; ++i) {
            const int cur = (m - i) & 1;  // the last (i = m - 1) in stage 1
            cp_async_wait_all();
            __syncthreads();  // the tile is in; every warp is done with the other stage
            if (i + 1 < m) {
                load_stage(first + i + 1, cur ^ 1);
            } else {
                load_stage(first, 0);
                load_c(first);
            }
            cp_async_commit();
            const float last = warp_cumsum(stage_dt(cur));
            state_update(last, stage_x(cur), stage_b(cur));
            lam += last;
        }
        __syncthreads();  // every warp done with stage 1 before the end state overwrites it
#pragma unroll
        for (int i = 0; i < NT8; ++i) {
            const int row = warp * 16 + g;
            const int col = i * 8 + t * 2;
            *reinterpret_cast<float2*>(sS + row * LDS + col) = make_float2(sacc[i][0], sacc[i][1]);
            *reinterpret_cast<float2*>(sS + (row + 8) * LDS + col) = make_float2(sacc[i][2], sacc[i][3]);
        }
        if (tid == 0) *sLam = lam;
    } else {
        load_stage(first, 0);
        load_c(first);
        cp_async_commit();
    }
    if (k > 1) cluster_arrive();  // (1) S_loc and Lambda published (the last CTA publishes nothing)

    // ---- phase 2: the state entering this segment ------------------------------
    auto hand_on = [&]() {
#pragma unroll
        for (int i = 0; i < NT8; ++i) sacc[i][0] = sacc[i][1] = sacc[i][2] = sacc[i][3] = 0.f;
        float coef = 1.f;  // exp(Lambda_{q+1} + .. + Lambda_{rank-1}) for the q being read
#pragma unroll 1
        for (int q = rank - 1; q >= 0; --q) {
            const uint32_t base = map_cluster(smem_u32(sS), (uint32_t)q);
            float2 v[NT8][2];
#pragma unroll
            for (int i = 0; i < NT8; ++i) {
                const int off = (warp * 16 + g) * LDS + i * 8 + t * 2;
                v[i][0] = ld_cluster_f32x2(base + off * 4);
                v[i][1] = ld_cluster_f32x2(base + (off + 8 * LDS) * 4);
            }
#pragma unroll
            for (int i = 0; i < NT8; ++i) {
                sacc[i][0] = fmaf(coef, v[i][0].x, sacc[i][0]);
                sacc[i][1] = fmaf(coef, v[i][0].y, sacc[i][1]);
                sacc[i][2] = fmaf(coef, v[i][1].x, sacc[i][2]);
                sacc[i][3] = fmaf(coef, v[i][1].y, sacc[i][3]);
            }
            coef *= ex2(ld_cluster_f32(map_cluster(smem_u32(sLam), (uint32_t)q)));
        }
        if (prm.init != nullptr) {
#pragma unroll
            for (int i = 0; i < NT8; ++i) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int pr = warp * 16 + g + ((e & 2) ? 8 : 0);
                    const int nn = i * 8 + t * 2 + (e & 1);
                    sacc[i][e] = fmaf(coef, prm.init[state0 + pr * N + nn], sacc[i][e]);
                }
            }
        }
    };

    // ---- phase 3: y over the segment's tiles, from the state entering it ------
    // Tile j of the segment is in stage j & 1; the next tile's x, B and dt
    // come in under this one's products, its C under this one's y_diag.  In a
    // cluster, stage 1 holds this CTA's S_loc until every CTA of the cluster
    // has read what it needs (barrier (2)), so the first tile waits for that
    // before it loads the second.
    bool waited = false;
#pragma unroll 1
    for (int tile = first; tile < end; ++tile) {
        const int cur = (tile - first) & 1;
        const bool head_tile = tile == first;
        const bool more = tile + 1 < end;
        const __nv_bfloat16* sX = stage_x(cur);
        const __nv_bfloat16* sB = stage_b(cur);
        const float* sDt = stage_dt(cur);
        cp_async_wait_all();
        __syncthreads();  // (A) the tile is in; every warp is done with the previous tile
        if (more && !(k > 1 && head_tile)) {
            load_stage(tile + 1, cur ^ 1);
            cp_async_commit();
        }
        const float last = warp_cumsum(sDt);
        scores(sB, sDt);
        if (head_tile) {
            if (k > 1) cluster_wait();  // (1) every S_loc before ours is published
            hand_on();
            if (k > 1) cluster_arrive();  // (2) done reading the other CTAs' shared memory
        }

        // y = exp(cum_i) C_i state^T, the state as hi + lo from the registers
        float acc[kRowTiles][2][4];
#pragma unroll
        for (int mt = 0; mt < kRowTiles; ++mt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][0][e] = acc[mt][1][e] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
            uint32_t cf[kRowTiles][4];
#pragma unroll
            for (int mt = 0; mt < kRowTiles; ++mt) {
                ldmatrix_x4(cf[mt][0], cf[mt][1], cf[mt][2], cf[mt][3], sC + mt * 16 * LDN + kk * 16 + a_lane);
            }
            uint32_t bh[2][2], bl[2][2];
#pragma unroll
            for (int nt2 = 0; nt2 < 2; ++nt2) {
                split_bf16(sacc[2 * kk][2 * nt2], sacc[2 * kk][2 * nt2 + 1], bh[nt2][0], bl[nt2][0]);
                split_bf16(sacc[2 * kk + 1][2 * nt2], sacc[2 * kk + 1][2 * nt2 + 1], bh[nt2][1], bl[nt2][1]);
            }
#pragma unroll
            for (int nt2 = 0; nt2 < 2; ++nt2) {
#pragma unroll
                for (int mt = 0; mt < kRowTiles; ++mt) mma_bf16(acc[mt][nt2], cf[mt], bh[nt2][0], bh[nt2][1]);
            }
#pragma unroll
            for (int nt2 = 0; nt2 < 2; ++nt2) {
#pragma unroll
                for (int mt = 0; mt < kRowTiles; ++mt) mma_bf16(acc[mt][nt2], cf[mt], bl[nt2][0], bl[nt2][1]);
            }
        }
#pragma unroll
        for (int mt = 0; mt < kRowTiles; ++mt) {
            const float ea = ex2(sCum[mt * 16 + g]);
            const float eb = ex2(sCum[mt * 16 + g + 8]);
#pragma unroll
            for (int nt2 = 0; nt2 < 2; ++nt2) {
                acc[mt][nt2][0] *= ea;
                acc[mt][nt2][1] *= ea;
                acc[mt][nt2][2] *= eb;
                acc[mt][nt2][3] *= eb;
            }
        }
        __syncthreads();  // (B) C B^T complete; every warp done with C
        if (more) {
            if (k > 1 && head_tile) {
                cluster_wait();  // (2) no CTA of the cluster still reads our stage 1
                waited = true;
                load_stage(tile + 1, 1);
            }
            load_c(tile + 1);
            cp_async_commit();
        }

        // y += (C B^T scaled) x, hi + lo, for the blocks j <= i
#pragma unroll
        for (int jt = 0; jt < kRowTiles; ++jt) {
            uint32_t r0, r1, r2, r3;
            ldmatrix_x4_trans(r0, r1, r2, r3, sX + jt * 16 * LDX + warp * 16 + bx_lane);
            uint32_t mh[kRowTiles][4], ml[kRowTiles][4];
#pragma unroll
            for (int mt = jt; mt < kRowTiles; ++mt) {
                ldmatrix_x4(mh[mt][0], mh[mt][1], mh[mt][2], mh[mt][3], sMhi + mt * 16 * LDM + jt * 16 + am_lane);
                ldmatrix_x4(ml[mt][0], ml[mt][1], ml[mt][2], ml[mt][3], sMlo + mt * 16 * LDM + jt * 16 + am_lane);
            }
#pragma unroll
            for (int mt = jt; mt < kRowTiles; ++mt) {
                mma_bf16(acc[mt][0], mh[mt], r0, r1);
                mma_bf16(acc[mt][1], mh[mt], r2, r3);
            }
#pragma unroll
            for (int mt = jt; mt < kRowTiles; ++mt) {
                mma_bf16(acc[mt][0], ml[mt], r0, r1);
                mma_bf16(acc[mt][1], ml[mt], r2, r3);
            }
        }

        // y rounded to bf16 once, here
        const int t0 = tile * kTile;
#pragma unroll
        for (int mt = 0; mt < kRowTiles; ++mt) {
            const int row_a = t0 + mt * 16 + g;
            const int row_b = row_a + 8;
#pragma unroll
            for (int nt2 = 0; nt2 < 2; ++nt2) {
                const int col = warp * 16 + nt2 * 8 + t * 2;
                if (row_a < prm.s) {
                    *reinterpret_cast<__nv_bfloat162*>(gY + (long long)row_a * prm.y_ss + col) =
                        __floats2bfloat162_rn(acc[mt][nt2][0], acc[mt][nt2][1]);
                }
                if (row_b < prm.s) {
                    *reinterpret_cast<__nv_bfloat162*>(gY + (long long)row_b * prm.y_ss + col) =
                        __floats2bfloat162_rn(acc[mt][nt2][2], acc[mt][nt2][3]);
                }
            }
        }

        // the state entering the next tile (or, in the last CTA, the final one)
        if (more || last_cta) state_update(last, sX, sB);
    }

    if (last_cta) {
#pragma unroll
        for (int i = 0; i < NT8; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int pr = warp * 16 + g + ((e & 2) ? 8 : 0);
                const int nn = i * 8 + t * 2 + (e & 1);
                prm.final_state[state0 + pr * N + nn] = sacc[i][e];
            }
        }
    }
    if (k > 1 && !waited) cluster_wait();  // (2) no CTA exits while a later one may still read its S_loc
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

cudaError_t launch_error(cudaError_t err) {
    if (err != cudaSuccess) {
        cudaGetLastError();  // the launch was refused and nothing ran: clear the error it left
        return err;
    }
    return cudaGetLastError();
}

template <int P, int N>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
    using L = F32Layout<P, N>;
    const int qp = (p.chunk + 15) & ~15;
    const int smem_max = L::bytes(kMaxChunk);
    if (smem_max > 48 * 1024) {
        cudaError_t err =
            cudaFuncSetAttribute(ssd_scan_f32<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
        if (err != cudaSuccess) return err;
    }
    dim3 grid(p.h, p.b);
    ssd_scan_f32<P, N><<<grid, kThreads, L::bytes(qp), stream>>>(p);
    return launch_error(cudaSuccess);
}

// The bf16 kernel as k CTAs a (batch, head): a grid of (k, h, b) CTAs in
// clusters of (k, 1, 1).
template <int P, int N>
cudaError_t launch_bf16(const Params& p, int cluster, cudaStream_t stream) {
    using L = TileLayout<P, N>;
    auto kernel = ssd_scan_bf16<P, N>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes(true));
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr = {};
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = (unsigned)cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(cluster, p.h, p.b);
    config.blockDim = dim3(L::kThreads);
    config.dynamicSmemBytes = L::bytes(cluster > 1);
    config.stream = stream;
    config.attrs = &attr;
    config.numAttrs = 1;
    return launch_error(cudaLaunchKernelEx(&config, kernel, p));
}

// The largest cluster the bf16 kernel can launch with on the current device:
// the portable 8 where the card has cluster launch and holds one cluster of 8
// of these CTAs with their exchange buffers, else 1 (the sequential form only).
template <int P, int N>
cudaError_t cluster_limit(int* out) {
    using L = TileLayout<P, N>;
    *out = 1;
    int device = 0, can = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&can, cudaDevAttrClusterLaunch, device);
    if (err != cudaSuccess || !can) return err;
    auto kernel = ssd_scan_bf16<P, N>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes(true));
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr = {};
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = (unsigned)kMaxCluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(kMaxCluster);
    config.blockDim = dim3(L::kThreads);
    config.dynamicSmemBytes = L::bytes(true);
    config.attrs = &attr;
    config.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &config);
    if (err == cudaSuccess && clusters >= 1) *out = kMaxCluster;
    return err;
}

template <int P, int N>
cudaError_t launch_typed(int dtype, const Params& p, int cluster, cudaStream_t stream) {
    return dtype == 1 ? launch_bf16<P, N>(p, cluster, stream) : launch_f32<P, N>(p, stream);
}

}  // namespace

// Returns a cudaError_t as int (0 on success), or -1 for a shape, chunk,
// type or cluster size that this file does not build.  `dtype`: 0 = float32,
// 1 = bfloat16 (x, B, C and y; dt, A and the states are float32).  `cluster`
// is the bf16 kernel's CTAs a (batch, head), 1 .. min(8, ceil(s / 64)) (the
// wrapper takes it from `scan_form`); the float32 kernel takes 1 only.
// Strides are in elements: x (batch, seq, head), dt (batch, seq, head),
// B (batch, seq), C (batch, seq), y (batch, seq, head); the last dim of x, B,
// C, y is contiguous, and for bf16 every row of x, B, C starts on a 16-byte
// boundary.  `init` may be null (a zero state).  Nothing is allocated and
// nothing synchronises: the launch goes onto `stream`.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A, const void* B,
                            const void* C, const float* init, void* y, float* final_state,
                            int dtype, int b, int s, int h, int p, int n, int chunk, int cluster,
                            const long long* strides, void* stream) {
    if (chunk < 1 || chunk > kMaxChunk || s % chunk != 0 || (dtype != 0 && dtype != 1)) return -1;
    const int tiles = (s + kTile - 1) / kTile;
    if (dtype == 1 ? (cluster < 1 || cluster > kMaxCluster || cluster > tiles) : cluster != 1) return -1;
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
        err = launch_typed<16, 16>(dtype, prm, cluster, st);
    } else if (p == 32 && n == 16) {
        err = launch_typed<32, 16>(dtype, prm, cluster, st);
    } else if (p == 64 && n == 16) {
        err = launch_typed<64, 16>(dtype, prm, cluster, st);
    } else if (p == 64 && n == 32) {
        err = launch_typed<64, 32>(dtype, prm, cluster, st);
    } else if (p == 64 && n == 128) {
        err = launch_typed<64, 128>(dtype, prm, cluster, st);
    } else {
        return -1;
    }
    return static_cast<int>(err);
}

// The largest cluster of the bf16 kernel at (p, n) on the current device
// (see cluster_limit above), into *out.  Returns a cudaError_t as int, or -1
// for a (p, n) this file does not build.
extern "C" int ssd_scan_cluster_limit(int p, int n, int* out) {
    cudaError_t err;
    if (p == 16 && n == 16) {
        err = cluster_limit<16, 16>(out);
    } else if (p == 32 && n == 16) {
        err = cluster_limit<32, 16>(out);
    } else if (p == 64 && n == 16) {
        err = cluster_limit<64, 16>(out);
    } else if (p == 64 && n == 32) {
        err = cluster_limit<64, 32>(out);
    } else if (p == 64 && n == 128) {
        err = cluster_limit<64, 128>(out);
    } else {
        return -1;
    }
    return static_cast<int>(err);
}
