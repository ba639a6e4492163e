// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `flash_attention_fwd` / `_kernel` of
// src/repro/kernels/flash_attention/kernel.py (the `pl.pallas_call` there).
// Same function: softmax(q k^T / sqrt(d) [causal, -1e30]) v by online
// softmax over KV tiles (q and k rows d = dqk wide, v rows dv wide: MLA's
// 192 and 128, the function of the reference's `flash_core` with g = 1) with an f32 running max `m`, denominator `l` and
// accumulator, GQA by index (kv head = h / (h / kvh)), final divide by
// max(l, 1e-30).  It also writes lse = m + log(max(l, 1e-30)), which the
// Pallas kernel does not, because the backward pass of a later slice
// recomputes from it.
//
// What changed against the TPU form.  The Pallas grid runs its innermost KV
// axis in order on one core and carries m / l / acc in VMEM scratch from one
// grid step to the next.  Blocks of a CUDA grid run in no order, so here a
// (batch, q head, q tile) belongs to one CTA from start to end and the KV
// axis is a loop inside it; m, l and the accumulator never leave registers.
// Rows past sq are zero-filled on load and never stored; keys past sk get
// -inf, and a guard keeps exp(-inf - -inf) out of the sums.
//
// What bounds it on an H100.  At the serving shape (b=4, h=24, kvh=8,
// s=4096, d=128, bf16, causal) the work is 2*b*h*s^2*d = 4.1e11 FLOP against
// 0.27 GB of compulsory traffic: 1500 FLOP per byte, far above the card's
// 295, so the bound is the tensor cores: 0.42 ms at 989 TFLOP/s.  Only
// `wgmma` reaches that rate, and it must be fed from shared memory without
// the math warps spending registers or issue slots on loads.  Two kernels,
// each built at the instances (DQK, DV) = 32, 64, 80, 96, 128 and 160
// (square) and (192, 128); a call takes the smallest instance that holds
// both of its head dims (`instance_of`), so every width the reference takes
// is taken up to 160, and a qk width up to 192 beside a v width up to 128.
// The true widths travel in Params (`dqk`, `dv`): they are the tensor maps'
// extents, so TMA's zero fill pads a row to its instance (zero Q and K
// columns add nothing to S; zero V columns give output columns that are
// not stored), and the store writes `dv` columns.  A square 192 would leave
// one K/V stage in shared memory, so 160 is the widest square:
//
// - bf16 (`flash_fwd_hopper`, templated on DQK and DV): a CTA of three
//   warpgroups, 128 q rows.
//   Warpgroup 0 is the producer: one thread issues TMA loads of Q once and of
//   K and V through a ring of stages (the largest power of two that fits,
//   at most four: two at d = 128 and (192, 128), four at 64 and 80; three
//   fit at 128 but read 3-10 % slower than two), each stage with a full and
//   an empty mbarrier for K and for V;
//   the group drops to 24 registers (`setmaxnreg`), the consumers rise to
//   240.  Warpgroups 1 and 2 are consumers of 64 q rows each.  S = Q K^T is
//   a `wgmma` m64n128k16 with both operands in swizzled shared memory
//   (K-major; 128-byte swizzle, 64-byte at 32, 80, 96 and 160); the online softmax runs
//   on the accumulator in registers in base 2 (`ex2.approx`, scale * log2(e) folded into one FMA);
//   P is rounded to bf16 as the reference rounds it and repacked in
//   registers from the accumulator layout into the A fragment of O += P V, a
//   `wgmma` with A from registers and V read MN-major (transposed) from
//   shared memory.  K is handed back to the producer as soon as S is waited
//   on, V as soon as P V is.  The tensor maps are 4-D (d, s, head, batch)
//   over the caller's strides, so the serving path's transposed (b, s, h, d)
//   views are read with no copy; a 128-wide row takes two 64-element boxes
//   (the 128-byte swizzle's span), a 192-wide Q or K row three.  K and V
//   tiles have their own widths and byte counts (48 and 32 KB at (192,
//   128); with Q's 48 KB and two stages, 214,096 bytes of the 232,448 a
//   block may have); Q K^T takes DQK/16 k-steps, P V one m64nDVk16 `wgmma`
//   a k-step, and the store writes dv columns.
//   d = 80: a 160-byte row fits no 128-byte swizzle box, so at 80 the rows
//   are cut into 32-element boxes with 64-byte swizzle and padded to 96:
//   the tensor maps' extent stays 80, TMA fills columns 80-95 with zeros
//   (Q's and K's add nothing to S, V's give output columns that are not
//   stored), and S takes 6 k-steps and P V is an m64n96k16.  That costs
//   1.2x the tensor work of an exact 80.  An exact form in one layout, five
//   16-element boxes with 32-byte swizzle and an m64n80k16 P V, read no
//   faster at stablelm's prefill (0.98-1.00 ms against 0.91-0.99 in turns,
//   H100 at 700 W), so the tensor work is not what bounds 80, and the
//   padded form with the fewer, wider TMA boxes stays.
//   Registers (`nvcc -cubin -Xptxas -v`, sm_90a): 168 at every instance
//   (the consumers raised to 240 by `setmaxnreg`), no spill.
//   The softmax (exp2 on the MUFU unit, FMAs, the row max) leaves the tensor
//   cores idle unless products are queued, so each consumer issues S_j and
//   P_{j-1} V_{j-1} together and runs the softmax of S_j while P V still
//   runs (intra-warpgroup overlap).  That keeps S, P and O live at once, so
//   the consumers need more than the 168 registers that 384 threads leave
//   a thread: the kernel is built with `setmaxnreg`, which ptxas honours
//   here.  (Two named barriers that made the consumers take turns at the
//   tensor cores, ping-pong, gained nothing on top of the overlap at phi4's
//   shape and were dropped.)  The kernel is persistent, one CTA an SM:
//   while the consumers finish one q tile (its last P V and the store), the
//   producer already loads the next tile's Q and first K/V stages.  Tiles
//   are numbered heavy first (the last causal q tiles of every (b, h) before
//   any lighter one) and dealt out in rounds, every other round in reverse,
//   so every CTA gets about the same work.  Where a kv head has few q heads
//   (MLA's 16 of 16, stablelm's 32 of 32) the CTAs that run at once would
//   each read another head's K and V from device memory, 128 FLOP a byte
//   against the card's 295: so the q tiles of one (b, h) are dealt out in
//   bands side by side, enough that about eight CTAs read each K/V tile at
//   once, seven of them from L2 (band ceil(8 / group), 1 where a kv head has
//   eight q heads or more; at 80, 0.85-0.93 ms against 1.65 with band 1).
//   Read by phase at d = 128 (scripts/probe_flash_fwd.py; b=4, s=4096, 24,
//   56 and 96 q heads over 8 kv heads; H100 at 700 W): the loads do not set
//   the pace.  The same items and TMA loads with no products take 28-39 % of
//   the kernel's time, the producer waits for a free stage 81 % of its, the
//   consumers wait for a K or V tile 4 % of theirs; their loop of products
//   and softmax takes 85 %, an item's head, last P V and epilogue 10 %, in
//   which both consumers sit at the same item boundary.  So these were tried
//   and measured slower in turns, and are not kept (PERF.md, 6, "K1's
//   forward at large GQA groups"):
//   pairs of CTAs in a cluster that take two q heads of one kv head and
//   multicast each half of every K and V tile to both (half the bytes out of
//   L2; 6-11 % slower at groups 3, 7 and 12, three stages slower still); and
//   issuing the next item's S_0 beside an item's last P V, with the epilogue
//   under it or not, which made ptxas spill 200-1800 bytes and serialise the
//   products (C7512) at every instance from 80 up.
//   Code that never runs moves this kernel's time: a block that is never
//   taken, put before the tile loop, read 7.7 % slower at qwen3-moe's d = 128
//   (H100 at 700 W).  So two builds are compared only in turns on one card,
//   and a gain of a few per cent is not read as a change in the work.
//   At deepseek-v2-lite's prefill (b=4, h=16, s=4096, dqk 192, dv 128,
//   causal) the work is 2*(dqk+dv)*b*h*pairs = 3.4e11 FLOP against 0.34 GB,
//   and at stablelm's (b=4, h=32, s=4096, d=80) as much: both bound by the
//   tensor cores, 0.35 ms.
//   At 16 (the smoke configs') the row pads to 32 and S takes two k-steps:
//   the `mma.sync` kernel that took 16 before is gone.  bf16 rows must be
//   multiples of 8 wide (a store writes 8 columns); kernel.py pads others.
// - f32 (`flash_fwd_f32`): full-precision FMAs on the CUDA cores (no TF32),
//   because the reference upcasts before its dot products and is held to
//   2e-5.  It is a correctness path, not a fast one.
//
// `flash_attention_path_dqk_dv(dtype, dqk, dv)` says which kernel takes a
// call; the wrapper's `kernel_path` is the same table.  No path falls back to
// another: a tensor map that cannot be encoded is an error code.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Phase marks of the Hopper kernel and its load-only form, for
// scripts/probe_flash_fwd.py: that script builds this source with K1_MARK and
// its companions defined to add clock64 intervals to per-role counters, or
// with K1_LOAD_ONLY true (the consumers wait for each tile and release it,
// with no products).  Here the marks are empty and the load-only form is not
// built, so neither changes the kernel's code.
#ifndef K1_MARK
#define K1_MARKS_BEGIN
#define K1_MARK(phase)
#define K1_MARKS_END(role)
#endif
#ifndef K1_LOAD_ONLY
#define K1_LOAD_ONLY false
#endif

namespace {

constexpr float kNegCausal = -1e30f;  // the reference's causal mask value
constexpr float kLog2e = 1.4426950408889634f;

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
    int dqk, dv;  // the true head dims: the tensor maps' extents and the columns stored
    float scale;
    int causal;
    int band;  // the Hopper kernel's schedule: q tiles of one (batch, head) dealt out side by side
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&v);
}


// ---------------------------------------------------------------------------
// bf16, head dims 64, 80 and 128 and MLA's (192, 128): the Hopper kernel.  A
// CTA is three warpgroups: warpgroup 0 is the producer (one thread issues
// every TMA load; the group gives its registers away), warpgroups 1 and 2
// are consumers of 64 q rows each.  Q is loaded once; K and V go through a
// ring of stages, each with a full and an empty mbarrier for K and for V, so
// that K of a stage is handed back as soon as Q K^T has read it and V as
// soon as P V has.  Q and K rows are DQK wide, V and output rows DV wide.
// ---------------------------------------------------------------------------

constexpr int kHBlockM = 128;  // q rows a CTA: two consumer warpgroups of 64
constexpr int kHBlockN = 128;  // keys a KV tile
constexpr int kHThreads = 384;
constexpr int kSmemLimit = 232448;  // shared memory a block may have on an H100
constexpr long long kWaitTrapCycles = 1LL << 34;  // ~8 s at 2 GHz: a lost barrier traps, not hangs
constexpr int kKVShare = 8;  // CTAs that read one kv head's K and V tiles at once in a banded schedule

// The shared-memory layout of the Hopper kernel at (DQK, DV).  Every tile is
// cut into boxes of kBox elements a row, one TMA load each, whose rows are
// kRowBytes = 2 kBox bytes with the swizzle of that span: 64-element boxes
// with 128-byte swizzle where both head dims are multiples of 64; else (32,
// 80, 96, 160) 32-element boxes with 64-byte swizzle, 80's row padded to 96
// (the tensor map's extent is the true width, so TMA fills the rest with
// zeros).
template <int DQK, int DV>
struct HopperCfg {
    static constexpr int kBox = (DQK % 64 == 0 && DV % 64 == 0) ? 64 : 32;
    static constexpr int kRowBytes = 2 * kBox;
    static constexpr int kDQK = (DQK + kBox - 1) / kBox * kBox;  // padded widths
    static constexpr int kDV = (DV + kBox - 1) / kBox * kBox;
    static constexpr int kQBytes = kHBlockM * kDQK * 2;
    static constexpr int kKBytes = kHBlockN * kDQK * 2;  // one K tile
    static constexpr int kVBytes = kHBlockN * kDV * 2;   // one V tile
    // K/V stages: the largest power of two that fits, at most 4 (a ring of
    // three at d = 128 read 3-10 % slower than two; see the note at the top)
    static constexpr int kFit = (kSmemLimit - 1024 - kQBytes - 8 * (2 + 4 * 4)) / (kKBytes + kVBytes);
    static constexpr int kStages = kFit >= 4 ? 4 : (kFit >= 2 ? 2 : kFit);
    static constexpr int kBarBytes = 8 * (2 + 4 * kStages);
    // 1024 bytes of slack: the swizzled tiles must start on 1024-byte boundaries
    static constexpr int kSmem = 1024 + kQBytes + kStages * (kKBytes + kVBytes) + kBarBytes;
    static_assert(kStages >= 2 && kSmem <= kSmemLimit, "the tiles do not fit shared memory");
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

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
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

// d (64 x 128, f32) (+)= A (64 x 16, shared, K-major) * B (128 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
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

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The online softmax of one consumer thread's two accumulator rows, row_a
// and row_a + 8, in base 2.
struct OnlineSoftmax {
    float m_a, m_b;  // running max of the raw scores
    float l_a, l_b;  // per-thread partial denominators; reduced at the end
    float scale_log2;

    __device__ explicit OnlineSoftmax(float scale_log2_)
        : m_a(-INFINITY), m_b(-INFINITY), l_a(0.f), l_b(0.f), scale_log2(scale_log2_) {}

    // Masks a tile of raw scores (keys from k0; `masked` says whether any
    // key of it needs a mask), moves the running max, turns the scores into
    // p = exp2(s * scale * log2(e) - m) in place and adds them to l.  Returns
    // the factors that rescale the accumulator's rows.
    template <int BN>
    __device__ __forceinline__ void tile(float (&s)[BN / 2], int k0, int sk, bool causal,
                                         int row_a, int tq, bool masked, float& alpha_a,
                                         float& alpha_b) {
        if (masked) {
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) {
                const int col = k0 + (i / 4) * 8 + tq * 2 + (i & 1);
                const int row = row_a + ((i & 2) ? 8 : 0);
                if (col >= sk) {
                    s[i] = -INFINITY;  // never enters the max or the sum
                } else if (causal && col > row) {
                    s[i] = kNegCausal;
                }
            }
        }
        float mx_a = m_a, mx_b = m_b;
#pragma unroll
        for (int i = 0; i < BN / 2; i += 4) {
            mx_a = fmaxf(mx_a, fmaxf(s[i], s[i + 1]));
            mx_b = fmaxf(mx_b, fmaxf(s[i + 2], s[i + 3]));
        }
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        // a row that has seen no key yet keeps m = -inf; subtract 0 instead so
        // that exp2(-inf - -inf) never appears
        const float ms_a = (mx_a == -INFINITY) ? 0.f : mx_a * scale_log2;
        const float ms_b = (mx_b == -INFINITY) ? 0.f : mx_b * scale_log2;
        alpha_a = ex2(m_a * scale_log2 - ms_a);
        alpha_b = ex2(m_b * scale_log2 - ms_b);
        m_a = mx_a;
        m_b = mx_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int i = 0; i < BN / 2; i += 4) {
            s[i] = ex2(fmaf(s[i], scale_log2, -ms_a));
            s[i + 1] = ex2(fmaf(s[i + 1], scale_log2, -ms_a));
            s[i + 2] = ex2(fmaf(s[i + 2], scale_log2, -ms_b));
            s[i + 3] = ex2(fmaf(s[i + 3], scale_log2, -ms_b));
            sum_a += s[i] + s[i + 1];
            sum_b += s[i + 2] + s[i + 3];
        }
        l_a = l_a * alpha_a + sum_a;
        l_b = l_b * alpha_b + sum_b;
    }
};

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], float alpha_a, float alpha_b) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
        acc[i] *= alpha_a;
        acc[i + 1] *= alpha_a;
        acc[i + 2] *= alpha_b;
        acc[i + 3] *= alpha_b;
    }
}

// p rounded to bf16 as the reference does: the accumulator fragments of two
// neighbouring 8-key chunks are the A fragment of one k-step of P V
template <int KS>
__device__ __forceinline__ void pack_p(uint32_t (&pf)[KS][4], const float (&s)[KS * 8]) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
        pf[ks][0] = pack_bf16(s[8 * ks], s[8 * ks + 1]);
        pf[ks][1] = pack_bf16(s[8 * ks + 2], s[8 * ks + 3]);
        pf[ks][2] = pack_bf16(s[8 * ks + 4], s[8 * ks + 5]);
        pf[ks][3] = pack_bf16(s[8 * ks + 6], s[8 * ks + 7]);
    }
}

template <int DQK, int DV, bool LOAD_ONLY>
__global__ void __launch_bounds__(kHThreads, 1)
    flash_fwd_hopper(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Params p) {
    using Cfg = HopperCfg<DQK, DV>;
    constexpr int STAGES = Cfg::kStages;
    constexpr int BM = kHBlockM;
    constexpr int BN = kHBlockN;
    constexpr int BOX = Cfg::kBox;            // elements a box row
    constexpr int ROW = Cfg::kRowBytes;       // bytes a box row: the swizzle's span
    constexpr int QK_BOXES = Cfg::kDQK / BOX;  // boxes a Q or K row
    constexpr int V_BOXES = Cfg::kDV / BOX;    // boxes a V row
    constexpr int DVP = Cfg::kDV;             // the output accumulator's (padded) width

    extern __shared__ unsigned char smem_raw[];
    const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t sK = sQ + Cfg::kQBytes;           // stage s at sK + s * kKBytes
    const uint32_t sV = sK + STAGES * Cfg::kKBytes;  // stage s at sV + s * kVBytes
    const uint32_t bars = sV + STAGES * Cfg::kVBytes;
    const uint32_t full_q = bars;
    const uint32_t empty_q = bars + 8;
    auto full_k = [&](int s) { return bars + 8u * (2 + s); };
    auto full_v = [&](int s) { return bars + 8u * (2 + STAGES + s); };
    auto empty_k = [&](int s) { return bars + 8u * (2 + 2 * STAGES + s); };
    auto empty_v = [&](int s) { return bars + 8u * (2 + 3 * STAGES + s); };

    // Persistent: the work items go out in rounds of gridDim.x, one to a CTA,
    // every other round in reverse (a CTA's k-th item is number_of(k)), so
    // that the items of every CTA add up to about the same work.  Items are
    // numbered heavy first in bands of p.band q tiles: the bands from the
    // last q tiles (the most keys under a causal mask) to the first, every
    // (batch, head) at one band before any at the next, so the light items
    // come last and even out the CTAs.  Within a band the q tiles of one
    // (batch, head) are neighbours, so the CTAs that take them at once read
    // the same K and V tiles at about the same time: one read from device
    // memory, the others from L2.
    const int n_qtiles = (p.sq + BM - 1) / BM;
    const int n_items = n_qtiles * p.b * p.h;
    const int band_items = p.band * p.b * p.h;
    auto number_of = [&](int k) {
        return static_cast<int>(k * gridDim.x + ((k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x));
    };
    struct Item {
        int q0, head, batch, kvhead, n_tiles;
    };
    auto item = [&](int w) {
        Item it;
        // unsigned: the signed form built to code that read 2-10 % slower at
        // every instance, though it runs only some 60 instructions an item
        // more; this kernel's time moves with its code layout (PERF.md, 6)
        const unsigned band = unsigned(w) / unsigned(band_items);
        const unsigned g = min(unsigned(p.band), unsigned(n_qtiles) - band * unsigned(p.band));  // the last band may have fewer q tiles
        const unsigned r = unsigned(w) - band * unsigned(band_items);
        const int bh = int(r / g);
        it.q0 = (n_qtiles - 1 - int(band) * p.band - int(r - unsigned(bh) * g)) * BM;
        it.batch = bh / p.h;
        it.head = bh - it.batch * p.h;
        it.kvhead = it.head / (p.h / p.kvh);
        it.n_tiles = (p.sk + BN - 1) / BN;  // KV tiles; under the causal mask none above the diagonal
        if (p.causal) it.n_tiles = min(it.n_tiles, (it.q0 + BM - 1) / BN + 1);
        return it;
    };

    if (threadIdx.x == 0) {
        mbar_init(full_q, 1);
        mbar_init(empty_q, 8);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full_k(s), 1);
            mbar_init(full_v(s), 1);
            mbar_init(empty_k(s), 8);  // one arrival from each consumer warp
            mbar_init(empty_v(s), 8);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // one role a warpgroup, warp-uniform as setmaxnreg needs it; the two
    // branches never meet again
    const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    if (role == 0) {
        // ---- producer ---------------------------------------------------------
        setmaxnreg_dec<24>();
        K1_MARKS_BEGIN
        if (threadIdx.x == 0) {
            tma_prefetch(&tm_q);
            tma_prefetch(&tm_k);
            tma_prefetch(&tm_v);
            int kv = 0;  // KV tiles loaded so far: its stage and phase
            for (int n = 0; number_of(n) < n_items; ++n) {
                const Item it = item(number_of(n));
                K1_MARK(3);
                mbar_wait(empty_q, (n & 1) ^ 1);  // the item before is done with Q
                K1_MARK(0);
                // a box's columns past the head dim are zero-filled and counted
                mbar_expect_tx(full_q, Cfg::kQBytes);
#pragma unroll
                for (int x = 0; x < QK_BOXES; ++x) {
                    tma_load_4d(sQ + x * BM * ROW, &tm_q, full_q, x * BOX, it.q0, it.head, it.batch);
                }
                K1_MARK(1);
                for (int j = 0; j < it.n_tiles; ++j, ++kv) {
                    const int s = kv % STAGES;
                    const uint32_t phase = (kv / STAGES) & 1;
                    K1_MARK(3);
                    mbar_wait(empty_k(s), phase ^ 1);
                    K1_MARK(2);
                    mbar_expect_tx(full_k(s), Cfg::kKBytes);
#pragma unroll
                    for (int x = 0; x < QK_BOXES; ++x) {
                        tma_load_4d(sK + s * Cfg::kKBytes + x * BN * ROW, &tm_k, full_k(s),
                                    x * BOX, j * BN, it.kvhead, it.batch);
                    }
                    K1_MARK(3);
                    mbar_wait(empty_v(s), phase ^ 1);
                    K1_MARK(2);
                    mbar_expect_tx(full_v(s), Cfg::kVBytes);
#pragma unroll
                    for (int x = 0; x < V_BOXES; ++x) {
                        tma_load_4d(sV + s * Cfg::kVBytes + x * BN * ROW, &tm_v, full_v(s),
                                    x * BOX, j * BN, it.kvhead, it.batch);
                    }
                }
            }
            K1_MARK(3);
        }
        K1_MARKS_END(0)
    } else {
        // ---- consumers ------------------------------------------------------------
        setmaxnreg_inc<240>();
        const int wg = role - 1;  // 0 or 1: q rows [q0 + 64 wg, q0 + 64 wg + 64) of an item
        const int t = threadIdx.x & 127;
        const int lane = t & 31;
        const int tq = lane & 3;  // accumulator column pair within each 8
        const int row0 = wg * 64 + (t >> 5) * 16 + (lane >> 2);  // and row0 + 8, from q0
        const uint32_t q_base = sQ + wg * 64 * ROW;

        // S = Q K^T of stage s: Q and K both K-major in shared memory, a
        // k-step 32 bytes of a box row (the leading offset is not read)
        auto issue_qk = [&](float (&acc)[BN / 2], int s) {
            constexpr int STEPS = BOX / 16;  // k-steps a box
#pragma unroll
            for (int kk = 0; kk < Cfg::kDQK / 16; ++kk) {
                const uint32_t qoff = (kk / STEPS) * BM * ROW + (kk % STEPS) * 32;
                const uint32_t koff = (kk / STEPS) * BN * ROW + (kk % STEPS) * 32;
                wgmma_ss(acc, swizzled_desc<ROW>(q_base + qoff, 16),
                         swizzled_desc<ROW>(sK + s * Cfg::kKBytes + koff, 16), kk > 0);
            }
            wgmma_commit();
        };
        // O += P V of stage s: P from registers, V MN-major in shared memory,
        // a k-step 16 rows; the leading offset steps from one box to the next
        auto issue_pv = [&](float (&acc)[DVP / 2], const uint32_t (&pf)[BN / 16][4], int s) {
#pragma unroll
            for (int ks = 0; ks < BN / 16; ++ks) {
                wgmma_rs(acc, pf[ks], swizzled_desc<ROW>(sV + s * Cfg::kVBytes + ks * 16 * ROW, BN * ROW));
            }
            wgmma_commit();
        };

        K1_MARKS_BEGIN
        int kv = 0;  // KV tiles consumed so far: its stage and phase
        for (int n = 0; number_of(n) < n_items; ++n) {
            const Item it = item(number_of(n));
            K1_MARK(0);
            if constexpr (LOAD_ONLY) {
                mbar_wait(full_q, n & 1);
                for (int j = 0; j < it.n_tiles; ++j) {
                    const int s = (kv + j) % STAGES;
                    const uint32_t phase = ((kv + j) / STAGES) & 1;
                    mbar_wait(full_k(s), phase);
                    if (lane == 0) {
                        mbar_arrive(empty_k(s));
                        if (j == it.n_tiles - 1) mbar_arrive(empty_q);
                    }
                    mbar_wait(full_v(s), phase);
                    if (lane == 0) mbar_arrive(empty_v(s));
                }
                kv += it.n_tiles;
                K1_MARK(2);
                continue;
            }
            const int wrow0 = it.q0 + wg * 64;
            const int row_a = it.q0 + row0;
            // keys past sk, or (causal) past this warpgroup's first row: mask
            auto masked = [&](int k0) { return k0 + BN > p.sk || (p.causal && k0 + BN - 1 > wrow0); };

            float oacc[DVP / 2];
#pragma unroll
            for (int i = 0; i < DVP / 2; ++i) oacc[i] = 0.f;
            OnlineSoftmax sm(p.scale * kLog2e);
            float sacc[BN / 2];
            uint32_t pf[BN / 16][4];  // P of the tile before, in bf16

            // S_j = Q K_j^T and O += P_{j-1} V_{j-1} are in flight together:
            // the softmax of S_j runs while the tensor cores do the P V product
            // of the tile before (intra-warpgroup overlap), and the other
            // consumer's products fill in where this one waits.
            mbar_wait(full_q, n & 1);
            {
                const int s = kv % STAGES;
                mbar_wait(full_k(s), (kv / STAGES) & 1);
                wgmma_fence();
                issue_qk(sacc, s);
                wgmma_wait<0>();
                fence_regs(sacc);
                if (lane == 0) {
                    mbar_arrive(empty_k(s));
                    if (it.n_tiles == 1) mbar_arrive(empty_q);  // Q is free for the next item
                }
                float alpha_a, alpha_b;  // the accumulator is still zero
                sm.tile<BN>(sacc, 0, p.sk, p.causal, row_a, tq, masked(0), alpha_a, alpha_b);
                pack_p(pf, sacc);
            }
            K1_MARK(1);
            for (int j = 1; j < it.n_tiles; ++j) {
                const int s = (kv + j) % STAGES;
                const int sp = (kv + j - 1) % STAGES;
                K1_MARK(3);
                mbar_wait(full_k(s), ((kv + j) / STAGES) & 1);
                mbar_wait(full_v(sp), ((kv + j - 1) / STAGES) & 1);
                K1_MARK(2);
                wgmma_fence();
                issue_qk(sacc, s);
                issue_pv(oacc, pf, sp);
                wgmma_wait<1>();  // S_j has landed; P_{j-1} V_{j-1} may still run
                fence_regs(sacc);
                if (lane == 0) {
                    mbar_arrive(empty_k(s));
                    if (j == it.n_tiles - 1) mbar_arrive(empty_q);
                }
                float alpha_a, alpha_b;
                sm.tile<BN>(sacc, j * BN, p.sk, p.causal, row_a, tq, masked(j * BN), alpha_a, alpha_b);
                wgmma_wait<0>();
                fence_regs(oacc);
                fence_regs(pf);
                if (lane == 0) mbar_arrive(empty_v(sp));
                rescale(oacc, alpha_a, alpha_b);
                pack_p(pf, sacc);
            }
            K1_MARK(3);
            const int sl = (kv + it.n_tiles - 1) % STAGES;
            mbar_wait(full_v(sl), ((kv + it.n_tiles - 1) / STAGES) & 1);
            K1_MARK(2);
            wgmma_fence();
            issue_pv(oacc, pf, sl);
            wgmma_wait<0>();
            fence_regs(oacc);
            fence_regs(pf);
            if (lane == 0) mbar_arrive(empty_v(sl));
            kv += it.n_tiles;
            K1_MARK(4);

            // ---- epilogue: o / max(l, 1e-30) in bf16 (p.dv columns), lse ---------
            float l_a = sm.l_a, l_b = sm.l_b;
            const int row_b = row_a + 8;
            l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
            l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
            l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
            l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
            const float den_a = fmaxf(l_a, 1e-30f);
            const float den_b = fmaxf(l_b, 1e-30f);
            const float inv_a = 1.f / den_a;
            const float inv_b = 1.f / den_b;
            __nv_bfloat16* gO =
                static_cast<__nv_bfloat16*>(p.o) + it.batch * p.o_sb + it.head * p.o_sh;
            float* lse = p.lse + ((long long)it.batch * p.h + it.head) * p.sq;
            if (row_a < p.sq) {
                __nv_bfloat16* orow = gO + (long long)row_a * p.o_ss + tq * 2;
#pragma unroll
                for (int c = 0; c < DVP / 8; ++c) {
                    if (c * 8 < p.dv) {
                        *reinterpret_cast<__nv_bfloat162*>(orow + c * 8) =
                            __floats2bfloat162_rn(oacc[4 * c] * inv_a, oacc[4 * c + 1] * inv_a);
                    }
                }
                if (tq == 0) lse[row_a] = sm.m_a * p.scale + logf(den_a);
            }
            if (row_b < p.sq) {
                __nv_bfloat16* orow = gO + (long long)row_b * p.o_ss + tq * 2;
#pragma unroll
                for (int c = 0; c < DVP / 8; ++c) {
                    if (c * 8 < p.dv) {
                        *reinterpret_cast<__nv_bfloat162*>(orow + c * 8) =
                            __floats2bfloat162_rn(oacc[4 * c + 2] * inv_b, oacc[4 * c + 3] * inv_b);
                    }
                }
                if (tq == 0) lse[row_b] = sm.m_b * p.scale + logf(den_b);
            }
            K1_MARK(5);
        }
        K1_MARKS_END(1 + wg)
    }
}

// ---------------------------------------------------------------------------
// f32: full-precision FMAs on the CUDA cores.  256 threads as 16 x 16; thread
// (ty, tx) owns q rows ty + 16 i, keys tx + 16 j and output columns tx + 16 c.
// Q and K rows are DQK wide, V and output rows DV wide.
// ---------------------------------------------------------------------------

constexpr int kF32Block = 64;  // q rows per block and keys per tile

template <int DQK, int DV>
constexpr int f32_smem_bytes() {
    return (2 * kF32Block * (DQK + 1) + kF32Block * (DV + 1) + kF32Block * (kF32Block + 1)) * 4;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(256) flash_fwd_f32(const Params p) {
    constexpr int BM = kF32Block;
    constexpr int BN = kF32Block;
    constexpr int LDQ = DQK + 1;  // odd stride: conflict-free column walks
    constexpr int LDV = DV + 1;
    constexpr int LDP = BN + 1;
    constexpr int DC = DV / 16;  // output columns per thread
    constexpr int R = BM / 16;   // q rows per thread
    constexpr int C = BN / 16;   // keys per thread

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* sQ = reinterpret_cast<float*>(smem_raw);
    float* sK = sQ + BM * LDQ;
    float* sV = sK + BN * LDQ;
    float* sP = sV + BN * LDV;

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

    // 64 rows of `padded` elements, rows `ld` apart in shared memory: the
    // first `width` of each row from memory, the rest and rows past `limit`
    // zeros
    auto load_rows = [&](float* dst, const float* src, long long stride, int row0, int limit,
                         int width, int padded, int ld) {
        for (int idx = tid; idx < BM * padded; idx += 256) {
            const int r = idx / padded;
            const int c = idx - r * padded;
            const int grow = row0 + r;
            dst[r * ld + c] = (grow < limit && c < width) ? src[(long long)grow * stride + c] : 0.f;
        }
    };

    int n_tiles = (p.sk + BN - 1) / BN;
    if (p.causal) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);

    load_rows(sQ, gQ, p.q_ss, q0, p.sq, p.dqk, DQK, LDQ);

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
        load_rows(sK, gK, p.k_ss, k0, p.sk, p.dqk, DQK, LDQ);
        load_rows(sV, gV, p.v_ss, k0, p.sk, p.dv, DV, LDV);
        __syncthreads();

        float s[R][C];
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
            for (int c = 0; c < C; ++c) s[i][c] = 0.f;
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
            for (int c = 0; c < DC; ++c) vv[c] = sV[kk * LDV + tx + 16 * c];
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
                if (tx + 16 * c < p.dv) gO[(long long)row * p.o_ss + tx + 16 * c] = oacc[i][c] / den;
            }
            if (tx == 0) lse[row] = m[i] + logf(den);
        }
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Return codes of the C entry besides cudaError_t: the path does not take
// this (dtype, d); libcuda has no cuTensorMapEncodeTiled; a tensor map
// could not be encoded for these pointers and strides; a bf16 head dim is
// not a multiple of 8 (the wrapper pads such widths).
constexpr int kErrNotBuilt = -1;
constexpr int kErrNoEncoder = -2;
constexpr int kErrTensorMap = -3;
constexpr int kErrWidth = -4;

// The instances built, by the (dqk, dv) of their template: the square widths
// 32, 64, 80, 96, 128 and 160, and MLA's (192, 128).  A call takes the
// smallest that holds both of its head dims (the true widths are the tensor
// maps' extents and the columns stored; TMA's zero fill pads the rest), so
// every dqk and dv up to 160 is taken, and a dqk up to 192 with a dv up to
// 128.  The square at 192 would leave a single K/V stage in shared memory.
// Returns the instance's dqk, 0 for none.  kernel.py's `kernel_instance` is
// the same table.
constexpr int kSquares[] = {32, 64, 80, 96, 128, 160};

int instance_of(int dqk, int dv) {
    if (dqk < 1 || dv < 1) return 0;
    const int w = dqk > dv ? dqk : dv;
    for (int sq : kSquares) {
        if (w <= sq) return sq;
    }
    return (dqk <= 192 && dv <= 128) ? 192 : 0;
}

// Path ids, as kernel.py names them: 0 "f32", 1 "wgmma".
int path_of(int dtype, int dqk, int dv) {
    if (instance_of(dqk, dv) == 0 || (dtype != 0 && dtype != 1)) return kErrNotBuilt;
    return dtype;
}

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

template <int DQK, int DV>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
    return launch(flash_fwd_f32<DQK, DV>, f32_smem_bytes<DQK, DV>(), 256, kF32Block, p, stream);
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

// The Hopper kernel's band: how many q tiles of one (batch, q head) are dealt
// out side by side.  With the q heads of a kv head neighbours in the order
// already, a band makes about kKVShare CTAs read the same K and V tiles at
// once.  kernel.py's `fwd_band` is the same rule.
int band_of(int h, int kvh, int sq) {
    const int n_qtiles = (sq + kHBlockM - 1) / kHBlockM;
    const int group = h / kvh;
    return min(n_qtiles, max(1, (kKVShare + group - 1) / group));
}

template <int DQK, int DV, bool LOAD_ONLY = K1_LOAD_ONLY>
int launch_hopper(Params p, cudaStream_t stream) {
    using Cfg = HopperCfg<DQK, DV>;
    static_assert(Cfg::kBox == 64 || Cfg::kBox == 32, "encode_map takes boxes of 64 and 32");
    const EncodeTiled encode = encoder();
    if (encode == nullptr) return kErrNoEncoder;
    constexpr int box = Cfg::kBox;
    CUtensorMap tm_q, tm_k, tm_v;
    if (!encode_map(encode, &tm_q, p.q, p.dqk, p.sq, p.h, p.b, p.q_ss, p.q_sh, p.q_sb, box, kHBlockM) ||
        !encode_map(encode, &tm_k, p.k, p.dqk, p.sk, p.kvh, p.b, p.k_ss, p.k_sh, p.k_sb, box, kHBlockN) ||
        !encode_map(encode, &tm_v, p.v, p.dv, p.sk, p.kvh, p.b, p.v_ss, p.v_sh, p.v_sb, box, kHBlockN)) {
        return kErrTensorMap;
    }
    constexpr int smem = Cfg::kSmem;
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_hopper<DQK, DV, LOAD_ONLY>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_qtiles = (p.sq + kHBlockM - 1) / kHBlockM;
    p.band = band_of(p.h, p.kvh, p.sq);
    const int n_items = n_qtiles * p.b * p.h;
    flash_fwd_hopper<DQK, DV, LOAD_ONLY><<<min(n_items, sms), kHThreads, smem, stream>>>(tm_q, tm_k, tm_v, p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Which kernel takes (dtype, qk head dim, v head dim): 0 the f32 kernel, 1
// the wgmma kernel, -1 none.  kernel.py's
// `kernel_path` is the same table; a card test holds the two together.
extern "C" int flash_attention_path_dqk_dv(int dtype, int dqk, int dv) {
    return path_of(dtype, dqk, dv);
}

// The same table for one head dim (dqk == dv).
extern "C" int flash_attention_path(int dtype, int d) { return path_of(dtype, d, d); }

// The Hopper kernel's band for h q heads over kvh kv heads and sq queries
// (`band_of`).  kernel.py's `fwd_band` is the same rule; a card test holds the
// two together.
extern "C" int flash_attention_fwd_band(int h, int kvh, int sq) { return band_of(h, kvh, sq); }

// The instance that takes (qk head dim, v head dim), by its template's dqk:
// 32, 64, 80, 96, 128, 160 (square) or 192 (with dv 128); 0 for none.
extern "C" int flash_attention_instance(int dqk, int dv) { return instance_of(dqk, dv); }

// Returns a cudaError_t as int (0 on success), -1 for head dims or a type
// that this file does not build, -2 when libcuda has no tensor-map
// encoder, -3 when a tensor map cannot be encoded for these pointers and
// strides, -4 for a bf16 head dim that is not a multiple of 8.  `dtype`: 0 = float32, 1 = bfloat16.  q and k rows are `dqk`
// wide, v and o rows `dv` wide.  Strides are in elements; the head dim must
// be contiguous, and for bf16 every row must start on a 16-byte boundary.
// Nothing is allocated and nothing synchronises: the launch goes onto
// `stream`.
extern "C" int flash_attention_fwd_dqk_dv(const void* q, const void* k, const void* v, void* o,
                                          float* lse, int dtype, int b, int h, int kvh, int sq,
                                          int sk, int dqk, int dv, const long long* strides,
                                          float scale, int causal, void* stream) {
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
    p.dqk = dqk;
    p.dv = dv;
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
    p.band = 1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int path = path_of(dtype, dqk, dv);
    if (path < 0) return kErrNotBuilt;
    if (path == 1) {
        if (dqk % 8 != 0 || dv % 8 != 0) return kErrWidth;
        switch (instance_of(dqk, dv)) {
            case 32: return launch_hopper<32, 32>(p, s);
            case 64: return launch_hopper<64, 64>(p, s);
            case 80: return launch_hopper<80, 80>(p, s);
            case 96: return launch_hopper<96, 96>(p, s);
            case 128: return launch_hopper<128, 128>(p, s);
            case 160: return launch_hopper<160, 160>(p, s);
            default: return launch_hopper<192, 128>(p, s);
        }
    }
    switch (instance_of(dqk, dv)) {
        case 32: return static_cast<int>(launch_f32<32, 32>(p, s));
        case 64: return static_cast<int>(launch_f32<64, 64>(p, s));
        case 80: return static_cast<int>(launch_f32<80, 80>(p, s));
        case 96: return static_cast<int>(launch_f32<96, 96>(p, s));
        case 128: return static_cast<int>(launch_f32<128, 128>(p, s));
        case 160: return static_cast<int>(launch_f32<160, 160>(p, s));
        default: return static_cast<int>(launch_f32<192, 128>(p, s));
    }
}

// The entry for one head dim (dqk == dv), kept with its signature for the
// callers that load an earlier source through it.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int dtype, int b, int h, int kvh, int sq,
                                   int sk, int d, const long long* strides, float scale,
                                   int causal, void* stream) {
    return flash_attention_fwd_dqk_dv(q, k, v, o, lse, dtype, b, h, kvh, sq, sk, d, d, strides,
                                      scale, causal, stream);
}
