// SCU barrier, notifier and self-signal for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the three TPU kernels of src/repro/kernels/scu_barrier/kernel.py:
//   K3 `scu_barrier_kernel`     (the `pl.pallas_call` at line 79; body `_barrier_body`, :45)
//   K4 `scu_notifier_kernel`    (:112; body `_notifier_body`, :94)
//   K5 `scu_self_signal_kernel` (:134; body `_self_signal_body`, :123)
//
// What changed against the TPU form.  There the parties are the devices of a
// mesh axis, joined by remote DMAs and their semaphores.  The paper's parties
// are processing elements that share one L1; on one H100 the closest analogue
// is thread blocks (CTAs) that share the card's L2.  So a party here is a CTA,
// a remote copy is a store to device memory, the semaphore signal a
// `st.release.gpu` of a flag word, and the restful wait (the SCU's `elw`) an
// `ld.acquire.gpu` poll that sleeps (`__nanosleep`) between polls.
//
// Flags carry an epoch that the wrapper increments every launch, so a flag
// left by an earlier launch never reads as set and back-to-back launches need
// no memset.  Every flag slot is written by one party once a launch.  A wait
// is bounded by `clock64()`: a party that never arrives ends in `__trap()`,
// which the next synchronize reports; nothing hangs and nothing is caught.
//
// K3, the dissemination barrier over n parties, one CTA a party.  Each party
// publishes its arrival words, then in round r = 0 .. ceil(log2 n) - 1 it
// releases the round-r flag of party (i + 2^r) mod n and acquires its own,
// which party (i - 2^r) mod n releases.  After the last round it has heard,
// through a chain of release/acquire pairs, from every party, so every
// published word is visible to it, and it sums the n words in party order:
// the count is exact for every n >= 1, and every party's result is the same
// sum in the same order.  (The Pallas body sums what it receives in
// floor(log2 n) rounds instead, which is the count only where n is a power
// of two.)  The n CTAs must all be resident at once, or a party waits on one
// that never runs: the launch is cooperative, which CUDA refuses when the
// grid does not fit on the card at once.
//
// K4, the notifier.  Every party other than `target` publishes its payload
// row and releases its flag; the target acquires the n - 1 flags and sums the
// rows in party order, the target's own row counted as zero; every other
// party's output is zero.  These are the semantics of `notifier` in
// src/repro/kernels/scu_barrier/ops.py:51.  Only the target waits, so the
// launch need not be cooperative: the other CTAs finish without waiting.
//
// K5, the self-signal: the SCU base unit's signal, restful wait, consume on
// one SM.  One CTA a tile of 4096 floats: one thread issues a bulk async copy
// (`cp.async.bulk`, the TMA's plain form) of the tile into shared memory,
// completed on an `mbarrier` armed with the byte count (`expect_tx`); the
// threads wait on the barrier's phase (`mbarrier.try_wait.parity`, the
// hardware's suspend-until-event wait), then write buf + 1.  A bulk copy
// takes a 16-byte-aligned address and a multiple of 16 bytes: the wrapper
// hands over an aligned tensor, and the last < 16 bytes of the tensor go by
// plain loads.
//
// What bounds them on an H100.  K3 and K4 move a few words: their floor is
// latency, ceil(log2 n) one-way flag hand-offs between two SMs through L2
// (K4: one) plus one kernel launch; `scu_pingpong` and `scu_empty` below
// measure both (scripts/bench_scu_barrier.py).  Each party's sum reads n
// words, n^2 in all, from L2.  K5 moves 8 bytes an element (read once,
// written once): bytes, at 3.35 TB/s.  The design keeps K3's and K4's waits
// to one thread a CTA and does the copies and sums with the CTA's warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPartyThreads = 32;  // K3, K4: one warp a party
constexpr int kTile = 4096;        // K5: floats a CTA, 16 KB of shared memory
constexpr int kTileThreads = 256;

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// The restful wait: poll with acquire, sleeping between polls (at most 256 ns).
__device__ __forceinline__ void wait_flag(const unsigned* p, unsigned epoch, long long limit) {
    if (ld_acquire(p) == epoch) return;
    const long long t0 = clock64();
    unsigned ns = 16;
    while (ld_acquire(p) != epoch) {
        __nanosleep(ns);
        if (ns < 256) ns <<= 1;
        if (clock64() - t0 > limit) __trap();  // a party never arrived
    }
}

__global__ void __launch_bounds__(kPartyThreads)
barrier_kernel(const float* __restrict__ arrive, float* __restrict__ out, float* words,
               unsigned* flags, int n, int m, int rounds, unsigned epoch, long long limit) {
    const int i = blockIdx.x;
    for (int k = threadIdx.x; k < m; k += blockDim.x)
        words[(size_t)i * m + k] = arrive[(size_t)i * m + k];
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();  // the warp's published words, before the first release
        for (int r = 0; r < rounds; ++r) {
            const int partner = (int)(((long long)i + (1LL << r)) % n);
            st_release(flags + (size_t)r * n + partner, epoch);
            wait_flag(flags + (size_t)r * n + i, epoch, limit);
        }
        __threadfence();
    }
    __syncthreads();
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
        float s = 0.f;
        for (int j = 0; j < n; ++j) s += __ldcg(words + (size_t)j * m + k);
        out[(size_t)i * m + k] = s;
    }
}

__global__ void __launch_bounds__(kPartyThreads)
notifier_kernel(const float* __restrict__ payload, float* __restrict__ out, float* slots,
                unsigned* flags, int n, int m, int target, unsigned epoch, long long limit) {
    const int i = blockIdx.x;
    if (i != target) {
        for (int k = threadIdx.x; k < m; k += blockDim.x)
            slots[(size_t)i * m + k] = payload[(size_t)i * m + k];
        __syncthreads();
        if (threadIdx.x == 0) {
            __threadfence();
            st_release(flags + i, epoch);
        }
        for (int k = threadIdx.x; k < m; k += blockDim.x) out[(size_t)i * m + k] = 0.f;
        return;
    }
    if (threadIdx.x == 0) {
        for (int j = 0; j < n; ++j)
            if (j != target) wait_flag(flags + j, epoch, limit);
        __threadfence();
    }
    __syncthreads();
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
        float s = 0.f;
        for (int j = 0; j < n; ++j) s += j == target ? 0.f : __ldcg(slots + (size_t)j * m + k);
        out[(size_t)i * m + k] = s;
    }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(kTileThreads)
self_signal_kernel(const float* __restrict__ x, float* __restrict__ out, long long total) {
    __shared__ alignas(16) float buf[kTile];
    __shared__ alignas(8) uint64_t bar;
    const long long start = (long long)blockIdx.x * kTile;
    const int len = (int)(total - start < kTile ? total - start : kTile);
    const int bulk_bytes = (len * 4) & ~15;  // the 16-byte multiple the bulk copy takes
    const uint32_t bar_addr = smem_addr(&bar);
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_addr) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        if (bulk_bytes > 0) {
            // signal: arm the barrier with the bytes to come, start the copy
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                         ::"r"(bar_addr), "r"(bulk_bytes) : "memory");
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                ::"r"(smem_addr(buf)), "l"(x + start), "r"(bulk_bytes), "r"(bar_addr) : "memory");
        } else {
            asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar_addr) : "memory");
        }
    }
    for (int k = bulk_bytes / 4 + threadIdx.x; k < len; k += blockDim.x) buf[k] = x[start + k];
    // restful wait: suspend until the barrier's phase 0 completes
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(bar_addr) : "memory");
    }
    __syncthreads();  // the tail's plain stores
    for (int k = threadIdx.x; k < len; k += blockDim.x) out[start + k] = buf[k] + 1.f;  // consume
}

// Measurement only (scripts/bench_scu_barrier.py, chip_smoke.py): two CTAs pass a
// flag back and forth `iters` times with K3's release, acquire and wait.
__global__ void pingpong_kernel(unsigned* flags, int iters, long long limit) {
    if (threadIdx.x != 0) return;
    unsigned* ping = flags;
    unsigned* pong = flags + 32;  // another 128-byte line
    for (int k = 1; k <= iters; ++k) {
        if (blockIdx.x == 0) {
            st_release(ping, (unsigned)k);
            wait_flag(pong, (unsigned)k, limit);
        } else {
            wait_flag(ping, (unsigned)k, limit);
            st_release(pong, (unsigned)k);
        }
    }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" const char* scu_error_name(int err) { return cudaGetErrorName((cudaError_t)err); }

static int launch_error(cudaError_t err) {
    if (err != cudaSuccess) {
        cudaGetLastError();  // the launch was refused and nothing ran: clear the error it left
        return (int)err;
    }
    return (int)cudaGetLastError();
}

// Largest n that K3 can take: CTAs of one warp that fit on the card at once.
extern "C" int scu_barrier_max_parties(int* out) {
    int dev = 0, sms = 0, per_sm = 0, coop = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, barrier_kernel, kPartyThreads, 0);
    *out = coop ? sms * per_sm : 0;
    return (int)err;
}

extern "C" int scu_barrier(const float* arrive, float* out, float* words, unsigned* flags, int n,
                           int m, unsigned epoch, long long limit, void* stream) {
    if (n < 1 || m < 1) return (int)cudaErrorInvalidValue;
    int rounds = 0;
    while ((1LL << rounds) < n) ++rounds;
    void* args[] = {&arrive, &out, &words, &flags, &n, &m, &rounds, &epoch, &limit};
    return launch_error(cudaLaunchCooperativeKernel((const void*)barrier_kernel, dim3(n),
                                                    dim3(kPartyThreads), args, 0,
                                                    (cudaStream_t)stream));
}

extern "C" int scu_notifier(const float* payload, float* out, float* slots, unsigned* flags, int n,
                            int m, int target, unsigned epoch, long long limit, void* stream) {
    if (n < 1 || m < 1 || target < 0 || target >= n) return (int)cudaErrorInvalidValue;
    notifier_kernel<<<n, kPartyThreads, 0, (cudaStream_t)stream>>>(payload, out, slots, flags, n, m,
                                                                  target, epoch, limit);
    return (int)cudaGetLastError();
}

extern "C" int scu_self_signal(const float* x, float* out, long long total, void* stream) {
    if (total < 1) return (int)cudaErrorInvalidValue;
    const long long blocks = (total + kTile - 1) / kTile;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    self_signal_kernel<<<(unsigned)blocks, kTileThreads, 0, (cudaStream_t)stream>>>(x, out, total);
    return (int)cudaGetLastError();
}

extern "C" int scu_pingpong(unsigned* flags, int iters, long long limit, void* stream) {
    void* args[] = {&flags, &iters, &limit};
    return launch_error(cudaLaunchCooperativeKernel((const void*)pingpong_kernel, dim3(2),
                                                    dim3(kPartyThreads), args, 0,
                                                    (cudaStream_t)stream));
}

// The launch K3 pays, with nothing in it: a cooperative grid of n one-warp CTAs.
extern "C" int scu_empty(int n, void* stream) {
    return launch_error(cudaLaunchCooperativeKernel((const void*)empty_kernel, dim3(n),
                                                    dim3(kPartyThreads), nullptr, 0,
                                                    (cudaStream_t)stream));
}
