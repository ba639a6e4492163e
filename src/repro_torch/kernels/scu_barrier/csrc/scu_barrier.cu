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
// K3 has two forms; the wrapper picks one from the shapes alone
// (`barrier_form` in kernel.py), and a launch that fails raises in either.
//
// K3, cluster form (n <= the cluster limit, a row of at most kClusterRowCap
// words).  Hopper's thread-block cluster is the nearest thing on this card to
// the SCU's cores sharing one L1: up to 8 CTAs (16 where the card allows a
// non-portable size) that the hardware schedules together, that read each
// other's shared memory (distributed shared memory, DSMEM) and that meet at a
// hardware barrier.  One cluster of n one-warp CTAs, launched with
// `cudaLaunchKernelEx` and a cluster dimension of {n, 1, 1}, not
// cooperatively.  Each party stages its arrival row in its own shared memory,
// meets the others at `barrier.cluster.arrive.release` /
// `barrier.cluster.wait.acquire`, sums column k over the parties j = 0 .. n-1
// in party order, reading party j's row through `mapa` +
// `ld.shared::cluster`, writes its row, and meets the others once more so no
// CTA exits while another still reads its shared memory.  No flags, no
// epoch, no workspace.
//
// K3, dissemination form (every other n up to the resident limit, and rows
// wider than the cluster form's cap).  Each party publishes its arrival
// words, then in round r = 0 .. ceil(log2 n) - 1 it releases the round-r flag
// of party (i + 2^r) mod n and acquires its own, which party (i - 2^r) mod n
// releases.  After the last round it has heard, through a chain of
// release/acquire pairs, from every party, so every published word is
// visible to it, and it sums the n words: the count is exact for every
// n >= 1.  (The Pallas body sums what it receives in floor(log2 n) rounds
// instead, which is the count only where n is a power of two.)  The n CTAs
// must all be resident at once, or a party waits on one that never runs: the
// launch is cooperative, which CUDA refuses when the grid does not fit on
// the card at once.  The release sum issues its loads kBatch ahead of its
// adds, so a thread has kBatch L2 reads in flight instead of one.
//
// The order of K3's sums.  Cluster form, and dissemination form with rows of
// 32 words or more: column k is summed over j = 0 .. n-1 in party order, one
// thread a column.  Dissemination form with rows of fewer than 32 words:
// lane l sums the parties j = l, l + 32, l + 64, ... in that order, and the
// 32 lane sums are combined by a fixed `__shfl_xor_sync` butterfly (strides
// 16, 8, 4, 2, 1).  Each step adds a lane's value and its partner's, which
// float addition gives the same bits in either order, so every lane, and
// every party, ends with the same bits.  Either way every party's row is the
// same sum in the same order, and on integer-valued words it is the exact
// count.  The two forms may differ from each other in the last bit on other
// words.
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
// Its body reaches 93 % of its bytes bound at 2^20 floats on an H100; what
// it lost to one `x + 1` at the barrier sweep's 8 floats was all the
// wrapper's host time, which the launch path below and in kernel.py cuts.
//
// What bounds them on an H100.  K3 and K4 move a few words: their floor is
// latency.  For the cluster form, one cluster launch and two hardware
// barriers; for the dissemination form, ceil(log2 n) one-way flag hand-offs
// between two SMs through L2 (K4: one) plus one cooperative launch.
// `scu_pingpong`, `scu_empty` and `scu_cluster_floor` below measure those
// floors (scripts/bench_scu_barrier.py).  Each party's sum reads n words,
// n^2 in all.  K5 moves 8 bytes an element (read once, written once):
// bytes, at 3.35 TB/s.  The design keeps K3's and K4's waits to one thread
// a CTA and does the copies and sums with the CTA's warp.
//
// The launch path.  Every entry takes the caller's device index and raw
// stream.  It makes that device current only where it is not already, and
// puts the old one back after the launch (`DeviceGuard`), so the wrapper
// needs no device context of its own; it returns the launch's error code,
// which the wrapper raises on.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kPartyThreads = 32;       // K3, K4: one warp a party
constexpr int kBatch = 8;               // K3's sums: loads in flight a thread
constexpr int kPortableCluster = 8;     // CTAs a cluster on every Hopper card
constexpr int kNonPortableCluster = 16; // where the card allows it
constexpr int kClusterRowCap = 12288;   // K3 cluster form: words a party, 48 KB of shared memory
constexpr int kTile = 4096;             // K5: floats a CTA, 16 KB of shared memory
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The cluster's hardware barrier: every thread of every CTA of the cluster
// arrives (release at cluster scope) and waits (acquire at cluster scope).
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}

// A float of CTA `rank`'s shared memory, at the address `local` has in ours.
__device__ __forceinline__ float ld_cluster(uint32_t local, uint32_t rank) {
    uint32_t remote;
    float v;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
    asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(remote) : "memory");
    return v;
}

// The sum of load(j) over j = first, first + step, ... < n, added in that
// order; the loads are issued kBatch at a time, ahead of their adds, so a
// thread keeps kBatch reads in flight without changing the order of the sum.
template <typename Load>
__device__ __forceinline__ float sum_in_order(Load load, int first, int step, int n) {
    float s = 0.f;
    for (int j0 = first; j0 < n; j0 += kBatch * step) {
        float v[kBatch];
#pragma unroll
        for (int t = 0; t < kBatch; ++t) v[t] = j0 + t * step < n ? load(j0 + t * step) : 0.f;
#pragma unroll
        for (int t = 0; t < kBatch; ++t)
            if (j0 + t * step < n) s += v[t];
    }
    return s;
}

// K3, cluster form: the grid is one cluster of n one-warp CTAs.
__global__ void __launch_bounds__(kPartyThreads)
barrier_cluster_kernel(const float* __restrict__ arrive, float* __restrict__ out, int n, int m) {
    extern __shared__ float row[];  // this party's arrival row, m words
    const uint32_t i = cluster_rank();
    for (int k = threadIdx.x; k < m; k += kPartyThreads) row[k] = arrive[(size_t)i * m + k];
    cluster_sync();  // every party's row staged, and visible to every party
    for (int k = threadIdx.x; k < m; k += kPartyThreads) {
        const uint32_t local = smem_addr(row + k);
        out[(size_t)i * m + k] = sum_in_order([&](int j) { return ld_cluster(local, (uint32_t)j); }, 0, 1, n);
    }
    cluster_sync();  // no party exits while another still reads its row
}

// K3, dissemination form.
__global__ void __launch_bounds__(kPartyThreads)
barrier_kernel(const float* __restrict__ arrive, float* __restrict__ out, float* words,
               unsigned* flags, int n, int m, int rounds, unsigned epoch, long long limit) {
    const int i = blockIdx.x;
    const int lane = threadIdx.x;
    for (int k = lane; k < m; k += kPartyThreads) words[(size_t)i * m + k] = arrive[(size_t)i * m + k];
    __syncthreads();
    if (lane == 0) {
        __threadfence();  // the warp's published words, before the first release
        for (int r = 0; r < rounds; ++r) {
            const int partner = (int)(((long long)i + (1LL << r)) % n);
            st_release(flags + (size_t)r * n + partner, epoch);
            wait_flag(flags + (size_t)r * n + i, epoch, limit);
        }
        __threadfence();
    }
    __syncthreads();
    if (m >= kPartyThreads) {  // a lane a column, the parties in order
        for (int k = lane; k < m; k += kPartyThreads)
            out[(size_t)i * m + k] =
                sum_in_order([&](int j) { return __ldcg(words + (size_t)j * m + k); }, 0, 1, n);
        return;
    }
    for (int k = 0; k < m; ++k) {  // lane l: the parties l, l + 32, ..., then a butterfly
        float s = sum_in_order([&](int j) { return __ldcg(words + (size_t)j * m + k); }, lane,
                               kPartyThreads, n);
#pragma unroll
        for (int d = kPartyThreads / 2; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
        if (lane == 0) out[(size_t)i * m + k] = s;
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

// Measurement only: the cluster form's floor, a cluster of one-warp CTAs that
// meets `syncs` times at the hardware barrier and does nothing else.
__global__ void __launch_bounds__(kPartyThreads) cluster_floor_kernel(int syncs) {
    for (int k = 0; k < syncs; ++k) cluster_sync();
}

// Makes `device` current for the guard's life, where it is not already.
class DeviceGuard {
  public:
    explicit DeviceGuard(int device) {
        int current = 0;
        err_ = cudaGetDevice(&current);
        if (err_ == cudaSuccess && current != device) {
            err_ = cudaSetDevice(device);
            if (err_ == cudaSuccess) previous_ = current;
        }
    }
    ~DeviceGuard() {
        if (previous_ >= 0) cudaSetDevice(previous_);
    }
    int error() const { return (int)err_; }

  private:
    cudaError_t err_;
    int previous_ = -1;
};

int launch_error(cudaError_t err) {
    if (err != cudaSuccess) {
        cudaGetLastError();  // the launch was refused and nothing ran: clear the error it left
        return (int)err;
    }
    return (int)cudaGetLastError();
}

// The launch of one cluster of n one-warp CTAs: the grid is the cluster.
class ClusterLaunch {
  public:
    ClusterLaunch(int n, size_t smem, void* stream) {
        attr_.id = cudaLaunchAttributeClusterDimension;
        attr_.val.clusterDim.x = (unsigned)n;
        attr_.val.clusterDim.y = 1;
        attr_.val.clusterDim.z = 1;
        config_.gridDim = dim3(n);
        config_.blockDim = dim3(kPartyThreads);
        config_.dynamicSmemBytes = smem;
        config_.stream = (cudaStream_t)stream;
        config_.attrs = &attr_;
        config_.numAttrs = 1;
    }
    ClusterLaunch(const ClusterLaunch&) = delete;  // config_ points into the object
    ClusterLaunch& operator=(const ClusterLaunch&) = delete;

    const cudaLaunchConfig_t* config() const { return &config_; }

    template <typename... Expected, typename... Actual>
    cudaError_t operator()(void (*kernel)(Expected...), Actual&&... args) const {
        return cudaLaunchKernelEx(&config_, kernel, std::forward<Actual>(args)...);
    }

  private:
    cudaLaunchAttribute attr_ = {};
    cudaLaunchConfig_t config_ = {};
};

}  // namespace

extern "C" const char* scu_error_name(int err) { return cudaGetErrorName((cudaError_t)err); }

// Largest n that K3's dissemination form can take: one-warp CTAs that fit on
// the card at once.
extern "C" int scu_barrier_max_parties(int device, int* out) {
    DeviceGuard guard(device);
    if (guard.error()) return guard.error();
    int sms = 0, per_sm = 0, coop = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, barrier_kernel, kPartyThreads, 0);
    *out = coop ? sms * per_sm : 0;
    return (int)err;
}

// Largest n that K3's cluster form takes on this card: 16 where the card lets
// a kernel ask for a non-portable cluster size and can hold one such cluster
// of one-warp CTAs with a full row each, else the portable 8 (0 where the
// card has no cluster launch).  Also the row cap of that form.
extern "C" int scu_barrier_cluster_limit(int device, int* parties, int* row_cap) {
    DeviceGuard guard(device);
    if (guard.error()) return guard.error();
    *row_cap = kClusterRowCap;
    int can = 0;
    cudaError_t err = cudaDeviceGetAttribute(&can, cudaDevAttrClusterLaunch, device);
    *parties = can ? kPortableCluster : 0;
    if (err != cudaSuccess || !can) return (int)err;
    err = cudaFuncSetAttribute(barrier_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(cluster_floor_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    const ClusterLaunch probe(kNonPortableCluster, kClusterRowCap * sizeof(float), nullptr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)barrier_cluster_kernel, probe.config());
    if (err == cudaSuccess && clusters >= 1) *parties = kNonPortableCluster;
    return (int)err;
}

extern "C" int scu_barrier_cluster(const float* arrive, float* out, int n, int m, int device, void* stream) {
    if (n < 1 || n > kNonPortableCluster || m < 1 || m > kClusterRowCap) return (int)cudaErrorInvalidValue;
    DeviceGuard guard(device);
    if (guard.error()) return guard.error();
    const ClusterLaunch launch(n, (size_t)m * sizeof(float), stream);
    return launch_error(launch(barrier_cluster_kernel, arrive, out, n, m));
}

extern "C" int scu_barrier(const float* arrive, float* out, float* words, unsigned* flags, int n,
                           int m, unsigned epoch, long long limit, int device, void* stream) {
    if (n < 1 || m < 1) return (int)cudaErrorInvalidValue;
    DeviceGuard guard(device);
    if (guard.error()) return guard.error();
    int rounds = 0;
    while ((1LL << rounds) < n) ++rounds;
    void* args[] = {&arrive, &out, &words, &flags, &n, &m, &rounds, &epoch, &limit};
    return launch_error(cudaLaunchCooperativeKernel((const void*)barrier_kernel, dim3(n),
                                                    dim3(kPartyThreads), args, 0,
                                                    (cudaStream_t)stream));
}

extern "C" int scu_notifier(const float* payload, float* out, float* slots, unsigned* flags, int n,
                            int m, int target, unsigned epoch, long long limit, int device,
                            void* stream) {
    if (n < 1 || m < 1 || target < 0 || target >= n) return (int)cudaErrorInvalidValue;
    DeviceGuard guard(device);
    if (guard.error()) return guard.error();
    notifier_kernel<<<n, kPartyThreads, 0, (cudaStream_t)stream>>>(payload, out, slots, flags, n, m,
                                                                  target, epoch, limit);
    return (int)cudaGetLastError();
}

extern "C" int scu_self_signal(const float* x, float* out, long long total, int device, void* stream) {
    if (total < 1) return (int)cudaErrorInvalidValue;
    const long long blocks = (total + kTile - 1) / kTile;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    DeviceGuard guard(device);
    if (guard.error()) return guard.error();
    self_signal_kernel<<<(unsigned)blocks, kTileThreads, 0, (cudaStream_t)stream>>>(x, out, total);
    return (int)cudaGetLastError();
}

extern "C" int scu_pingpong(unsigned* flags, int iters, long long limit, int device, void* stream) {
    DeviceGuard guard(device);
    if (guard.error()) return guard.error();
    void* args[] = {&flags, &iters, &limit};
    return launch_error(cudaLaunchCooperativeKernel((const void*)pingpong_kernel, dim3(2),
                                                    dim3(kPartyThreads), args, 0,
                                                    (cudaStream_t)stream));
}

// The launch the dissemination form pays, with nothing in it: a cooperative
// grid of n one-warp CTAs.
extern "C" int scu_empty(int n, int device, void* stream) {
    DeviceGuard guard(device);
    if (guard.error()) return guard.error();
    return launch_error(cudaLaunchCooperativeKernel((const void*)empty_kernel, dim3(n),
                                                    dim3(kPartyThreads), nullptr, 0,
                                                    (cudaStream_t)stream));
}

// The cluster form's floor: one cluster of n one-warp CTAs that meets `syncs`
// times at the hardware barrier (0: an empty cluster launch).
extern "C" int scu_cluster_floor(int n, int syncs, int device, void* stream) {
    if (n < 1 || n > kNonPortableCluster) return (int)cudaErrorInvalidValue;
    DeviceGuard guard(device);
    if (guard.error()) return guard.error();
    const ClusterLaunch launch(n, 0, stream);
    return launch_error(launch(cluster_floor_kernel, syncs));
}
