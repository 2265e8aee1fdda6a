// RG-LRU linear recurrence — the Hopper counterpart of the TPU kernel
// src/repro/kernels/rglru_scan/kernel.py::rglru_scan (Pallas).
//
// What it computes: h_t = a_t * h_{t-1} + b_t over time, elementwise over
// the channels, seeded by h0; a, b and h are (B, S, D) f32, h0 is (B, D),
// every h_t is written.  Each step is one fused multiply-add rounded once
// (__fmaf_rn), which is what the JAX package's scans compute on its CPU
// backend (XLA contracts a * h + b) and what the plain versions in
// ../ref.py compute, so the kernel equals the sequential plain version
// bit for bit.  Any S >= 1 and any D: no tile has to divide them.
//
// Design: one thread per (batch, channel), neighbouring threads on
// neighbouring channels, walking time; the carry is one register (the TPU
// kernel's VMEM carry across time tiles).  The recurrence is serial in
// time, but the loads of a_t and b_t do not depend on h, so each thread
// keeps STAGES - 1 stages of STEPS time steps of its own channel in flight
// with cp.async into shared memory while it runs the current stage.  A
// thread reads back only what it copied itself, so no barrier is needed;
// the per-thread wait on the oldest copy group is enough.
//
// What bounds it on this card: bytes.  a and b are read once and h
// written once (12 bytes a step and channel) for 2 FLOPs: far under the
// ridge.  At the recurrentgemma-2b prefill shape (B 8, S 512, D 2560)
// 20,480 threads keep 2 * (STAGES - 1) * STEPS loads each in flight,
// ~3.9 MB across the card: more than its bandwidth-latency product.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int THREADS = 64;
constexpr int STEPS = 8;   // time steps a stage
constexpr int STAGES = 4;  // stages in flight, the current one included

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src));
}

__device__ __forceinline__ void commit_group() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_oldest_group() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 1));
}

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  int64_t S, int64_t D) {
    __shared__ float sa[STAGES][STEPS][THREADS];
    __shared__ float sb[STAGES][STEPS][THREADS];
    const int tid = threadIdx.x;
    const int64_t d = (int64_t)blockIdx.x * THREADS + tid;
    if (d >= D) return;
    const int64_t off = (int64_t)blockIdx.y * S * D + d;
    const float* ap = a + off;
    const float* bp = b + off;
    float* hp = h + off;
    const int64_t n_stages = (S + STEPS - 1) / STEPS;

    // stage c's steps into buffer c % STAGES; an empty group past the end
    // keeps the count of groups the wait counts on uniform
    auto issue = [&](int64_t c) {
        if (c < n_stages) {
            const int buf = (int)(c % STAGES);
#pragma unroll
            for (int u = 0; u < STEPS; ++u) {
                const int64_t t = c * STEPS + u;
                if (t < S) {
                    copy_async4(&sa[buf][u][tid], ap + t * D);
                    copy_async4(&sb[buf][u][tid], bp + t * D);
                }
            }
        }
        commit_group();
    };

    for (int c = 0; c < STAGES - 1; ++c) issue(c);
    float hv = h0[(int64_t)blockIdx.y * D + d];
    for (int64_t c = 0; c < n_stages; ++c) {
        // refills the buffer stage c - 1 used: this thread read it already
        issue(c + STAGES - 1);
        wait_oldest_group();  // stage c has landed
        const int buf = (int)(c % STAGES);
        const int64_t t0 = c * STEPS;
#pragma unroll
        for (int u = 0; u < STEPS; ++u) {
            if (t0 + u < S) {
                hv = __fmaf_rn(sa[buf][u][tid], hv, sb[buf][u][tid]);
                hp[(t0 + u) * D] = hv;
            }
        }
    }
}

// a, b, h: contiguous (B, S, D) f32; h0: contiguous (B, D) f32.  Returns
// the CUDA error of the launch (0 = launched), or -1 for an empty or
// oversized problem (B must fit the grid's y dimension).
extern "C" int rglru_scan_launch(const float* a, const float* b,
                                 const float* h0, float* h, int64_t B,
                                 int64_t S, int64_t D, void* stream) {
    if (B < 1 || S < 1 || D < 1 || B > 65535) return -1;
    const dim3 grid((unsigned)((D + THREADS - 1) / THREADS), (unsigned)B);
    rglru_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        a, b, h0, h, S, D);
    return (int)cudaGetLastError();
}
