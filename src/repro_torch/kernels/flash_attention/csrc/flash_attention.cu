// Flash attention forward: online softmax over KV tiles — the Hopper
// counterpart of the TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_3d (Pallas).
//
// What it computes: for every (batch, query head) and query row,
// softmax(q k^T * scale + mask) v with scale = 1/sqrt(hd), f32 inside,
// output in q's type.  Masks, as in the TPU kernel: causal k_pos <= q_pos,
// window k_pos > q_pos - window, masked logits -1e30 (not -inf).  GQA:
// query head hq reads kv head hq / G with G = Hq / Hkv (the TPU wrapper's
// flattening (b*Hq + hq) / G is the same head).  Ragged Sq and Skv are
// masked here, not asserted: keys past Skv take no part in the softmax
// (p = 0), query rows past Sq are not stored.
//
// Tile skipping (both kernels): a KV tile wholly above the causal diagonal
// or wholly before every row's window is not visited.  For a row with at
// least one live key this changes nothing (the TPU kernel accumulates
// exp(-1e30 - m) = 0 there, or junk under m = -1e30 that the first live
// tile's alpha = 0 wipes out).  A row with no live key at all (window > 0
// and q_pos - window + 1 > Skv - 1, possible only when Sq > Skv) gets the
// TPU kernel's uniform average over all keys: a block holding such a row
// visits every tile.
//
// Two kernels, picked by the inputs' type (flash_attention_launch):
//
// * bf16 (the serving paths): flash_tc_kernel, on the tensor cores.  One
//   block per (b*Hq + hq, 64 * NC query rows): a producer warpgroup (one
//   thread issues every copy) and NC consumer warpgroups of 64 query rows
//   each, NC = 2 (384 threads) at hd 16-128 and 1 (256 threads) at hd 256.
//   The Q tile comes once, K and V tiles of 64 keys through a ring of 2
//   (hd 256) or 3 stages, all by TMA (cp.async.bulk.tensor on 4-D maps
//   (hd, H, S, B) of the (B, S, H, hd) tensors, built per call with
//   cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so the
//   library needs no -lcuda), with full and empty mbarriers per stage.
//   S = Q K^T is wgmma m64n64k16 (both operands in shared memory, K-major,
//   128-byte swizzle; 32-byte at hd 16, whose rows are 32 bytes), f32
//   accumulators.  The online softmax runs on the accumulator fragment:
//   the scale is applied to the f32 S accumulators with log2(e) folded in
//   (bf16 q cannot be scaled before the product without another rounding:
//   the one difference from the TPU kernel's order), row max by quad
//   shuffles, ex2.approx (one MUFU instruction), row sums kept per thread
//   and reduced once at the end.
//   P is rounded to bf16 in registers and is the register A operand of
//   O += P V (wgmma with V from shared memory, transposed: V's head dim is
//   contiguous); P never goes through shared memory.  Masks are applied
//   only on tiles that straddle the diagonal, the window's edge or Skv
//   (keys past Skv get -inf: TMA fills them with zeros); a consumer skips
//   the tiles with no live key for any of its rows.  The heaviest query
//   tiles (the last ones, under causal) are launched first.  Registers:
//   O is hd/2 f32 a thread beside 32 of S: 126 at hd 128; hd 256 runs one
//   consumer warpgroup (192, see NC256).  What bounds it: the minimum is
//   the bytes (q, k, v, o once: ~0.015 ms at qwen3-1.7b's prefill against
//   ~0.009 of operations), but each block reads its K and V tiles again,
//   ~98 MB through L2 at that shape; timed with the products or the
//   softmax taken out, the copies alone take ~60 % of the kernel and the
//   softmax most of the rest (PERF.md).
//
// * f32 (tests and the plain-version checks, not the serving paths):
//   flash_kernel, the SIMT kernel, at one tile (64 query rows, 32 keys).
//   Tensor cores in bf16 or TF32 cannot hold f32's 2e-5 bound, so every
//   product is an f32 FMA.  One block of 128 threads per (b*Hq + hq, 64
//   query rows) stages its query tile (scaled before the product, as the
//   TPU kernel does; transposed) once, then walks the KV tiles in order,
//   as the TPU grid walks its innermost axis: each tile staged in shared
//   memory (K transposed, V row-major), S = Q K^T in registers (thread
//   (r, c) = (tid / 8, tid % 8) owns rows r + 16 i and keys c + 8 j), the
//   running max, denominator and accumulator (rows r + 16 i, head dims
//   c + 8 jd) in registers, P through shared memory for P V.  Bound by
//   operations at the f32 SIMT rate.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define NEG_INF (-1e30f)

struct FlashArgs {
    const void* q;   // element (b, s, h, d) at b*q_sb + s*q_ss + h*q_sh + d
    const void* k;
    const void* v;
    void* o;         // same layout rule as q, with o_* strides
    int64_t B, Hq, Hkv, Sq, Skv;
    int64_t q_sb, q_ss, q_sh;
    int64_t k_sb, k_ss, k_sh;
    int64_t v_sb, v_ss, v_sh;
    int64_t o_sb, o_ss, o_sh;
    int64_t causal, window;
    float scale;
};

// ---------------------------------------------------------------------------
// f32: the SIMT kernel
// ---------------------------------------------------------------------------

constexpr int THREADS = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}

template <int HD, int BQ, int BK>
constexpr size_t flash_smem_bytes() {
    // Qt [HD][BQ+1], Kt [HD][BK+1], Vs [BK][HD], Pt [BK][BQ+1]
    return sizeof(float) * ((size_t)HD * (BQ + 1) + (size_t)HD * (BK + 1)
                            + (size_t)BK * HD + (size_t)BK * (BQ + 1));
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(THREADS) flash_kernel(FlashArgs a) {
    constexpr int RQ = BQ / 16;   // rows a thread owns
    constexpr int RK = BK / 8;    // keys a thread owns in S
    constexpr int RD = HD / 8;    // head dims a thread owns in O
    constexpr int LQ = BQ + 1;    // padded row lengths (no bank conflicts)
    constexpr int LK = BK + 1;
    extern __shared__ float smem[];
    float* Qt = smem;
    float* Kt = Qt + HD * LQ;
    float* Vs = Kt + HD * LK;
    float* Pt = Vs + BK * HD;

    const int tid = threadIdx.x, r = tid >> 3, c = tid & 7;
    const int64_t bh = blockIdx.x;
    const int64_t b = bh / a.Hq, hq = bh % a.Hq;
    const int64_t hkv = hq / (a.Hq / a.Hkv);
    const int64_t q0 = (int64_t)blockIdx.y * BQ;
    const T* q = (const T*)a.q + b * a.q_sb + hq * a.q_sh;
    const T* k = (const T*)a.k + b * a.k_sb + hkv * a.k_sh;
    const T* v = (const T*)a.v + b * a.v_sb + hkv * a.v_sh;
    T* o = (T*)a.o + b * a.o_sb + hq * a.o_sh;

    for (int idx = tid; idx < BQ * HD; idx += THREADS) {
        const int m = idx / HD, d = idx % HD;
        const int64_t qi = q0 + m;
        Qt[d * LQ + m] = qi < a.Sq ? to_f(q[qi * a.q_ss + d]) * a.scale
                                   : 0.f;
    }

    // the key range this block visits (inclusive), see the header
    const int64_t q_last = min(q0 + BQ, a.Sq) - 1;
    int64_t k_lo = 0, k_hi = a.Skv - 1;
    const bool dead_row = a.window > 0 && q_last - a.window + 1 > a.Skv - 1;
    if (!dead_row) {
        if (a.causal) k_hi = min(k_hi, q_last);
        if (a.window > 0) k_lo = max((int64_t)0, q0 - a.window + 1);
    }

    float m_i[RQ], l_i[RQ], acc[RQ][RD];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        m_i[i] = NEG_INF;
        l_i[i] = 0.f;
#pragma unroll
        for (int jd = 0; jd < RD; ++jd) acc[i][jd] = 0.f;
    }

    for (int64_t t = k_lo / BK; t <= k_hi / BK; ++t) {
        const int64_t k0 = t * BK;
        __syncthreads();  // the previous tile's Kt / Vs / Pt reads are done
        for (int idx = tid; idx < BK * HD; idx += THREADS) {
            const int n = idx / HD, d = idx % HD;
            const int64_t kj = k0 + n;
            const bool in = kj < a.Skv;
            Kt[d * LK + n] = in ? to_f(k[kj * a.k_ss + d]) : 0.f;
            Vs[n * HD + d] = in ? to_f(v[kj * a.v_ss + d]) : 0.f;
        }
        __syncthreads();

        float s[RQ][RK];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < HD; ++d) {
            float qv[RQ], kv[RK];
#pragma unroll
            for (int i = 0; i < RQ; ++i) qv[i] = Qt[d * LQ + r + 16 * i];
#pragma unroll
            for (int j = 0; j < RK; ++j) kv[j] = Kt[d * LK + c + 8 * j];
#pragma unroll
            for (int i = 0; i < RQ; ++i)
#pragma unroll
                for (int j = 0; j < RK; ++j)
                    s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < RQ; ++i) {
            const int64_t qpos = q0 + r + 16 * i;
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < RK; ++j) {
                const int64_t kpos = k0 + c + 8 * j;
                if (kpos >= a.Skv) {
                    s[i][j] = -INFINITY;  // not a key: p = 0
                } else {
                    bool live = true;
                    if (a.causal) live = live && kpos <= qpos;
                    if (a.window > 0) live = live && kpos > qpos - a.window;
                    if (!live) s[i][j] = NEG_INF;
                }
                mx = fmaxf(mx, s[i][j]);
            }
            // the 8 threads of a row are lanes c = 0..7 of one warp
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
            const float m_new = fmaxf(m_i[i], mx);
            const float alpha = expf(m_i[i] - m_new);
            float ps = 0.f;
#pragma unroll
            for (int j = 0; j < RK; ++j) {
                const float p = expf(s[i][j] - m_new);
                ps += p;
                Pt[(c + 8 * j) * LQ + r + 16 * i] = p;
            }
            ps += __shfl_xor_sync(0xffffffffu, ps, 1);
            ps += __shfl_xor_sync(0xffffffffu, ps, 2);
            ps += __shfl_xor_sync(0xffffffffu, ps, 4);
            l_i[i] = l_i[i] * alpha + ps;
            m_i[i] = m_new;
#pragma unroll
            for (int jd = 0; jd < RD; ++jd) acc[i][jd] *= alpha;
        }
        __syncthreads();

#pragma unroll 4
        for (int n = 0; n < BK; ++n) {
            float pv[RQ];
#pragma unroll
            for (int i = 0; i < RQ; ++i) pv[i] = Pt[n * LQ + r + 16 * i];
#pragma unroll
            for (int jd = 0; jd < RD; ++jd) {
                const float vv = Vs[n * HD + c + 8 * jd];
#pragma unroll
                for (int i = 0; i < RQ; ++i)
                    acc[i][jd] = fmaf(pv[i], vv, acc[i][jd]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
        const int64_t qi = q0 + r + 16 * i;
        if (qi >= a.Sq) continue;
        const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
        for (int jd = 0; jd < RD; ++jd)
            o[qi * a.o_ss + c + 8 * jd] = from_f<T>(acc[i][jd] / denom);
    }
}


template <typename T, int HD, int BQ, int BK>
static int launch_simt(const FlashArgs* a, cudaStream_t stream) {
    constexpr size_t smem = flash_smem_bytes<HD, BQ, BK>();
    auto fn = flash_kernel<T, HD, BQ, BK>;
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)(a->B * a->Hq),
                    (unsigned)((a->Sq + BQ - 1) / BQ));
    fn<<<grid, THREADS, smem, stream>>>(*a);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (TMA, mbarriers, wgmma: sm_90a)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

// Wait for the phase of the given parity to complete.  A wait that never
// ends is a fault of the kernel: it traps (the launch then fails) rather
// than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    for (uint32_t spins = 0;; ++spins) {
        uint32_t done;
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (spins == (1u << 22)) __trap();
    }
}

// a box of the 4-D map to shared memory; completion counted on ``bar``
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), layout (1 = 128-byte swizzle, 3 = 32-byte)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
           | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16)
           | ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32)
           | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers an asynchronous wgmma reads or writes: the compiler must
// neither read them before the wait nor reuse them while it runs.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// 2^x, one MUFU instruction (results under 2^-126 flush to zero)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
    return *reinterpret_cast<uint32_t*>(&h);
}

// D (64 x 64, f32) += A (64 x 16, K-major, shared) * B (16 x 64,
// K-major, shared); scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 16, f32) += A (64 x 16, bf16 registers) * B (16 x 16,
// N-major (transposed), shared)
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64,
// N-major (transposed), shared)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128,
// N-major (transposed), shared)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// consumer warpgroups a block at head dim 256 (2 at the others): ptxas
// holds a kernel with two consumer warpgroups to 168 registers a thread
// (with a producer warpgroup, 384 threads, and with a producer warp, 288;
// setmaxnreg did not change it), and at hd 256 (128 f32 of O a thread)
// that spilled 260-392 bytes and serialized the wgmmas; one consumer
// warpgroup (256 threads) takes 192 registers with no spill and ran
// 0.068 ms against 0.089-0.102 at recurrentgemma-2b's prefill shape on
// an H100 80GB HBM3
constexpr int NC256 = 1;

template <int HD, int NC_>
struct Tc {
    static_assert(HD == 16 || HD == 64 || HD == 128 || HD == 256,
                  "head dims 16, 64, 128, 256");
    static_assert(NC_ == 1 || NC_ == 2, "one or two consumer warpgroups");
    static constexpr int NC = NC_;               // consumer warpgroups
    static constexpr int THREADS = 128 * (NC + 1);
    static constexpr int BQ = 64 * NC;           // query rows a block
    static constexpr int BK = 64;                // keys a tile
    static constexpr int STAGES = HD == 256 ? 2 : 3;
    static constexpr int CW = HD < 64 ? HD : 64; // head dims in one TMA box
    static constexpr int NCH = HD / CW;          // boxes across the head dim
    static constexpr int RB = 2 * CW;            // bytes of a box's row
    static constexpr uint32_t LAYOUT = RB == 128 ? 1 : 3;
    static constexpr int NPV = HD < 128 ? HD : 128;  // N of one P V wgmma
    static constexpr int NPVH = HD / NPV;
    static constexpr uint32_t Q_BYTES = BQ * HD * 2;
    static constexpr uint32_t KV_BYTES = BK * HD * 2;
    static constexpr uint32_t BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
    // 1024 bytes of slack to align the tiles (the swizzle's period)
    static constexpr uint32_t SMEM = 1024 + BAR_OFF + 8 * (1 + 3 * STAGES);
};

template <int HD, int NC>
__global__ void __launch_bounds__(Tc<HD, NC>::THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const FlashArgs a) {
    using C = Tc<HD, NC>;
    constexpr int BQ = C::BQ, BK = C::BK, STAGES = C::STAGES;
    constexpr int CW = C::CW, NCH = C::NCH, RB = C::RB;
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    // shared memory: Q [NCH][BQ][CW], then per stage K and V [NCH][BK][CW]
    // (each box row-major, swizzled by TMA as wgmma reads it), then the
    // barriers: Q, full K and full V per stage, empty per stage
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t sQ = base;
    const uint32_t sK = base + C::Q_BYTES;
    const uint32_t sV = sK + STAGES * C::KV_BYTES;
    const uint32_t bar_q = base + C::BAR_OFF;
    const uint32_t full_k = bar_q + 8;
    const uint32_t full_v = full_k + 8 * STAGES;
    const uint32_t empty = full_v + 8 * STAGES;

    const int64_t bh = blockIdx.x;
    const int64_t b = bh / a.Hq, hq = bh % a.Hq;
    const int64_t hkv = hq / (a.Hq / a.Hkv);
    // the heaviest query tiles first (under causal, the last ones)
    const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * BQ;
    // the key tiles this block visits (inclusive), see the header
    const int64_t q_last = min(q0 + BQ, a.Sq) - 1;
    int64_t k_lo = 0, k_hi = a.Skv - 1;
    const bool dead_row = a.window > 0 && q_last - a.window + 1 > a.Skv - 1;
    if (!dead_row) {
        if (a.causal) k_hi = min(k_hi, q_last);
        if (a.window > 0) k_lo = max((int64_t)0, q0 - a.window + 1);
    }
    const int t_lo = (int)(k_lo / BK);
    const int n_tiles = (int)(k_hi / BK) - t_lo + 1;

    if (threadIdx.x == 0) {
        mbar_init(bar_q, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full_k + 8 * s, 1);
            mbar_init(full_v + 8 * s, 1);
            mbar_init(empty + 8 * s, C::NC * 128);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // the warpgroup, warp-uniform by construction (a shuffle from lane 0)
    const int wgi = __shfl_sync(0xffffffffu, (int)(threadIdx.x / 128), 0);
    if (wgi == 0) {
        // the producer warpgroup: thread 0 issues every copy
        if (threadIdx.x == 0) {
            const int ib = (int)b, ihq = (int)hq, ihkv = (int)hkv;
            mbar_expect_tx(bar_q, C::Q_BYTES);
            for (int c = 0; c < NCH; ++c)
                tma_load_4d(sQ + c * BQ * RB, &qmap, bar_q, c * CW, ihq,
                            (int)q0, ib);
            for (int it = 0; it < n_tiles; ++it) {
                const int s = it % STAGES;
                const uint32_t ph = (it / STAGES) & 1;
                const int k0 = (t_lo + it) * BK;
                mbar_wait(empty + 8 * s, ph ^ 1);  // a fresh stage passes
                mbar_expect_tx(full_k + 8 * s, C::KV_BYTES);
                for (int c = 0; c < NCH; ++c)
                    tma_load_4d(sK + s * C::KV_BYTES + c * BK * RB, &kmap,
                                full_k + 8 * s, c * CW, ihkv, k0, ib);
                mbar_expect_tx(full_v + 8 * s, C::KV_BYTES);
                for (int c = 0; c < NCH; ++c)
                    tma_load_4d(sV + s * C::KV_BYTES + c * BK * RB, &vmap,
                                full_v + 8 * s, c * CW, ihkv, k0, ib);
            }
        }
    } else {
        // a consumer warpgroup: 64 query rows
        const int wg = wgi - 1, tw = threadIdx.x % 128;
        const int warp = tw / 32, lane = tw % 32, gid = lane / 4, t4 = lane % 4;
        // accumulator fragment: element i of a thread is row (i & 2 ? row1 :
        // row0), column 8 * (i / 4) + 2 * t4 + (i & 1)
        const int64_t w0 = q0 + 64 * wg;
        const int64_t row0 = w0 + 16 * warp + gid, row1 = row0 + 8;
        const bool has_rows = w0 < a.Sq;
        const int64_t w_last = min(w0 + 63, a.Sq - 1);
        const bool wg_dead = a.window > 0 && w_last - a.window + 1 > a.Skv - 1;
        const float sl2 = a.scale * 1.4426950408889634f;  // scale * log2(e)

        float o[C::NPVH][C::NPV / 2];
#pragma unroll
        for (int h = 0; h < C::NPVH; ++h)
#pragma unroll
            for (int i = 0; i < C::NPV / 2; ++i) o[h][i] = 0.f;
        // running max (log2 domain) and this thread's share of the denominator
        float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
        const uint32_t aQ = sQ + 64 * wg * RB;
        float sc[BK / 2];  // S, then P, of a tile (the first k-step
                           // overwrites it)
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;

        mbar_wait(bar_q, 0);
        for (int it = 0; it < n_tiles; ++it) {
            const int s = it % STAGES;
            const uint32_t ph = (it / STAGES) & 1;
            const int64_t k0 = (int64_t)(t_lo + it) * BK;
            // a tile with no live key for any of this warpgroup's rows
            const bool skip = !has_rows || (!wg_dead && (
                (a.causal && k0 > w_last)
                || (a.window > 0 && k0 + BK - 1 <= w0 - a.window)));
            mbar_wait(full_k + 8 * s, ph);
            if (!skip) {
                const uint32_t bK = sK + s * C::KV_BYTES;
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < HD / 16; ++kk) {
                    const uint32_t c = kk * 16 / CW;
                    const uint32_t off = (kk * 16 % CW) * 2;
                    wgmma_ss_n64(
                        sc,
                        gmma_desc(aQ + c * BQ * RB + off, 16, 8 * RB,
                                  C::LAYOUT),
                        gmma_desc(bK + c * BK * RB + off, 16, 8 * RB,
                                  C::LAYOUT),
                        kk > 0);
                }
                wgmma_commit();
                wgmma_wait_all();
                keep(sc);

                // scale, and mask the tiles on an edge
                const bool edge = k0 + BK > a.Skv
                    || (a.causal && k0 + BK - 1 > w0)
                    || (a.window > 0 && k0 <= w_last - a.window);
                // column - row and column - Skv of element 0 (positions fit
                // in 32 bits); element i adds 8 (i / 4) + (i & 1), and row1
                // is 8 past row0
                const int cr0 = (int)(k0 - row0) + 2 * t4;
                const int cs0 = (int)(k0 - a.Skv) + 2 * t4;
                const int win = (int)min(a.window, (int64_t)0x7fffffff);
                float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
                for (int i = 0; i < BK / 2; ++i) {
                    float x = sc[i] * sl2;
                    if (edge) {
                        const int dc = 8 * (i >> 2) + (i & 1);
                        const int cr = cr0 + dc - ((i & 2) ? 8 : 0);
                        if (cs0 + dc >= 0) {
                            x = -INFINITY;  // not a key: p = 0
                        } else if ((a.causal && cr > 0)
                                   || (win > 0 && cr <= -win)) {
                            x = NEG_INF;
                        }
                    }
                    sc[i] = x;
                    if (i & 2) mx1 = fmaxf(mx1, x);
                    else mx0 = fmaxf(mx0, x);
                }
                // a row's 64 keys are in the 4 threads of a quad
                mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
                mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
                mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
                mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
                const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
                const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
                m0 = mn0;
                m1 = mn1;
                float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
                for (int i = 0; i < BK / 2; ++i) {
                    const float p = ex2(sc[i] - ((i & 2) ? mn1 : mn0));
                    sc[i] = p;
                    if (i & 2) ps1 += p;
                    else ps0 += p;
                }
                l0 = l0 * al0 + ps0;
                l1 = l1 * al1 + ps1;
#pragma unroll
                for (int h = 0; h < C::NPVH; ++h)
#pragma unroll
                    for (int i = 0; i < C::NPV / 2; ++i)
                        o[h][i] *= (i & 2) ? al1 : al0;
                // P in bf16: the S fragment of keys 16 kk.. is the A fragment
                // of the k-step kk
                uint32_t pa[BK / 16][4];
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
                    for (int r = 0; r < 4; ++r)
                        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r],
                                              sc[8 * kk + 2 * r + 1]);

                mbar_wait(full_v + 8 * s, ph);
                const uint32_t bV = sV + s * C::KV_BYTES;
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
                    for (int h = 0; h < C::NPVH; ++h)
                        wgmma_rs(o[h], pa[kk],
                                 gmma_desc(bV + (h * C::NPV / CW) * BK * RB
                                               + kk * 16 * RB,
                                           BK * RB, 8 * RB, C::LAYOUT));
                wgmma_commit();
                wgmma_wait_all();
#pragma unroll
                for (int h = 0; h < C::NPVH; ++h) keep(o[h]);
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk) keep(pa[kk]);
            } else {
                mbar_wait(full_v + 8 * s, ph);
            }
            mbar_arrive(empty + 8 * s);
        }

        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        const float inv0 = 1.f / fmaxf(l0, 1e-30f);
        const float inv1 = 1.f / fmaxf(l1, 1e-30f);
        __nv_bfloat16* out = (__nv_bfloat16*)a.o + b * a.o_sb + hq * a.o_sh;
#pragma unroll
        for (int h = 0; h < C::NPVH; ++h)
#pragma unroll
            for (int i = 0; i < C::NPV / 2; i += 2) {
                const int64_t row = (i & 2) ? row1 : row0;
                const float inv = (i & 2) ? inv1 : inv0;
                const int col = h * C::NPV + 8 * (i >> 2) + 2 * t4;
                if (row < a.Sq)
                    *reinterpret_cast<__nv_bfloat162*>(
                        out + row * a.o_ss + col) = __floats2bfloat162_rn(
                        o[h][i] * inv, o[h][i + 1] * inv);
            }
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = (EncodeTiled)p;
    }
    return fn;
}

// A (B, S, H, hd) bf16 tensor as the 4-D map (hd, H, S, B), boxes of
// cw x 1 x rows x 1 (rows past S read as zeros).  Byte strides must be
// multiples of 16 and the base 16-byte aligned (the wrapper checks).
static bool encode(CUtensorMap* map, const void* ptr, int64_t B, int64_t S,
                   int64_t H, int hd, int64_t sb, int64_t ss, int64_t sh,
                   int cw, int rows) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                   (cuuint64_t)sb * 2};
    const cuuint32_t box[4] = {(cuuint32_t)cw, 1, (cuuint32_t)rows, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
              dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
              cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int NC>
static int tc_attributes(cudaFuncAttributes* fa) {
    using C = Tc<HD, NC>;
    auto fn = flash_tc_kernel<HD, NC>;
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(fa, fn);
    return (int)err;
}

template <int HD, int NC>
static int launch_tc(const FlashArgs* a, cudaStream_t stream) {
    using C = Tc<HD, NC>;
    cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<HD, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)C::SMEM);
    if (err != cudaSuccess) return (int)err;
    CUtensorMap qm, km, vm;
    if (!encode(&qm, a->q, a->B, a->Sq, a->Hq, HD, a->q_sb, a->q_ss, a->q_sh,
                C::CW, C::BQ)
        || !encode(&km, a->k, a->B, a->Skv, a->Hkv, HD, a->k_sb, a->k_ss,
                   a->k_sh, C::CW, C::BK)
        || !encode(&vm, a->v, a->B, a->Skv, a->Hkv, HD, a->v_sb, a->v_ss,
                   a->v_sh, C::CW, C::BK))
        return -2;
    const dim3 grid((unsigned)(a->B * a->Hq),
                    (unsigned)((a->Sq + C::BQ - 1) / C::BQ));
    flash_tc_kernel<HD, NC><<<grid, C::THREADS, C::SMEM, stream>>>(qm, km, vm,
                                                                  *a);
    return (int)cudaGetLastError();
}

// dtype 0 = float32 (the SIMT kernel), 1 = bfloat16 (the tensor-core
// kernel).  Returns the CUDA error of the launch (0 = launched), -1 for a
// head dim or type without an instance, -2 if a TMA map could not be
// built.
extern "C" int flash_attention_launch(const FlashArgs* args, int dtype,
                                      int hd, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) {
        switch (hd) {
            case 16: return launch_simt<float, 16, 64, 32>(args, st);
            case 64: return launch_simt<float, 64, 64, 32>(args, st);
            case 128: return launch_simt<float, 128, 64, 32>(args, st);
            case 256: return launch_simt<float, 256, 64, 32>(args, st);
            default: return -1;
        }
    }
    if (dtype == 1) {
        switch (hd) {
            case 16: return launch_tc<16, 2>(args, st);
            case 64: return launch_tc<64, 2>(args, st);
            case 128: return launch_tc<128, 2>(args, st);
            case 256: return launch_tc<256, NC256>(args, st);
            default: return -1;
        }
    }
    return -1;
}

// The bf16 instance of head dim ``hd``: out[0] dynamic shared memory
// bytes, out[1] threads a block, out[2] registers a thread (the launch
// bound), out[3] local memory bytes a thread.  Returns a CUDA error, or -1.
extern "C" int flash_attention_info(int hd, int* out) {
    cudaFuncAttributes fa;
    int err, smem, threads;
    switch (hd) {
        case 16: err = tc_attributes<16, 2>(&fa); smem = Tc<16, 2>::SMEM;
                 threads = Tc<16, 2>::THREADS; break;
        case 64: err = tc_attributes<64, 2>(&fa); smem = Tc<64, 2>::SMEM;
                 threads = Tc<64, 2>::THREADS; break;
        case 128: err = tc_attributes<128, 2>(&fa); smem = Tc<128, 2>::SMEM;
                  threads = Tc<128, 2>::THREADS; break;
        case 256: err = tc_attributes<256, NC256>(&fa);
                  smem = Tc<256, NC256>::SMEM;
                  threads = Tc<256, NC256>::THREADS; break;
        default: return -1;
    }
    if (err != 0) return err;
    out[0] = smem;
    out[1] = threads;
    out[2] = fa.numRegs;
    out[3] = (int)fa.localSizeBytes;
    return 0;
}
