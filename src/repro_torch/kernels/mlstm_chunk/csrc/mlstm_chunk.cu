// Chunkwise mLSTM with its state carried in and out, on the Hopper tensor
// cores — the counterpart of the TPU kernel src/repro/kernels/mlstm_chunk/
// kernel.py::mlstm_chunk (Pallas), extended by the state the model's
// chunked form carries (src/repro/models/recurrent.py::mlstm_scan_chunked).
//
// What it computes, per (batch, head), over chunks of KC = 64 positions
// from the state (C0, n0):
//   d_j   = cumsum(log f)_j in the chunk (XLA's CPU order: blocks of 16,
//           each left to right from 0, plus the earlier blocks' totals)
//   eq_j  = exp(d_j) / sqrt(dh);  g_l = exp(d_end - d_l + log i_l)
//   s_jl  = (q_j . k_l) / sqrt(dh) exp(min(d_j - d_l + log i_l, 30)),
//           l <= j (the causal pairs and the tail past S are masked by
//           tests, never by adding -inf)
//   h_j   = (eq_j q_j . C + sum_l s_jl v_l) / max(|eq_j q_j . n + sum_l s_jl|, 1)
//   C     = C exp(d_end) + sum_l g_l k_l v_l^T
//   n     = n exp(d_end) + sum_l g_l k_l
// q, k, v are bf16 (B, S, H, dh) read through their strides (unit stride
// over dh, 16-byte multiples otherwise); log f, log i f32 (B, S, H); C0, C
// f32 (B, H, dh, dh); n0, n f32 (B, H, dh); h f32 (B, S, H, dh).  dh is a
// multiple of 32 up to 512; inside, the head dim is padded with zeros to
// DP, a multiple of 64 (TMA fills the boxes past dh with zeros).
//
// Prefill (S > 1) is two kernels, launched by one call:
//
// (a) mlstm_scores_kernel, grid (chunks, B*H), one warpgroup: the chunk's
//     q and k by TMA, 64-wide slices (64 x 64 boxes, 128-byte swizzle)
//     through a ring of 4 stages (74 KB: 3 blocks an SM), S = Q K^T by
//     wgmma m64n64k16 over DP (bf16 products are exact, f32 sums), gated in
//     registers; the gated scores are written as three bf16 images (hi =
//     bf16(s), mid = bf16(s - hi), lo = bf16(s - hi - mid): all of s's 24
//     mantissa bits) in the swizzled layout the second kernel's wgmma
//     reads, with their row sums (the intra-chunk normaliser), eq, g,
//     exp(d_end) and u = sum_l g_l k_l (the chunk's share of n): 24 KB +
//     4 (256 + DP) bytes a chunk, once per chunk and head.
//
// (b) mlstm_state_kernel, grid (DP / BN, B*H), serial over the chunks.
//     A block owns C's columns [e0, e0 + BN) and keeps them transposed,
//     C^T (BN x DP) f32, in the accumulator registers of its two consumer
//     warpgroups for the whole sequence (warpgroup w holds the head dims
//     of its half of the 64-wide slices: at most 4 slices, 128 f32 a
//     thread).  For every chunk:
//       inter^T = C^T q^T      A = C^T from registers as three bf16
//                              parts (the accumulator fragment is the
//                              A fragment), B = the q slices (K-major)
//       intra^T = v^T S^T      A = v^T (MN-major), B = the S images
//                              (shared between the warpgroups)
//       C^T     = exp(d_end) C^T + (g v)^T k   A = (g v)^T as three bf16
//                              parts in shared memory (MN-major), B =
//                              the k slices (MN-major); each slice's
//                              products into a fresh accumulator, then
//                              one fmaf into the state
//       h       = (eq inter + intra) / max(|eq q.n + rowsum|, 1), while
//                              the first slice's products run
//       n       = exp(d_end) n + u
//     q.n (DP terms a row) is summed on the CUDA cores in f32 while the
//     inter product runs.  Every product is wgmma m64n64k16 into f32; the
//     f32 operands (C, the scores, g v) go in as three bf16 parts, hi +
//     mid + lo (all 24 of their bits: exact), a product each; q, k and v
//     go in unsplit.  Two parts (16 bits) were not enough: a late layer of
//     xlstm-350m (random weights) had h at 0.95 of the bound from the
//     exact recurrence (f64), and teacher-forced through 24 layers the
//     logits moved 14.3 % from the plain route, past the plain routes'
//     own 11.6 %.  The tensor cores' f32 sums truncate rather than round,
//     so the state takes each chunk's update as one rounded fmaf.  The
//     copies are TMA (the v tile, the q and k slices) and a plain bulk
//     copy (the scores), each stage with a full mbarrier: two chunk
//     stages, and a slice for each warpgroup in 8 ring stages, 4 for q
//     and 4 for k (one chunk's worth at DP 512).  No wgmma group has a
//     branch (ptxas serializes one that has: C7520): at DP < 512 the
//     products over slices a warpgroup lacks run over ring halves that
//     hold zeros.  Warp 0 issues the next chunk's q slices and stage right
//     after the block barrier that follows the inter products (which
//     frees them), its k slices after the one that ends the chunk, a stage
//     a lane (a copy's issue takes ~100 cycles: one thread issuing them
//     all held its warpgroup ~2,400 cycles a chunk): no producer warp and
//     no empty barriers.
//     BN = 64: C^T's rows are the wgmma's M (64), so a smaller BN would
//     leave rows of every product empty.  At BN 64 a thread holds 128 f32
//     of C^T (DP 512) beside 32 of inter and 32 of A fragments: two
//     warpgroups alone may use up to 255 registers; ptxas held a block
//     with a third warpgroup (or a warp) for the copies to 168 and spilled,
//     and ignored setmaxnreg (C7512).  The shared memory (the ring 128 KB,
//     two chunk stages of 35 KB, g v 24 KB; the warpgroups' exchange of
//     16 KB lies over the chunk's spent S images) fits one block an SM
//     (226 KB); 256 blocks at xlstm-350m's prefill shape (B 8, H 4, dh
//     512).
//
// Decode (S = 1) is a step in place, bound by the state's bytes: two
// kernels of one call.  mlstm_decode_n_kernel (grid B*H) updates n
// (n = f n + i k, each element read and written by one thread) and writes
// max(|q.n / sqrt(dh)|, 1); then mlstm_decode_c_kernel (grid (dh / 32,
// B*H), 256 threads) streams its 32 columns of C once, C = f C + i k v^T,
// written where it was read (C may be C0: no block reads another's
// columns), and sums q . C over d in a fixed order (32 row groups, then
// in order): no atomics, two calls are bit-equal.  n is written by the
// first kernel before the second reads anything of it: every block of
// the second needs the whole n, so n is never read by one block while
// another writes it.
//
// What bounds it on this card: at the prefill shape the function needs
// ~151 MB of traffic (0.045 ms at 3.35 TB/s) against 18.3 GFLOP (0.019 ms
// at the bf16 tensor-core peak, 0.27 ms at the f32 peak): bytes.  The
// kernels' own work is larger: the hi/lo split doubles the products, the
// scores pass writes and re-reads 4 MB, and every column block reads its
// head's q and k again (256 MB through L2 at that shape).  Decode moves
// the 67 MB state once in, once out (0.020 ms).
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int KC = 64;                     // chunk
constexpr int BN = 64;                     // columns of C a state block owns
constexpr int MAX_DP = 512;                // the padded head dim, at most
constexpr int TILE = KC * 64 * 2;          // one 64 x 64 bf16 tile: 8 KB
// a chunk's scores in the scratch: S hi, mid and lo images, then eq[64],
// g[64], rowsum[64], misc[64] (exp(d_end) at 0) and u[DP], f32
constexpr int VEC_EQ = 0, VEC_G = 64, VEC_RS = 128, VEC_MISC = 192,
              VEC_U = 256;
__host__ __device__ constexpr int64_t sc_bytes(int dp) {
    return 3 * TILE + 4 * (int64_t)(VEC_U + dp);
}

// ---------------------------------------------------------------------------
// helpers: shared memory, mbarriers, TMA, wgmma (sm_90a)
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

// ``bytes`` (a multiple of 16) from global to shared memory, counted on
// ``bar``
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
           "r"(bar) : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), 128-byte swizzle.  Every tile here is 64 rows
// of 128 bytes as TMA writes a 64 x 64 bf16 box: K-major operands advance
// a k-step by 32 bytes within the row, MN-major ones by 16 rows.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
           | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
           | ((uint64_t)(TILE >> 4) << 16)
           | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// the byte offset of element (row, col) of a 64 x 64 bf16 tile in the
// 128-byte swizzle (16-byte chunk col / 8 of a row at chunk ^ (row % 8))
__device__ __forceinline__ int sw128(int row, int col) {
    return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
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
template <int N, int M>
__device__ __forceinline__ void keep(uint32_t (&r)[N][M][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                asm volatile("" : "+r"(r[i][m][j]) :: "memory");
}

// bf16 bits -> f32 (exact)
__device__ __forceinline__ float lo16(uint32_t w) {
    return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi16(uint32_t w) {
    return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float bf(uint16_t b) {
    return __uint_as_float((uint32_t)b << 16);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
    return *reinterpret_cast<uint32_t*>(&h);
}

// (x0, x1) as three bf16 parts, hi + mid + lo = x for every normal f32
// (8 + 8 + 8 mantissa bits; each difference is exact in f32)
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    const float r0 = x0 - hf.x, r1 = x1 - hf.y;
    const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
    const float2 mf = __bfloat1622float2(m);
    hi = as_u32(h);
    mid = as_u32(m);
    lo = as_u32(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// D (64 x 64, f32) += A (64 x 16, shared) * B (16 x 64, shared); with
// acc = 0, D = A B.  TA, TB: 1 = the operand is MN-major (its M or N index
// contiguous), 0 = K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc = 1) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, K-major,
// shared)
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
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
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

// Accumulator fragment of a warpgroup's m64n64 product: element x of a
// thread (warp w, lane = 4 gid + t4) is row 16 w + gid + 8 ((x >> 1) & 1),
// column 8 (x >> 2) + 2 t4 + (x & 1).  The elements 8 kk .. 8 kk + 7 are
// the bf16 A fragment of the k-step kk (columns 16 kk .. 16 kk + 15).
__device__ __forceinline__ int frag_row(int warp, int gid, int x) {
    return 16 * warp + gid + ((x & 2) ? 8 : 0);
}
__device__ __forceinline__ int frag_col(int t4, int x) {
    return 8 * (x >> 2) + 2 * t4 + (x & 1);
}

// ---------------------------------------------------------------------------
// (a) the scores pass
// ---------------------------------------------------------------------------

constexpr int SC_THREADS = 128;
constexpr int SC_STAGES = 4;               // ring of (q slice, k slice)
// the ring, then lfs, lis, dcum, g (64 f32 each), the partial sums of u
// (4 x MAX_DP f32), the barriers, and 1024 bytes of slack to align the
// tiles: 3 blocks an SM
constexpr int SC_OFF_F = SC_STAGES * 2 * TILE;
constexpr int SC_OFF_U = SC_OFF_F + 4 * 4 * KC;
constexpr int SC_OFF_BAR = SC_OFF_U + 4 * 4 * MAX_DP;
constexpr int SC_SMEM = 1024 + SC_OFF_BAR + 8 * SC_STAGES;

__global__ void __launch_bounds__(SC_THREADS)
mlstm_scores_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const float* __restrict__ lf, const float* __restrict__ li,
                    uint8_t* __restrict__ sc, int64_t S, int64_t H, int dp,
                    float scale) {
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    uint8_t* gbase = smem_raw + (base - raw);
    const int ns = dp / 64;
    float* lfs = reinterpret_cast<float*>(gbase + SC_OFF_F);
    float* lis = lfs + KC;
    float* dcum = lis + KC;
    float* gs = dcum + KC;
    float* up = reinterpret_cast<float*>(gbase + SC_OFF_U);  // [4][MAX_DP]
    const uint32_t full = base + SC_OFF_BAR;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gid = lane >> 2, t4 = lane & 3;
    const int c = blockIdx.x;
    const int64_t bh = blockIdx.y, b = bh / H, hh = bh % H;
    const int64_t t0 = (int64_t)c * KC;
    const int kc = (int)(S - t0 < KC ? S - t0 : KC);
    uint8_t* out = sc + (bh * gridDim.x + c) * sc_bytes(dp);
    float* vec = reinterpret_cast<float*>(out + 3 * TILE);

    // slice s of q and k into stage s % SC_STAGES
    auto issue = [&](int s) {
        const uint32_t st = base + (s % SC_STAGES) * 2 * TILE;
        const uint32_t bar = full + 8 * (s % SC_STAGES);
        mbar_expect_tx(bar, 2 * TILE);
        tma_load_4d(st, &qmap, bar, 64 * s, (int)hh, (int)t0, (int)b);
        tma_load_4d(st + TILE, &kmap, bar, 64 * s, (int)hh, (int)t0, (int)b);
    };
    if (tid == 0) {
        for (int i = 0; i < SC_STAGES; ++i) mbar_init(full + 8 * i, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int s = 0; s < ns && s < SC_STAGES; ++s) issue(s);
    }
    // the gates; past S, f = 1 and i = 0 (log i = -1e30)
    if (tid < KC) {
        float f = 0.f, g = -1e30f;
        if (tid < kc) {
            const int64_t gi = (b * S + t0 + tid) * H + hh;
            f = lf[gi];
            g = li[gi];
        }
        lfs[tid] = f;
        lis[tid] = g;
    }
    __syncthreads();
    // the cumulative sum of log f in XLA's order, then the decays
    if (warp == 0) {
        if (lane < KC / 16) {
            float acc = 0.f;
            for (int i = 0; i < 16; ++i) {
                acc += lfs[lane * 16 + i];
                dcum[lane * 16 + i] = acc;
            }
        }
        __syncwarp();
        float tot[KC / 16 - 1];
#pragma unroll
        for (int bb = 0; bb < KC / 16 - 1; ++bb) tot[bb] = dcum[bb * 16 + 15];
        __syncwarp();
        for (int j = lane; j < KC; j += 32) {
            float ex = 0.f;
#pragma unroll
            for (int bb = 0; bb < KC / 16 - 1; ++bb)  // static indices
                if (bb < j / 16) ex += tot[bb];
            dcum[j] = dcum[j] + ex;
        }
        __syncwarp();
        const float d_end = dcum[KC - 1];
        for (int j = lane; j < KC; j += 32) {
            const float g = expf((d_end - dcum[j]) + lis[j]);
            gs[j] = g;
            vec[VEC_EQ + j] = expf(dcum[j]) * scale;
            vec[VEC_G + j] = g;
        }
        if (lane == 0) vec[VEC_MISC] = expf(d_end);
    }
    __syncthreads();

    // S = Q K^T over the padded head dim, a slice at a time (the first
    // k-step overwrites); beside it the slice's share of u: a pair of head
    // dims a thread (lane), a quarter of the positions (warp)
    float acc[32];
    for (int s = 0; s < ns; ++s) {
        const uint32_t st = base + (s % SC_STAGES) * 2 * TILE;
        mbar_wait(full + 8 * (s % SC_STAGES), (s / SC_STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<0, 0>(acc, desc_k(st + kk * 32),
                           desc_k(st + TILE + kk * 32), s | kk);
        wgmma_commit();
        const uint8_t* kt = gbase + (st - base) + TILE;
        float u0 = 0.f, u1 = 0.f;
#pragma unroll 4
        for (int l = 16 * warp; l < 16 * warp + 16; ++l) {
            const uint32_t w = *reinterpret_cast<const uint32_t*>(
                kt + sw128(l, 2 * lane));
            u0 = fmaf(gs[l], lo16(w), u0);
            u1 = fmaf(gs[l], hi16(w), u1);
        }
        up[warp * MAX_DP + 64 * s + 2 * lane] = u0;
        up[warp * MAX_DP + 64 * s + 2 * lane + 1] = u1;
        wgmma_wait_all();
        keep(acc);
        __syncthreads();  // the stage is read
        if (tid == 0 && s + SC_STAGES < ns) {
            fence_async_shared();
            issue(s + SC_STAGES);
        }
    }

    // gate, sum the rows, write the hi, mid and lo images
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
        const int j = frag_row(warp, gid, x), l = frag_col(t4, x);
        float s = 0.f;
        if (l <= j && j < kc) {
            const float rel = (dcum[j] - dcum[l]) + lis[l];
            s = acc[x] * scale * expf(fminf(rel, 30.f));
        }
        acc[x] = s;
        if (x & 2) rs1 += s;
        else rs0 += s;
    }
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    if (t4 == 0) {
        vec[VEC_RS + frag_row(warp, gid, 0)] = rs0;
        vec[VEC_RS + frag_row(warp, gid, 2)] = rs1;
    }
#pragma unroll
    for (int x = 0; x < 32; x += 2) {
        uint32_t hi, mid, lo;
        split3(acc[x], acc[x + 1], hi, mid, lo);
        const int off = sw128(frag_row(warp, gid, x), frag_col(t4, x));
        *reinterpret_cast<uint32_t*>(out + off) = hi;
        *reinterpret_cast<uint32_t*>(out + TILE + off) = mid;
        *reinterpret_cast<uint32_t*>(out + 2 * TILE + off) = lo;
    }
    // u = sum_l g_l k_l: the four quarters' sums in order
    for (int d = tid; d < dp; d += SC_THREADS)
        vec[VEC_U + d] = ((up[d] + up[MAX_DP + d]) + up[2 * MAX_DP + d])
                         + up[3 * MAX_DP + d];
}

// ---------------------------------------------------------------------------
// (b) the state-and-output pass
// ---------------------------------------------------------------------------

constexpr int ST_THREADS = 256;            // two warpgroups
constexpr int RING = 8;                    // q slices 0-3, k slices 4-7
constexpr int PAIR = 2 * TILE;             // a slice for each warpgroup
// a chunk stage: the v tile, then the scores as the scratch holds them
constexpr int CSTAGE = 4 * TILE + 4 * (VEC_U + MAX_DP);  // 35 KB
constexpr int OFF_CST = RING * PAIR;
constexpr int OFF_GV = OFF_CST + 2 * CSTAGE;   // g v: hi, mid, lo tiles
constexpr int OFF_N = OFF_GV + 3 * TILE;       // n, f32 [MAX_DP]
constexpr int OFF_QN = OFF_N + 4 * MAX_DP;     // q.n partials [2][2][64]
constexpr int OFF_BAR = OFF_QN + 4 * 4 * KC;   // ring full, chunk full
constexpr int ST_SMEM = 1024 + OFF_BAR + 8 * (RING + 2);
static_assert(CSTAGE % 1024 == 0 && OFF_GV % 1024 == 0, "tile alignment");
static_assert(ST_SMEM <= 232448, "shared memory of one block");

struct StateMaps {
    CUtensorMap q, k, v;
};

// Warp 0 issues the copies of chunk c, a stage a lane (lane i the slices
// of ring stage i, lane 4 the chunk stage): its q slices and its stage
// (q = true), or its k slices.  Called only where every thread has
// finished with the buffers they replace (after a block barrier), so no
// barrier counts the stages free.
__device__ __forceinline__ void issue_chunk(const StateMaps& m, bool q,
                                            int c, uint32_t base,
                                            const uint8_t* sc, int64_t scb,
                                            int64_t bh, int64_t b,
                                            int64_t hh, int nch, int e0,
                                            int ns, int nsw) {
    const uint32_t ring = base, rfull = base + OFF_BAR;
    const uint32_t cfull = rfull + 8 * RING;
    const int t0 = c * KC, lane = threadIdx.x & 31;
    if (q && lane == 4) {
        const int cs = c & 1;
        const uint32_t cst = base + OFF_CST + cs * CSTAGE;
        mbar_expect_tx(cfull + 8 * cs, TILE + (uint32_t)scb);
        tma_load_4d(cst, &m.v, cfull + 8 * cs, e0, (int)hh, t0, (int)b);
        bulk_load(cst + TILE, sc + (bh * nch + c) * scb, (uint32_t)scb,
                  cfull + 8 * cs);
    }
    if (lane < nsw) {
        const CUtensorMap* map = q ? &m.q : &m.k;
        const int st = (q ? 0 : 4) + lane;
        const bool two = nsw + lane < ns;  // warpgroup 1 has slice nsw + i
        mbar_expect_tx(rfull + 8 * st, (two ? 2 : 1) * TILE);
        tma_load_4d(ring + st * PAIR, map, rfull + 8 * st, 64 * lane,
                    (int)hh, t0, (int)b);
        if (two)
            tma_load_4d(ring + st * PAIR + TILE, map, rfull + 8 * st,
                        64 * (nsw + lane), (int)hh, t0, (int)b);
    }
}

__global__ void __launch_bounds__(ST_THREADS, 1)
mlstm_state_kernel(const __grid_constant__ StateMaps maps,
                   const uint8_t* __restrict__ sc,
                   const float* __restrict__ C0, const float* __restrict__ n0,
                   float* __restrict__ h, float* __restrict__ Cout,
                   float* __restrict__ nout, int64_t S, int64_t H, int dh,
                   int dp) {
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    uint8_t* gbase = smem_raw + (base - raw);
    const uint32_t ring = base, cst = base + OFF_CST;
    const uint32_t gv = base + OFF_GV;
    float* ns_ = reinterpret_cast<float*>(gbase + OFF_N);
    float* qnp = reinterpret_cast<float*>(gbase + OFF_QN);
    const uint32_t rfull = base + OFF_BAR, cfull = rfull + 8 * RING;

    const int64_t bh = blockIdx.y, b = bh / H, hh = bh % H;
    const int e0 = blockIdx.x * BN;
    const int nch = (int)((S + KC - 1) / KC);
    const int ns = dp / 64, nsw = (ns + 1) / 2;  // slices; warpgroup 0's
    const int64_t scb = sc_bytes(dp);

    if (threadIdx.x == 0) {
        for (int s = 0; s < RING + 2; ++s) mbar_init(rfull + 8 * s, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    if (threadIdx.x < 32) {
        issue_chunk(maps, true, 0, base, sc, scb, bh, b, hh, nch, e0, ns,
                    nsw);
        issue_chunk(maps, false, 0, base, sc, scb, bh, b, hh, nch, e0, ns,
                    nsw);
    }
    for (int d = threadIdx.x; d < dp; d += ST_THREADS)
        ns_[d] = d < dh ? n0[bh * dh + d] : 0.f;
    // the ring halves no copy fills (DP < 512) hold zeros: the products
    // over them run unconditionally (no branch in a wgmma group) and add
    // exactly nothing
    for (int i = threadIdx.x; i < RING * 2 * (TILE / 16); i += ST_THREADS) {
        const int half = i / (TILE / 16);  // stage half / 2, warpgroup half % 2
        const int slice = half / 2 % 4, wg = half % 2;
        if (wg ? nsw + slice >= ns : slice >= nsw)
            *reinterpret_cast<uint4*>(gbase + i * 16) =
                make_uint4(0, 0, 0, 0);
    }
    fence_async_shared();

    // warpgroup w holds the head dims of slices s0 .. s0 + my_ns - 1
    const int w = threadIdx.x / 128, tw = threadIdx.x % 128;
    const int warp = tw >> 5, lane = tw & 31, gid = lane >> 2, t4 = lane & 3;
    const int s0 = w ? nsw : 0, my_ns = w ? ns - nsw : nsw;
    const float* C0p = C0 + bh * dh * dh;

    // C^T: Cr[i] is slice s0 + i, rows e0 + (fragment row), columns
    // 64 (s0 + i) + (fragment column)
    float Cr[4][32];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int x = 0; x < 32; ++x) {
            const int e = e0 + frag_row(warp, gid, x);
            const int d = 64 * (s0 + i) + frag_col(t4, x);
            Cr[i][x] = (i < my_ns && e < dh && d < dh)
                           ? C0p[(int64_t)d * dh + e] : 0.f;
        }
    __syncthreads();  // the barriers are initialised, n is in

    const int qj = tw & 63, qh = tw >> 6;  // q.n: a row, half a slice
    for (int c = 0; c < nch; ++c) {
        const int cs = c & 1;
        const uint32_t par = c & 1;  // every ring stage fills once a chunk
        const int64_t t0 = (int64_t)c * KC;
        const int kc = (int)(S - t0 < KC ? S - t0 : KC);
        const uint32_t vt = cst + cs * CSTAGE;
        const uint32_t simg = vt + TILE;  // the S images: hi, mid, lo
        const uint8_t* vtg = gbase + OFF_CST + cs * CSTAGE;
        const float* vec = reinterpret_cast<const float*>(vtg + 4 * TILE);
        // the warpgroups' exchange, over the S hi and mid images once the
        // intra products have read them
        float* X = reinterpret_cast<float*>(gbase + OFF_CST + cs * CSTAGE
                                            + TILE);
        mbar_wait(cfull + 8 * cs, (c >> 1) & 1);

        // inter^T = C^T q^T over this warpgroup's slices (the others add
        // zeros); q.n beside it
        float acc[32];
#pragma unroll
        for (int x = 0; x < 32; ++x) acc[x] = 0.f;
        float qn8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if (i < nsw) mbar_wait(rfull + 8 * i, par);
            const uint32_t qs = ring + i * PAIR + w * TILE;
            const uint8_t* qrow = gbase + (qs - base) + qj * 128;
            const float* nsl = ns_ + 64 * (s0 + i);
            // half a slice at a time (k-steps 2 hf, 2 hf + 1): its three
            // parts' fragments, 6 products, q.n's share while they run
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                uint32_t f3[2][3][4];
#pragma unroll
                for (int kq = 0; kq < 2; ++kq)
#pragma unroll
                    for (int r = 0; r < 4; ++r) {
                        const int x = 8 * (2 * hf + kq) + 2 * r;
                        split3(Cr[i][x], Cr[i][x + 1], f3[kq][0][r],
                               f3[kq][1][r], f3[kq][2][r]);
                    }
                wgmma_fence();
#pragma unroll
                for (int kq = 0; kq < 2; ++kq)
#pragma unroll
                    for (int pt = 0; pt < 3; ++pt)
                        wgmma_rs(acc, f3[kq][pt],
                                 desc_k(qs + (2 * hf + kq) * 32));
                wgmma_commit();
                if (i < my_ns) {
#pragma unroll
                    for (int u = 2 * hf; u < 2 * hf + 2; ++u) {
                        const int ch = 4 * qh + u;
                        const uint4 q8 = *reinterpret_cast<const uint4*>(
                            qrow + (((ch ^ qj) & 7) << 4));
                        const float4 na = *reinterpret_cast<const float4*>(
                            nsl + 8 * ch);
                        const float4 nb = *reinterpret_cast<const float4*>(
                            nsl + 8 * ch + 4);
                        qn8[0] = fmaf(lo16(q8.x), na.x, qn8[0]);
                        qn8[1] = fmaf(hi16(q8.x), na.y, qn8[1]);
                        qn8[2] = fmaf(lo16(q8.y), na.z, qn8[2]);
                        qn8[3] = fmaf(hi16(q8.y), na.w, qn8[3]);
                        qn8[4] = fmaf(lo16(q8.z), nb.x, qn8[4]);
                        qn8[5] = fmaf(hi16(q8.z), nb.y, qn8[5]);
                        qn8[6] = fmaf(lo16(q8.w), nb.z, qn8[6]);
                        qn8[7] = fmaf(hi16(q8.w), nb.w, qn8[7]);
                    }
                }
                wgmma_wait_all();
                keep(acc);
                keep(f3);
            }
        }
        qnp[(2 * w + qh) * KC + qj] = ((qn8[0] + qn8[1]) + (qn8[2] + qn8[3]))
                                      + ((qn8[4] + qn8[5]) + (qn8[6] + qn8[7]));

        // eq inter, plus this warpgroup's share of intra^T = v^T S^T
        // (warpgroup 0 the hi image and the lo image's first half,
        // warpgroup 1 the mid image and the lo image's second half)
#pragma unroll
        for (int x = 0; x < 32; ++x) acc[x] *= vec[VEC_EQ + frag_col(t4, x)];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<1, 0>(acc, desc_mn(vt + kk * 2048),
                           desc_k(simg + w * TILE + kk * 32));
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int kk = 2 * w + u;
            wgmma_ss<1, 0>(acc, desc_mn(vt + kk * 2048),
                           desc_k(simg + 2 * TILE + kk * 32));
        }
        wgmma_commit();
        // g v as bf16 hi, mid and lo, in v's layout: 16 elements a thread
#pragma unroll
        for (int m = 0; m < 2; ++m) {
            const int id = threadIdx.x + ST_THREADS * m;  // 16-byte chunk
            const int l = id >> 3, off = id * 16;
            const uint4 v8 = *reinterpret_cast<const uint4*>(vtg + off);
            const float g = vec[VEC_G + l];
            uint4 hi, mid, lo;
            split3(lo16(v8.x) * g, hi16(v8.x) * g, hi.x, mid.x, lo.x);
            split3(lo16(v8.y) * g, hi16(v8.y) * g, hi.y, mid.y, lo.y);
            split3(lo16(v8.z) * g, hi16(v8.z) * g, hi.z, mid.z, lo.z);
            split3(lo16(v8.w) * g, hi16(v8.w) * g, hi.w, mid.w, lo.w);
            *reinterpret_cast<uint4*>(gbase + OFF_GV + off) = hi;
            *reinterpret_cast<uint4*>(gbase + OFF_GV + TILE + off) = mid;
            *reinterpret_cast<uint4*>(gbase + OFF_GV + 2 * TILE + off) = lo;
        }
        wgmma_wait_all();
        keep(acc);
        __syncthreads();  // every intra product has read the S images
        // each warpgroup hands the other the half of its fragment the other
        // finishes (warpgroup 0 the elements 0-15, columns j < 32;
        // warpgroup 1 the rest)
        float mine[16];  // the half this warpgroup finishes (acc dies here)
#pragma unroll
        for (int x = 0; x < 16; ++x) {
            X[x * 256 + w * 128 + tw] = w ? acc[x] : acc[x + 16];
            mine[x] = w ? acc[x + 16] : acc[x];
        }
        // g v for the wgmma reads; X before the copies that refill the
        // stage (after the next chunk's first barrier)
        fence_async_shared();
        __syncthreads();  // the q slices and the other chunk stage are free
        if (threadIdx.x < 32 && c + 1 < nch)
            issue_chunk(maps, true, c + 1, base, sc, scb, bh, b, hh, nch, e0,
                        ns, nsw);

        // C^T = exp(d_end) C^T + (g v)^T k, a slice at a time: the
        // chunk's products into a fresh accumulator (the tensor cores' f32
        // sums truncate; the running state only sees one rounded fmaf a
        // chunk), the slices past my_ns over zeros; h under the first
        const float e_end = vec[VEC_MISC];
        for (int i = 0; i < nsw; ++i) mbar_wait(rfull + 8 * (4 + i), par);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float t[32];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int pt = 0; pt < 3; ++pt)
                    wgmma_ss<1, 1>(t, desc_mn(gv + pt * TILE + kk * 2048),
                                   desc_mn(ring + (4 + i) * PAIR + w * TILE
                                           + kk * 2048),
                                   kk | pt);
            wgmma_commit();
            if (i == 0) {
                // h = (eq inter + intra) / max(|eq q.n + rowsum|, 1):
                // warpgroup w the fragment elements 16 w .. 16 w + 15 (8
                // columns j)
                float* hp = h + ((b * S + t0) * H + hh) * dh;
                float inv[8];
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    const int j = frag_col(t4, 16 * w + 4 * (u >> 1)
                                                   + (u & 1));
                    const float qnj = ((qnp[j] + qnp[KC + j])
                                       + qnp[2 * KC + j]) + qnp[3 * KC + j];
                    inv[u] = __frcp_rn(fmaxf(
                        fabsf(vec[VEC_EQ + j] * qnj + vec[VEC_RS + j]),
                        1.f));
                }
#pragma unroll
                for (int y = 0; y < 16; ++y) {
                    const int x = 16 * w + y;
                    const int e = e0 + frag_row(warp, gid, x);
                    const int j = frag_col(t4, x);
                    const float other = X[y * 256 + (1 - w) * 128 + tw];
                    if (e < dh && j < kc)
                        hp[(int64_t)j * H * dh + e] =
                            (w ? other + mine[y] : mine[y] + other)
                            * inv[2 * (y >> 2) + (y & 1)];
                }
            }
            wgmma_wait_all();
            keep(t);
#pragma unroll
            for (int x = 0; x < 32; ++x)
                Cr[i][x] = fmaf(Cr[i][x], e_end, t[x]);
        }
        // n = exp(d_end) n + u over this warpgroup's head dims
        for (int d = 64 * s0 + tw; d < 64 * (s0 + my_ns); d += 128)
            ns_[d] = fmaf(ns_[d], e_end, vec[VEC_U + d]);
        __syncthreads();  // the k slices, n, X, the partials, g v are free
        if (threadIdx.x < 32 && c + 1 < nch)
            issue_chunk(maps, false, c + 1, base, sc, scb, bh, b, hh, nch,
                        e0, ns, nsw);
    }

    float* Cp = Cout + bh * dh * dh;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int x = 0; x < 32; ++x) {
            const int e = e0 + frag_row(warp, gid, x);
            const int d = 64 * (s0 + i) + frag_col(t4, x);
            if (i < my_ns && e < dh && d < dh)
                Cp[(int64_t)d * dh + e] = Cr[i][x];
        }
    if (blockIdx.x == 0)
        for (int d = 64 * s0 + tw; d < 64 * (s0 + my_ns) && d < dh; d += 128)
            nout[bh * dh + d] = ns_[d];
}

// ---------------------------------------------------------------------------
// decode: the step in place
// ---------------------------------------------------------------------------

constexpr int DN_THREADS = 128;
constexpr int DC_THREADS = 256, DC_COLS = 32, DC_ROWS = 8;

// n = f n + i k (in place when n is n0), den = max(|q / sqrt(dh) . n|, 1)
__global__ void __launch_bounds__(DN_THREADS)
mlstm_decode_n_kernel(const uint16_t* __restrict__ q,
                      const uint16_t* __restrict__ k,
                      const float* __restrict__ lf,
                      const float* __restrict__ li, const float* n0, float* n,
                      float* __restrict__ den, int64_t H, int dh, int64_t qsb,
                      int64_t qsh, int64_t ksb, int64_t ksh, float scale) {
    __shared__ float red[DN_THREADS / 32];
    const int64_t bh = blockIdx.x, b = bh / H, hh = bh % H;
    const int tid = threadIdx.x;
    const float f = expf(lf[bh]), ig = expf(fminf(li[bh], 30.f));
    const uint16_t* qp = q + b * qsb + hh * qsh;
    const uint16_t* kp = k + b * ksb + hh * ksh;
    float part = 0.f;
    for (int d = tid; d < dh; d += DN_THREADS) {
        const float nn = fmaf(f, n0[bh * dh + d], ig * bf(kp[d]));
        n[bh * dh + d] = nn;
        part = fmaf(bf(qp[d]) * scale, nn, part);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
    if ((tid & 31) == 0) red[tid >> 5] = part;
    __syncthreads();
    if (tid == 0) {
        float s = red[0];
        for (int i = 1; i < DN_THREADS / 32; ++i) s += red[i];
        den[bh] = fmaxf(fabsf(s), 1.f);
    }
}

// C = f C + i k v^T over 32 columns (in place when C is C0), h = q / sqrt(dh)
// . C / den
__global__ void __launch_bounds__(DC_THREADS)
mlstm_decode_c_kernel(const uint16_t* __restrict__ q,
                      const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v,
                      const float* __restrict__ lf,
                      const float* __restrict__ li, const float* C0, float* C,
                      const float* __restrict__ den, float* __restrict__ h,
                      int64_t H, int dh, int64_t qsb, int64_t qsh, int64_t ksb,
                      int64_t ksh, int64_t vsb, int64_t vsh, float scale) {
    __shared__ float qs[MAX_DP], ik[MAX_DP];
    __shared__ float red[DC_THREADS / 8][DC_COLS + 1];
    const int64_t bh = blockIdx.y, b = bh / H, hh = bh % H;
    const int e0 = blockIdx.x * DC_COLS;
    const int tid = threadIdx.x, cq = tid & 7, rg = tid >> 3;
    const float f = expf(lf[bh]), ig = expf(fminf(li[bh], 30.f));
    for (int d = tid; d < dh; d += DC_THREADS) {
        qs[d] = bf(q[b * qsb + hh * qsh + d]) * scale;
        ik[d] = ig * bf(k[b * ksb + hh * ksh + d]);
    }
    float vv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) vv[u] = bf(v[b * vsb + hh * vsh + e0 + 4 * cq + u]);
    __syncthreads();
    const float* cin = C0 + bh * dh * dh + e0 + 4 * cq;
    float* cout = C + bh * dh * dh + e0 + 4 * cq;
    // rows rg, rg + 32, ...: DC_ROWS of them loaded before any is stored
    // (C may be C0, so a store would otherwise hold back the next loads)
    constexpr int STEP = DC_THREADS / 8;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = rg; d0 < dh; d0 += DC_ROWS * STEP) {
        float4 c[DC_ROWS];
#pragma unroll
        for (int r = 0; r < DC_ROWS; ++r) {
            const int d = d0 + r * STEP;
            if (d < dh)
                c[r] = *reinterpret_cast<const float4*>(cin + (int64_t)d * dh);
        }
#pragma unroll
        for (int r = 0; r < DC_ROWS; ++r) {
            const int d = d0 + r * STEP;
            if (d >= dh) break;
            const float kd = ik[d], qd = qs[d];
            c[r].x = fmaf(f, c[r].x, kd * vv[0]);
            c[r].y = fmaf(f, c[r].y, kd * vv[1]);
            c[r].z = fmaf(f, c[r].z, kd * vv[2]);
            c[r].w = fmaf(f, c[r].w, kd * vv[3]);
            *reinterpret_cast<float4*>(cout + (int64_t)d * dh) = c[r];
            acc[0] = fmaf(qd, c[r].x, acc[0]);
            acc[1] = fmaf(qd, c[r].y, acc[1]);
            acc[2] = fmaf(qd, c[r].z, acc[2]);
            acc[3] = fmaf(qd, c[r].w, acc[3]);
        }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) red[rg][4 * cq + u] = acc[u];
    __syncthreads();
    if (tid < DC_COLS) {
        float s = red[0][tid];
        for (int r = 1; r < DC_THREADS / 8; ++r) s += red[r][tid];
        h[bh * dh + e0 + tid] = s / den[bh];
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

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

// A (B, S, H, dh) bf16 tensor as the 4-D map (dh, H, S, B), boxes of
// 64 x 1 x 64 x 1 in the 128-byte swizzle (head dims past dh and rows past
// S read as zeros).  Byte strides are multiples of 16 and the base is
// 16-byte aligned (the wrapper checks).
static bool encode(CUtensorMap* map, const void* ptr, int64_t B, int64_t S,
                   int64_t H, int64_t dh, int64_t sb, int64_t ss,
                   int64_t sh) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)H, (cuuint64_t)S,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                   (cuuint64_t)sb * 2};
    const cuuint32_t box[4] = {64, 1, KC, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
              dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

static bool shape_ok(int64_t B, int64_t S, int64_t H, int64_t dh) {
    return B >= 1 && S >= 1 && H >= 1 && dh >= 32 && dh <= MAX_DP
           && dh % 32 == 0 && B * H <= 65535;
}

// The scratch the prefill's scores pass writes, in bytes.
extern "C" int64_t mlstm_scratch_bytes(int64_t BH, int64_t S, int64_t dh) {
    const int dp = (int)((dh + 63) / 64 * 64);
    return BH * ((S + KC - 1) / KC) * sc_bytes(dp);
}

// Prefill (any S >= 1; the wrapper sends S = 1 to decode): q, k, v bf16
// (B, S, H, dh), strides in elements (dh contiguous, 16-byte multiples);
// lf, li contiguous f32 (B, S, H); C0, C contiguous f32 (B, H, dh, dh);
// n0, n contiguous f32 (B, H, dh), n not n0; h contiguous f32 (B, S, H,
// dh); sc mlstm_scratch_bytes of scratch.  Returns the CUDA error of the
// launches (0 = launched), -1 for a shape the kernels do not take, -2 if
// a TMA map could not be built.
extern "C" int mlstm_prefill_launch(
    const void* q, const void* k, const void* v, const float* lf,
    const float* li, const float* C0, const float* n0, float* h, float* C,
    float* n, void* sc, int64_t B, int64_t S, int64_t H, int64_t dh,
    int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
    int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, float scale,
    void* stream) {
    if (!shape_ok(B, S, H, dh) || S > 0x7fffffff) return -1;
    const cudaStream_t st = (cudaStream_t)stream;
    const int dp = (int)((dh + 63) / 64 * 64);
    StateMaps m;
    if (!encode(&m.q, q, B, S, H, dh, qsb, qss, qsh)
        || !encode(&m.k, k, B, S, H, dh, ksb, kss, ksh)
        || !encode(&m.v, v, B, S, H, dh, vsb, vss, vsh))
        return -2;
    cudaError_t err = cudaFuncSetAttribute(
        mlstm_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SC_SMEM);
    if (err != cudaSuccess) return (int)err;
    const unsigned nch = (unsigned)((S + KC - 1) / KC);
    mlstm_scores_kernel<<<dim3(nch, (unsigned)(B * H)), SC_THREADS, SC_SMEM,
                          st>>>(
        m.q, m.k, lf, li, static_cast<uint8_t*>(sc), S, H, dp, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(mlstm_state_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ST_SMEM);
    if (err != cudaSuccess) return (int)err;
    mlstm_state_kernel<<<dim3((unsigned)(dp / BN), (unsigned)(B * H)),
                         ST_THREADS, ST_SMEM, st>>>(
        m, static_cast<const uint8_t*>(sc), C0, n0, h, C, n, S, H, (int)dh,
        dp);
    return (int)cudaGetLastError();
}

// Decode (S = 1): q, k, v bf16 (B, 1, H, dh), strides (batch, head) in
// elements; lf, li contiguous f32 (B, 1, H); C0, C contiguous, 16-byte
// aligned f32 (B, H, dh, dh), C may be C0; n0, n contiguous f32 (B, H,
// dh), n may be n0; h contiguous f32 (B, 1, H, dh); den B*H f32 of
// scratch.  Returns the CUDA error of the launches, or -1.
extern "C" int mlstm_decode_launch(
    const void* q, const void* k, const void* v, const float* lf,
    const float* li, const float* C0, const float* n0, float* h, float* C,
    float* n, float* den, int64_t B, int64_t H, int64_t dh, int64_t qsb,
    int64_t qsh, int64_t ksb, int64_t ksh, int64_t vsb, int64_t vsh,
    float scale, void* stream) {
    if (!shape_ok(B, 1, H, dh)) return -1;
    const cudaStream_t st = (cudaStream_t)stream;
    const auto* qp = static_cast<const uint16_t*>(q);
    const auto* kp = static_cast<const uint16_t*>(k);
    mlstm_decode_n_kernel<<<(unsigned)(B * H), DN_THREADS, 0, st>>>(
        qp, kp, lf, li, n0, n, den, H, (int)dh, qsb, qsh, ksb, ksh, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    mlstm_decode_c_kernel<<<dim3((unsigned)(dh / DC_COLS), (unsigned)(B * H)),
                            DC_THREADS, 0, st>>>(
        qp, kp, static_cast<const uint16_t*>(v), lf, li, C0, C, den, h, H,
        (int)dh, qsb, qsh, ksb, ksh, vsb, vsh, scale);
    return (int)cudaGetLastError();
}

// The kernels as the runtime sees them, in the order scores, state,
// decode n, decode C: out[4 i] dynamic shared memory bytes, out[4 i + 1]
// threads a block, out[4 i + 2] registers a
// thread, out[4 i + 3] local memory bytes a thread.  Returns a CUDA error.
extern "C" int mlstm_info(int* out) {
    const void* fns[4] = {(const void*)mlstm_scores_kernel,
                          (const void*)mlstm_state_kernel,
                          (const void*)mlstm_decode_n_kernel,
                          (const void*)mlstm_decode_c_kernel};
    const int smem[4] = {SC_SMEM, ST_SMEM, 0, 0};
    const int threads[4] = {SC_THREADS, ST_THREADS, DN_THREADS, DC_THREADS};
    for (int i = 0; i < 4; ++i) {
        cudaError_t err = cudaSuccess;
        if (smem[i] > 48 * 1024)
            err = cudaFuncSetAttribute(
                fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, smem[i]);
        cudaFuncAttributes fa;
        if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, fns[i]);
        if (err != cudaSuccess) return (int)err;
        out[4 * i] = smem[i];
        out[4 * i + 1] = threads[i];
        out[4 * i + 2] = fa.numRegs;
        out[4 * i + 3] = (int)fa.localSizeBytes;
    }
    return 0;
}
