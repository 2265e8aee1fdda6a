// Chunkwise mLSTM with its state carried in and out — the Hopper
// counterpart of the TPU kernel src/repro/kernels/mlstm_chunk/kernel.py::
// mlstm_chunk (Pallas), extended by the state the model's chunked form
// carries (src/repro/models/recurrent.py::mlstm_scan_chunked).
//
// What it computes, per (batch, head), over chunks of KC = 64 positions
// from the state (C0, n0):
//   d_j   = cumsum(log f)_j in the chunk (XLA's CPU order: blocks of 16,
//           each left to right from 0, plus the earlier blocks' totals)
//   inter = (q_j / sqrt(dh)) exp(d_j) . C          inter_n likewise with n
//   s_jl  = (q_j / sqrt(dh)) . k_l  exp(min(d_j - d_l + log i_l, 30)),
//           l <= j (the causal pairs and the tail past S are masked by
//           tests, never by adding -inf)
//   h_j   = (inter_j + sum_l s_jl v_l) / max(|inter_n_j + sum_l s_jl|, 1)
//   C     = C exp(d_end) + sum_l exp(d_end - d_l + log i_l) k_l v_l^T
//   n     = n exp(d_end) + sum_l exp(d_end - d_l + log i_l) k_l
// q, k, v are bf16 (B, S, H, dh) read through their strides (unit stride
// over dh); log f, log i f32 (B, S, H); C0, C f32 (B, H, dh, dh); n0, n
// f32 (B, H, dh); h is written f32 (B, S, H, dh).  Any S >= 1: the tail
// chunk is zero-filled past S with log f = 0 and log i = -1e30, as the
// model pads it, and S = 1 is a decode step.  All arithmetic is f32 FMAs
// on the CUDA cores; the sums run in another order than the plain
// version's, which the kernel is held to within atol 3e-4 / rtol 3e-3.
//
// The design, against what the card offers: the TPU kernel keeps one
// head's (dh, dh) state in VMEM; at xlstm-350m's dh = 512 that is 1 MiB of
// f32, against 227 KB of shared memory a block.  So the value axis of C
// is split across blocks: grid (dh / BE, B * H), and each block owns the
// columns C[:, e0:e0+BE] (64 KB at BE = 32) for the whole sequence, with
// the whole n (every block needs it for the normaliser).  Each block
// recomputes the chunk's K x K gated scores and the normaliser read
// q_dec . n; only its own columns of h and C are written (n by the block
// of columns 0).  A chunk's q and k sit transposed in shared memory as
// bf16 (64 KB each at dh 512), v's columns and the scores as f32; one
// block fills an SM (221 KB), 512 blocks at the xlstm-350m prefill shape.
//
// What bounds it on this card: operations.  At the prefill shape (B 8,
// S 512, H 4, dh 512) the function needs 18.3 GFLOP over the causal
// pairs (0.27 ms at 67 TFLOP/s f32) against ~151 MB of traffic (0.05 ms);
// the score recomputation in every column block doubles the kernel's own
// count.  Decode (S = 1) moves the 64 MB state and does little
// arithmetic: bytes.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int KC = 64;           // chunk
constexpr int BE = 32;           // columns of C a block owns (one a lane)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int JW = KC / WARPS;   // rows of a chunk a warp owns (inter, h)
constexpr int MAX_DH = 512;

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

// shared memory: floats first, then the two bf16 tiles (16-byte aligned:
// every float array below is a multiple of 4 floats)
__host__ __device__ constexpr size_t smem_floats(int dh) {
    return (size_t)dh * BE        // Cs [dh][BE]
           + dh                   // ns [dh]
           + KC * KC              // sT [l][j]
           + KC * BE              // vs [l][e]
           + 5 * KC               // dcum, eq, ek, lis, lfs
           + 4 * KC               // red: inter_n partials [4][KC]
           + 2 * KC               // interN, intraN
           + 4;                   // misc: exp(d_end)
}
__host__ __device__ constexpr size_t smem_bytes(int dh) {
    return smem_floats(dh) * 4 + 2 * (size_t)dh * KC * 2;
}

__global__ void __launch_bounds__(THREADS, 1)
mlstm_chunk_kernel(const uint16_t* __restrict__ q,
                   const uint16_t* __restrict__ k,
                   const uint16_t* __restrict__ v,
                   const float* __restrict__ lf, const float* __restrict__ li,
                   const float* __restrict__ C0, const float* __restrict__ n0,
                   float* __restrict__ h, float* __restrict__ Cout,
                   float* __restrict__ nout, int64_t S, int64_t H, int dh,
                   int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
                   int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
                   int64_t vsh, float scale) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* Cs = reinterpret_cast<float*>(smem);
    float* ns = Cs + dh * BE;
    float* sT = ns + dh;
    float* vs = sT + KC * KC;
    float* dcum = vs + KC * BE;
    float* eq = dcum + KC;
    float* ek = eq + KC;
    float* lis = ek + KC;
    float* lfs = lis + KC;
    float* red = lfs + KC;
    float* interN = red + 4 * KC;
    float* intraN = interN + KC;
    float* misc = intraN + KC;
    uint16_t* qT = reinterpret_cast<uint16_t*>(misc + 4);  // [dh][KC]
    uint16_t* kT = qT + dh * KC;                            // [dh][KC]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int e0 = blockIdx.x * BE;
    const int64_t bh = blockIdx.y;
    const int64_t b = bh / H, hh = bh % H;
    const float* C0p = C0 + bh * dh * dh;

    // this block's columns of C0 (16-byte loads, all in flight), and n0
#pragma unroll 4
    for (int i = tid; i < dh * (BE / 4); i += THREADS) {
        const int d = i / (BE / 4), c4 = i % (BE / 4);
        *reinterpret_cast<float4*>(Cs + d * BE + c4 * 4) =
            *reinterpret_cast<const float4*>(C0p + (int64_t)d * dh + e0
                                             + c4 * 4);
    }
    for (int i = tid; i < dh; i += THREADS) ns[i] = n0[bh * dh + i];

    const int64_t n_chunks = (S + KC - 1) / KC;
    for (int64_t c = 0; c < n_chunks; ++c) {
        const int64_t t0 = c * KC;
        const int kc = (int)(S - t0 < KC ? S - t0 : KC);
        __syncthreads();  // the previous chunk is done with every buffer

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
        // q and k transposed into shared memory, 8 elements a load; zero
        // past S (neighbouring threads on neighbouring rows j)
        const int octs = dh / 8;
        for (int i = tid; i < KC * octs; i += THREADS) {
            const int j = i % KC, o = i / KC;
            uint4 qa = make_uint4(0, 0, 0, 0), ka = qa;
            if (j < kc) {
                const int64_t t = t0 + j;
                qa = *reinterpret_cast<const uint4*>(
                    q + b * qsb + t * qss + hh * qsh + o * 8);
                ka = *reinterpret_cast<const uint4*>(
                    k + b * ksb + t * kss + hh * ksh + o * 8);
            }
            const uint16_t* qv = reinterpret_cast<const uint16_t*>(&qa);
            const uint16_t* kv = reinterpret_cast<const uint16_t*>(&ka);
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                qT[(o * 8 + u) * KC + j] = qv[u];
                kT[(o * 8 + u) * KC + j] = kv[u];
            }
        }
        // this block's columns of v, f32
        for (int i = tid; i < KC * BE; i += THREADS) {
            const int l = i / BE, e = i % BE;
            vs[i] = l < kc ? bf(v[b * vsb + (t0 + l) * vss + hh * vsh + e0
                                  + e])
                           : 0.f;
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
            for (int bb = 0; bb < KC / 16 - 1; ++bb)
                tot[bb] = dcum[bb * 16 + 15];
            __syncwarp();
            for (int j = lane; j < KC; j += 32) {
                float ex = 0.f;
                for (int bb = 0; bb < j / 16; ++bb) ex += tot[bb];
                dcum[j] = dcum[j] + ex;
            }
            __syncwarp();
            const float d_end = dcum[KC - 1];
            for (int j = lane; j < KC; j += 32) {
                eq[j] = expf(dcum[j]) * scale;
                ek[j] = expf((d_end - dcum[j]) + lis[j]);
            }
            if (lane == 0) misc[0] = expf(d_end);
        }
        __syncthreads();

        // the gated scores, a 4 x 4 tile a thread: s_jl into sT[l][j]
        {
            const int tj = tid / 16, tl = tid % 16;
            float acc[4][4] = {};
            if (tj * 4 < kc && tl * 4 < kc && tl <= tj) {
                for (int d = 0; d < dh; ++d) {
                    const uint2 qa = *reinterpret_cast<const uint2*>(
                        qT + d * KC + tj * 4);
                    const uint2 ka = *reinterpret_cast<const uint2*>(
                        kT + d * KC + tl * 4);
                    const float qf[4] = {lo16(qa.x), hi16(qa.x), lo16(qa.y),
                                         hi16(qa.y)};
                    const float kf[4] = {lo16(ka.x), hi16(ka.x), lo16(ka.y),
                                         hi16(ka.y)};
#pragma unroll
                    for (int a = 0; a < 4; ++a)
#pragma unroll
                        for (int bb = 0; bb < 4; ++bb)
                            acc[a][bb] = fmaf(qf[a], kf[bb], acc[a][bb]);
                }
            }
#pragma unroll
            for (int a = 0; a < 4; ++a) {
#pragma unroll
                for (int bb = 0; bb < 4; ++bb) {
                    const int j = tj * 4 + a, l = tl * 4 + bb;
                    float s = 0.f;
                    if (l <= j && j < kc) {
                        const float rel = (dcum[j] - dcum[l]) + lis[l];
                        s = acc[a][bb] * scale * expf(fminf(rel, 30.f));
                    }
                    sT[l * KC + j] = s;
                }
            }
        }
        // the normaliser read q_j . n, in four partial sums over dh
        {
            const int j = tid % KC, part = tid / KC, len = dh / 4;
            float a = 0.f;
            for (int d = part * len; d < (part + 1) * len; ++d)
                a = fmaf(bf(qT[d * KC + j]), ns[d], a);
            red[part * KC + j] = a;
        }
        __syncthreads();

        if (tid < KC) {
            float sn = 0.f;
            for (int l = 0; l < KC; ++l) sn += sT[l * KC + tid];
            intraN[tid] = sn;
            interN[tid] = eq[tid] * (((red[tid] + red[KC + tid])
                                      + red[2 * KC + tid])
                                     + red[3 * KC + tid]);
        }
        // inter (q . C) and intra (s . v) for the warp's rows, lane = column
        float ai[JW] = {}, aa[JW] = {};
        const int j0 = warp * JW;
        if (j0 < kc) {
            for (int d = 0; d < dh; ++d) {
                const float cv = Cs[d * BE + lane];
                const uint4 q8 = *reinterpret_cast<const uint4*>(
                    qT + d * KC + j0);
                const float qf[8] = {lo16(q8.x), hi16(q8.x), lo16(q8.y),
                                     hi16(q8.y), lo16(q8.z), hi16(q8.z),
                                     lo16(q8.w), hi16(q8.w)};
#pragma unroll
                for (int u = 0; u < JW; ++u) ai[u] = fmaf(qf[u], cv, ai[u]);
            }
            const int l_end = kc < j0 + JW ? kc : j0 + JW;
            for (int l = 0; l < l_end; ++l) {
                const float vv = vs[l * BE + lane];
                const float4 s0 = *reinterpret_cast<const float4*>(
                    sT + l * KC + j0);
                const float4 s1 = *reinterpret_cast<const float4*>(
                    sT + l * KC + j0 + 4);
                const float sf[8] = {s0.x, s0.y, s0.z, s0.w,
                                     s1.x, s1.y, s1.z, s1.w};
#pragma unroll
                for (int u = 0; u < JW; ++u) aa[u] = fmaf(sf[u], vv, aa[u]);
            }
        }
        __syncthreads();  // the normalisers are in; C and n are read

        // h for the warp's rows, this block's columns
#pragma unroll
        for (int u = 0; u < JW; ++u) {
            const int j = j0 + u;
            if (j < kc) {
                const float num = fmaf(eq[j], ai[u], aa[u]);
                const float den = fmaxf(fabsf(interN[j] + intraN[j]), 1.f);
                h[((b * S + t0 + j) * H + hh) * dh + e0 + lane] = num / den;
            }
        }
        // the state update: C[d, lane] for the warp's rows of d
        const float e_end = misc[0];
        float vk[KC];
#pragma unroll
        for (int l = 0; l < KC; ++l) vk[l] = ek[l] * vs[l * BE + lane];
        const int rows = dh / WARPS;
        const int groups = (kc + 7) / 8;  // groups of 8 positions with data
        for (int d = warp * rows; d < (warp + 1) * rows; ++d) {
            float a = 0.f;
#pragma unroll
            for (int l8 = 0; l8 < KC / 8; ++l8) {
                if (l8 >= groups) break;
                const uint4 k8 = *reinterpret_cast<const uint4*>(
                    kT + d * KC + l8 * 8);
                a = fmaf(lo16(k8.x), vk[l8 * 8 + 0], a);
                a = fmaf(hi16(k8.x), vk[l8 * 8 + 1], a);
                a = fmaf(lo16(k8.y), vk[l8 * 8 + 2], a);
                a = fmaf(hi16(k8.y), vk[l8 * 8 + 3], a);
                a = fmaf(lo16(k8.z), vk[l8 * 8 + 4], a);
                a = fmaf(hi16(k8.z), vk[l8 * 8 + 5], a);
                a = fmaf(lo16(k8.w), vk[l8 * 8 + 6], a);
                a = fmaf(hi16(k8.w), vk[l8 * 8 + 7], a);
            }
            Cs[d * BE + lane] = fmaf(Cs[d * BE + lane], e_end, a);
            // n[d]: lanes split the chunk's positions, then a warp sum
            const uint32_t kw = *reinterpret_cast<const uint32_t*>(
                kT + d * KC + 2 * lane);
            float p = fmaf(lo16(kw), ek[2 * lane],
                           hi16(kw) * ek[2 * lane + 1]);
            if (kc > 2) {  // else lane 0 holds every live position
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    p += __shfl_xor_sync(0xffffffffu, p, off);
            }
            if (lane == 0) ns[d] = fmaf(ns[d], e_end, p);
        }
    }
    __syncthreads();
    float* Cp = Cout + bh * dh * dh;
#pragma unroll 4
    for (int i = tid; i < dh * (BE / 4); i += THREADS) {
        const int d = i / (BE / 4), c4 = i % (BE / 4);
        *reinterpret_cast<float4*>(Cp + (int64_t)d * dh + e0 + c4 * 4) =
            *reinterpret_cast<const float4*>(Cs + d * BE + c4 * 4);
    }
    if (blockIdx.x == 0)
        for (int i = tid; i < dh; i += THREADS) nout[bh * dh + i] = ns[i];
}

// q, k, v: bf16 (B, S, H, dh), strides in elements (dh contiguous, rows
// 16-byte aligned); lf, li: contiguous f32 (B, S, H); C0, C: contiguous,
// 16-byte aligned f32 (B, H, dh, dh); n0, n: contiguous f32 (B, H, dh);
// h: contiguous f32 (B, S, H, dh).  Returns the CUDA error of the launch
// (0 = launched), or -1 for a shape the kernel does not take.
extern "C" int mlstm_chunk_launch(
    const void* q, const void* k, const void* v, const float* lf,
    const float* li, const float* C0, const float* n0, float* h, float* C,
    float* n, int64_t B, int64_t S, int64_t H, int64_t dh, int64_t qsb,
    int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh, float scale, void* stream) {
    if (B < 1 || S < 1 || H < 1 || dh < BE || dh > MAX_DH || dh % BE
        || B * H > 65535)
        return -1;
    const size_t smem = smem_bytes((int)dh);
    cudaError_t err = cudaFuncSetAttribute(
        mlstm_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)(dh / BE), (unsigned)(B * H));
    mlstm_chunk_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), lf, li, C0, n0, h, C, n, S, H,
        (int)dh, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, scale);
    return (int)cudaGetLastError();
}

// The dynamic shared memory a block of head dim dh asks for, in bytes.
extern "C" int64_t mlstm_chunk_smem_bytes(int64_t dh) {
    return (int64_t)smem_bytes((int)dh);
}
