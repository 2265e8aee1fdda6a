// Flash attention forward: online softmax over KV tiles — the Hopper
// counterpart of the TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_3d (Pallas).
//
// What it computes: for every (batch, query head) and query row,
// softmax(q k^T * scale + mask) v with scale = 1/sqrt(hd), in f32 inside
// (q, k, v are read as f32 or bf16 and converted; q is scaled before the
// product, as the TPU kernel does), output in q's type.  Masks, as in the
// TPU kernel: causal k_pos <= q_pos, window k_pos > q_pos - window, masked
// logits -1e30 (not -inf).  GQA: query head hq reads kv head hq / G with
// G = Hq / Hkv (the TPU wrapper's flattening (b*Hq + hq) / G is the same
// head).  Ragged Sq and Skv are masked here, not asserted: keys past Skv
// take no part in the softmax (p = 0), query rows past Sq are not stored.
//
// Design: one block of 128 threads per (b*Hq + hq, BQ query rows).  The
// block stages its query tile (scaled, transposed) once, then walks the KV
// tiles of BK keys in order, as the TPU grid walks its innermost axis:
// each tile is staged in shared memory (K transposed, V row-major, both
// f32), S = Q K^T goes to registers (thread (r, c) = (tid / 8, tid % 8)
// owns rows r + 16 i and keys c + 8 j), the running max, denominator and
// accumulator (rows r + 16 i, head dims c + 8 jd) stay in registers in
// f32, and P goes through shared memory for P V.  Products are plain f32
// FMAs: the f32 cases hold the 2e-5 bound that tensor cores (bf16 / TF32
// inputs) cannot.
//
// Tile skipping: a KV tile wholly above the causal diagonal or wholly
// before every row's window is not visited.  For a row with at least one
// live key this changes nothing (the TPU kernel accumulates exp(-1e30 - m)
// = 0 there, or junk under m = -1e30 that the first live tile's alpha = 0
// wipes out).  A row with no live key at all (window > 0 and q_pos - window
// + 1 > Skv - 1, possible only when Sq > Skv) gets the TPU kernel's
// uniform average over all keys: a block holding such a row visits every
// tile.
//
// What bounds it on this card: operations.  4 * Sq * Skv * hd FLOPs per
// (b, hq) before the causal cut, against (q + k + v + o) bytes read or
// written once; at the qwen3-1.7b prefill shape (S 512, hd 128) that is
// ~120 FLOPs a byte in bf16 — under the card's ~295 bf16 ridge, but these
// FMAs run at the f32 SIMT rate (67 TFLOP/s), not the tensor cores'.
// The design does nothing about that yet: mma / wgmma on bf16 tiles is
// later work.
#include <cstdint>
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

constexpr int THREADS = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
        float x) {
    return __float2bfloat16(x);  // round to nearest even, as astype
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
static int launch(const FlashArgs* a, cudaStream_t stream) {
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

template <typename T, int HD>
static int launch_tiles(const FlashArgs* a, int bq, int bk,
                        cudaStream_t stream) {
    if (bq == 64 && bk == 32) return launch<T, HD, 64, 32>(a, stream);
    if (bq == 32 && bk == 32) return launch<T, HD, 32, 32>(a, stream);
    if (bq == 64 && bk == 64) return launch<T, HD, 64, 64>(a, stream);
    return -1;
}

template <typename T>
static int launch_hd(const FlashArgs* a, int hd, int bq, int bk,
                     cudaStream_t stream) {
    switch (hd) {
        case 16: return launch_tiles<T, 16>(a, bq, bk, stream);
        case 64: return launch_tiles<T, 64>(a, bq, bk, stream);
        case 128: return launch_tiles<T, 128>(a, bq, bk, stream);
        case 256: return launch_tiles<T, 256>(a, bq, bk, stream);
        default: return -1;
    }
}

// dtype 0 = float32, 1 = bfloat16.  Returns the CUDA error of the launch
// (0 = launched), or -1 for a head dim / tile shape not instantiated.
extern "C" int flash_attention_launch(const FlashArgs* args, int dtype,
                                      int hd, int bq, int bk, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) return launch_hd<float>(args, hd, bq, bk, st);
    if (dtype == 1) return launch_hd<__nv_bfloat16>(args, hd, bq, bk, st);
    return -1;
}
