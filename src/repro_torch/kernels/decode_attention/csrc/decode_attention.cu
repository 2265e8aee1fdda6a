// Flash-decode: one query token's grouped query rows against a KV cache —
// the Hopper counterpart of the TPU kernel
// src/repro/kernels/decode_attention/kernel.py::decode_attention_3d
// (Pallas).
//
// What it computes: for every (batch, kv head) bh and each of its G query
// rows g (query head hq = hkv * G + g), softmax(q k^T * scale) v over the
// cache positions, where positions k_pos >= kv_len are masked with -1e30
// (not -inf), scale = 1/sqrt(hd); f32 inside (q scaled before the
// product, as the TPU kernel does), output in q's type.  kv_len is a host
// integer passed as a kernel argument, so the caller never syncs.  It need
// not be a multiple of any tile: positions past min(kv_len, Skv) are not
// visited (for kv_len >= 1 they add exp(-1e30 - m) = 0 in the TPU kernel;
// for kv_len <= 0 every position is masked and, as there, the result is
// the uniform average over all Skv positions).
//
// Design: one block of 128 threads per bh, walking the cache in tiles of
// 128 positions, one position per thread.  A thread reads its position's
// key row with 16-byte loads (the wrapper guarantees 16-byte aligned rows)
// and dots it with the G scaled query rows held in shared memory; the
// tile's max and sum for each g are block reductions (warp shuffles, then
// shared memory), every thread keeping the running max and denominator.
// The tile's V rows are staged in shared memory (f32) at the start of the
// tile, 16 bytes a thread with neighbouring threads on neighbouring
// bytes, so their loads overlap the key loads.  P goes to shared memory
// and each thread accumulates P V for its own head dims (d = tid % hd,
// and d + 128 for hd 256), key groups splitting the tile when hd < 128
// and summed once at the end.
//
// What bounds it on this card: bytes.  The whole live cache, K and V, is
// read once (2 * kv_len * hd * elt bytes per bh) for 4 * G * kv_len * hd
// FLOPs: ~2 FLOPs a byte for G = 2 in bf16, far under the ridge.  The
// design reads each byte once; what it does not do yet is spread one bh
// over several SMs (split-KV with a combine pass): with B * Hkv = 64
// blocks at the qwen3-1.7b decode shape, half the card's 132 SMs sit idle.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define NEG_INF (-1e30f)

struct DecodeArgs {
    const void* q;   // element (bh, g, d) at bh*q_sbh + g*q_sg + d
    const void* k;   // element (b, h, n, d) at b*k_sb + h*k_sh + n*k_ss + d
    const void* v;
    void* o;         // same layout rule as q, with o_* strides
    int64_t BH, Hkv, G, Skv, kv_len;
    int64_t q_sbh, q_sg;
    int64_t k_sb, k_sh, k_ss;
    int64_t v_sb, v_sh, v_ss;
    int64_t o_sbh, o_sg;
    float scale;
};

constexpr int THREADS = 128;  // = positions per tile
constexpr int WARPS = THREADS / 32;
constexpr int MAXG = 16;

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
    return __float2bfloat16(x);
}

// 16 bytes of a row as f32: 4 floats or 8 bf16
template <typename T> struct Vec;
template <> struct Vec<float> {
    static constexpr int N = 4;
    __device__ __forceinline__ static void load(const float* p, float* out) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
    }
};
template <> struct Vec<__nv_bfloat16> {
    static constexpr int N = 8;
    __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                                float* out) {
        const uint4 x = *reinterpret_cast<const uint4*>(p);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            out[2 * i] = f.x;
            out[2 * i + 1] = f.y;
        }
    }
};

template <int HD>
constexpr size_t decode_smem_bytes() {
    // vs [THREADS][HD], qs [MAXG][HD], ps [MAXG][THREADS] (reused for the
    // key-group sums), red [2][WARPS][MAXG]
    return sizeof(float) * ((size_t)THREADS * HD + (size_t)MAXG * HD
                            + (size_t)MAXG * THREADS + 2 * WARPS * MAXG);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) decode_kernel(DecodeArgs a) {
    constexpr int CPT = HD >= THREADS ? HD / THREADS : 1;  // dims a thread owns
    constexpr int KG = HD >= THREADS ? 1 : THREADS / HD;   // key groups in P V
    constexpr int VN = Vec<T>::N;
    extern __shared__ float4 smem4[];  // 16-byte aligned
    float* vs = reinterpret_cast<float*>(smem4);
    float* qs = vs + THREADS * HD;
    float* ps = qs + MAXG * HD;
    float* red_max = ps + MAXG * THREADS;
    float* red_sum = red_max + WARPS * MAXG;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int G = (int)a.G;
    const int64_t bh = blockIdx.x;
    const int64_t b = bh / a.Hkv, h = bh % a.Hkv;
    const T* q = (const T*)a.q + bh * a.q_sbh;
    const T* k = (const T*)a.k + b * a.k_sb + h * a.k_sh;
    const T* v = (const T*)a.v + b * a.v_sb + h * a.v_sh;
    T* o = (T*)a.o + bh * a.o_sbh;

    for (int idx = tid; idx < G * HD; idx += THREADS) {
        const int g = idx / HD, d = idx % HD;
        qs[g * HD + d] = to_f(q[g * a.q_sg + d]) * a.scale;
    }
    __syncthreads();

    const int d0 = tid % HD, kg = tid / HD;  // P V: dims d0 + c*THREADS
    float m_run[MAXG], l_run[MAXG], acc[MAXG][CPT];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
        m_run[g] = NEG_INF;
        l_run[g] = 0.f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[g][c] = 0.f;
    }

    const int64_t n_end = a.kv_len >= 1 ? min(a.kv_len, a.Skv) : a.Skv;
    for (int64_t k0 = 0; k0 < n_end; k0 += THREADS) {
        const int64_t n = k0 + tid;
        const int tile = (int)min((int64_t)THREADS, n_end - k0);
        // the tile's V rows to shared memory, 16 bytes a thread, coalesced
        for (int idx = tid; idx < tile * (HD / VN); idx += THREADS) {
            const int nn = idx / (HD / VN), dv = (idx % (HD / VN)) * VN;
            float x[VN];
            Vec<T>::load(v + (k0 + nn) * a.v_ss + dv, x);
#pragma unroll
            for (int e = 0; e < VN; e += 4)
                *reinterpret_cast<float4*>(vs + nn * HD + dv + e) =
                    make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
        }
        float s[MAXG];
        if (n < n_end) {
#pragma unroll
            for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
            const T* kr = k + n * a.k_ss;
#pragma unroll 4
            for (int d = 0; d < HD; d += VN) {
                float kv[VN];
                Vec<T>::load(kr + d, kv);
#pragma unroll
                for (int g = 0; g < MAXG; ++g) {
                    if (g < G) {
#pragma unroll
                        for (int e = 0; e < VN; ++e)
                            s[g] = fmaf(qs[g * HD + d + e], kv[e], s[g]);
                    }
                }
            }
            if (n >= a.kv_len) {
#pragma unroll
                for (int g = 0; g < MAXG; ++g) s[g] = NEG_INF;
            }
        } else {
#pragma unroll
            for (int g = 0; g < MAXG; ++g) s[g] = -INFINITY;  // not a position
        }

        // the tile's max per g
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
            if (g >= G) break;
            float x = s[g];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
            if (lane == 0) red_max[warp * MAXG + g] = x;
        }
        __syncthreads();
        float alpha[MAXG];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
            if (g >= G) break;
            float mx = red_max[g];
#pragma unroll
            for (int w = 1; w < WARPS; ++w)
                mx = fmaxf(mx, red_max[w * MAXG + g]);
            const float m_new = fmaxf(m_run[g], mx);
            alpha[g] = expf(m_run[g] - m_new);
            m_run[g] = m_new;
            const float p = expf(s[g] - m_new);
            ps[g * THREADS + tid] = p;
            float x = p;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                x += __shfl_xor_sync(0xffffffffu, x, off);
            if (lane == 0) red_sum[warp * MAXG + g] = x;
        }
        __syncthreads();
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
            if (g >= G) break;
            float sum = 0.f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) sum += red_sum[w * MAXG + g];
            l_run[g] = l_run[g] * alpha[g] + sum;
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[g][c] *= alpha[g];
        }

        for (int nn = kg; nn < tile; nn += KG) {
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
                const float vv = vs[nn * HD + d0 + c * THREADS];
#pragma unroll
                for (int g = 0; g < MAXG; ++g) {
                    if (g < G)
                        acc[g][c] = fmaf(ps[g * THREADS + nn], vv, acc[g][c]);
                }
            }
        }
        __syncthreads();  // vs / ps / red are rewritten by the next tile
    }

    if (KG > 1) {  // sum the key groups' partial accumulators (hd < 128)
        float* part = ps;  // [KG][MAXG][HD] = MAXG * THREADS floats
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
            if (g < G) part[(kg * MAXG + g) * HD + d0] = acc[g][0];
        __syncthreads();
        if (kg == 0) {
#pragma unroll
            for (int g = 0; g < MAXG; ++g) {
                if (g >= G) break;
                float x = 0.f;
                for (int j = 0; j < KG; ++j) x += part[(j * MAXG + g) * HD + d0];
                acc[g][0] = x;
            }
        }
    }
    if (kg == 0) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
            if (g >= G) break;
            const float denom = fmaxf(l_run[g], 1e-30f);
#pragma unroll
            for (int c = 0; c < CPT; ++c)
                o[g * a.o_sg + d0 + c * THREADS] = from_f<T>(acc[g][c] / denom);
        }
    }
}

template <typename T, int HD>
static int launch(const DecodeArgs* a, cudaStream_t stream) {
    constexpr size_t smem = decode_smem_bytes<HD>();
    auto fn = decode_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fn<<<(unsigned)a->BH, THREADS, smem, stream>>>(*a);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_hd(const DecodeArgs* a, int hd, cudaStream_t stream) {
    switch (hd) {
        case 16: return launch<T, 16>(a, stream);
        case 64: return launch<T, 64>(a, stream);
        case 128: return launch<T, 128>(a, stream);
        case 256: return launch<T, 256>(a, stream);
        default: return -1;
    }
}

// dtype 0 = float32, 1 = bfloat16.  Returns the CUDA error of the launch
// (0 = launched), or -1 for a head dim not instantiated or G > MAXG.
extern "C" int decode_attention_launch(const DecodeArgs* args, int dtype,
                                       int hd, void* stream) {
    if (args->G < 1 || args->G > MAXG) return -1;
    const cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) return launch_hd<float>(args, hd, st);
    if (dtype == 1) return launch_hd<__nv_bfloat16>(args, hd, st);
    return -1;
}
