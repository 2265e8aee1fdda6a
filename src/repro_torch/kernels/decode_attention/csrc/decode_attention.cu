// Flash-decode: one query token's grouped query rows against a KV cache,
// split over the cache — the Hopper counterpart of the TPU kernel
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
// the uniform average over all Skv positions: every split then covers
// its share of all Skv positions, each with m = -1e30).
//
// What bounds it on this card: bytes.  The live cache, K and V, is read
// once (2 * kv_len * hd * elt bytes per bh) for 4 * G * kv_len * hd FLOPs:
// ~2 FLOPs a byte for G = 2 in bf16, far under the ridge, so tensor cores
// do not help; what helps is keeping the card full of bytes in flight.
//
// Design: grid (B * Hkv, nsplit).  The wrapper picks nsplit
// (ops.split_count) so that B * Hkv * nsplit covers the card's SMs twice
// where each split still holds at least 64 positions; split s of bh takes
// positions [s * n / nsplit, (s + 1) * n / nsplit) of the n it visits.  A
// block is 4 warps that work alone until the end: warp w takes the
// split's tiles of PW rows (8, or 16 at 32-byte rows) w, w + 4, ..., and
// streams each tile's K and V rows into its own ring of shared memory
// (2 or 4 stages) with 16-byte cp.async copies, the next stages in flight
// while it computes on one.  In a tile, the lanes of a warp split a row's
// 16-byte chunks (16 lanes for hd 128 in bf16, so two rows at once); the
// dot with each scaled query row (held in shared memory, f32) is reduced
// across those lanes by shuffles, and each lane group keeps its own
// online softmax (max, denominator) and its chunks of P V for every g,
// in f32 (with G <= 2 the lane's chunks of the query rows stay in
// registers).  At the end the lane groups, then the 4 warps (through the
// ring's shared memory), merge their states in a fixed order.  With one
// split the block writes the output; otherwise it writes its partial
// (o, m, l) in f32 to scratch and a second kernel, launched by the same
// call, merges the splits in split order.  No atomics: two calls give the
// same bits.
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

constexpr int THREADS = 128;
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
    __device__ __forceinline__ static void load(const void* p, float* out) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
    }
};
template <> struct Vec<__nv_bfloat16> {
    static constexpr int N = 8;
    __device__ __forceinline__ static void load(const void* p, float* out) {
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename T, int HD, int GCAP>
struct Dc {
    static constexpr int VEC = Vec<T>::N;          // elements in 16 bytes
    static constexpr int NCH = HD / VEC;           // 16-byte chunks a row
    static constexpr int LW = NCH < 32 ? NCH : 32; // lanes on one row
    static constexpr int CPL = NCH / LW;           // chunks a lane owns
    static constexpr int PWT = 32 / LW;            // rows a warp takes at once
    static constexpr int PW = PWT > 8 ? PWT : 8;   // rows of a warp's tile
    static constexpr int ROW = HD * (int)sizeof(T);
    static constexpr int STAGE = 2 * PW * ROW;     // K then V of a tile
    static constexpr int STAGES = STAGE >= 8192 ? 2 : 4;
    static constexpr size_t RING = (size_t)WARPS * STAGES * STAGE;
    // the warps' merged states: [WARPS][GCAP][HD + 2] f32 (o, m, l)
    static constexpr size_t MERGE = (size_t)WARPS * GCAP * (HD + 2) * 4;
    static constexpr size_t SHARED = RING > MERGE ? RING : MERGE;
    static constexpr size_t SMEM = SHARED + (size_t)GCAP * HD * 4;
};

template <typename T, int HD, int GCAP>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(DecodeArgs a, float* part, int nsplit) {
    using D = Dc<T, HD, GCAP>;
    constexpr int VEC = D::VEC, LW = D::LW, CPL = D::CPL, PWT = D::PWT;
    constexpr int PW = D::PW, ROW = D::ROW, STAGES = D::STAGES;
    constexpr int NA = CPL * VEC;  // head dims a lane accumulates
    extern __shared__ float4 smem4[];  // 16-byte aligned
    uint8_t* ring = reinterpret_cast<uint8_t*>(smem4);
    float* qs = reinterpret_cast<float*>(ring + D::SHARED);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int G = (int)a.G;
    const int64_t bh = blockIdx.x, split = blockIdx.y;
    const int64_t b = bh / a.Hkv, h = bh % a.Hkv;
    const T* q = (const T*)a.q + bh * a.q_sbh;
    const T* k = (const T*)a.k + b * a.k_sb + h * a.k_sh;
    const T* v = (const T*)a.v + b * a.v_sb + h * a.v_sh;

    for (int idx = tid; idx < G * HD; idx += THREADS) {
        const int g = idx / HD, d = idx % HD;
        qs[g * HD + d] = to_f(q[g * a.q_sg + d]) * a.scale;
    }
    __syncthreads();

    const bool all_masked = a.kv_len < 1;
    const int64_t n_end = all_masked ? a.Skv : min(a.kv_len, a.Skv);
    const int64_t n0 = split * n_end / nsplit;
    const int64_t n1 = (split + 1) * n_end / nsplit;
    const int64_t n_tiles = (n1 - n0 + PW - 1) / PW;
    const int my_tiles = n_tiles > warp
        ? (int)((n_tiles - warp + WARPS - 1) / WARPS) : 0;
    uint8_t* my_ring = ring + (size_t)warp * STAGES * D::STAGE;

    // the j-th tile of this warp: K rows, then V rows, into stage j % STAGES
    auto issue = [&](int j) {
        const int64_t r0 = n0 + (int64_t)(warp + j * WARPS) * PW;
        const int rows = (int)min((int64_t)PW, n1 - r0);
        uint8_t* kst = my_ring + (j % STAGES) * D::STAGE;
        uint8_t* vst = kst + PW * ROW;
        for (int idx = lane; idx < rows * D::NCH; idx += 32) {
            const int r = idx / D::NCH, c = idx % D::NCH;
            cp_async16(kst + r * ROW + c * 16, k + (r0 + r) * a.k_ss + c * VEC);
            cp_async16(vst + r * ROW + c * 16, v + (r0 + r) * a.v_ss + c * VEC);
        }
    };

    float m[GCAP], l[GCAP], acc[GCAP][NA];
#pragma unroll
    for (int g = 0; g < GCAP; ++g) {
        m[g] = NEG_INF;
        l[g] = 0.f;
#pragma unroll
        for (int e = 0; e < NA; ++e) acc[g][e] = 0.f;
    }

#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
        if (j < my_tiles) issue(j);
        cp_async_commit();
    }
    const int grp = lane / LW, li = lane % LW;  // lane group (row), lane in it
    // small groups keep the lane's chunks of the query rows in registers
    constexpr bool QREG = GCAP <= 4;
    float qr[QREG ? GCAP : 1][NA];
    if constexpr (QREG) {
#pragma unroll
        for (int g = 0; g < GCAP; ++g)
#pragma unroll
            for (int ci = 0; ci < CPL; ++ci)
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                    qr[g][ci * VEC + e] =
                        g < G ? qs[g * HD + (li + LW * ci) * VEC + e] : 0.f;
    }
    for (int j = 0; j < my_tiles; ++j) {
        if (j + STAGES - 1 < my_tiles) issue(j + STAGES - 1);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();  // tile j's copies have landed
        __syncwarp();
        const uint8_t* kst = my_ring + (j % STAGES) * D::STAGE;
        const uint8_t* vst = kst + PW * ROW;
        const int64_t r0 = n0 + (int64_t)(warp + j * WARPS) * PW;
        const int rows = (int)min((int64_t)PW, n1 - r0);
#pragma unroll
        for (int rr = 0; rr < PW / PWT; ++rr) {
            const int r = rr * PWT + grp;
            float sd[GCAP];
#pragma unroll
            for (int g = 0; g < GCAP; ++g) sd[g] = 0.f;
#pragma unroll
            for (int ci = 0; ci < CPL; ++ci) {
                const int c = li + LW * ci;
                float kv[VEC];
                Vec<T>::load(kst + r * ROW + c * 16, kv);
#pragma unroll
                for (int g = 0; g < GCAP; ++g) {
                    if (g < G) {
#pragma unroll
                        for (int e = 0; e < VEC; ++e) {
                            float qv;
                            if constexpr (QREG) qv = qr[g][ci * VEC + e];
                            else qv = qs[g * HD + c * VEC + e];
                            sd[g] = fmaf(qv, kv[e], sd[g]);
                        }
                    }
                }
            }
#pragma unroll
            for (int g = 0; g < GCAP; ++g) {
                if (g < G) {
#pragma unroll
                    for (int off = LW / 2; off > 0; off >>= 1)
                        sd[g] += __shfl_xor_sync(0xffffffffu, sd[g], off);
                }
            }
            if (r < rows) {  // the same for every lane of a group
                float vv[NA];
#pragma unroll
                for (int ci = 0; ci < CPL; ++ci)
                    Vec<T>::load(vst + r * ROW + (li + LW * ci) * 16,
                                 vv + ci * VEC);
#pragma unroll
                for (int g = 0; g < GCAP; ++g) {
                    if (g < G) {
                        const float s = all_masked ? NEG_INF : sd[g];
                        const float mn = fmaxf(m[g], s);
                        const float al = expf(m[g] - mn);
                        const float p = expf(s - mn);
                        l[g] = l[g] * al + p;
                        m[g] = mn;
#pragma unroll
                        for (int e = 0; e < NA; ++e)
                            acc[g][e] = fmaf(p, vv[e], acc[g][e] * al);
                    }
                }
            }
        }
        __syncwarp();  // the stage is read; the next issue may refill it
    }

    // merge the lane groups of the warp (rows taken side by side)
#pragma unroll
    for (int off = LW; off < 32; off <<= 1) {
#pragma unroll
        for (int g = 0; g < GCAP; ++g) {
            if (g < G) {
                const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
                const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
                const float mn = fmaxf(m[g], mo);
                const float a1 = expf(m[g] - mn), a2 = expf(mo - mn);
                l[g] = l[g] * a1 + lo * a2;
                m[g] = mn;
#pragma unroll
                for (int e = 0; e < NA; ++e) {
                    const float x =
                        __shfl_xor_sync(0xffffffffu, acc[g][e], off);
                    acc[g][e] = acc[g][e] * a1 + x * a2;
                }
            }
        }
    }

    // then the warps, through shared memory (the ring is done with)
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    float* mrg = reinterpret_cast<float*>(ring);  // [WARPS][GCAP][HD + 2]
    if (grp == 0) {
#pragma unroll
        for (int g = 0; g < GCAP; ++g) {
            if (g < G) {
                float* row = mrg + ((size_t)warp * GCAP + g) * (HD + 2);
#pragma unroll
                for (int ci = 0; ci < CPL; ++ci)
#pragma unroll
                    for (int e = 0; e < VEC; ++e)
                        row[(li + LW * ci) * VEC + e] = acc[g][ci * VEC + e];
                if (li == 0) {
                    row[HD] = m[g];
                    row[HD + 1] = l[g];
                }
            }
        }
    }
    __syncthreads();
    for (int idx = tid; idx < G * HD; idx += THREADS) {
        const int g = idx / HD, d = idx % HD;
        float mx = NEG_INF;
#pragma unroll
        for (int w = 0; w < WARPS; ++w)
            mx = fmaxf(mx, mrg[((size_t)w * GCAP + g) * (HD + 2) + HD]);
        float lsum = 0.f, osum = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const float* row = mrg + ((size_t)w * GCAP + g) * (HD + 2);
            const float f = expf(row[HD] - mx);
            lsum += row[HD + 1] * f;
            osum += row[d] * f;
        }
        if (nsplit == 1) {
            T* o = (T*)a.o + bh * a.o_sbh;
            o[g * a.o_sg + d] = from_f<T>(osum / fmaxf(lsum, 1e-30f));
        } else {
            float* pr = part + ((bh * nsplit + split) * G + g) * (HD + 2);
            pr[d] = osum;
            if (d == 0) {
                pr[HD] = mx;
                pr[HD + 1] = lsum;
            }
        }
    }
}

// the splits' partials [BH][nsplit][G][hd + 2] (o, m, l), merged in split
// order
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(DecodeArgs a, const float* part, int nsplit, int hd) {
    const int64_t bh = blockIdx.x;
    const int G = (int)a.G;
    T* o = (T*)a.o + bh * a.o_sbh;
    for (int idx = threadIdx.x; idx < G * hd; idx += THREADS) {
        const int g = idx / hd, d = idx % hd;
        const float* p0 = part + (bh * nsplit * G + g) * (hd + 2);
        const int64_t step = (int64_t)G * (hd + 2);  // to the next split
        float mx = NEG_INF;
        for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, p0[s * step + hd]);
        float lsum = 0.f, osum = 0.f;
        for (int s = 0; s < nsplit; ++s) {
            const float* pr = p0 + s * step;
            const float f = expf(pr[hd] - mx);
            lsum += pr[hd + 1] * f;
            osum += pr[d] * f;
        }
        o[g * a.o_sg + d] = from_f<T>(osum / fmaxf(lsum, 1e-30f));
    }
}

template <typename T, int HD, int GCAP>
static int launch(const DecodeArgs* a, int nsplit, float* part,
                  cudaStream_t stream) {
    using D = Dc<T, HD, GCAP>;
    auto fn = decode_split_kernel<T, HD, GCAP>;
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)D::SMEM);
    if (err != cudaSuccess) return (int)err;
    fn<<<dim3((unsigned)a->BH, (unsigned)nsplit), THREADS, D::SMEM, stream>>>(
        *a, part, nsplit);
    err = cudaGetLastError();
    if (err != cudaSuccess || nsplit == 1) return (int)err;
    decode_combine_kernel<T><<<(unsigned)a->BH, THREADS, 0, stream>>>(
        *a, part, nsplit, HD);
    return (int)cudaGetLastError();
}

template <typename T, int GCAP>
static int launch_hd(const DecodeArgs* a, int hd, int nsplit, float* part,
                     cudaStream_t stream) {
    switch (hd) {
        case 16: return launch<T, 16, GCAP>(a, nsplit, part, stream);
        case 64: return launch<T, 64, GCAP>(a, nsplit, part, stream);
        case 128: return launch<T, 128, GCAP>(a, nsplit, part, stream);
        case 256: return launch<T, 256, GCAP>(a, nsplit, part, stream);
        default: return -1;
    }
}

template <typename T>
static int launch_g(const DecodeArgs* a, int hd, int nsplit, float* part,
                    cudaStream_t stream) {
    if (a->G <= 2) return launch_hd<T, 2>(a, hd, nsplit, part, stream);
    return launch_hd<T, MAXG>(a, hd, nsplit, part, stream);
}

// dtype 0 = float32, 1 = bfloat16.  ``part`` is f32 scratch of
// BH * nsplit * G * (hd + 2) values (unused when nsplit is 1).  Launches
// the split kernel and, for nsplit > 1, the merge.  Returns the CUDA error
// of the launches (0 = launched), or -1 for a head dim not instantiated,
// G > MAXG or nsplit < 1.
extern "C" int decode_attention_launch(const DecodeArgs* args, int dtype,
                                       int hd, int nsplit, float* part,
                                       void* stream) {
    if (args->G < 1 || args->G > MAXG || nsplit < 1) return -1;
    if (nsplit > 1 && part == nullptr) return -1;
    const cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) return launch_g<float>(args, hd, nsplit, part, st);
    if (dtype == 1) return launch_g<__nv_bfloat16>(args, hd, nsplit, part, st);
    return -1;
}
