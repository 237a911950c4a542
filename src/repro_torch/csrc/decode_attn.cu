// Flash-decode softmax attention for Hopper (sm_90a): one query per
// sequence over a ring KV cache, with GQA.  Replaces the TPU kernel
// src/repro/kernels/decode_attn.py::decode_attn (_kernel).
//
//   out[b, h] = softmax_s(q[b, h] . k[b, s, h / G] / sqrt(D)) . v[b, s, h / G],
//   G = H / KV; every slot s of the cache is attended (no length mask).
//
// q (B, H, D) and out (B, H, D) in the model's type; k, v are read in the
// MODEL layout (B, S, KV, D) through their strides — the reference
// wrapper transposed the whole cache to (B, KV, S, D) on every call,
// which on this card would cost more than the kernel.  float32 or
// bfloat16 inputs; logits, softmax weights and sums stay float32 on the
// CUDA cores.
//
// Design.  The TPU kernel walks the keys of one (b, h) sequentially
// with a running (max, sum, acc) in VMEM.  At the Zamba2 decode shape
// (B = 2, 32 heads) that is 64 rows for 132 SMs, so here the keys are
// split instead: pass 1 gives each block one (b, kv head, 128-key
// split) — 2 x 32 x 64 = 4096 blocks at S = 8192 — loads the split's K
// and V rows once for all G query heads of the kv head (16-byte loads,
// converted to float32 in shared memory), and writes each head's
// partial (max, sum, PV) to a float32 scratch; pass 2 merges the
// splits of each (b, h) with the usual rescaling.  The ragged last
// split masks its own edge, so any S is taken and nothing falls back.
//
// What bounds it.  At that shape the cache is ~134 MB of bf16 K + V for
// ~0.07 GFLOP: bound by bytes (~0.04 ms at 3.35 TB/s).  The scratch adds
// B * H * n_split * (D + 2) * 4 bytes each way (~1 MB here).  This first
// version loads a split, then computes on it; it relies on several
// resident blocks per SM, not on asynchronous copies, to keep loads in
// flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

extern "C" {

struct DecodeParams {
    const void* q;  long long q_stride[2];    // (B, H, D): b, h; unit d
    const void* k;  long long k_stride[3];    // (B, S, KV, D): b, s, kv; unit d
    const void* v;  long long v_stride[3];
    void* out;      long long o_stride[2];    // (B, H, D)
    float* part;                              // (B, H, n_split, D + 2) float32 scratch
    int B, H, KV, S, D, n_split;
    int dtype;                                // 0 float32, 1 bfloat16
    float scale;                              // 1 / sqrt(D)
};

}  // extern "C"

namespace {

constexpr int BK = 128;       // keys per split (one block)
constexpr int NT = 128;       // threads per block
constexpr int SMEM_MAX = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* d, float x) { *d = x; }
__device__ __forceinline__ void store(__nv_bfloat16* d, float x) { *d = __float2bfloat16(x); }

// one 16-byte load, widened to float32
template <typename T> struct Vec;
template <> struct Vec<float> {
    static constexpr int n = 4;
    __device__ static void load(const float* src, float* dst) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
    }
};
template <> struct Vec<__nv_bfloat16> {
    static constexpr int n = 8;
    __device__ static void load(const __nv_bfloat16* src, float* dst) {
        const uint4 u = *reinterpret_cast<const uint4*>(src);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h2[i]);
            dst[2 * i] = f.x; dst[2 * i + 1] = f.y;
        }
    }
};

int smem_bytes(int G, int D) {
    return static_cast<int>(sizeof(float)) * (BK * (D + 1) + BK * D + G * D + G * BK);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) decode_partial_kernel(const DecodeParams p) {
    constexpr int KS = D + 1;                  // padded K row: key t's column d, conflict-free
    constexpr int VN = Vec<T>::n, VR = D / VN;
    extern __shared__ float smem[];
    const int G = p.H / p.KV;
    float* sK = smem;                          // (BK, D + 1)
    float* sV = sK + BK * KS;                  // (BK, D)
    float* sQ = sV + BK * D;                   // (G, D), pre-scaled
    float* sP = sQ + G * D;                    // (G, BK) logits, then weights

    const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int s0 = split * BK, n_valid = min(BK, p.S - s0);
    const int tid = threadIdx.x;

    const T* q = static_cast<const T*>(p.q) + b * p.q_stride[0];
    for (int idx = tid; idx < G * D; idx += NT) {
        const int g = idx / D, d = idx % D;
        sQ[idx] = to_f(q[(kvh * G + g) * p.q_stride[1] + d]) * p.scale;
    }
    const T* kb = static_cast<const T*>(p.k) + b * p.k_stride[0] + kvh * p.k_stride[2];
    const T* vb = static_cast<const T*>(p.v) + b * p.v_stride[0] + kvh * p.v_stride[2];
    for (int idx = tid; idx < BK * VR; idx += NT) {
        const int t = idx / VR, j = (idx % VR) * VN;   // neighbours read one row
        float kv[VN], vv[VN];
        if (t < n_valid) {
            Vec<T>::load(kb + (s0 + t) * p.k_stride[1] + j, kv);
            Vec<T>::load(vb + (s0 + t) * p.v_stride[1] + j, vv);
        } else {
#pragma unroll
            for (int e = 0; e < VN; ++e) kv[e] = vv[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VN; ++e) {
            sK[t * KS + j + e] = kv[e];
            sV[t * D + j + e] = vv[e];
        }
    }
    __syncthreads();

    for (int idx = tid; idx < G * BK; idx += NT) {
        const int g = idx / BK, t = idx % BK;
        float s = -INFINITY;                   // past the ragged edge: weight exactly 0
        if (t < n_valid) {
            s = 0.f;
#pragma unroll 16
            for (int d = 0; d < D; ++d) s = fmaf(sQ[g * D + d], sK[t * KS + d], s);
        }
        sP[idx] = s;
    }
    __syncthreads();

    // per head: the split's max and sum, weights back into sP
    const int w = tid / 32, lane = tid % 32;
    for (int g = w; g < G; g += NT / 32) {
        float sv[BK / 32], m = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 32; ++j) {
            sv[j] = sP[g * BK + lane + 32 * j];
            m = fmaxf(m, sv[j]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        float l = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 32; ++j) {
            const float e = expf(sv[j] - m);   // m is finite: every split has a live key
            sP[g * BK + lane + 32 * j] = e;
            l += e;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
        if (lane == 0) {
            float* pr = p.part + ((static_cast<long long>(b) * p.H + kvh * G + g) * p.n_split + split) * (D + 2);
            pr[D] = m;
            pr[D + 1] = l;
        }
    }
    __syncthreads();

    for (int idx = tid; idx < G * D; idx += NT) {
        const int g = idx / D, d = idx % D;
        float acc = 0.f;
        for (int t = 0; t < n_valid; ++t) acc = fmaf(sP[g * BK + t], sV[t * D + d], acc);
        p.part[((static_cast<long long>(b) * p.H + kvh * G + g) * p.n_split + split) * (D + 2) + d] = acc;
    }
}

// merge the splits of one (b, h): thread d owns output column d
template <typename T>
__global__ void decode_combine_kernel(const DecodeParams p) {
    const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
    const int W = p.D + 2;
    const float* pr = p.part + (static_cast<long long>(b) * p.H + h) * p.n_split * W;
    float m = -INFINITY;
    for (int s = 0; s < p.n_split; ++s) m = fmaxf(m, pr[s * W + p.D]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < p.n_split; ++s) {
        const float c = expf(pr[s * W + p.D] - m);
        l = fmaf(c, pr[s * W + p.D + 1], l);
        acc = fmaf(c, pr[s * W + d], acc);
    }
    T* o = static_cast<T*>(p.out) + b * p.o_stride[0] + h * p.o_stride[1];
    store(o + d, acc / l);
}

template <typename T, int D>
cudaError_t launch(const DecodeParams& p, cudaStream_t stream) {
    const int smem = smem_bytes(p.H / p.KV, D);
    cudaError_t err = cudaFuncSetAttribute(decode_partial_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    decode_partial_kernel<T, D><<<dim3(p.n_split, p.KV, p.B), NT, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    decode_combine_kernel<T><<<dim3(p.H, p.B), D, 0, stream>>>(p);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const DecodeParams& p, cudaStream_t s) {
    switch (p.D) {
        case 32: return launch<T, 32>(p, s);
        case 64: return launch<T, 64>(p, s);
        case 128: return launch<T, 128>(p, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" int decode_attn(const DecodeParams* p, void* stream) {
    if (p->B < 1 || p->S < 1 || p->KV < 1 || p->H % p->KV != 0 ||
        p->n_split != (p->S + BK - 1) / BK || smem_bytes(p->H / p->KV, p->D) > SMEM_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (p->dtype == 0) return static_cast<int>(dispatch<float>(*p, s));
    if (p->dtype == 1) return static_cast<int>(dispatch<__nv_bfloat16>(*p, s));
    return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int decode_attn_keys_per_split() { return BK; }

extern "C" int decode_attn_struct_size() { return static_cast<int>(sizeof(DecodeParams)); }
