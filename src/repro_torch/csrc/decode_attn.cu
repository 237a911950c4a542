// Flash-decode softmax attention for Hopper (sm_90a): one query per
// sequence over a ring KV cache, with GQA.  Replaces the TPU kernel
// src/repro/kernels/decode_attn.py::decode_attn (_kernel).
//
//   out[b, h] = softmax_s(q[b, h] . k[b, s, h / G] / sqrt(D)) . v[b, s, h / G],
//   G = H / KV; every slot s of the cache is attended (no length mask).
//   lse[b, h] = log sum_s exp(q[b, h] . k[b, s, h / G] / sqrt(D))  (optional)
//
// q (B, H, D) and out (B, H, D) in the model's type; k, v are read in the
// MODEL layout (B, S, KV, D) through their strides, so no transposed copy
// of the cache is ever made.  float32 or bfloat16 inputs; logits, softmax
// weights and sums stay float32 on the CUDA cores.
//
// What bounds it.  At the Zamba2 decode shape (B 2, H = KV = 32, S 8192,
// D 64, bf16) the cache is ~134 MB of K + V for ~0.07 GFLOP: bound by
// bytes (~0.04 ms at 3.35 TB/s).  Each key row of one kv head is 128 B,
// and the next key's row lies KV * D elements on.
//
// Design (a pipelined split-K decode).  The TPU kernel walks the keys of
// one (b, h) in order with a running (max, sum, acc) in VMEM.  Here:
//
//   * The keys of each (b, kv head) are split into `n_split` runs of
//     `keys_per_split`, a plan the wrapper sizes to the card
//     (kernels/cuda_lib.py::decode_split_plan): at most one block per
//     SM, all in one wave, so no SM carries more runs than another and
//     the fewest runs stream the cache at once.
//     One block of 128 threads owns one (kv head, split, b) and up to
//     GH = 4 query heads of that kv head (larger G takes several head
//     groups, each its own block); every loaded K / V row serves them all.
//   * The kv head is the grid's fastest axis, so the blocks resident at
//     once read the same keys of neighbouring kv heads: together whole
//     rows of the cache, not 128 B pieces of many DRAM pages.
//   * K and V stay in their own type in shared memory.  Each block streams
//     its run through a ring of NS = 4 tiles filled by 16-byte `cp.async`
//     copies, NS - 1 tiles (48 KB) in flight while one is consumed.
//     Values widen to float32 in registers, at use.
//   * A key row is D * sizeof(T) / 16 lanes (8 at D 64 in bf16), each
//     owning one 16-byte chunk of the row; the dot product finishes in
//     log2 of that many shuffles.  Every thread copies exactly the chunks
//     it later reads, so the ring needs no barrier: `cp.async.wait_group`
//     alone makes a tile visible to the thread that reads it.
//   * Each lane group keeps an online softmax (max, sum, acc of its D
//     chunk) in registers, updated once per KPG = 4 keys of a tile; the
//     PV step is the same lanes on the same rows, so every thread works.
//     The block merges its lane groups in a fixed order into one float32
//     partial (acc, max, sum) per head, in its shared memory.
//   * The n_split blocks of a row form one thread-block cluster, and the
//     splits merge through distributed shared memory in split order: no
//     partial in device memory, no second launch (a second launch, and a
//     merge through device memory behind an atomic ticket, each left a
//     tail on the card's profile).  The orders are fixed, so two calls
//     give the same bits.
//
// The log-sum-exp.  Where the caller asks for it (`lse` not null), the
// block that writes head h's element d = 0 also writes lse[b, h] =
// (max + log2(sum)) ln 2 in float32, from the same fixed-order merge of
// the splits: the scores are held in log2 units, so the merged max and sum
// are those of the row's softmax.  Nothing else changes, so `out` has the
// same bits with and without it.  A caller that holds a ring in parts (the
// sequence sharded over devices) merges the parts' outputs with it.
//
// Ragged edges: a run's last tile masks keys past the run (zero-filled
// copies, score -inf), so any S is taken and nothing falls back.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

extern "C" {

struct DecodeParams {
    const void* q;  long long q_stride[2];    // (B, H, D): b, h; unit d
    const void* k;  long long k_stride[3];    // (B, S, KV, D): b, s, kv; unit d
    const void* v;  long long v_stride[3];
    void* out;      long long o_stride[2];    // (B, H, D)
    float* lse;     long long lse_stride;     // (B, H) float32: b; unit h; null: not asked
    int B, H, KV, S, D;
    int n_split, keys_per_split;              // the split plan; n_split blocks per cluster
    int heads_per_block;                      // GH: 1, 2 or 4 query heads per block
    int dtype;                                // 0 float32, 1 bfloat16
    float scale;                              // 1 / sqrt(D)
};

}  // extern "C"

namespace {

constexpr int NT = 128;         // threads per block
constexpr int NS = 4;           // ring stages
constexpr int KPG = 4;          // keys per lane group per tile
constexpr int MAX_SPLITS = 8;   // the portable cluster size
constexpr int RING_BYTES = NS * 2 * KPG * NT * 16;   // 64 KB, any type and D
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void store(float* d, float x) { *d = x; }
__device__ __forceinline__ void store(__nv_bfloat16* d, float x) { *d = __float2bfloat16(x); }

// one 16-byte chunk, widened to float32
template <typename T> struct Chunk;
template <> struct Chunk<float> {
    static constexpr int n = 4;
    __device__ static void widen(const uint4& u, float* f) {
        f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
        f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
    }
};
template <> struct Chunk<__nv_bfloat16> {
    static constexpr int n = 8;
    __device__ static void widen(const uint4& u, float* f) {
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 x = __bfloat1622float2(h2[i]);
            f[2 * i] = x.x; f[2 * i + 1] = x.y;
        }
    }
};

// 16-byte asynchronous copy to shared memory; `live` false writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(live ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename T, int D, int GH>
__global__ void __launch_bounds__(NT) decode_attn_kernel(const DecodeParams p) {
    constexpr int VN = Chunk<T>::n;            // elements per 16-byte chunk
    constexpr int LPR = D / VN;                // lanes per key row
    constexpr int RPB = NT / LPR;              // lane groups (rows per pass) per block
    constexpr int TK = KPG * RPB;              // keys per tile
    constexpr int TILE = TK * D;               // elements of one K (or V) tile
    constexpr int W = D + 2;                   // a partial: acc, max, sum
    static_assert(2 * TILE * sizeof(T) * NS == RING_BYTES, "ring size");
    static_assert((RPB + 1) * GH * W * sizeof(float) <= RING_BYTES, "merge buffers");
    extern __shared__ uint4 smem[];
    T* ring = reinterpret_cast<T*>(smem);      // NS x (K tile, V tile), rows of D

    const cg::cluster_group cluster = cg::this_cluster();   // the n_split runs of a row
    const int hgrid = blockIdx.x, split = blockIdx.y, b = blockIdx.z;   // kv head fastest
    const int G = p.H / p.KV;
    const int n_hg = (G + GH - 1) / GH;
    const int kvh = hgrid / n_hg, g0 = (hgrid % n_hg) * GH;
    const int s0 = split * p.keys_per_split;
    const int n_keys = min(p.keys_per_split, p.S - s0);
    const int n_tiles = (n_keys + TK - 1) / TK;
    const int tid = threadIdx.x;
    const int grp = tid / LPR, j = tid % LPR;  // key row of the pass; chunk of the row

    const T* kb = static_cast<const T*>(p.k) + b * p.k_stride[0] + kvh * p.k_stride[2] +
                  s0 * p.k_stride[1] + j * VN;
    const T* vb = static_cast<const T*>(p.v) + b * p.v_stride[0] + kvh * p.v_stride[2] +
                  s0 * p.v_stride[1] + j * VN;

    // the chunks this thread copies are exactly the ones it reads:
    // rows grp + kk * RPB of each tile, chunk j
    auto issue = [&](int tile) {
        T* sk = ring + (tile % NS) * 2 * TILE + grp * D + j * VN;
        T* sv = sk + TILE;
#pragma unroll
        for (int kk = 0; kk < KPG; ++kk) {
            const int t = tile * TK + kk * RPB + grp;
            const bool live = t < n_keys;
            const long long row = live ? t : 0;
            cp_async16(sk + kk * RPB * D, kb + row * p.k_stride[1], live);
            cp_async16(sv + kk * RPB * D, vb + row * p.v_stride[1], live);
        }
    };
#pragma unroll
    for (int st = 0; st < NS - 1; ++st) {
        if (st < n_tiles) issue(st);
        cp_async_commit();
    }

    // this lane's chunk of each head's query, in log2 units
    float qf[GH][VN];
    const T* q = static_cast<const T*>(p.q) + b * p.q_stride[0] + j * VN;
#pragma unroll
    for (int g = 0; g < GH; ++g) {
        if (g0 + g < G) {
            Chunk<T>::widen(*reinterpret_cast<const uint4*>(q + (kvh * G + g0 + g) * p.q_stride[1]),
                            qf[g]);
#pragma unroll
            for (int e = 0; e < VN; ++e) qf[g][e] *= p.scale * LOG2E;
        } else {
#pragma unroll
            for (int e = 0; e < VN; ++e) qf[g][e] = 0.f;
        }
    }

    float m[GH], l[GH], acc[GH][VN];
#pragma unroll
    for (int g = 0; g < GH; ++g) {
        m[g] = -INFINITY;
        l[g] = 0.f;
#pragma unroll
        for (int e = 0; e < VN; ++e) acc[g][e] = 0.f;
    }

    for (int tile = 0; tile < n_tiles; ++tile) {
        cp_async_wait<NS - 2>();               // this thread's copies of `tile` landed
        if (tile + NS - 1 < n_tiles) issue(tile + NS - 1);   // into the slot read last time
        cp_async_commit();

        const T* sk = ring + (tile % NS) * 2 * TILE + grp * D + j * VN;
        const T* sv = sk + TILE;
        float s[GH][KPG];
#pragma unroll
        for (int kk = 0; kk < KPG; ++kk) {
            float kf[VN];
            Chunk<T>::widen(*reinterpret_cast<const uint4*>(sk + kk * RPB * D), kf);
#pragma unroll
            for (int g = 0; g < GH; ++g) {
                float x = 0.f;
#pragma unroll
                for (int e = 0; e < VN; ++e) x = fmaf(qf[g][e], kf[e], x);
                s[g][kk] = x;
            }
        }
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
            for (int g = 0; g < GH; ++g)
#pragma unroll
                for (int kk = 0; kk < KPG; ++kk)
                    s[g][kk] += __shfl_xor_sync(0xffffffffu, s[g][kk], o);

        float corr[GH];
#pragma unroll
        for (int g = 0; g < GH; ++g) {
            float mx = m[g];
#pragma unroll
            for (int kk = 0; kk < KPG; ++kk) {
                if (tile * TK + kk * RPB + grp >= n_keys) s[g][kk] = -INFINITY;
                mx = fmaxf(mx, s[g][kk]);
            }
            // mx is -inf only while this lane group has seen no live key:
            // then every weight is 0 and the state stays as it is
            const float base = mx == -INFINITY ? 0.f : mx;
            corr[g] = exp2f(m[g] - base);
            m[g] = mx;
            float sum = 0.f;
#pragma unroll
            for (int kk = 0; kk < KPG; ++kk) {
                s[g][kk] = exp2f(s[g][kk] - base);
                sum += s[g][kk];
            }
            l[g] = fmaf(l[g], corr[g], sum);
        }
#pragma unroll
        for (int g = 0; g < GH; ++g)
#pragma unroll
            for (int e = 0; e < VN; ++e) acc[g][e] *= corr[g];
#pragma unroll
        for (int kk = 0; kk < KPG; ++kk) {
            float vf[VN];
            Chunk<T>::widen(*reinterpret_cast<const uint4*>(sv + kk * RPB * D), vf);
#pragma unroll
            for (int g = 0; g < GH; ++g)
#pragma unroll
                for (int e = 0; e < VN; ++e) acc[g][e] = fmaf(s[g][kk], vf[e], acc[g][e]);
        }
    }

    // merge the lane groups in a fixed order into this block's partial;
    // the ring becomes the buffers
    cp_async_wait<0>();
    __syncthreads();
    float* sm = reinterpret_cast<float*>(smem);   // (RPB, GH, W) lane-group states
    float* part = sm + RPB * GH * W;              // (GH, W) this split's partial
#pragma unroll
    for (int g = 0; g < GH; ++g) {
        float* row = sm + (grp * GH + g) * W;
#pragma unroll
        for (int e = 0; e < VN; ++e) row[j * VN + e] = acc[g][e];
        if (j == 0) {
            row[D] = m[g];
            row[D + 1] = l[g];
        }
    }
    __syncthreads();
    for (int idx = tid; idx < GH * D; idx += NT) {
        const int g = idx / D, d = idx % D;
        float mx = -INFINITY;
        for (int r = 0; r < RPB; ++r) mx = fmaxf(mx, sm[(r * GH + g) * W + D]);
        mx = mx == -INFINITY ? 0.f : mx;       // a padded head (g0 + g >= G) saw no key
        float sum = 0.f, a = 0.f;
        for (int r = 0; r < RPB; ++r) {
            const float* row = sm + (r * GH + g) * W;
            const float c = exp2f(row[D] - mx);
            sum = fmaf(c, row[D + 1], sum);
            a = fmaf(c, row[d], a);
        }
        part[g * W + d] = a;
        if (d == 0) {
            part[g * W + D] = mx;
            part[g * W + D + 1] = sum;
        }
    }

    // merge the row's splits in split order through distributed shared
    // memory; block `split` writes its share of the outputs
    cluster.sync();
    const int per = (GH * D + p.n_split - 1) / p.n_split;
    for (int idx = split * per + tid; idx < min(GH * D, (split + 1) * per); idx += NT) {
        const int g = idx / D, d = idx % D;
        if (g0 + g >= G) continue;
        float mx = -INFINITY, sum = 0.f, a = 0.f;
        for (int r = 0; r < p.n_split; ++r) {
            const float* pr = cluster.map_shared_rank(part, r) + g * W;
            const float mr = pr[D];            // finite: every run holds a live key
            const float nm = fmaxf(mx, mr);
            const float c_old = exp2f(mx - nm), c = exp2f(mr - nm);
            sum = fmaf(sum, c_old, pr[D + 1] * c);
            a = fmaf(a, c_old, pr[d] * c);
            mx = nm;
        }
        const int h = kvh * G + g0 + g;
        store(static_cast<T*>(p.out) + b * p.o_stride[0] + h * p.o_stride[1] + d, a / sum);
        if (d == 0 && p.lse != nullptr)
            p.lse[b * p.lse_stride + h] = (mx + log2f(sum)) * LN2;
    }
    cluster.sync();                            // peers may still read our partial
}

template <typename T, int D, int GH>
cudaError_t launch(const DecodeParams& p, cudaStream_t stream) {
    static unsigned configured = 0;            // one bit per device: the > 48 KB opt-in
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (!(configured & (1u << dev))) {
        err = cudaFuncSetAttribute(decode_attn_kernel<T, D, GH>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES);
        if (err != cudaSuccess) return err;
        configured |= 1u << dev;
    }
    const int n_hg = (p.H / p.KV + GH - 1) / GH;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = p.n_split;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.KV * n_hg, p.n_split, p.B);
    cfg.blockDim = dim3(NT, 1, 1);
    cfg.dynamicSmemBytes = RING_BYTES;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, decode_attn_kernel<T, D, GH>, p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_heads(const DecodeParams& p, cudaStream_t s) {
    switch (p.heads_per_block) {
        case 1: return launch<T, D, 1>(p, s);
        case 2: return launch<T, D, 2>(p, s);
        case 4: return launch<T, D, 4>(p, s);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T>
cudaError_t dispatch(const DecodeParams& p, cudaStream_t s) {
    switch (p.D) {
        case 32: return by_heads<T, 32>(p, s);
        case 64: return by_heads<T, 64>(p, s);
        case 128: return by_heads<T, 128>(p, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" int decode_attn(const DecodeParams* p, void* stream) {
    if (p->B < 1 || p->S < 1 || p->KV < 1 || p->H % p->KV != 0 || p->keys_per_split < 1 ||
        p->n_split < 1 || p->n_split > MAX_SPLITS ||
        p->n_split != (p->S + p->keys_per_split - 1) / p->keys_per_split)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (p->dtype == 0) return static_cast<int>(dispatch<float>(*p, s));
    if (p->dtype == 1) return static_cast<int>(dispatch<__nv_bfloat16>(*p, s));
    return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int decode_attn_max_splits() { return MAX_SPLITS; }

extern "C" int decode_attn_struct_size() { return static_cast<int>(sizeof(DecodeParams)); }
