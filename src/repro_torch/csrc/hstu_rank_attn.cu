// HSTU pointwise (SiLU) attention for Hopper (sm_90a), full float32 on the
// CUDA cores.  One kernel serves the four TPU kernels of the relay path:
//
//   * src/repro/kernels/hstu_attn.py::hstu_attn (_kernel): causal prefill,
//     run here with no prefix and every query an "incr" token;
//   * src/repro/kernels/prefix_rank_attn.py::prefix_rank_attn (_kernel):
//     rank with cache, prefix K/V read from a dense (B, H, P, D) view;
//   * src/repro/kernels/paged_prefix_attn.py::paged_prefix_rank_attn
//     (_prefix_pages_kernel + _new_tokens_kernel): the same scores with the
//     prefix K/V read from a (N + 1, page_tokens, H, D) page pool through
//     separate K and V page tables and a per-row resident length;
//   * src/repro/kernels/paged_prefix_attn.py::segment_rank_attn
//     (_segment_pages_kernel + _new_tokens_kernel): beyond-prefix reuse,
//     the table naming the pages of a row's cached SPANS in order, with
//     per-page page_pos / page_valid and per-query q_pos (below).
//
// What it computes: out[q] = sum_k mask(q, k) * silu(q.k / sqrt(D)) / n_total
// * v[k], keys = [prefix | new tokens].  Every query sees every resident
// prefix key; among the new tokens incr queries are causal and item
// queries see the incr tokens and themselves only.  There is no softmax
// state, so the sum splits over key tiles with nothing to rescale.
//
// Design.  The TPU ran a sequential kv grid axis with a VMEM accumulator
// (and, for the paged kernel, two passes joined by an f32 partial in
// HBM).  Hopper runs blocks in parallel with nothing carried between
// them.  Here one thread-block cluster of CL <= 8 blocks owns one
// (b, h, 64-query tile); block r of it loops over every CL-th 64-key tile
// of [prefix | new tokens] itself: the prefix tiles (dense view, or pages
// looked up by the block's own page-table loads), then the new-token
// tiles, into ONE f32 register accumulator.  The CL partial sums are then
// added through distributed shared memory in rank order.  The paged
// kernel is one pass; no partial sum ever reaches device memory.  The
// split matters at small batch: one block per (b, h, q-tile) gives 8
// blocks on 132 SMs for a B=1 rank.  CL depends only on the per-row shape
// (prefix length and new tokens), so each row's reduction order depends
// only on its own (b, h, q-tile), never on the batch.  The key tile is
// always 64 keys; a pool whose pages divide 64 is read page by page
// inside the tile, so the dense and paged paths add the same products in
// the same order and agree bit for bit at equal padded length.
//
// What bounds it.  At the live ranking shape (2048-token psi, 80 new
// tokens, H = 4, D = 64) one layer is ~0.17 GFLOP over ~4.4 MB of K/V: in
// full f32 on the CUDA cores (67 TFLOP/s) it is bound by operations, with
// tensor cores it would be bound by bytes.  This first version keeps f32
// FMAs (TF32/bf16 with wgmma + TMA is a later decision) and spends its
// design on the operation side: 4x4 register tiles per thread for both
// products, K stored transposed and Q/P rows padded in shared memory so
// the inner loops issue 128-bit shared loads without bank conflicts, and
// tiles that the mask wholly removes (keys past the causal edge, item x
// item tiles off the diagonal, pages past a row's resident length) are
// never loaded or multiplied.  Dropping a tile is exact: its products
// are all +-0 and adding them leaves the accumulator unchanged.
//
// The segment mode is a compile-time variant (SEG), so the three other
// kernels run the code they ran before it existed.  Its cached keys are
// the table's pages in order (key_row addresses them as key /
// page_tokens); key j of slot p sits at global position page_pos[p] + j
// and exists only where j < page_valid[p].  Per 64-key tile the block
// first writes each key's position to shared memory (INT_MAX where the
// page does not hold it), so the mask becomes one compare, key position
// <= q_pos[q], and a key a page does not hold is never read (it enters
// the products as zero, like a key past prefix_lens).  A tile is
// skipped only when no key of it is visible to any query of the tile:
// slots past the spans, pages whose position lies after the tile's last
// query.  The fresh tokens are the new-token pass unchanged (local
// causality equals global causality, since q_pos increases).  With one
// span at [0, prefix_len) and q_pos after it, the visited tiles, the
// loaded values and the mask bits are kernel 3's, so the two agree bit
// for bit; the cluster split is the same function of the shape.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

extern "C" {

struct RankAttnParams {
    const float* q;      long long q_stride[3];    // (B, H, Sq, D), unit D stride
    const float* k_new;  long long kn_stride[3];   // (B, H, Sq, D)
    const float* v_new;  long long vn_stride[3];
    const float* k_pre;  long long kp_stride[3];   // dense prefix (B, H, n_prefix, D)
    const float* v_pre;  long long vp_stride[3];
    const float* k_pool;                           // (N + 1, page_tokens, H, D)
    const float* v_pool;
    const int* k_table;                            // (B, n_pages) rows
    const int* v_table;
    long long kt_stride;                           // row stride of each table
    long long vt_stride;
    const int* prefix_lens;                        // (B,) resident prefix tokens
    float* out;          long long o_stride[3];    // (B, H, Sq, D)
    int B, H, Sq, D;
    int n_prefix;                                  // prefix keys (paged: n_pages * page_tokens)
    int n_incr;                                    // new tokens before the items
    int page_tokens;
    int paged;                                     // 1: prefix from the pool
    float scale;                                   // 1 / sqrt(D)
    float n_total;                                 // the normalizer n
    // segment mode, after the older members so their offsets stay put
    const int* page_pos;   long long pp_stride;    // (B, n_pages) rows
    const int* page_valid; long long pv_stride;    // (B, n_pages) rows
    const int* q_pos;      long long qp_stride;    // (B, Sq) rows
    int segment;                                   // 1: pool pages are spans (paged too)
};

}  // extern "C"

namespace {

constexpr int BQ = 64;    // queries per block
constexpr int BK = 64;    // keys per tile
constexpr int NT = 256;   // threads: a 16 x 16 grid, 4 rows x 4 columns each
constexpr int PS = BK + 4;

enum Source { kNew = 0, kDense = 1, kPaged = 2 };

template <int D, bool SEG = false> struct Geometry {
    static constexpr int QS = D + 4;   // padded Q row: breaks bank aliasing, keeps 16 B alignment
    static constexpr int DC = D / 16;  // output columns per thread
    // + the segment mode's key and query positions (32-bit ints)
    static constexpr int floats = BQ * QS + D * BK + BK * D + BQ * PS + (SEG ? BK + BQ : 0);
};

__device__ __forceinline__ float lane(const float4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

template <int D>
__device__ __forceinline__ const float* key_row(const RankAttnParams& p, int src,
                                                bool value, int b, int h, int key) {
    if (src == kNew) {
        const long long* s = value ? p.vn_stride : p.kn_stride;
        return (value ? p.v_new : p.k_new) + b * s[0] + h * s[1] + key * s[2];
    }
    if (src == kDense) {
        const long long* s = value ? p.vp_stride : p.kp_stride;
        return (value ? p.v_pre : p.k_pre) + b * s[0] + h * s[1] + key * s[2];
    }
    const int* table = value ? p.v_table : p.k_table;
    const long long ts = value ? p.vt_stride : p.kt_stride;
    const long long page = table[b * ts + key / p.page_tokens];
    const float* pool = value ? p.v_pool : p.k_pool;
    return pool + ((page * p.page_tokens + key % p.page_tokens) * p.H + h) * (long long)D;
}

// Keys [k0, k0 + n_valid) into shared memory: K transposed (sKT[d][c]),
// V row-major; keys past n_valid are zero so no garbage enters a product.
// SPAN: so are the keys whose position sKpos[c] is INT_MAX (not held).
template <int D, bool SPAN = false>
__device__ __forceinline__ void load_tile(float* sKT, float* sV, const RankAttnParams& p,
                                          int src, int b, int h, int k0, int n_valid,
                                          const int* sKpos = nullptr) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int idx = threadIdx.x; idx < BK * (D / 4); idx += NT) {
        const int c = idx % BK, d = (idx / BK) * 4;   // consecutive threads: consecutive keys
        float4 k = zero;
        if (c < n_valid && (!SPAN || sKpos[c] != INT_MAX))
            k = *reinterpret_cast<const float4*>(key_row<D>(p, src, false, b, h, k0 + c) + d);
        sKT[(d + 0) * BK + c] = k.x;
        sKT[(d + 1) * BK + c] = k.y;
        sKT[(d + 2) * BK + c] = k.z;
        sKT[(d + 3) * BK + c] = k.w;
    }
    for (int idx = threadIdx.x; idx < BK * (D / 4); idx += NT) {
        const int c = idx / (D / 4), d = (idx % (D / 4)) * 4;
        float4 v = zero;
        if (c < n_valid && (!SPAN || sKpos[c] != INT_MAX))
            v = *reinterpret_cast<const float4*>(key_row<D>(p, src, true, b, h, k0 + c) + d);
        *reinterpret_cast<float4*>(sV + c * D + d) = v;
    }
}

// sP = mask(silu(Q K^T * scale) / n_total) for one key tile.  Thread
// (ty, tx) owns rows ty + 16 i and columns 4 tx + j.  SPAN: the mask is
// sKpos[c] <= sQpos[r] (the segment mode's cached keys).
template <int D, bool SPAN = false>
__device__ __forceinline__ void tile_scores(const float* sQ, const float* sKT, float* sP,
                                            const RankAttnParams& p, bool rank_mask,
                                            int q0, int k0, int n_valid,
                                            const int* sKpos = nullptr,
                                            const int* sQpos = nullptr) {
    constexpr int QS = Geometry<D>::QS;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            a[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * QS + d);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float4 k = *reinterpret_cast<const float4*>(sKT + (d + e) * BK + tx * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float qa = lane(a[i], e);
                s[i][0] = fmaf(qa, k.x, s[i][0]);
                s[i][1] = fmaf(qa, k.y, s[i][1]);
                s[i][2] = fmaf(qa, k.z, s[i][2]);
                s[i][3] = fmaf(qa, k.w, s[i][3]);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = tx * 4 + j, ki = k0 + c;
            bool visible = c < n_valid;
            if (SPAN) visible = visible && sKpos[c] <= sQpos[r];
            if (rank_mask)
                visible = visible && ki <= qi &&
                          (qi < p.n_incr || ki < p.n_incr || ki == qi);
            sP[r * PS + c] = visible ? silu(s[i][j] * p.scale) / p.n_total : 0.f;
        }
    }
}

// acc += sP . sV, keys in order 0..63 for every output element.
template <int D>
__device__ __forceinline__ void tile_accumulate(float (&acc)[4][D / 16], const float* sP,
                                                const float* sV) {
    constexpr int DC = Geometry<D>::DC;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
        float4 pr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            pr[i] = *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * PS + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float v[DC];
            const float* vrow = sV + (c + e) * D + tx * DC;
            if constexpr (DC % 4 == 0) {
#pragma unroll
                for (int j = 0; j < DC; j += 4) {
                    const float4 t = *reinterpret_cast<const float4*>(vrow + j);
                    v[j] = t.x; v[j + 1] = t.y; v[j + 2] = t.z; v[j + 3] = t.w;
                }
            } else {
#pragma unroll
                for (int j = 0; j < DC; j += 2) {
                    const float2 t = *reinterpret_cast<const float2*>(vrow + j);
                    v[j] = t.x; v[j + 1] = t.y;
                }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float pa = lane(pr[i], e);
#pragma unroll
                for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pa, v[j], acc[i][j]);
            }
        }
    }
}

template <int D, bool SEG>
__global__ void __launch_bounds__(NT) hstu_rank_attn_kernel(const RankAttnParams p) {
    constexpr int QS = Geometry<D>::QS, DC = Geometry<D>::DC;
    extern __shared__ float4 smem4[];
    float* sQ = reinterpret_cast<float*>(smem4);
    float* sKT = sQ + BQ * QS;
    float* sV = sKT + D * BK;
    float* sP = sV + BK * D;

    // a cluster of CL blocks shares one (b, h, q-tile); block `rank` of
    // it takes every CL-th key tile of the sequence [prefix | new]
    const cg::cluster_group cluster = cg::this_cluster();
    const int CL = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int q0 = (blockIdx.x / CL) * BQ, h = blockIdx.y, b = blockIdx.z;
    const int q1 = min(q0 + BQ, p.Sq) - 1;   // last query of this tile

    const float* qb = p.q + b * p.q_stride[0] + h * p.q_stride[1];
    for (int idx = threadIdx.x; idx < BQ * (D / 4); idx += NT) {
        const int r = idx / (D / 4), d = (idx % (D / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q0 + r < p.Sq)
            v = *reinterpret_cast<const float4*>(qb + (q0 + r) * p.q_stride[2] + d);
        *reinterpret_cast<float4*>(sQ + r * QS + d) = v;
    }

    float acc[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

    const int n_pre_tiles = (p.n_prefix + BK - 1) / BK;   // padded: same split dense/paged
    if constexpr (SEG) {
        // 1s) cached spans: key position <= query position, where held
        int* sKpos = reinterpret_cast<int*>(sP + BQ * PS);
        int* sQpos = sKpos + BK;
        const int* qpos = p.q_pos + b * p.qp_stride;
        if (threadIdx.x < BQ)
            sQpos[threadIdx.x] = q0 + threadIdx.x < p.Sq ? qpos[q0 + threadIdx.x] : INT_MIN;
        __syncthreads();
        int qmax = INT_MIN;   // the tile's last visible position
        for (int r = 0; r < BQ; ++r) qmax = max(qmax, sQpos[r]);
        for (int k0 = rank * BK; k0 < p.n_prefix; k0 += CL * BK) {
            const int n_valid = min(BK, p.n_prefix - k0);
            __syncthreads();   // the last tile's reads of sKpos are done
            if (threadIdx.x < BK) {
                const int c = threadIdx.x, key = k0 + c;
                int pos = INT_MAX;
                if (c < n_valid) {
                    const int slot = key / p.page_tokens, j = key % p.page_tokens;
                    if (j < p.page_valid[b * p.pv_stride + slot])
                        pos = p.page_pos[b * p.pp_stride + slot] + j;
                }
                sKpos[c] = pos;
            }
            // a block-uniform skip: no key of the tile is visible to any query
            if (!__syncthreads_or(threadIdx.x < BK && sKpos[threadIdx.x] <= qmax)) continue;
            load_tile<D, true>(sKT, sV, p, kPaged, b, h, k0, n_valid, sKpos);
            __syncthreads();
            tile_scores<D, true>(sQ, sKT, sP, p, false, q0, k0, n_valid, sKpos, sQpos);
            __syncthreads();
            tile_accumulate<D>(acc, sP, sV);
        }
    } else {
        // 1) prefix: every query sees every resident key
        const int src = p.paged ? kPaged : kDense;
        const int plen = p.paged ? min(p.n_prefix, p.prefix_lens[b]) : p.n_prefix;
        for (int k0 = rank * BK; k0 < plen; k0 += CL * BK) {
            const int n_valid = min(BK, plen - k0);
            __syncthreads();
            load_tile<D>(sKT, sV, p, src, b, h, k0, n_valid);
            __syncthreads();
            tile_scores<D>(sQ, sKT, sP, p, false, q0, k0, n_valid);
            __syncthreads();
            tile_accumulate<D>(acc, sP, sV);
        }
    }

    // 2) new tokens under the rank mask; tiles past the causal edge and
    //    item x item tiles off the diagonal hold no visible key
    const int first_new = ((rank - n_pre_tiles) % CL + CL) % CL;
    for (int k0 = first_new * BK; k0 <= q1; k0 += CL * BK) {
        if (q0 >= p.n_incr && k0 >= p.n_incr && k0 + BK - 1 < q0) continue;
        const int n_valid = min(BK, p.Sq - k0);
        __syncthreads();
        load_tile<D>(sKT, sV, p, kNew, b, h, k0, n_valid);
        __syncthreads();
        tile_scores<D>(sQ, sKT, sP, p, true, q0, k0, n_valid);
        __syncthreads();
        tile_accumulate<D>(acc, sP, sV);
    }

    // 3) reduce the cluster's partial sums through distributed shared
    //    memory, in rank order (a fixed order: no atomics, no partial in
    //    device memory); block `rank` writes its share of the rows
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float* sAcc = sKT;                       // BQ x D, over the K/V tiles
    __syncthreads();                         // the last tile's reads are done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) sAcc[(ty + 16 * i) * D + tx * DC + j] = acc[i][j];
    cluster.sync();
    const int rows = (BQ + CL - 1) / CL, r0 = rank * rows, r1 = min(BQ, r0 + rows);
    float* ob = p.out + b * p.o_stride[0] + h * p.o_stride[1];
    for (int idx = threadIdx.x; idx < (r1 - r0) * D; idx += NT) {
        const int r = r0 + idx / D, c = idx % D;
        if (q0 + r >= p.Sq) continue;
        float s = 0.f;
        for (int src_rank = 0; src_rank < CL; ++src_rank)
            s += cluster.map_shared_rank(sAcc, src_rank)[r * D + c];
        ob[(q0 + r) * p.o_stride[2] + c] = s;
    }
    cluster.sync();                          // peers may still read our sAcc
}

// Blocks per (b, h, q-tile): enough that each takes ~4 key tiles, at most
// the portable cluster size.  A function of the per-row shape only —
// never of the batch — so a row's summation order ignores its batch, and
// dense, paged and segment launches at equal padded length split
// identically.
int cluster_size(const RankAttnParams& p) {
    const int tiles = (p.n_prefix + BK - 1) / BK + (p.Sq + BK - 1) / BK;
    return min(8, max(1, (tiles + 3) / 4));
}

template <int D, bool SEG>
cudaError_t launch(const RankAttnParams& p, cudaStream_t stream) {
    const int smem = static_cast<int>(sizeof(float) * Geometry<D, SEG>::floats);
    static unsigned configured = 0;   // one bit per device: the > 48 KB opt-in
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (!(configured & (1u << dev))) {
        err = cudaFuncSetAttribute(hstu_rank_attn_kernel<D, SEG>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        configured |= 1u << dev;
    }
    const int CL = cluster_size(p);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(((p.Sq + BQ - 1) / BQ) * CL, p.H, p.B);
    cfg.blockDim = dim3(NT, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, hstu_rank_attn_kernel<D, SEG>, p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

extern "C" int hstu_rank_attn_f32(const RankAttnParams* p, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (p->segment && !p->paged) return static_cast<int>(cudaErrorInvalidValue);
    switch (p->D) {
        case 32: return p->segment ? launch<32, true>(*p, s) : launch<32, false>(*p, s);
        case 64: return p->segment ? launch<64, true>(*p, s) : launch<64, false>(*p, s);
        case 128: return p->segment ? launch<128, true>(*p, s) : launch<128, false>(*p, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

extern "C" const char* hstu_rank_attn_error(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int hstu_rank_attn_struct_size() { return static_cast<int>(sizeof(RankAttnParams)); }
