// HSTU pointwise (SiLU) attention for Hopper (sm_90a), float32 or bfloat16
// in and out, both products on the tensor cores in 3xTF32 with float32
// sums.  One kernel serves the four TPU kernels of the relay path:
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
// What bounds it.  At the live ranking shape (2048-token psi, 80 new
// tokens, H = 4, D = 64) a (b, h) row is ~0.04 GFLOP over ~1 MB of K/V.
// On the CUDA cores (67 TFLOP/s FP32) that is bound by operations, ~10x
// over its bytes.  Single-pass TF32 keeps ~3 decimal digits, which the
// model's scores (card vs CPU within 1e-4 of the largest) do not allow.
// 3xTF32 keeps ~22 bits: three tensor-core products per product, whose
// bound (3 x FLOPs / 495 TFLOP/s) lies below the FP32 one.  mma.sync
// stays short of that peak (only wgmma reaches it); what holds the kernel
// further back is the issue of everything beside the products -- a
// hi/lo split (4 integer/float operations) per operand value, two shared
// loads per three products, the SiLU and the mask -- and, at small
// batch, per-block key loops of only a few tiles.
//
// Arithmetic.  mma.sync.m16n8k8 .tf32 for S = Q K^T and O = P V.  Each
// f32 operand x is split into hi and lo = x - hi, both rounded to TF32 to
// nearest, ties away from zero (cvt.rna.tf32.f32's rounding, done as an
// integer add of half a TF32 ulp: ptxas emulates cvt.rna in five
// instructions), and a product adds lo.hi' and hi.lo' before hi.hi' into
// an f32 accumulator.  The products of a k-step are issued for all eight
// n-blocks at a time (every lo.hi', then every hi.lo', then every hi.hi')
// so that eight accumulator chains interleave.  The S accumulator
// fragment of an m16n8 block gives lane (g = lane / 4, t = lane % 4) keys
// 2t and 2t + 1 of rows g and g + 8; those four values are reused as P's
// A fragment slots t and t + 4, and V's B fragment is read from key rows
// 2t and 2t + 1 to match: scores never leave registers.
// silu(x * scale) / n = (x * scale / n) / (1 + 2^(-x * scale * log2 e))
// with ex2.approx and a fast divide, computed for every score and then
// selected by the mask (no branch per element; a tile that is wholly
// visible skips the mask).  Q is split once and
// held in registers (for D = 128 it is held unsplit and split per use);
// K and V are split per fragment as they are read.
//
// Tiling.  Each warp owns 16 query rows; a block holds q_rows of them
// (a rank of Sq <= 128 queries in ONE block, so every prefix K/V tile is
// read once per (b, h), and no warp multiplies rows wholly past Sq).  A
// thread-block cluster of `cluster` blocks owns one (b, h, q-tile); block
// r of it takes every cluster-th 64-key tile of [prefix | new tokens]
// into one register accumulator, and the partial sums are added through
// distributed shared memory in rank order (no atomics, no partial in
// device memory).  The grid runs the q-tiles last to first, so the
// longest causal tiles start first.  A thread holds at most 168
// registers (D <= 64), so two blocks of five warps (a rank of 80 queries)
// share an SM.  The plan (q_rows, cluster) comes from
// kernels/cuda_lib.py::rank_launch_plan, a function of (n_prefix, Sq)
// only, so a row's summation order never depends on its batch, and
// dense, paged and segment launches at equal padded length split alike.
//
// Pipeline.  K/V tiles stream through a ring of NS stages with cp.async
// (16-byte copies, rows padded to D + 4 floats so both fragment reads are
// free of bank conflicts).  The addresses of a tile (one pointer per key
// row, the page tables read once per key, not per copy; SEG: each key's
// position) are written to shared memory one iteration before its copies
// are issued, and the copies NS - 1 tiles before it is multiplied: one
// barrier per tile, which also votes the segment mode's skip.  A key
// that is past the valid length or not held by a page is zero-filled by
// the copy (src-size 0), never read.
//
// Skipping is exact (a dropped product is +-0): a block never loads or
// multiplies a tile past the causal edge, an item x item tile off the
// diagonal, or a page past the row's resident length; a warp skips a
// tile that no row of its own sees.  Dense, paged and segment prefixes
// skip by the same rule on the same values, so the paged launch equals
// the dense one bit for bit at equal padded length, and the segment
// launch with one span at [0, prefix_len) the paged one.
//
// Types.  q, k, v, the page pools and the output are all float32 or all
// bfloat16 (a compile-time variant, T), as the Pallas kernels take either
// and write q's type.  A bf16 row is copied raw into a bf16 ring (rows
// padded by 16 bytes, D + 8 values, which keeps both fragment reads free
// of bank conflicts) and each value widens to float32 where it is read
// into a fragment, so all arithmetic is the float32 kernel's: a bf16
// launch equals the float32 launch on float32 copies of its inputs,
// rounded once (to nearest even) as the output is written.  A bf16 value
// is exact in TF32, so the lo half of its split is zero and two of its
// three products add nothing; they are kept, so the bits stay the float32
// kernel's.  P in P V is a float32 score and keeps its split.
//
// The segment mode is a compile-time variant (SEG).  Its cached keys are
// the table's pages in order; key j of slot p sits at global position
// page_pos[p] + j and exists only where j < page_valid[p] (INT_MAX
// otherwise, and zero-filled).  The mask is key position <= q_pos[q]; a
// tile is skipped when no key of it is visible to any query of the
// block, and by a warp when none is visible to any of its queries.  The
// fresh tokens are the new-token pass unchanged (q_pos increases, so
// local causality equals global causality).

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef REPRO_KERNEL_TYPE
#define REPRO_KERNEL_TYPE 0
#endif

namespace cg = cooperative_groups;

extern "C" {

// q, k, v, the pools and out hold one type: float32 (hstu_rank_attn_f32)
// or bfloat16 (hstu_rank_attn_bf16)
struct RankAttnParams {
    const void* q;       long long q_stride[3];    // (B, H, Sq, D), unit D stride
    const void* k_new;   long long kn_stride[3];   // (B, H, Sq, D)
    const void* v_new;   long long vn_stride[3];
    const void* k_pre;   long long kp_stride[3];   // dense prefix (B, H, n_prefix, D)
    const void* v_pre;   long long vp_stride[3];
    const void* k_pool;                            // (N + 1, page_tokens, H, D)
    const void* v_pool;
    const int* k_table;                            // (B, n_pages) rows
    const int* v_table;
    long long kt_stride;                           // row stride of each table
    long long vt_stride;
    const int* prefix_lens;                        // (B,) resident prefix tokens
    void* out;           long long o_stride[3];    // (B, H, Sq, D)
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
    // the launch plan (kernels/cuda_lib.py::rank_launch_plan)
    int q_rows;                                    // queries per block, a multiple of 16
    int cluster;                                   // blocks per (b, h, q-tile)
};

}  // extern "C"

namespace {

constexpr int BK = 64;            // keys per tile
constexpr int MAX_Q_ROWS = 128;   // 8 warps of 16 query rows
constexpr int MAX_CLUSTER = 8;    // the portable cluster size

// The addresses of one key tile: a row pointer per key (nullptr: the
// copy zero-fills it) and, in the segment mode, each key's position.
template <typename T> struct SlotT {
    const T* k[BK];
    const T* v[BK];
    int pos[BK];
};

template <int D, typename T> struct Geometry {
    static constexpr int VEC = 16 / static_cast<int>(sizeof(T));   // values per 16-byte copy
    static constexpr int KS = D + VEC;             // padded K/V row (values of T)
    static constexpr int NS = 2;                   // ring stages
    static constexpr int NA = NS + 1;              // address slots
    static constexpr int TILE = 2 * BK * KS;       // one stage: K then V
    static constexpr int AS = D + 8;               // row of the reduction buffer (floats)
    static constexpr bool QSPLIT = D <= 64;        // Q held split in registers
    static constexpr int RING = static_cast<int>(sizeof(T)) * NS * TILE;   // ring bytes
    static constexpr int RED = 4 * MAX_Q_ROWS * AS;                        // reduction bytes
    // the reduction buffer overlays the ring
    static constexpr int bytes = NA * static_cast<int>(sizeof(SlotT<T>)) + 32 + (RING > RED ? RING : RED);
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

// x = hi + lo, each rounded to TF32 to nearest, ties away from zero (what
// cvt.rna.tf32.f32 gives for finite x, which ptxas would emulate in five
// instructions): add half an ulp of TF32 and let the low 13 bits go.
// hi is cut here, because lo is x - hi; lo keeps its low bits, which the
// tensor core ignores.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// the value as float32 (exact for bf16)
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// four consecutive outputs: float32 as they are, bf16 rounded to nearest even
__device__ __forceinline__ void store4(float* dst, float4 s) {
    *reinterpret_cast<float4*>(dst) = s;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 s) {
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
    d[0] = __floats2bfloat162_rn(s.x, s.y);
    d[1] = __floats2bfloat162_rn(s.z, s.w);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[off + j] += a . b[j] for N blocks in 3xTF32, b[j] = (b[j][0], b[j][1]) as
// floats: every block's lo.hi', then every hi.lo', then every hi.hi', so
// that the N accumulators' chains interleave (each block's own order is
// the two cross terms, then hi.hi')
template <int N, int M>
__device__ __forceinline__ void mma3(float (&c)[M][4], int off, const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const float (&b)[N][2]) {
    uint32_t bh[N][2], bl[N][2];
#pragma unroll
    for (int j = 0; j < N; ++j) {
        split(b[j][0], bh[j][0], bl[j][0]);
        split(b[j][1], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) mma(c[off + j], al, bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < N; ++j) mma(c[off + j], ah, bl[j][0], bl[j][1]);
#pragma unroll
    for (int j = 0; j < N; ++j) mma(c[off + j], ah, bh[j][0], bh[j][1]);
}

__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// Whether some row of [r0, r1] sees some new-token key of the tile at k0
// under the rank mask (key <= query, and an item query sees the incr
// keys and itself only).
__device__ __forceinline__ bool new_tile_seen(int r0, int r1, int k0, int Sq, int n_incr) {
    const int c1 = min(k0 + BK - 1, Sq - 1);
    return k0 <= r1 && (k0 < n_incr || max(k0, max(r0, n_incr)) <= min(c1, r1));
}

// At most 168 registers a thread (D <= 64), so that three warps fit the
// 16384 registers of an SM sub-partition: two blocks of five or six warps
// (the rank's 80 or 96 queries), or three of four (a 64-query tile), share
// an SM.  Uncapped, ptxas gives the D = 64 build more, and such a block
// has an SM to itself.
template <int D, bool SEG, typename T>
__global__ void __maxnreg__(D == 128 ? 255 : 168) hstu_rank_attn_kernel(const RankAttnParams p) {
    using G = Geometry<D, T>;
    using Slot = SlotT<T>;
    constexpr int KS = G::KS, NS = G::NS, NA = G::NA, TILE = G::TILE, AS = G::AS, VEC = G::VEC;
    constexpr int KD = D / 8;            // k-steps of S, n-blocks of O
    constexpr int NG = KD < 8 ? KD : 8;  // O blocks per product group
    extern __shared__ float4 smem4[];
    Slot* slots = reinterpret_cast<Slot*>(smem4);
    int* sWarpMax = reinterpret_cast<int*>(slots + NA);
    T* ring = reinterpret_cast<T*>(sWarpMax + 8);

    const cg::cluster_group cluster = cg::this_cluster();
    const int CL = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int QR = p.q_rows, NT = blockDim.x;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    // q-tiles run last to first: a causal tile's work grows with its index,
    // so the longest blocks start first and the short ones fill the tail
    const int q0 = (gridDim.z - 1 - blockIdx.z) * QR, h = blockIdx.x / CL, b = blockIdx.y;
    const int q1 = min(q0 + QR, p.Sq) - 1;   // last query of this block
    const int r0 = q0 + warp * 16;           // this warp's first query
    const int r1 = min(r0 + 15, p.Sq - 1);
    const bool active = r0 < p.Sq;

    const int n_pre_tiles = (p.n_prefix + BK - 1) / BK;   // padded: same split in all modes
    const int n_tiles = n_pre_tiles + (p.Sq + BK - 1) / BK;
    const int plen = p.paged && !SEG ? min(p.n_prefix, p.prefix_lens[b]) : p.n_prefix;

    // Q fragments of rows r0 + g, r0 + g + 8 (zero past Sq)
    constexpr int NQS = G::QSPLIT ? KD : 1, NQF = G::QSPLIT ? 1 : KD;
    uint32_t qh[NQS][4], ql[NQS][4];
    float qf[NQF][4];
    {
        const T* qb = static_cast<const T*>(p.q) + b * p.q_stride[0] + h * p.q_stride[1];
        const bool v0 = r0 + g < p.Sq, v1 = r0 + g + 8 < p.Sq;
        const T* row0 = qb + (r0 + g) * p.q_stride[2];
        const T* row1 = qb + (r0 + g + 8) * p.q_stride[2];
#pragma unroll
        for (int ks = 0; ks < KD; ++ks) {
            const int c = ks * 8 + t;
            const float x[4] = {v0 ? to_f32(row0[c]) : 0.f, v1 ? to_f32(row1[c]) : 0.f,
                                v0 ? to_f32(row0[c + 4]) : 0.f, v1 ? to_f32(row1[c + 4]) : 0.f};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                if constexpr (G::QSPLIT) split(x[e], qh[ks][e], ql[ks][e]);
                else qf[ks][e] = x[e];
            }
        }
    }

    // segment mode: this lane's query positions, the warp's and block's last
    int qp[2] = {INT_MIN, INT_MIN};
    int wq_max = INT_MIN, qmax = INT_MIN;
    if constexpr (SEG) {
        const int* qpos = p.q_pos + b * p.qp_stride;
        if (r0 + g < p.Sq) qp[0] = qpos[r0 + g];
        if (r0 + g + 8 < p.Sq) qp[1] = qpos[r0 + g + 8];
        wq_max = __reduce_max_sync(0xffffffffu, max(qp[0], qp[1]));
        if (lane == 0) sWarpMax[warp] = wq_max;
        __syncthreads();
        for (int w = 0; w < NT / 32; ++w) qmax = max(qmax, sWarpMax[w]);
    }

    float o[KD][4];
#pragma unroll
    for (int j = 0; j < KD; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

    // key tile gt of [prefix | new]: kept unless the rules above drop it
    auto next_tile = [&](int gt) {
        for (; gt < n_tiles; gt += CL) {
            if (gt < n_pre_tiles) {
                if (gt * BK < plen) break;
            } else {
                const int k0 = (gt - n_pre_tiles) * BK;
                if (k0 <= q1 && !(q0 >= p.n_incr && k0 >= p.n_incr && k0 + BK - 1 < q0)) break;
            }
        }
        return gt;
    };

    // the addresses of tile gt into slot s; returns this thread's vote
    // that the tile holds a key some query sees
    auto prep = [&](int gt, Slot& s) {
        if (gt >= n_tiles) return false;
        const bool pre = gt < n_pre_tiles;
        bool vote = !SEG || !pre;
        for (int idx = tid; idx < 2 * BK; idx += NT) {
            const int c = idx % BK;
            const bool val = idx >= BK;
            const T* row = nullptr;
            int pos = INT_MAX;
            if (pre) {
                const int key = gt * BK + c;
                if (key < plen) {
                    if (p.paged) {
                        const int slot = key / p.page_tokens, j = key % p.page_tokens;
                        bool held = true;
                        if constexpr (SEG) {
                            held = j < p.page_valid[b * p.pv_stride + slot];
                            if (held) pos = p.page_pos[b * p.pp_stride + slot] + j;
                        }
                        if (held) {
                            const long long page = val ? p.v_table[b * p.vt_stride + slot]
                                                       : p.k_table[b * p.kt_stride + slot];
                            row = static_cast<const T*>(val ? p.v_pool : p.k_pool) +
                                  ((page * p.page_tokens + j) * p.H + h) * (long long)D;
                        }
                    } else {
                        const long long* st = val ? p.vp_stride : p.kp_stride;
                        row = static_cast<const T*>(val ? p.v_pre : p.k_pre) + b * st[0] +
                              h * st[1] + key * st[2];
                    }
                }
            } else {
                const int key = (gt - n_pre_tiles) * BK + c;
                if (key < p.Sq) {
                    const long long* st = val ? p.vn_stride : p.kn_stride;
                    row = static_cast<const T*>(val ? p.v_new : p.k_new) + b * st[0] +
                          h * st[1] + key * st[2];
                }
            }
            (val ? s.v : s.k)[c] = row;
            if (SEG && !val) {
                s.pos[c] = pos;
                vote = vote || pos <= qmax;
            }
        }
        return vote;
    };

    // the copies of a tile whose addresses are in slot s into a stage
    auto issue = [&](const Slot& s, T* stage) {
        constexpr int CPR = D / VEC;   // 16-byte chunks per row
        for (int idx = tid; idx < 2 * BK * CPR; idx += NT) {
            const int val = idx / (BK * CPR), c = (idx / CPR) % BK, ch = idx % CPR;
            const T* row = val ? s.v[c] : s.k[c];
            cp_async16(stage + val * BK * KS + c * KS + ch * VEC, row ? row + ch * VEC : p.q,
                       row != nullptr);
        }
    };

    // acc += the tile's masked scores . V, for this warp's 16 rows
    auto compute = [&](int gt, const T* sK, const Slot& s) {
        const T* sV = sK + BK * KS;
        const bool pre = gt < n_pre_tiles;
        const int k0 = pre ? gt * BK : (gt - n_pre_tiles) * BK;
        const int n_valid = min(BK, (pre ? plen : p.Sq) - k0);
        // a warp skips a tile none of its rows sees (exact: its products are +-0)
        if (!pre) {
            if (!new_tile_seen(r0, r1, k0, p.Sq, p.n_incr)) return;
        } else if constexpr (SEG) {
            if (!__any_sync(0xffffffffu, s.pos[lane] <= wq_max || s.pos[lane + 32] <= wq_max))
                return;
        }

        float sc[BK / 8][4];
#pragma unroll
        for (int nb = 0; nb < BK / 8; ++nb) sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KD; ++ks) {
            uint32_t ah[4], al[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                if constexpr (G::QSPLIT) {
                    ah[e] = qh[ks][e];
                    al[e] = ql[ks][e];
                } else {
                    split(qf[ks][e], ah[e], al[e]);
                }
            }
            float kb[BK / 8][2];
#pragma unroll
            for (int nb = 0; nb < BK / 8; ++nb) {
                const T* kr = sK + (nb * 8 + g) * KS + ks * 8 + t;
                kb[nb][0] = to_f32(kr[0]);
                kb[nb][1] = to_f32(kr[4]);
            }
            mma3(sc, 0, ah, al, kb);
        }
        // mask, SiLU and 1/n on the fragment: element e is row g + 8 (e / 2),
        // key 2t + (e % 2) of its chunk.  silu(x * scale) / n is
        // (x * scale / n) / (1 + 2^(-x * scale * log2 e)), computed for every
        // element and then selected (no branch per element), or not masked
        // at all where the whole tile is visible.
        const float c_mul = p.scale / p.n_total, c_exp = -p.scale * 1.4426950408889634f;
        // whole: every score of the tile is visible (a full dense or paged
        // prefix tile; a full new-token tile below the warp's diagonal
        // whose rows, or keys, are all incr tokens)
        const bool whole = n_valid == BK && (pre ? !SEG : k0 + BK - 1 <= r0 &&
                           (r1 < p.n_incr || k0 + BK - 1 < p.n_incr));
        auto silu_n = [&](float x) {
            return __fdividef(x * c_mul, 1.0f + exp2_approx(x * c_exp));
        };
        if (whole) {
#pragma unroll
            for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
                for (int e = 0; e < 4; ++e) sc[nb][e] = silu_n(sc[nb][e]);
        } else {
#pragma unroll
            for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int col = nb * 8 + 2 * t + (e & 1);
                    const int qi = r0 + g + 8 * (e >> 1), ki = k0 + col;
                    bool visible;
                    if (pre) {
                        if constexpr (SEG) visible = s.pos[col] <= qp[e >> 1];
                        else visible = col < n_valid;
                    } else {
                        visible = col < n_valid && ki <= qi &&
                                  (qi < p.n_incr || ki < p.n_incr || ki == qi);
                    }
                    const float y = silu_n(sc[nb][e]);
                    sc[nb][e] = visible ? y : 0.f;
                }
            }
        }
        // O += P . V, P straight from the score fragment (keys 2t, 2t + 1
        // as slots t, t + 4; V read from key rows 2t and 2t + 1 to match)
#pragma unroll
        for (int kc = 0; kc < BK / 8; ++kc) {
            uint32_t ah[4], al[4];
            split(sc[kc][0], ah[0], al[0]);
            split(sc[kc][2], ah[1], al[1]);
            split(sc[kc][1], ah[2], al[2]);
            split(sc[kc][3], ah[3], al[3]);
            const T* v0 = sV + (kc * 8 + 2 * t) * KS + g;
#pragma unroll
            for (int dg = 0; dg < KD; dg += NG) {   // NG output blocks at a time
                float vb[NG][2];
#pragma unroll
                for (int dn = 0; dn < NG; ++dn) {
                    vb[dn][0] = to_f32(v0[(dg + dn) * 8]);
                    vb[dn][1] = to_f32(v0[KS + (dg + dn) * 8]);
                }
                mma3(o, dg, ah, al, vb);
            }
        }
    };

    // the ring: position j of the window holds tile gq[j]; live[j] says
    // its copies were issued (the segment mode's vote can drop a tile)
    int gq[NS + 1];
    bool live[NS];
    gq[0] = next_tile(rank);
#pragma unroll
    for (int j = 1; j <= NS; ++j) gq[j] = next_tile(gq[j - 1] + CL);
#pragma unroll
    for (int j = 0; j < NS - 1; ++j) {
        const bool vote = prep(gq[j], slots[j]);
        live[j] = __syncthreads_or(vote);
        if (live[j]) issue(slots[j], ring + j * TILE);
        cp_async_commit();
    }
    bool vote = prep(gq[NS - 1], slots[NS - 1]);
    for (int i = 0; gq[0] < n_tiles; ++i) {
        cp_async_wait<NS - 2>();                // this thread's copies of tile i landed
        // one barrier: tile i visible to all, tile i - 1 done (its stage
        // and slot free), the addresses of tile i + NS - 1 written
        live[NS - 1] = __syncthreads_or(vote);
        if (live[NS - 1]) issue(slots[(i + NS - 1) % NA], ring + ((i + NS - 1) % NS) * TILE);
        cp_async_commit();
        vote = prep(gq[NS], slots[(i + NS) % NA]);
        if (live[0] && active) compute(gq[0], ring + (i % NS) * TILE, slots[i % NA]);
#pragma unroll
        for (int j = 0; j < NS; ++j) gq[j] = gq[j + 1];
        gq[NS] = next_tile(gq[NS] + CL);
#pragma unroll
        for (int j = 0; j < NS - 1; ++j) live[j] = live[j + 1];
    }

    // reduce the cluster's partial sums through distributed shared memory,
    // in rank order (a fixed order: no atomics, no partial in device
    // memory); block `rank` writes its share of the rows
    cp_async_wait<0>();
    __syncthreads();                         // the last tile's reads are done
    float* sAcc = reinterpret_cast<float*>(ring);   // QR x AS floats, over the ring
    {
        const int r = warp * 16 + g;
#pragma unroll
        for (int dn = 0; dn < KD; ++dn) {
            const int c = dn * 8 + 2 * t;
            *reinterpret_cast<float2*>(sAcc + r * AS + c) = make_float2(o[dn][0], o[dn][1]);
            *reinterpret_cast<float2*>(sAcc + (r + 8) * AS + c) = make_float2(o[dn][2], o[dn][3]);
        }
    }
    cluster.sync();
    const int rows = (QR + CL - 1) / CL, ra = rank * rows, rb = min(QR, ra + rows);
    T* ob = static_cast<T*>(p.out) + b * p.o_stride[0] + h * p.o_stride[1];
    for (int idx = tid; idx < (rb - ra) * (D / 4); idx += NT) {
        const int r = ra + idx / (D / 4), c = (idx % (D / 4)) * 4;
        if (q0 + r >= p.Sq) continue;
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int src = 0; src < CL; ++src) {
            const float4 x = *reinterpret_cast<const float4*>(
                cluster.map_shared_rank(sAcc, src) + r * AS + c);
            s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
        }
        store4(ob + (q0 + r) * p.o_stride[2] + c, s);
    }
    cluster.sync();                          // peers may still read our sAcc
}

// Launch p's plan on `stream`.
template <int D, bool SEG, typename T>
cudaError_t launch(const RankAttnParams& p, cudaStream_t stream) {
    constexpr int smem = Geometry<D, T>::bytes;
    const int QR = p.q_rows, CL = p.cluster;
    if (QR < 16 || QR > MAX_Q_ROWS || QR % 16 || CL < 1 || CL > MAX_CLUSTER || p.Sq < 1)
        return cudaErrorInvalidValue;
    static unsigned configured = 0;   // one bit per device: the > 48 KB opt-in
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (!(configured & (1u << dev))) {
        err = cudaFuncSetAttribute(hstu_rank_attn_kernel<D, SEG, T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        configured |= 1u << dev;
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CL * p.H, p.B, (p.Sq + QR - 1) / QR);
    cfg.blockDim = dim3(2 * QR, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, hstu_rank_attn_kernel<D, SEG, T>, p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const RankAttnParams& p, cudaStream_t s) {
    if (p.segment && !p.paged) return cudaErrorInvalidValue;
    switch (p.D) {
        case 32: return p.segment ? launch<32, true, T>(p, s) : launch<32, false, T>(p, s);
        case 64: return p.segment ? launch<64, true, T>(p, s) : launch<64, false, T>(p, s);
        case 128: return p.segment ? launch<128, true, T>(p, s) : launch<128, false, T>(p, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// The build compiles this file once per input type, both at once: with
// REPRO_KERNEL_TYPE 0 the float32 kernels and the shared exports, with 1
// the bf16 kernels (kernels/cuda_lib.py, UNITS).
#if REPRO_KERNEL_TYPE == 1
extern "C" int hstu_rank_attn_bf16(const RankAttnParams* p, void* stream) {
    return static_cast<int>(dispatch<__nv_bfloat16>(*p, static_cast<cudaStream_t>(stream)));
}
#else
extern "C" int hstu_rank_attn_f32(const RankAttnParams* p, void* stream) {
    return static_cast<int>(dispatch<float>(*p, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* hstu_rank_attn_error(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int hstu_rank_attn_struct_size() { return static_cast<int>(sizeof(RankAttnParams)); }

extern "C" int hstu_rank_attn_max_cluster() { return MAX_CLUSTER; }
extern "C" int hstu_rank_attn_max_q_rows() { return MAX_Q_ROWS; }
#endif
