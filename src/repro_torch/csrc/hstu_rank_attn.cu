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
// Dense pipeline (rows 1-2).  K/V tiles stream through a ring of two
// stages with cp.async (16-byte copies, rows padded to D + 4 floats so
// both fragment reads are free of bank conflicts).  The addresses of a
// tile (one pointer per key row) are written to shared memory one
// iteration before its copies are issued, and the copies one tile before
// it is multiplied: one barrier per tile.  A key past the valid length is
// zero-filled by the copy (src-size 0), never read.
//
// Paged pipeline (rows 3-4, the compile-time variant PAGED, SEG beside
// it).  What bounds them on this card is operations, as for rows 1-2: at
// the main shape (B 8, ragged psi 9050 of 16384 tokens, 16 + 64 new
// tokens, H 4, D 64) 0.75 GFLOP is 0.0112 ms on the FP32 cores; in
// 3xTF32 it is 0.0046 ms, below the float32 launch's 21.2 MB at 0.0063
// ms (bf16: 10.6 MB, so 0.0046 ms by operations).  Both ran at 0.16-0.22
// of the FP32 bound.  Their loader was a chain of dependent steps on
// every tile: a global load of each key's page table entry (SEG: also
// page_valid and page_pos), a row pointer and a position written to
// shared memory, a barrier, 16-byte copies through those pointers (each
// key row a separate D-value strip of the (N + 1, page_tokens, H, D)
// pool), then a wait.  The paged loader below cuts the chain.  On the
// H100 the paged launch gained 5-11% in float32 at B 8 (PERF.md, section
// 6), but the chain was not what bound it: a block walks about five
// tiles, and each tile's 3xTF32 mma.sync products and the ALU work beside
// them take longer than the next tile's load, so one tile in flight hid
// the load already.  The segment launch gained 4-14% only once its mask
// kept the branch between prefix and new tiles outside the loop over
// scores (in compute, below); with the branch inside, it lost 1-6% to
// the cp.async loader.  What the loader does:
//
//   * the block stages the page table entries of every tile it will walk
//     (tiles rank, rank + cluster, ...; SEG: with page_pos and
//     page_valid) into shared memory in one pass at its start, 64 /
//     page_tokens entries a tile; nothing on the per-tile path loads from
//     device memory to find an address.  (A block with more entries than
//     the table holds, TAB, refills it a tile at a time, one loop turn
//     after the tile it replaces.)  The segment mode's skip vote and
//     each key's position, page_pos[p] + j where j < page_valid[p], come
//     from the staged entries: the positions are written beside the
//     stage when its tile is issued (64 lanes, one value each), so that
//     the mask reads one value a key;
//   * one thread issues a TMA box per page and column block from the
//     pool's tensor map: dims (D, H, page_tokens, N + 1) innermost first,
//     box (IN, 1, page_tokens, 1) at (c, h, 0, page), IN the values of
//     W = min(128, D x sizeof(T)) bytes, written through the W-byte
//     swizzle (CU_TENSOR_MAP_SWIZZLE_128B, 64B for the 64-byte rows of
//     bf16 at D 32).  The new-token tiles take tensor maps of their own
//     over the (B, H, Sq, D) views, dims (D, Sq, H, B), box (IN, 64, 1,
//     1) at (c, k0, h, b): the bounds past Sq fill zeros, as src-size 0
//     did.  The C launcher builds the maps (a launch at the shapes of an
//     earlier one reuses its maps, moved to its own tensors by
//     cuTensorMapReplaceAddress) and passes them as __grid_constant__
//     parameters (a CUDA graph captures them, the pool's address with
//     them, by value);
//   * a ring of two stages, each with its own mbarrier whose expect_tx
//     is the bytes of the boxes issued: a tile's products take longer
//     than the next tile's load, so one tile in flight hides it.  Rings
//     as deep as two blocks an SM allow (three stages of float32 at D
//     64, six of bf16) ran slower on the H100 (PERF.md, section 6): two
//     blocks of 110 KB leave L1 28 KB for the spills of the 168-register
//     cap;
//   * a stage holds K then V, each NC = D x sizeof(T) / W column blocks of
//     64 rows x W bytes; a value sits at its 16-byte chunk index XOR the
//     row's bits (row mod 8 for W = 128), so the K reads (rows g, columns
//     8ks + t, 8ks + t + 4) and the V reads (rows 2t, 2t + 1, columns g +
//     8n) stay free of bank conflicts without padding.
//
// TMA copies whole pages, so a page's keys past the row's resident length
// (paged) or past page_valid (SEG) arrive holding whatever the pool holds
// there, NaN included (a freed page keeps its last user's K/V).  Before a
// tile is published to the consumer warps those K and V rows are zeroed
// in shared memory, so a key that is not held is zero, as the zero-filled
// copy made it: a dropped product is still exactly +-0.  Pages wholly
// past the resident length or holding nothing are not loaded at all.
// The arithmetic, the Q split, the tile split, the plan and the
// reduction are the dense kernel's, so paged == dense bit for bit still.
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
// and write q's type.  A bf16 row is copied raw into a bf16 ring (dense:
// rows padded by 16 bytes, D + 8 values, which keeps both fragment reads
// free of bank conflicts; paged: swizzled) and each value widens to
// float32 where it is read into a fragment, so all arithmetic is the
// float32 kernel's: a bf16
// launch equals the float32 launch on float32 copies of its inputs,
// rounded once (to nearest even) as the output is written.  A bf16 value
// is exact in TF32, so the lo half of its split is zero and two of its
// three products add nothing; they are kept, so the bits stay the float32
// kernel's.  P in P V is a float32 score and keeps its split.
//
// The segment mode is a compile-time variant (SEG).  Its cached keys are
// the table's pages in order; key j of slot p sits at global position
// page_pos[p] + j and exists only where j < page_valid[p] (never
// visible otherwise, and zeroed).  The mask is key position <= q_pos[q]; a
// tile is skipped when no key of it is visible to any query of the
// block, and by a warp when none is visible to any of its queries.  The
// fresh tokens are the new-token pass unchanged (q_pos increases, so
// local causality equals global causality).


#include <climits>
#include <cstdint>
#include <cstdio>
#include <cooperative_groups.h>
#include <cuda.h>            // CUtensorMap and its enums only: no libcuda is linked
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
    // the pools' extents for their tensor maps (paged), in values
    long long kpool_stride[3];                     // (page, token, head) strides of k_pool
    long long vpool_stride[3];
    long long kpool_pages;                         // N + 1 of each pool
    long long vpool_pages;
};

}  // extern "C"

namespace {

constexpr int BK = 64;            // keys per tile
constexpr int MAX_Q_ROWS = 128;   // 8 warps of 16 query rows
constexpr int MAX_CLUSTER = 8;    // the portable cluster size
// a refused tensor map: TMA_ERROR + the driver's CUresult (above every
// cudaError_t below cudaErrorApiFailureBase)
constexpr int TMA_ERROR = 5000;

// The addresses of one dense key tile: a row pointer per key (nullptr:
// the copy zero-fills it).
template <typename T> struct SlotT {
    const T* k[BK];
    const T* v[BK];
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

// The paged loader's shared memory (bytes): a 1024-byte aligned ring of
// NS stages, each a K tile then a V tile of NC column blocks of 64 rows x
// W bytes as TMA writes them (swizzled); behind it the stages' mbarriers,
// the block's last query position (SEG), the staged page table (TAB
// entries: K and V page ids, SEG also page_pos and page_valid) and, SEG,
// each stage's 64 key positions (computed from the staged entries when
// the tile is issued, so that the mask reads one value a key) and the
// block's query positions (read where the mask needs them, not held in
// registers across the tile loop).
template <int D, bool SEG, typename T> struct PagedGeometry {
    static constexpr int ESZ = static_cast<int>(sizeof(T));
    static constexpr int W = D * ESZ < 128 ? D * ESZ : 128;   // a box row's bytes
    static constexpr int IN = W / ESZ;                        // values of a box row
    static constexpr int NC = D * ESZ / W;                    // boxes a page, for K or V
    static constexpr int SUB = BK * W;                        // one column block
    static constexpr int HALF = NC * SUB;                     // a K (or V) tile
    static constexpr int STAGE = 2 * HALF;
    // two stages: deeper rings ran slower on the H100 (PERF.md, section 6)
    static constexpr int NS = 2;
    static constexpr int TAB = 256;    // entries: NS + 1 tiles of 1-token pages, rounded up
    static constexpr int TABB = TAB * (SEG ? 4 : 2) * 4;
    static constexpr int KPOS = SEG ? NS * BK * 4 : 0;        // SEG: each stage's key positions
    static constexpr int QPOS = SEG ? MAX_Q_ROWS * 4 : 0;     // SEG: the block's query positions
    static constexpr int RED = 4 * MAX_Q_ROWS * (D + 8);
    static constexpr int ALIGN = 1024;
    static constexpr int RING = NS * STAGE;
    static constexpr int RR = RING > RED ? RING : RED;        // the reduction overlays the ring
    static constexpr int BARS = 8 * NS + 64;                  // the barriers, sWarpMax
    static constexpr int bytes = ALIGN + RR + BARS + TABB + KPOS + QPOS;
    static_assert((NS + 1) * BK <= TAB, "the staged table holds the ring's tiles");
};

// The paged launch's tensor maps: the K and V pools, the new K and V.
struct TmaMaps {
    CUtensorMap k, v, kn, vn;
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

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// arrive once and expect `bytes` of asynchronous copies on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}

// Wait until the barrier's phase of this parity completes.  A phase that
// never completes (a copy lost to a fault) would spin the block forever:
// the card stays held, every later launch on the stream waits behind it,
// and the host's next synchronisation never returns, with no error to
// report.  So after MBAR_WAIT_LIMIT_NS on the card's clock the block
// traps: the launch fails with an error the host sees at its next
// synchronisation, and the serving process can report it and restart.
// A correct wait takes microseconds; the limit is seconds, so that a
// block slowed by contention or descheduled by time-slicing is not taken
// for a lost copy.
constexpr uint64_t MBAR_WAIT_LIMIT_NS = 10ull * 1000 * 1000 * 1000;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint64_t t0 = 0;
    for (uint32_t n = 1;; ++n) {
        uint32_t done;
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (n % 1024 == 0) {                 // the clock, now and then
            const uint64_t now = globaltimer_ns();
            if (t0 == 0) t0 = now;
            else if (now - t0 > MBAR_WAIT_LIMIT_NS) __trap();
        }
    }
}

// one TMA box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2, int c3) {
    asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
                 "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
                    "r"(c3), "r"(bar)
                 : "memory");
}

// Where value (row8 + rlo, col8 + clo) of a stage's K or V tile lies,
// row8 and col8 multiples of 8 (unrolled: known to the compiler), rlo
// and clo below 8 (the lane's): the dense ring's padded rows, or the
// paged ring's swizzled column blocks (the 16-byte chunk index XOR the
// row's bits, as the W-byte swizzle writes it: row mod 8 for W = 128,
// (row / 2) mod 4 for W = 64, anchored at the 1024-byte aligned ring).
template <int D, bool PAGED, typename T> struct TileLayout {
    static constexpr int KS = Geometry<D, T>::KS;
    static __device__ __forceinline__ const T& at(const T* tile, int row8, int rlo, int col8,
                                                  int clo) {
        return tile[(row8 + rlo) * KS + col8 + clo];
    }
};
template <int D, typename T> struct TileLayout<D, true, T> {
    using PG = PagedGeometry<D, false, T>;
    // The chunk index is (cb >> 4) + (lb >> 4), whose bits are disjoint
    // (cb a multiple of 32 bytes for float32, lb below 16 for bf16), so
    // the swizzled offset is the lane's part XOR the unrolled chunk: one
    // LOP3 a chunk, the rest an immediate offset of the load.
    static __device__ __forceinline__ const T& at(const T* tile, int row8, int rlo, int col8,
                                                  int clo) {
        const int cb = (col8 % PG::IN) * PG::ESZ, lb = clo * PG::ESZ;   // bytes into the row
        const int sw = PG::W == 128 ? rlo : rlo >> 1;
        const int lane = (rlo * PG::W + (lb & 15)) ^ ((sw ^ (lb >> 4)) << 4);
        return *reinterpret_cast<const T*>(reinterpret_cast<const char*>(tile) +
                                           (lane ^ ((cb >> 4) << 4)) + (col8 / PG::IN) * PG::SUB +
                                           row8 * PG::W);
    }
};

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
// has an SM to itself.  PAGED: the prefix from the pool through the TMA
// loader (SEG: as spans); else the dense cp.async loader.
template <int D, bool PAGED, bool SEG, typename T>
__global__ void __maxnreg__(D == 128 ? 255 : 168)
hstu_rank_attn_kernel(const RankAttnParams p, const __grid_constant__ TmaMaps maps) {
    static_assert(PAGED || !SEG, "the segment mode reads its spans from the pool");
    using G = Geometry<D, T>;
    using PG = PagedGeometry<D, SEG, T>;
    using L = TileLayout<D, PAGED, T>;
    constexpr int AS = G::AS;
    constexpr int KD = D / 8;            // k-steps of S, n-blocks of O
    constexpr int NG = KD < 8 ? KD : 8;  // O blocks per product group
    extern __shared__ float4 smem4[];

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
    const int plen = PAGED && !SEG ? min(p.n_prefix, p.prefix_lens[b]) : p.n_prefix;

    // shared memory: the ring (the reduction buffer over it), and beside it
    // the dense loader's address slots or the paged loader's barriers and
    // staged table; sWarpMax: each warp's last query position (SEG)
    T* ring;
    int* sWarpMax;
    int* sQ = nullptr;                       // SEG: the block's query positions
    if constexpr (PAGED) {
        char* base = reinterpret_cast<char*>(smem4);
        base += (PG::ALIGN - (smem_u32(base) & (PG::ALIGN - 1))) & (PG::ALIGN - 1);
        ring = reinterpret_cast<T*>(base);
        sWarpMax = reinterpret_cast<int*>(base + PG::RR + 8 * PG::NS);
        sQ = reinterpret_cast<int*>(base + PG::RR + PG::BARS + PG::TABB + PG::KPOS);
    } else {
        sWarpMax = reinterpret_cast<int*>(reinterpret_cast<SlotT<T>*>(smem4) + G::NA);
        ring = reinterpret_cast<T*>(sWarpMax + 8);
    }

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

    // segment mode: the block's query positions (INT_MIN past Sq) into sQ,
    // each warp's largest into sWarpMax[warp], the block's into
    // sWarpMax[8] (read after the paged loader's first barrier)
    if constexpr (SEG) {
        const int* qpos = p.q_pos + b * p.qp_stride;
        const int qa = r0 + g < p.Sq ? qpos[r0 + g] : INT_MIN;
        const int qb = r0 + g + 8 < p.Sq ? qpos[r0 + g + 8] : INT_MIN;
        if (t == 0) {
            sQ[warp * 16 + g] = qa;
            sQ[warp * 16 + g + 8] = qb;
        }
        const int wq = __reduce_max_sync(0xffffffffu, max(qa, qb));
        if (lane == 0) sWarpMax[warp] = wq;
        __syncthreads();
        if (tid == 0) {
            int qmax = INT_MIN;
            for (int w = 0; w < NT / 32; ++w) qmax = max(qmax, sWarpMax[w]);
            sWarpMax[8] = qmax;
        }
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

    // a page holds 2^psh tokens
    const int psh = __ffs(p.page_tokens) - 1;

    // acc += the tile's masked scores . V, for this warp's 16 rows; SEG:
    // kpos holds the tile's key positions (INT_MAX where no key is held)
    auto compute = [&](int gt, const T* sK, const T* sV, const int* kpos) {
        const bool pre = gt < n_pre_tiles;
        const int k0 = pre ? gt * BK : (gt - n_pre_tiles) * BK;
        const int n_valid = min(BK, (pre ? plen : p.Sq) - k0);
        // a warp skips a tile none of its rows sees (exact: its products are +-0)
        if (!pre) {
            if (!new_tile_seen(r0, r1, k0, p.Sq, p.n_incr)) return;
        } else if constexpr (SEG) {
            const int wq = __reduce_max_sync(0xffffffffu, max(sQ[warp * 16 + g],
                                                              sQ[warp * 16 + g + 8]));
            if (!__any_sync(0xffffffffu, kpos[lane] <= wq || kpos[lane + 32] <= wq)) return;
        }

        // the lane's fragment coordinates; the paged layout reads them anew
        // each tile, so that its swizzled offsets (one a chunk) are formed
        // where they are used rather than held across the tile loop
        int fg = g, ft = t;
        if constexpr (PAGED) {
            int ln;
            asm volatile("mov.u32 %0, %%laneid;\n" : "=r"(ln));
            fg = ln >> 2;
            ft = ln & 3;
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
                kb[nb][0] = to_f32(L::at(sK, nb * 8, fg, ks * 8, ft));
                kb[nb][1] = to_f32(L::at(sK, nb * 8, fg, ks * 8, ft + 4));
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
        // the scores where visible(nb, e), else 0 (every score computed, then
        // selected: no branch per element)
        auto masked = [&](auto visible) {
#pragma unroll
            for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float y = silu_n(sc[nb][e]);
                    sc[nb][e] = visible(nb, e) ? y : 0.f;
                }
            }
        };
        // the rank mask: a prefix key up to the valid length, a new-token
        // key at or before the query (an item query sees the incr keys and
        // itself only)
        auto rank_visible = [&](int nb, int e) {
            const int col = nb * 8 + 2 * t + (e & 1);
            const int qi = r0 + g + 8 * (e >> 1), ki = k0 + col;
            return pre ? col < n_valid
                       : col < n_valid && ki <= qi &&
                             (qi < p.n_incr || ki < p.n_incr || ki == qi);
        };
        if (whole) {
#pragma unroll
            for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
                for (int e = 0; e < 4; ++e) sc[nb][e] = silu_n(sc[nb][e]);
        } else if constexpr (SEG) {
            // a cached key is visible to a query at or after its position.
            // The branch on pre stays outside the loop over scores: inside
            // it, the compiler branched and read two query positions at
            // every score, 8-15% of the segment launch's time on the H100
            // (PERF.md, section 6)
            if (pre) {
                const int qa = sQ[warp * 16 + g], qb = sQ[warp * 16 + g + 8];
                masked([&](int nb, int e) {
                    const int2 kk = *reinterpret_cast<const int2*>(kpos + nb * 8 + 2 * t);
                    return ((e & 1) ? kk.y : kk.x) <= ((e >> 1) ? qb : qa);
                });
            } else {
                masked(rank_visible);
            }
        } else {
            masked(rank_visible);
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
#pragma unroll
            for (int dg = 0; dg < KD; dg += NG) {   // NG output blocks at a time
                float vb[NG][2];
#pragma unroll
                for (int dn = 0; dn < NG; ++dn) {
                    vb[dn][0] = to_f32(L::at(sV, kc * 8, 2 * ft, (dg + dn) * 8, fg));
                    vb[dn][1] = to_f32(L::at(sV, kc * 8, 2 * ft + 1, (dg + dn) * 8, fg));
                }
                mma3(o, dg, ah, al, vb);
            }
        }
    };

    if constexpr (!PAGED) {
        // --- the dense loader: cp.async through per-key row pointers ---
        using Slot = SlotT<T>;
        constexpr int KS = G::KS, NS = G::NS, NA = G::NA, TILE = G::TILE, VEC = G::VEC;
        Slot* slots = reinterpret_cast<Slot*>(smem4);

        // the addresses of tile gt into slot s
        auto prep = [&](int gt, Slot& s) {
            if (gt >= n_tiles) return;
            const bool pre = gt < n_pre_tiles;
            for (int idx = tid; idx < 2 * BK; idx += NT) {
                const int c = idx % BK;
                const bool val = idx >= BK;
                const T* row = nullptr;
                if (pre) {
                    const int key = gt * BK + c;
                    if (key < plen) {
                        const long long* st = val ? p.vp_stride : p.kp_stride;
                        row = static_cast<const T*>(val ? p.v_pre : p.k_pre) + b * st[0] +
                              h * st[1] + key * st[2];
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
            }
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

        // the ring: position j of the window holds tile gq[j]
        int gq[NS + 1];
        gq[0] = next_tile(rank);
#pragma unroll
        for (int j = 1; j <= NS; ++j) gq[j] = next_tile(gq[j - 1] + CL);
#pragma unroll
        for (int j = 0; j < NS - 1; ++j) {
            prep(gq[j], slots[j]);
            __syncthreads();
            if (gq[j] < n_tiles) issue(slots[j], ring + j * TILE);
            cp_async_commit();
        }
        prep(gq[NS - 1], slots[NS - 1]);
        for (int i = 0; gq[0] < n_tiles; ++i) {
            cp_async_wait<NS - 2>();                // this thread's copies of tile i landed
            // one barrier: tile i visible to all, tile i - 1 done (its stage
            // and slot free), the addresses of tile i + NS - 1 written
            __syncthreads();
            if (gq[NS - 1] < n_tiles)
                issue(slots[(i + NS - 1) % NA], ring + ((i + NS - 1) % NS) * TILE);
            cp_async_commit();
            prep(gq[NS], slots[(i + NS) % NA]);
            if (active) {
                const T* sK = ring + (i % NS) * TILE;
                compute(gq[0], sK, sK + BK * KS, nullptr);
            }
#pragma unroll
            for (int j = 0; j < NS; ++j) gq[j] = gq[j + 1];
            gq[NS] = next_tile(gq[NS] + CL);
        }
        cp_async_wait<0>();
    } else {
        // --- the paged loader: staged tables, TMA boxes, an mbarrier ring ---
        constexpr int NS = PG::NS, W = PG::W, IN = PG::IN, NC = PG::NC;
        char* ringb = reinterpret_cast<char*>(ring);
        uint64_t* bars = reinterpret_cast<uint64_t*>(ringb + PG::RR);
        int* tk = sWarpMax + 16;                 // the staged table: K page ids,
        int* tv = tk + PG::TAB;                  // V page ids,
        int* tp = tv + PG::TAB;                  // SEG: page_pos,
        int* tl = tp + PG::TAB;                  // page_valid;
        int* kp = tl + PG::TAB;                  // SEG: each stage's key positions
        const int pt = p.page_tokens, ppt = BK >> psh;        // pages a tile
        const int wt = PG::TAB / ppt;                          // tiles the table holds
        const int n_pages = p.n_prefix >> psh;
        const int n_my = rank < n_pre_tiles ? (n_pre_tiles - 1 - rank) / CL + 1 : 0;

        if (tid == 0) {
            for (int s = 0; s < NS; ++s) mbar_init(smem_u32(bars + s), 1);
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        // the entries of this block's prefix tiles m0..m1 - 1 (its m-th tile
        // is rank + m CL): entry e of tile m is table slot (rank + m CL) ppt
        // + e, staged at (m % wt) ppt + e; a slot past the table holds nothing
        auto stage = [&](int m0, int m1) {
            for (int idx = tid; idx < (m1 - m0) * ppt; idx += NT) {
                const int m = m0 + idx / ppt, e = idx % ppt;
                const int slot = (rank + m * CL) * ppt + e, s = (m % wt) * ppt + e;
                const bool in = slot < n_pages;
                tk[s] = in ? p.k_table[b * p.kt_stride + slot] : 0;
                tv[s] = in ? p.v_table[b * p.vt_stride + slot] : 0;
                if constexpr (SEG) {
                    tp[s] = in ? p.page_pos[b * p.pp_stride + slot] : 0;
                    tl[s] = in ? p.page_valid[b * p.pv_stride + slot] : 0;
                }
            }
        };
        stage(0, min(n_my, wt));
        __syncthreads();                         // barriers initialised, table staged

        // A prefix tile's entries start at e0 = (m ppt) mod TAB, m its
        // position in the block's walk (prefix tiles come first, and only
        // a suffix of them past the resident length is skipped), carried
        // along with the ring's cursors.
        // page e of prefix tile gt holds keys (loaded by TMA)
        auto held = [&](int gt, int e0, int e) {
            if constexpr (SEG) return tl[e0 + e] > 0;
            else return gt * BK + (e << psh) < plen;
        };
        // whether some query of the block sees some key of tile gt (SEG; a
        // warp-collective vote, called alike by every thread)
        auto seen = [&](int gt, int e0) {
            if constexpr (SEG) {
                if (gt >= n_pre_tiles) return true;
                const int qmax = sWarpMax[8];
                const bool v = (lane < ppt && tl[e0 + lane] > 0 && tp[e0 + lane] <= qmax) ||
                               (lane + 32 < ppt && tl[e0 + lane + 32] > 0 &&
                                tp[e0 + lane + 32] <= qmax);
                return __any_sync(0xffffffffu, v) != 0;
            } else {
                return true;
            }
        };
        // tile gt's boxes into stage st (one thread): a held page's NC column
        // blocks of K and of V, or the new K and V rows of the tile
        auto issue = [&](int gt, int st, int e0) {
            const uint32_t dst = smem_u32(ringb + st * PG::STAGE), bar = smem_u32(bars + st);
            if (gt < n_pre_tiles) {
                int pages = 0;
                for (int e = 0; e < ppt; ++e) pages += held(gt, e0, e);
                mbar_expect_tx(bar, pages * 2 * pt * D * PG::ESZ);
                for (int e = 0; e < ppt; ++e) {
                    if (!held(gt, e0, e)) continue;
                    for (int c = 0; c < NC; ++c) {
                        const uint32_t at = dst + c * PG::SUB + (e << psh) * W;
                        tma_load4(at, &maps.k, bar, c * IN, h, 0, tk[e0 + e]);
                        tma_load4(at + PG::HALF, &maps.v, bar, c * IN, h, 0, tv[e0 + e]);
                    }
                }
            } else {
                const int k0 = (gt - n_pre_tiles) * BK;
                mbar_expect_tx(bar, PG::STAGE);
                for (int c = 0; c < NC; ++c) {
                    tma_load4(dst + c * PG::SUB, &maps.kn, bar, c * IN, k0, h, b);
                    tma_load4(dst + PG::HALF + c * PG::SUB, &maps.vn, bar, c * IN, k0, h, b);
                }
            }
        };
        // zero the K and V rows of prefix tile gt that hold no key (past
        // the resident length; SEG: past page_valid), landed in stage st,
        // before the tile is published: TMA copied whole pages, whose tails
        // hold anything (block-uniform; a warp-collective vote in SEG)
        auto zero_unheld = [&](int gt, int st, int e0) {
            if (gt >= n_pre_tiles) return;
            bool any;
            if constexpr (SEG) {
                any = __any_sync(0xffffffffu, (lane < ppt && tl[e0 + lane] < pt) ||
                                              (lane + 32 < ppt && tl[e0 + lane + 32] < pt));
            } else {
                any = plen - gt * BK < BK;
            }
            if (!any) return;
            constexpr int CPR = D * PG::ESZ / 16, CPW = W / 16;   // 16-byte chunks a row, a block row
            char* base = ringb + st * PG::STAGE;
            for (int idx = tid; idx < 2 * BK * CPR; idx += NT) {
                const int half = idx / (BK * CPR), r = (idx / CPR) % BK, ch = idx % CPR;
                bool in;
                if constexpr (SEG) in = (r & (pt - 1)) < tl[e0 + (r >> psh)];
                else in = gt * BK + r < plen;
                if (!in)
                    *reinterpret_cast<uint4*>(base + half * PG::HALF + (ch / CPW) * PG::SUB +
                                              r * W + (ch % CPW) * 16) = make_uint4(0, 0, 0, 0);
            }
            // these generic writes come before the next TMA write of the stage
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        };

        // SEG: the key positions of prefix tile gt, issued into stage st,
        // from its staged entries: page_pos + j where j < page_valid, else
        // INT_MAX (no query sees it); every thread of the block takes part
        auto positions = [&](int gt, int st, int e0) {
            if constexpr (SEG) {
                if (gt < n_pre_tiles) {
                    for (int k = tid; k < BK; k += NT) {
                        const int e = e0 + (k >> psh), j = k & (pt - 1);
                        kp[st * BK + k] = j < tl[e] ? tp[e] + j : INT_MAX;
                    }
                }
            }
        };

        // the ring as two cursors: tile `cons` (position i) is multiplied,
        // tile `prod` (position i + NS - 1) is issued; bit j of live says
        // position i + j is loaded and multiplied (SEG: some query of the
        // block sees it).  Unlike a window of NS + 1 tiles, this holds the
        // same few registers at any depth.
        int cons = next_tile(rank), prod = cons;
        int ec = 0, ep = 0;                      // their first staged entries
        uint32_t live = 0;
#pragma unroll
        for (int j = 0; j < NS - 1; ++j) {
            if (prod < n_tiles && seen(prod, ep)) {
                live |= 1u << j;
                if (tid == 0) issue(prod, j, ep);
                positions(prod, j, ep);
            }
            prod = next_tile(prod + CL);
            ep = (ep + ppt) & (PG::TAB - 1);
        }
        uint32_t phase = 0;                      // bit s: the parity stage s completes next
        for (int i = 0; cons < n_tiles; ++i) {
            const int st = i % NS;
            if (live & 1u) {
                mbar_wait(smem_u32(bars + st), (phase >> st) & 1u);
                phase ^= 1u << st;
                zero_unheld(cons, st, ec);
            }
            // one barrier: tile i (its zeroed rows, SEG its key positions)
            // visible to all, tile i - 1 done (its stage, positions and table
            // entries free)
            __syncthreads();
            if (i > 0 && i + wt - 1 < n_my) stage(i + wt - 1, i + wt);
            if (prod < n_tiles && seen(prod, ep)) {
                live |= 1u << (NS - 1);
                if (tid == 0) issue(prod, (i + NS - 1) % NS, ep);
                positions(prod, (i + NS - 1) % NS, ep);
            }
            prod = next_tile(prod + CL);
            ep = (ep + ppt) & (PG::TAB - 1);
            if ((live & 1u) && active) {
                const T* sK = reinterpret_cast<const T*>(ringb + st * PG::STAGE);
                compute(cons, sK, sK + PG::HALF / PG::ESZ, kp + st * BK);
            }
            cons = next_tile(cons + CL);
            ec = (ec + ppt) & (PG::TAB - 1);
            live >>= 1;
        }
    }

    // reduce the cluster's partial sums through distributed shared memory,
    // in rank order (a fixed order: no atomics, no partial in device
    // memory); block `rank` writes its share of the rows
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

// cuTensorMapEncodeTiled and cuTensorMapReplaceAddress, fetched from the
// driver through the runtime (the library links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
using ReplaceAddress = CUresult (*)(CUtensorMap*, void*);

cudaError_t driver_fn(const char* name, void** fn) {
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(name, fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(name, fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    return found == cudaDriverEntryPointSuccess && *fn ? cudaSuccess : cudaErrorSymbolNotFound;
}

// Every map of a launch but its address: a launch at the shapes of an
// earlier one on this thread takes that one's map and moves it to its
// own tensors with cuTensorMapReplaceAddress, so that the host does not
// encode four maps a call.
struct MapKey {
    long long dims[4], strides[3];
    int esz, d, box1, box2;
    bool operator==(const MapKey& o) const {
        for (int i = 0; i < 4; ++i)
            if (dims[i] != o.dims[i]) return false;
        for (int i = 0; i < 3; ++i)
            if (strides[i] != o.strides[i]) return false;
        return esz == o.esz && d == o.d && box1 == o.box1 && box2 == o.box2;
    }
};
struct MapCache {
    static constexpr int N = 16;
    MapKey key[N];
    CUtensorMap map[N];
    int used = 0, next = 0;
};
thread_local MapCache map_cache;

// A 4-d tensor map over `base` (dims innermost first, the outer three
// strides in values) whose box is (IN, box1, box2, 1), with the paged
// ring's swizzle; a size-1 dim's stride is never used and may be 0.
template <int D, typename T>
cudaError_t encode(CUtensorMap* map, const void* base, const long long (&dims)[4],
                   const long long (&strides)[3], int box1, int box2) {
    using PG = PagedGeometry<D, false, T>;
    static EncodeTiled encode_fn = nullptr;
    static ReplaceAddress replace_fn = nullptr;
    if (!encode_fn || !replace_fn) {
        void *e = nullptr, *r = nullptr;
        cudaError_t err = driver_fn("cuTensorMapEncodeTiled", &e);
        if (err == cudaSuccess) err = driver_fn("cuTensorMapReplaceAddress", &r);
        if (err != cudaSuccess) return err;
        encode_fn = reinterpret_cast<EncodeTiled>(e);
        replace_fn = reinterpret_cast<ReplaceAddress>(r);
    }
    MapKey key = {{dims[0], dims[1], dims[2], dims[3]}, {strides[0], strides[1], strides[2]},
                  PG::ESZ, D, box1, box2};
    MapCache& c = map_cache;
    for (int i = 0; i < c.used; ++i) {
        if (c.key[i] == key) {
            *map = c.map[i];
            const CUresult r = replace_fn(map, const_cast<void*>(base));
            return r == CUDA_SUCCESS ? cudaSuccess
                                     : static_cast<cudaError_t>(TMA_ERROR + static_cast<int>(r));
        }
    }
    cuuint64_t gdim[4], gstride[3];
    for (int i = 0; i < 4; ++i) gdim[i] = static_cast<cuuint64_t>(dims[i]);
    for (int i = 0; i < 3; ++i) {
        const long long st = strides[i] * PG::ESZ;
        gstride[i] = static_cast<cuuint64_t>(dims[i + 1] == 1 && st == 0 ? 16 : st);
    }
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(PG::IN), static_cast<cuuint32_t>(box1),
                               static_cast<cuuint32_t>(box2), 1u};
    const cuuint32_t estride[4] = {1u, 1u, 1u, 1u};
    const CUresult r = encode_fn(map,
                                 sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                 4, const_cast<void*>(base), gdim, gstride, box, estride,
                                 CU_TENSOR_MAP_INTERLEAVE_NONE,
                                 PG::W == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                              : CU_TENSOR_MAP_SWIZZLE_64B,
                                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<cudaError_t>(TMA_ERROR + static_cast<int>(r));
    const int i = c.used < MapCache::N ? c.used++ : (c.next++ % MapCache::N);
    c.key[i] = key;
    c.map[i] = *map;
    return cudaSuccess;
}

// The paged launch's maps: each pool (D, H, page_tokens, N + 1) in boxes of
// one page's rows of one head; the new K and V (D, Sq, H, B) in boxes of
// 64 rows.  The wrapper checked TMA's rules (kernels/cuda_lib.py,
// tma_pool_geometry).
template <int D, typename T>
cudaError_t paged_maps(const RankAttnParams& p, TmaMaps* m) {
    const long long pt = p.page_tokens;
    const long long kd[4] = {D, p.H, pt, p.kpool_pages}, vd[4] = {D, p.H, pt, p.vpool_pages};
    const long long ks[3] = {p.kpool_stride[2], p.kpool_stride[1], p.kpool_stride[0]};
    const long long vs[3] = {p.vpool_stride[2], p.vpool_stride[1], p.vpool_stride[0]};
    cudaError_t err = encode<D, T>(&m->k, p.k_pool, kd, ks, 1, p.page_tokens);
    if (err != cudaSuccess) return err;
    err = encode<D, T>(&m->v, p.v_pool, vd, vs, 1, p.page_tokens);
    if (err != cudaSuccess) return err;
    const long long nd[4] = {D, p.Sq, p.H, p.B};
    const long long kns[3] = {p.kn_stride[2], p.kn_stride[1], p.kn_stride[0]};
    const long long vns[3] = {p.vn_stride[2], p.vn_stride[1], p.vn_stride[0]};
    err = encode<D, T>(&m->kn, p.k_new, nd, kns, BK, 1);
    if (err != cudaSuccess) return err;
    return encode<D, T>(&m->vn, p.v_new, nd, vns, BK, 1);
}

// Launch p's plan on `stream`.
template <int D, bool PAGED, bool SEG, typename T>
cudaError_t launch(const RankAttnParams& p, cudaStream_t stream) {
    constexpr int smem = PAGED ? PagedGeometry<D, SEG, T>::bytes : Geometry<D, T>::bytes;
    const int QR = p.q_rows, CL = p.cluster;
    if (QR < 16 || QR > MAX_Q_ROWS || QR % 16 || CL < 1 || CL > MAX_CLUSTER || p.Sq < 1)
        return cudaErrorInvalidValue;
    TmaMaps maps = {};
    if constexpr (PAGED) {
        // the tile is whole pages (a power of two that divides 64)
        if (p.page_tokens < 1 || BK % p.page_tokens || (p.page_tokens & (p.page_tokens - 1)))
            return cudaErrorInvalidValue;
        cudaError_t err = paged_maps<D, T>(p, &maps);
        if (err != cudaSuccess) return err;
    }
    static unsigned configured = 0;   // one bit per device: the > 48 KB opt-in
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (!(configured & (1u << dev))) {
        err = cudaFuncSetAttribute(hstu_rank_attn_kernel<D, PAGED, SEG, T>,
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
    err = cudaLaunchKernelEx(&cfg, hstu_rank_attn_kernel<D, PAGED, SEG, T>, p, maps);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <int D, typename T>
cudaError_t dispatch_d(const RankAttnParams& p, cudaStream_t s) {
    if (!p.paged) return launch<D, false, false, T>(p, s);
    return p.segment ? launch<D, true, true, T>(p, s) : launch<D, true, false, T>(p, s);
}

template <typename T>
cudaError_t dispatch(const RankAttnParams& p, cudaStream_t s) {
    if (p.segment && !p.paged) return cudaErrorInvalidValue;
    switch (p.D) {
        case 32: return dispatch_d<32, T>(p, s);
        case 64: return dispatch_d<64, T>(p, s);
        case 128: return dispatch_d<128, T>(p, s);
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
    if (code >= TMA_ERROR && code < TMA_ERROR + 1000) {
        static thread_local char msg[96];
        snprintf(msg, sizeof(msg), "cuTensorMapEncodeTiled refused a tensor map (CUresult %d)",
                 code - TMA_ERROR);
        return msg;
    }
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int hstu_rank_attn_struct_size() { return static_cast<int>(sizeof(RankAttnParams)); }

// The paged loader's dynamic shared memory (bytes) at head dim D, with
// SEG and bf16 0 or 1 (0 for a D not compiled).
extern "C" int hstu_rank_attn_paged_smem(int D, int seg, int bf16) {
    switch (D * 4 + seg * 2 + bf16) {
        case 32 * 4: return PagedGeometry<32, false, float>::bytes;
        case 32 * 4 + 1: return PagedGeometry<32, false, __nv_bfloat16>::bytes;
        case 32 * 4 + 2: return PagedGeometry<32, true, float>::bytes;
        case 32 * 4 + 3: return PagedGeometry<32, true, __nv_bfloat16>::bytes;
        case 64 * 4: return PagedGeometry<64, false, float>::bytes;
        case 64 * 4 + 1: return PagedGeometry<64, false, __nv_bfloat16>::bytes;
        case 64 * 4 + 2: return PagedGeometry<64, true, float>::bytes;
        case 64 * 4 + 3: return PagedGeometry<64, true, __nv_bfloat16>::bytes;
        case 128 * 4: return PagedGeometry<128, false, float>::bytes;
        case 128 * 4 + 1: return PagedGeometry<128, false, __nv_bfloat16>::bytes;
        case 128 * 4 + 2: return PagedGeometry<128, true, float>::bytes;
        case 128 * 4 + 3: return PagedGeometry<128, true, __nv_bfloat16>::bytes;
        default: return 0;
    }
}

extern "C" int hstu_rank_attn_max_cluster() { return MAX_CLUSTER; }
extern "C" int hstu_rank_attn_max_q_rows() { return MAX_Q_ROWS; }
#endif
