// Mamba2 SSD chunk stages for Hopper (sm_90a): C, B and x in float32 or
// bfloat16, cum and dt float32, every product and sum in float32.
// Replaces the two TPU kernels of src/repro/kernels/ssd_chunk.py:
//
//   * ssd_chunk_intra (_kernel): per (batch b, chunk c, head h)
//       y[q] = sum_{t <= q} exp(cum[q] - cum[t]) * (C[q] . B[t]) * dt[t] * x[t]
//   * ssd_chunk_state (_state_kernel): per (b, c, h)
//       S[n, p] = sum_t exp(cum[Q-1] - cum[t]) * dt[t] * B[t, n] * x[t, p]
//
// Shapes: C, B (B, nc, Q, N); x (B, nc, Q, H, P); cum, dt (B, nc, Q, H);
// intra out (B, nc, Q, H, P); state out (B, nc, H, N, P); Q <= 128.  Read
// and written through strides with a unit last stride.
//
// Types.  As the Pallas kernels do, each kernel takes C, B and x in either
// float type and widens every value to float32 where it leaves shared
// memory for registers (a bf16 value is exact in float32); the arithmetic
// after that point is the float32 kernel's, so a bf16 launch gives the
// bits of the float32 launch on float32 copies of the same values.  A
// bf16 tile lands in shared memory as it lies in HBM, half the bytes of
// a float32 one: 16-byte copies carry 8 values of x (and of the state's
// B), 8-byte copies 4 of the intra's C and B (their swizzle moves 4-value
// chunks).  The state is float32 (the Pallas kernel's output type); the
// intra output is float32 or bf16, the latter rounded to nearest even
// from the float32 sum.  At the Zamba2 prefill shape on the H100 the
// bf16 state kernel takes about a fifth longer than the float32 one on
// widened inputs (PERF.md, ROADMAP Queue 2 A2); widening B once into
// float32 shared memory, out of the product loop, did not change that.
//
// ssd_chunk_intra.  It replaces a version that built the masked decay
// matrix M in shared memory per head and ran both products as FFMA, with
// no load in flight during a product (0.89 ms at the Zamba2 prefill
// shape, B = 2, L = 8192, H = 64, P = N = 64).  At that shape the
// function moves ~0.55 GB (x in, y out), 0.165 ms at 3.35 TB/s, and
// needs ~9 GFLOP of products.  Single-pass TF32 keeps ~3 decimal digits,
// which the model's f32 path does not allow, so the products run in
// 3xTF32 (x = hi + lo, each rounded to TF32 by an integer add, ptxas
// emulating cvt.rna.tf32.f32 in five instructions; lo.hi' and hi.lo'
// before hi.hi').  On the H100 mma.sync.m16n8k8 .tf32 retires about a
// quarter of wgmma's TF32 rate: a version with every product on
// mma.sync, causal work split 9 : 9 blocks a warp, took 0.32 ms, most of
// it in the tensor pipe, so M x runs on wgmma.
//
//   * One block is one warpgroup (4 warps) and owns (b, c, a group of
//     `heads_per_block` heads); the chunk is two 64-row tiles, warp w
//     holding rows 16w.. of each.
//   * S = C B^T once per block, with mma.sync in 3xTF32 from C and B in
//     shared memory (XOR-swizzled, conflict-free fragment reads), while
//     the first head's x is in flight.  Each warp keeps its rows of S in
//     registers in accumulator layout for all the block's heads: 8 key
//     blocks of 8 for tile 0, 16 for tile 1.
//   * Per head, M is formed on that fragment: where(t <= q, .., -inf)
//     selected before the exp, so a masked entry never becomes inf * 0,
//     times dt[t]; split hi/lo it is the register A operand of
//     wgmma.m64n64k8 .tf32 (the accumulator's keys 2t, 2t + 1 taken as
//     the A slots t, t + 4), no M in shared memory.  Tile 0 takes 8 key
//     steps, tile 1 16, each as three wgmma (lo.hi', hi.lo', hi.hi'), in
//     batches of 4 steps.
//   * wgmma's TF32 form reads B K-major only, and x lies key by key.  So
//     x streams through a cp.async landing slab (the next head's copies
//     issued before this head's products) and one pass per head splits it
//     into hi and lo planes in the canonical K-major, unswizzled layout
//     (8 x 16-byte core matrices), keys permuted to the A slots' order,
//     16-byte stores that hit 32 banks.  cum and dt of the whole head
//     group are copied once at block start (4-byte cp.async along H).
//   * At P = N = 64 and 16 heads a block takes ~113 KB of shared memory:
//     two blocks share an SM, one's products over the other's pass and
//     loads.  y is written straight from the accumulators: each 8-byte
//     store of a quarter warp fills one 32-byte sector.

// ssd_chunk_state.  At the same shape it is 8.6 GFLOP of FFMA against
// ~0.41 GB (x in, the (N, P) states out): bound by operations, with the
// bytes close behind, so loads must overlap the product and the product
// must not wait on shared memory.  A 16-byte shared load costs a
// wavefront per quarter warp, so a thread tile of 8 x 8 (4 such loads
// per 64 FFMA) keeps the shared-memory pipe as busy as the FMA pipes.
// One block of 128 threads owns (b, c, a group of `heads_per_block` = 32
// heads), 256 blocks at that shape, two per SM:
//   * B (Q, N) is loaded once per block as it lies in HBM (cp.async), no
//     transpose; the decay weights w[t, h] = exp(cum[Q-1] - cum[t]) dt[t]
//     of every head of the group are formed in shared memory before the
//     first product, reading cum and dt coalesced along H, 16 weights'
//     loads in flight per thread (the whole grid is one wave, so this
//     prologue is not hidden behind other blocks);
//   * x streams through two 32 KB slabs (TQ rows x R heads x P) filled by
//     cp.async, one loading while the other is used; x lands as it lies
//     in HBM;
//   * each thread owns a 16 x 8 tile of one head's (N, P) state; per key
//     row t it reads 16 B values, 8 x values and (every 4 rows) 4
//     weights, applies the weight to the B fragment in registers
//     (a_i = B[t, n_i] w[t, h]) and issues 128 FFMA: 6 shared loads per
//     128 FFMA.  The variants measured on the card are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#ifndef REPRO_KERNEL_TYPE
#define REPRO_KERNEL_TYPE 0
#endif
#include <cstdint>
#include <type_traits>

extern "C" {

struct SsdParams {
    const void* C;    long long c_stride[3];    // (B, nc, Q, N): b, c, q; unit n
    const void* Bm;   long long b_stride[3];    // (B, nc, Q, N)
    const void* x;    long long x_stride[4];    // (B, nc, Q, H, P): b, c, q, h; unit p
    const float* cum; long long cum_stride[4];  // (B, nc, Q, H): b, c, q, h
    const float* dt;  long long dt_stride[4];   // (B, nc, Q, H)
    void* out;        long long o_stride[4];    // intra: b, c, q, h; state: b, c, h, n; unit p
    int B, nc, Q, H, N, P;
    int heads_per_block;
    int out_bf16;                               // intra of bf16 inputs: 1 writes bf16
};

}  // extern "C"

namespace {

constexpr int QM = 128;        // largest chunk
constexpr int SMEM_MAX = 232448;   // dynamic shared memory one block may use

__device__ __forceinline__ float lane4(const float4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// 16-byte asynchronous copy to shared memory; `live` false writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(live ? 16 : 0) : "memory");
}
// 8-byte asynchronous copy (4 bf16 values); `live` false writes zeros
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool live) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(s), "l"(src), "r"(live ? 8 : 0) : "memory");
}
// 4 consecutive values of type T (16 bytes of float32, 8 of bf16)
template <typename T>
__device__ __forceinline__ void cp_async_4v(void* dst, const void* src, bool live) {
    if constexpr (sizeof(T) == 4) cp_async16(dst, src, live);
    else cp_async8(dst, src, live);
}
// 4-byte asynchronous copy, cached in L1 (its neighbours along H follow)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(live ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the value as float32 (exact for bf16)
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 4 consecutive values as float32: one 16-byte load of float32, one
// 8-byte load of bf16 (a bf16 value is the high half of its float32)
__device__ __forceinline__ float4 load4(const float* src) {
    return *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* src) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// two consecutive outputs: float32 as they are, bf16 rounded to nearest even
__device__ __forceinline__ void store2(float* dst, float a, float b) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
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

// ---- ssd_chunk_intra ---------------------------------------------------------

constexpr int IN_NT = 128;     // one warpgroup: warp w owns rows 16w.. of each 64-row tile
constexpr int IN_SLOTS = 24;   // 8-key blocks of S a warp holds: 8 + 16
constexpr int IN_WS = QM + 4;  // padded row of the (heads, Q) cum and dt tables
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of an intra block: the split-x planes (C and B before
// them), the x landing slab, the cum and dt tables.
__host__ __device__ constexpr int intra_smem_floats(int P, int N, int heads) {
    return 2 * QM * (P > N ? P : N) + QM * P + 2 * heads * IN_WS;
}

// Word of element (r, col) of an unpadded (QM, N) C or B tile: 16-byte
// chunk col / 4 of row r sits at chunk (col / 4) ^ (r mod 8) when 32
// divides N, else ^ ((r / 2) mod 4), so the fragment reads (rows g,
// columns k + t and k + t + 4) hit 32 banks.
__device__ __forceinline__ int cbsw(int r, int col, int N) {
    const int s = N & 16 ? (r >> 1) & 3 : r & 7;
    return r * N + (col ^ (s << 2));
}

__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// Word of element (r, col) of the unpadded (QM, P) x landing slab: 16-byte
// chunk col / 4 of row r sits at chunk (col / 4) ^ 2f, f = (r mod 2) +
// 2((r / 8) mod 2), so the split pass (lanes over 8 columns x 2 row
// parities x 2 key steps) reads 32 banks.
template <int P>
__device__ __forceinline__ int xsw(int r, int col) {
    return r * P + (col ^ (((r & 1) | ((r >> 2) & 2)) << 3));
}

// Word of x[key][col] in a split-x plane, the B operand of the M x product
// in the tensor cores' K-major layout without swizzle: one tile of 8P
// words per 8-key step, in it core matrices of 8 columns x 4 keys (128 B):
// column groups col / 8 at 256 B (the stride byte offset), key halves at
// 128 B (the leading byte offset), column col % 8 at 16 B, key slot at 4
// B.  Keys 2s and 2s + 1 of a step sit in slots s and s + 4, the order of
// the A operand built from the score accumulators.
template <int P>
__device__ __forceinline__ int xtw(int key, int col) {
    return (key >> 3) * 8 * P + (col >> 3) * 64 + (key & 1) * 32 + (col & 7) * 4 + ((key & 7) >> 1);
}

// Shared-memory matrix descriptor of a K-major, unswizzled B tile at `tile`
// (core matrices 128 B apart along K, 256 B apart along N)
__device__ __forceinline__ uint64_t kmajor_desc(const float* tile) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
    return static_cast<uint64_t>((addr >> 4) & 0x3fff) | (static_cast<uint64_t>(128 >> 4) << 16) |
           (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d += a . B for one m64n32k8 tile: a this warp's 16 x 8 slice of A
// (mma.m16n8k8 layout), B (8 x 32) read by the tensor cores through `desc`
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d += a . B for one m64n64k8 tile: a this warp's 16 x 8 slice of A
// (mma.m16n8k8 layout), B (8 x 64) read by the tensor cores through `desc`
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int PN>
__device__ __forceinline__ void wgmma_tile(float (&d)[PN / 2], const uint32_t (&a)[4], uint64_t desc) {
    if constexpr (PN == 32) wgmma_n32(d, a, desc);
    else wgmma_n64(d, a, desc);
}

// T: the type of C, B and x; TO: the output's (float32, or bf16 for bf16
// inputs).  Shared memory is laid out for float32 whatever T is.
template <int P, typename T, typename TO>
__global__ void __launch_bounds__(IN_NT, 2) ssd_intra_kernel(const SsdParams p) {
    constexpr int PN = P < 64 ? P : 64;        // output columns per product (wgmma N)
    constexpr int ND = PN / 2;                 // accumulators per thread
    constexpr int KG = 4;                      // 8-key steps per batch of products
    constexpr int XV = 16 / static_cast<int>(sizeof(T));   // x values per 16-byte copy
    extern __shared__ float4 smem4[];
    const int HG = p.heads_per_block;
    float* xh = reinterpret_cast<float*>(smem4);    // split x, hi; C and B before it
    float* xl = xh + QM * P;                   // split x, lo
    T* stage = reinterpret_cast<T*>(xh + 2 * QM * max(P, p.N));  // (QM, P) landing slab
    float* sCum = xh + 2 * QM * max(P, p.N) + QM * P;            // (HG, IN_WS)
    float* sDt = sCum + HG * IN_WS;

    const int b = blockIdx.z, c = blockIdx.y, h0 = blockIdx.x * HG;
    const int hg = min(HG, p.H - h0);          // live heads of this group
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;

    // x of head hl into the landing slab, every row, zero past Q
    const T* xb = static_cast<const T*>(p.x) + b * p.x_stride[0] + c * p.x_stride[1] +
                  h0 * p.x_stride[3];
    // (thread tid copies 16 bytes at column xc of rows xr + i QM / XI)
    constexpr int XI = QM * (P / XV) / IN_NT;
    const int xr = tid / (P / XV), xc = (tid % (P / XV)) * XV;
    auto issue = [&](int hl) {
        const T* src = xb + hl * p.x_stride[3] + xc;
#pragma unroll
        for (int i = 0; i < XI; ++i) {
            const int r = xr + i * (QM / XI);
            const bool live = r < p.Q;
            cp_async16(stage + xsw<P>(r, xc), src + (live ? r * p.x_stride[2] : 0), live);
        }
    };
    {   // C and B of the chunk over the split-x planes, cum and dt of every
        // head of the group (consecutive threads along H), all zero past Q,
        // and the first head's x
        T* sC = reinterpret_cast<T*>(xh);
        T* sB = sC + QM * p.N;
        const T* cb = static_cast<const T*>(p.C) + b * p.c_stride[0] + c * p.c_stride[1];
        const T* bb = static_cast<const T*>(p.Bm) + b * p.b_stride[0] + c * p.b_stride[1];
        for (int idx = tid; idx < QM * (p.N / 4); idx += IN_NT) {
            const int r = idx / (p.N / 4), col = (idx % (p.N / 4)) * 4;
            const bool live = r < p.Q;
            cp_async_4v<T>(sC + cbsw(r, col, p.N), cb + (live ? r * p.c_stride[2] + col : 0), live);
            cp_async_4v<T>(sB + cbsw(r, col, p.N), bb + (live ? r * p.b_stride[2] + col : 0), live);
        }
        const long long co = b * p.cum_stride[0] + c * p.cum_stride[1] + h0 * p.cum_stride[3];
        const long long dto = b * p.dt_stride[0] + c * p.dt_stride[1] + h0 * p.dt_stride[3];
        for (int idx = tid; idx < QM * HG; idx += IN_NT) {
            const int r = idx / HG, hl = idx % HG;
            const bool live = r < p.Q && hl < hg;
            cp_async4(sCum + hl * IN_WS + r,
                      p.cum + (live ? co + r * p.cum_stride[2] + hl * p.cum_stride[3] : 0), live);
            cp_async4(sDt + hl * IN_WS + r,
                      p.dt + (live ? dto + r * p.dt_stride[2] + hl * p.dt_stride[3] : 0), live);
        }
        cp_async_commit();
        issue(0);
        cp_async_commit();
        cp_async_wait<1>();                    // C, B and the tables landed
        __syncthreads();
    }

    // S = C B^T for this warp's rows of both 64-row tiles: slot i < 8 holds
    // key block i of rows 16 warp + (g, g + 8), slot 8 + j key block j of
    // rows 64 + 16 warp + (g, g + 8); blocks past a row are masked later
    float s[IN_SLOTS][4];
#pragma unroll
    for (int i = 0; i < IN_SLOTS; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    {
        const T* sC = reinterpret_cast<const T*>(xh);
        const T* sB = sC + QM * p.N;
        for (int k0 = 0; k0 < p.N; k0 += 8) {
            uint32_t ah[2][4], al[2][4];
#pragma unroll
            for (int tl = 0; tl < 2; ++tl) {
                const int ra = 64 * tl + 16 * warp + g;
                split(to_f32(sC[cbsw(ra, k0 + t, p.N)]), ah[tl][0], al[tl][0]);
                split(to_f32(sC[cbsw(ra + 8, k0 + t, p.N)]), ah[tl][1], al[tl][1]);
                split(to_f32(sC[cbsw(ra, k0 + t + 4, p.N)]), ah[tl][2], al[tl][2]);
                split(to_f32(sC[cbsw(ra + 8, k0 + t + 4, p.N)]), ah[tl][3], al[tl][3]);
            }
#pragma unroll
            for (int i = 0; i < IN_SLOTS; ++i) {
                const int tl = i < 8 ? 0 : 1;
                const int key = (i - 8 * tl) * 8 + g;
                const float bv[1][2] = {{to_f32(sB[cbsw(key, k0 + t, p.N)]),
                                         to_f32(sB[cbsw(key, k0 + t + 4, p.N)])}};
                mma3<1>(s, i, ah[tl], al[tl], bv);
            }
        }
    }

    const uint64_t dh = kmajor_desc(xh), dl = kmajor_desc(xl);
    TO* ob = static_cast<TO*>(p.out) + b * p.o_stride[0] + c * p.o_stride[1] + h0 * p.o_stride[3];
    for (int hl = 0; hl < hg; ++hl) {
        cp_async_wait<0>();                    // this thread's copies of head hl landed
        __syncthreads();                       // ... everyone's; the planes are free
        // split x once into the two planes: lane (c, e, j) of a warp takes
        // column 8cg + c, keys 8kb + 2s + e (s = 0..3) of step kb = 2kp + j,
        // one 16-byte row of a core matrix per plane, so reads and writes
        // hit 32 banks
#pragma unroll
        for (int u = warp; u < (P / 8) * (QM / 16); u += IN_NT / 32) {
            const int cg = u % (P / 8), kb = 2 * (u / (P / 8)) + (lane >> 4);
            const int e = (lane >> 3) & 1, col = 8 * cg + (lane & 7);
            const T* rd = stage + xsw<P>(8 * kb + e, col);
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int sl = 0; sl < 4; ++sl) split(to_f32(rd[2 * sl * P]), hi[sl], lo[sl]);
            const int w = xtw<P>(8 * kb + e, col);
            *reinterpret_cast<uint4*>(xh + w) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
            *reinterpret_cast<uint4*>(xl + w) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
        __syncthreads();                       // the planes are written; the slab is free
        if (hl + 1 < hg) issue(hl + 1);
        cp_async_commit();
        const float* cum = sCum + hl * IN_WS;
        const float* dt = sDt + hl * IN_WS;
        TO* oh = ob + hl * p.o_stride[3];
#pragma unroll
        for (int tl = 0; tl < 2; ++tl) {
            if (64 * tl >= p.Q) continue;
            const int qa = 64 * tl + 16 * warp + g;    // rows qa, qa + 8 of this lane
            const float cq[2] = {cum[qa], cum[qa + 8]};
            for (int pc = 0; pc < P; pc += PN) {
                float acc[ND];
#pragma unroll
                for (int j = 0; j < ND; ++j) acc[j] = 0.f;
#pragma unroll
                for (int k0 = 0; k0 < 8 * (tl + 1); k0 += KG) {
                    uint32_t ah[KG][4], al[KG][4];
#pragma unroll
                    for (int ks = 0; ks < KG; ++ks) {
                        // M = where(key <= q, exp(cum[q] - cum[key]), 0) S dt[key]
                        // on the fragment: element e is row qa + 8 (e / 2), key
                        // k + e % 2, A slot (e / 2) + 2 (e % 2)
                        const int kb = k0 + ks, k = kb * 8 + 2 * t;
                        const float2 ck = *reinterpret_cast<const float2*>(cum + k);
                        const float2 dk = *reinterpret_cast<const float2*>(dt + k);
                        float m[4];
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int q = qa + 8 * (e >> 1), key = k + (e & 1);
                            const float d = cq[e >> 1] - (e & 1 ? ck.y : ck.x);
                            m[e] = exp2_approx((key <= q ? d : -INFINITY) * LOG2E) *
                                   s[8 * tl + kb][e] * (e & 1 ? dk.y : dk.x);
                        }
                        split(m[0], ah[ks][0], al[ks][0]);
                        split(m[2], ah[ks][1], al[ks][1]);
                        split(m[1], ah[ks][2], al[ks][2]);
                        split(m[3], ah[ks][3], al[ks][3]);
                    }
                    wgmma_fence();
#pragma unroll
                    for (int ks = 0; ks < KG; ++ks) {
                        const uint64_t off = static_cast<uint64_t>((k0 + ks) * 32 * P + pc * 32) >> 4;
                        wgmma_tile<PN>(acc, al[ks], dh + off);
                        wgmma_tile<PN>(acc, ah[ks], dl + off);
                        wgmma_tile<PN>(acc, ah[ks], dh + off);
                    }
                    wgmma_commit();
                    wgmma_wait<0>();
                }
#pragma unroll
                for (int j = 0; j < ND / 4; ++j) {
                    TO* o = oh + pc + j * 8 + 2 * t;
                    if (qa < p.Q) store2(o + qa * p.o_stride[2], acc[4 * j], acc[4 * j + 1]);
                    if (qa + 8 < p.Q)
                        store2(o + (qa + 8) * p.o_stride[2], acc[4 * j + 2], acc[4 * j + 3]);
                }
            }
        }
    }
}

// ---- ssd_chunk_state ---------------------------------------------------------

constexpr int ST_NT = 128;       // threads per block
constexpr int ST_TM = 16;        // state rows per thread
constexpr int ST_STAGE = 8192;   // x values per ring stage (32 KB of float32, 16 of bf16)
constexpr int ST_NS = 2;         // ring stages: one slab loads while one is used
constexpr int ST_WS = QM + 4;    // padded row of the (heads, Q) weight table


// log2 of the heads a round holds: the largest power of two R with
// R * tph <= ST_NT threads and slabs of at least 4 rows
__host__ __device__ constexpr int log2_heads_per_round(int tph, int P) {
    int lg = 0;
    while ((2 << lg) * tph <= ST_NT && (2 << lg) * P * 4 <= ST_STAGE) ++lg;
    return lg;
}

// One block per (b, chunk, group of heads_per_block heads).  Thread tile:
// 16 state rows x 8 columns of one head, so (N / 16) * (P / 8) threads
// per head and R (a power of two) heads in flight per round; the rounds
// walk the group.  x streams through a ring of (TQ rows x R heads x P)
// slabs of exactly ST_STAGE values, flattened over (round, slab), the
// next slab loading while this one is used.  N and P are compile-time,
// so every shared-memory offset of the product is an immediate.  B and x
// of type T land as they lie in HBM and widen as they are read (load4).
template <int P, int N, typename T>
__global__ void __launch_bounds__(ST_NT, 2) ssd_state_kernel(const SsdParams p) {
    constexpr int TPH = (N / ST_TM) * (P / 8);  // threads per head
    constexpr int LG_R = log2_heads_per_round(TPH, P);
    constexpr int R = 1 << LG_R;               // heads per round
    constexpr int TQ = ST_STAGE / (R * P);     // x rows per slab
    constexpr int XV = 16 / static_cast<int>(sizeof(T));   // values per 16-byte copy
    constexpr int ST_CH = ST_STAGE / XV / ST_NT;           // copies each thread issues per slab
    extern __shared__ float4 smem4[];
    const int HG = p.heads_per_block;
    const int Q4 = (p.Q + 3) & ~3;             // rows the product walks; zero past Q
    const int n_slab = (p.Q + TQ - 1) / TQ;
    const int n_tiles = (HG + R - 1) / R * n_slab;
    T* sB = reinterpret_cast<T*>(smem4);       // (QM, N): B as it lies in HBM
    float* sW = reinterpret_cast<float*>(sB + QM * N);   // (HG, ST_WS): decay-to-end * dt
    T* ring = reinterpret_cast<T*>(sW + HG * ST_WS);     // ST_NS x (TQ, R, P) slabs of x

    const int b = blockIdx.z, c = blockIdx.y, h0 = blockIdx.x * HG;
    const int hg = min(HG, p.H - h0);          // live heads of this group
    const int tid = threadIdx.x;

    // B once per block, rows up to Q4 (zero past Q), with the first slab
    const T* bb = static_cast<const T*>(p.Bm) + b * p.b_stride[0] + c * p.b_stride[1];
    for (int idx = tid; idx < Q4 * (N / XV); idx += ST_NT) {
        const int t = idx / (N / XV), k = (idx % (N / XV)) * XV;
        const bool live = t < p.Q;
        cp_async16(sB + t * N + k, bb + (live ? t * p.b_stride[2] + k : 0), live);
    }
    // copy tid + i * ST_NT of a slab is row t, head hr, columns k..k+XV-1,
    // and lands at value (tid + i * ST_NT) * XV of the slab
    const T* xb = static_cast<const T*>(p.x) + b * p.x_stride[0] + c * p.x_stride[1] +
                  h0 * p.x_stride[3];
    auto issue = [&](int tile) {
        const int hl0 = tile / n_slab * R, t0 = (tile % n_slab) * TQ;
        T* dst = ring + (tile % ST_NS) * ST_STAGE;
#pragma unroll
        for (int i = 0; i < ST_CH; ++i) {
            const int idx = tid + i * ST_NT, q1 = idx / (P / XV);
            const int t = q1 >> LG_R, hr = q1 & (R - 1), k = (idx % (P / XV)) * XV;
            const bool live = t0 + t < p.Q && hl0 + hr < hg;
            cp_async16(dst + idx * XV,
                       xb + (live ? (t0 + t) * p.x_stride[2] + (hl0 + hr) * p.x_stride[3] + k : 0),
                       live);
        }
    };
#pragma unroll
    for (int st = 0; st < ST_NS - 1; ++st) {
        if (st < n_tiles) issue(st);
        cp_async_commit();
    }

    // every weight before the first product, read coalesced along H
    const float* cb = p.cum + b * p.cum_stride[0] + c * p.cum_stride[1] + h0 * p.cum_stride[3];
    const float* db = p.dt + b * p.dt_stride[0] + c * p.dt_stride[1] + h0 * p.dt_stride[3];
    constexpr int WB = 16;                     // weights whose loads are in flight together
    for (int base = tid; base < Q4 * HG; base += WB * ST_NT) {
        float cur[WB], last[WB], dt[WB];
#pragma unroll
        for (int i = 0; i < WB; ++i) {
            const int idx = base + i * ST_NT, t = idx / HG, hl = idx % HG;
            const bool live = idx < Q4 * HG && t < p.Q && hl < hg;
            cur[i] = live ? cb[t * p.cum_stride[2] + hl * p.cum_stride[3]] : 0.f;
            last[i] = live ? cb[(p.Q - 1) * p.cum_stride[2] + hl * p.cum_stride[3]] : 0.f;
            dt[i] = live ? db[t * p.dt_stride[2] + hl * p.dt_stride[3]] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < WB; ++i) {
            const int idx = base + i * ST_NT, t = idx / HG, hl = idx % HG;
            if (idx < Q4 * HG) sW[hl * ST_WS + t] = expf(last[i] - cur[i]) * dt[i];
        }
    }

    const int hr = tid / TPH, r = tid % TPH;
    const int ty = r / (P / 8), tx = r % (P / 8);  // rows ty*16 ..; columns tx*4 .. +4, + P/2
    float acc[ST_TM][8];
#pragma unroll
    for (int i = 0; i < ST_TM; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;

    for (int tile = 0; tile < n_tiles; ++tile) {
        cp_async_wait<ST_NS - 2>();            // this thread's copies of `tile` landed
        __syncthreads();                       // slab `tile` (and B, weights) visible; slot tile-1 free
        if (tile + ST_NS - 1 < n_tiles) issue(tile + ST_NS - 1);
        cp_async_commit();

        const int round = tile / n_slab, slab = tile % n_slab;
        const int t0 = slab * TQ;
        const int hl = round * R + hr;
        if (hr >= R || hl >= hg) continue;     // no head for this thread in this round
        const int tq = min(TQ, Q4 - t0);
        const T* xs = ring + (tile % ST_NS) * ST_STAGE + hr * P + tx * 4;
        const T* bs = sB + t0 * N + ty * ST_TM;
        const float* ws = sW + hl * ST_WS + t0;
        for (int t = 0; t < tq; t += 4) {
            const float4 w4 = *reinterpret_cast<const float4*>(ws + t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float w = lane4(w4, e);
                const float4 x0 = load4(xs + (t + e) * R * P);
                const float4 x1 = load4(xs + (t + e) * R * P + P / 2);
                float a[ST_TM];
#pragma unroll
                for (int i = 0; i < ST_TM; i += 4) {
                    const float4 bq = load4(bs + (t + e) * N + i);
                    a[i] = bq.x * w; a[i + 1] = bq.y * w; a[i + 2] = bq.z * w; a[i + 3] = bq.w * w;
                }
                const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
                for (int i = 0; i < ST_TM; ++i)
#pragma unroll
                    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(a[i], xv[jj], acc[i][jj]);
            }
        }
        if (slab == n_slab - 1) {              // the head's sum is complete
            float* ob = static_cast<float*>(p.out) + b * p.o_stride[0] + c * p.o_stride[1] + (h0 + hl) * p.o_stride[2] +
                        tx * 4;
#pragma unroll
            for (int i = 0; i < ST_TM; ++i) {
                float* row = ob + (ty * ST_TM + i) * p.o_stride[3];
                *reinterpret_cast<float4*>(row) =
                    make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
                *reinterpret_cast<float4*>(row + P / 2) =
                    make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
#pragma unroll
                for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;
            }
        }
    }
    cp_async_wait<0>();
}

bool valid(const SsdParams& p) {
    return p.Q >= 1 && p.Q <= QM && p.N >= 16 && p.N <= 128 && p.N % 16 == 0 &&
           p.heads_per_block >= 1 && p.B >= 1 && p.nc >= 1 && p.H >= 1;
}

// Launch `kernel` over the grid (head groups, chunks, batch) with `smem`
// bytes of dynamic shared memory, the carveout at its maximum.
template <typename K>
int run(K kernel, const SsdParams& p, int threads, int smem, cudaStream_t stream) {
    if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((p.H + p.heads_per_block - 1) / p.heads_per_block, p.nc, p.B);
    kernel<<<grid, threads, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// ssd_chunk_intra with inputs of type T; a bf16 launch writes bf16 when
// out_bf16 is set, else float32 (a float32 launch writes float32 only)
template <typename T>
int intra(const SsdParams* p, void* stream) {
    if (!valid(*p) || (sizeof(T) == 4 && p->out_bf16)) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int smem =
        static_cast<int>(sizeof(float)) * intra_smem_floats(p->P, p->N, p->heads_per_block);
    auto by_out = [&](auto p_tag) {
        constexpr int P = decltype(p_tag)::value;
        if constexpr (sizeof(T) == 2) {
            if (p->out_bf16) return run(ssd_intra_kernel<P, T, T>, *p, IN_NT, smem, s);
        }
        return run(ssd_intra_kernel<P, T, float>, *p, IN_NT, smem, s);
    };
    switch (p->P) {
        case 32: return by_out(std::integral_constant<int, 32>{});
        case 64: return by_out(std::integral_constant<int, 64>{});
        case 128: return by_out(std::integral_constant<int, 128>{});
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// ssd_chunk_state with inputs of type T (float32 out)
template <typename T>
int state(const SsdParams* p, void* stream) {
    if (!valid(*p) || p->out_bf16) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int smem = static_cast<int>(sizeof(T) * (QM * p->N + ST_NS * ST_STAGE) +
                                      sizeof(float) * p->heads_per_block * ST_WS);
    auto by_n = [&](auto p_tag) {
        constexpr int P = decltype(p_tag)::value;
        switch (p->N) {
            case 16: return run(ssd_state_kernel<P, 16, T>, *p, ST_NT, smem, s);
            case 32: return run(ssd_state_kernel<P, 32, T>, *p, ST_NT, smem, s);
            case 48: return run(ssd_state_kernel<P, 48, T>, *p, ST_NT, smem, s);
            case 64: return run(ssd_state_kernel<P, 64, T>, *p, ST_NT, smem, s);
            case 80: return run(ssd_state_kernel<P, 80, T>, *p, ST_NT, smem, s);
            case 96: return run(ssd_state_kernel<P, 96, T>, *p, ST_NT, smem, s);
            case 112: return run(ssd_state_kernel<P, 112, T>, *p, ST_NT, smem, s);
            case 128: return run(ssd_state_kernel<P, 128, T>, *p, ST_NT, smem, s);
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    };
    switch (p->P) {
        case 32: return by_n(std::integral_constant<int, 32>{});
        case 64: return by_n(std::integral_constant<int, 64>{});
        case 128: return by_n(std::integral_constant<int, 128>{});
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// The build compiles this file once per input type, both at once: with
// REPRO_KERNEL_TYPE 0 the float32 kernels and the shared export, with 1
// the bf16 kernels (kernels/cuda_lib.py, UNITS).
#if REPRO_KERNEL_TYPE == 1
extern "C" int ssd_chunk_intra_bf16(const SsdParams* p, void* stream) {
    return intra<__nv_bfloat16>(p, stream);
}
extern "C" int ssd_chunk_state_bf16(const SsdParams* p, void* stream) {
    return state<__nv_bfloat16>(p, stream);
}
#else
extern "C" int ssd_chunk_intra_f32(const SsdParams* p, void* stream) {
    return intra<float>(p, stream);
}
extern "C" int ssd_chunk_state_f32(const SsdParams* p, void* stream) {
    return state<float>(p, stream);
}

extern "C" int ssd_chunk_struct_size() { return static_cast<int>(sizeof(SsdParams)); }
#endif
