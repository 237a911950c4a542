// Mamba2 SSD chunk stages for Hopper (sm_90a), full float32 on the CUDA
// cores (no TF32: the products are FFMA, so the numbers are those of an
// f32 reference up to summation order).  Replaces the two TPU kernels of
// src/repro/kernels/ssd_chunk.py:
//
//   * ssd_chunk_intra (_kernel): per (batch b, chunk c, head h)
//       y[q] = sum_{t <= q} exp(cum[q] - cum[t]) * (C[q] . B[t]) * dt[t] * x[t]
//   * ssd_chunk_state (_state_kernel): per (b, c, h)
//       S[n, p] = sum_t exp(cum[Q-1] - cum[t]) * dt[t] * B[t, n] * x[t, p]
//
// Shapes: C, B (B, nc, Q, N); x (B, nc, Q, H, P); cum, dt (B, nc, Q, H);
// intra out (B, nc, Q, H, P); state out (B, nc, H, N, P); Q <= 128.  All
// float32, read and written through strides with a unit last stride.
//
// ssd_chunk_intra.  The TPU grid (B, nc, H) recomputes the (Q, Q) score
// tile C B^T for every head, although B and C are shared by all heads
// (one group).  Here one block owns (b, c, a group of up to
// `heads_per_block` heads): it computes C B^T once into shared memory and
// reuses it for each head of the group, so the head-independent half of
// the intra-chunk work is done H / heads_per_block times less.  Per head
// it builds the masked decay matrix M[q, t] in shared memory — selecting
// t <= q BEFORE the exp, so exp never sees the positive cum[q] - cum[t]
// of a masked entry and no inf * 0 = NaN can arise — then y = M x with a
// causal bound: each warp owns 16 rows and stops at its last row's column
// (M is zero past it), and the row groups are spread so that the four
// schedulers of an SM get equal work.  At the Zamba2 prefill shape
// (B = 2, L = 8192, H = 64, P = N = 64) it needs ~9 GFLOP against
// ~0.55 GB of x in and y out: bound by bytes at 67 TFLOP/s f32 and
// 3.35 TB/s.  It does not overlap loads with compute (one block per SM
// for ~200 KB of shared memory); a later version would double-buffer x
// and keep the score tile in registers.
//
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

#include <cuda_runtime.h>

#include <type_traits>

extern "C" {

struct SsdParams {
    const float* C;   long long c_stride[3];    // (B, nc, Q, N): b, c, q; unit n
    const float* Bm;  long long b_stride[3];    // (B, nc, Q, N)
    const float* x;   long long x_stride[4];    // (B, nc, Q, H, P): b, c, q, h; unit p
    const float* cum; long long cum_stride[4];  // (B, nc, Q, H): b, c, q, h
    const float* dt;  long long dt_stride[4];   // (B, nc, Q, H)
    float* out;       long long o_stride[4];    // intra: b, c, q, h; state: b, c, h, n; unit p
    int B, nc, Q, H, N, P;
    int heads_per_block;
};

}  // extern "C"

namespace {

constexpr int QM = 128;        // largest chunk
constexpr int MS = QM + 4;     // padded row of a (QM, QM) tile: 16 B aligned, banks spread
constexpr int NK = 32;         // state width loaded per step of C B^T
constexpr int NT = 256;        // threads per block
constexpr int SMEM_MAX = 232448;   // dynamic shared memory one block may use

__device__ __forceinline__ float lane4(const float4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int PC>
__device__ __forceinline__ void load_cols(float (&b)[PC], const float* row) {
    if constexpr (PC % 4 == 0) {
#pragma unroll
        for (int j = 0; j < PC; j += 4) {
            const float4 t = *reinterpret_cast<const float4*>(row + j);
            b[j] = t.x; b[j + 1] = t.y; b[j + 2] = t.z; b[j + 3] = t.w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < PC; j += 2) {
            const float2 t = *reinterpret_cast<const float2*>(row + j);
            b[j] = t.x; b[j + 1] = t.y;
        }
    }
}

template <int PC>
__device__ __forceinline__ void store_cols(float* row, const float (&v)[PC]) {
    if constexpr (PC % 4 == 0) {
#pragma unroll
        for (int j = 0; j < PC; j += 4)
            *reinterpret_cast<float4*>(row + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    } else {
#pragma unroll
        for (int j = 0; j < PC; j += 2)
            *reinterpret_cast<float2*>(row + j) = make_float2(v[j], v[j + 1]);
    }
}

// x rows [0, QM) of head h into sX (QM, P); rows at or past Q are zero,
// so they add nothing to any product.
template <int P>
__device__ __forceinline__ void load_x(float* sX, const SsdParams& p, int b, int c, int h) {
    const float* xb = p.x + b * p.x_stride[0] + c * p.x_stride[1] + h * p.x_stride[3];
    for (int idx = threadIdx.x; idx < QM * (P / 4); idx += NT) {
        const int t = idx / (P / 4), j = (idx % (P / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t < p.Q) v = *reinterpret_cast<const float4*>(xb + t * p.x_stride[2] + j);
        *reinterpret_cast<float4*>(sX + t * P + j) = v;
    }
}

__device__ __forceinline__ float at4(const float* base, const long long* s, int b, int c,
                                     int t, int h) {
    return base[b * s[0] + c * s[1] + t * s[2] + h * s[3]];
}

// ---- ssd_chunk_intra ---------------------------------------------------------

template <int P>
__global__ void __launch_bounds__(NT, 1) ssd_intra_kernel(const SsdParams p) {
    constexpr int PC = P / 16;                 // output columns per thread
    extern __shared__ float4 smem4[];
    float* sS = reinterpret_cast<float*>(smem4);   // (QM, MS) scores C B^T
    float* sM = sS + QM * MS;                  // (QM, MS) masked decay * scores * dt
    float* sR = sM + QM * MS;                  // C / B^T chunks, then x
    float* sCum = sR + max(QM * (NK + 4) + NK * MS, QM * P);
    float* sDt = sCum + QM;

    const int b = blockIdx.z, c = blockIdx.y;
    const int h0 = blockIdx.x * p.heads_per_block;
    const int h1 = min(p.H, h0 + p.heads_per_block);
    const int tid = threadIdx.x;
    const int Qp = (p.Q + 3) & ~3;

    // 1) S = C B^T over the whole (QM, QM) tile, NK state columns at a time
    {
        float* sC = sR;                        // (QM, NK + 4)
        float* sBT = sR + QM * (NK + 4);       // (NK, MS)
        const int ty = tid / 16, tx = tid % 16;
        float s[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
        const float* cb = p.C + b * p.c_stride[0] + c * p.c_stride[1];
        const float* bb = p.Bm + b * p.b_stride[0] + c * p.b_stride[1];
        for (int n0 = 0; n0 < p.N; n0 += NK) {
            const int nk = min(NK, p.N - n0);
            __syncthreads();
            for (int idx = tid; idx < QM * (NK / 4); idx += NT) {
                const int t = idx / (NK / 4), k = (idx % (NK / 4)) * 4;
                float4 cv = make_float4(0.f, 0.f, 0.f, 0.f), bv = cv;
                if (t < p.Q && k < nk) {
                    cv = *reinterpret_cast<const float4*>(cb + t * p.c_stride[2] + n0 + k);
                    bv = *reinterpret_cast<const float4*>(bb + t * p.b_stride[2] + n0 + k);
                }
                *reinterpret_cast<float4*>(sC + t * (NK + 4) + k) = cv;
                sBT[(k + 0) * MS + t] = bv.x;
                sBT[(k + 1) * MS + t] = bv.y;
                sBT[(k + 2) * MS + t] = bv.z;
                sBT[(k + 3) * MS + t] = bv.w;
            }
            __syncthreads();
#pragma unroll 2
            for (int k = 0; k < NK; k += 4) {
                float4 a[8];
#pragma unroll
                for (int i = 0; i < 8; ++i)
                    a[i] = *reinterpret_cast<const float4*>(sC + (ty + 16 * i) * (NK + 4) + k);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float bv[8];
                    load_cols<8>(bv, sBT + (k + e) * MS + tx * 8);
#pragma unroll
                    for (int i = 0; i < 8; ++i) {
                        const float ai = lane4(a[i], e);
#pragma unroll
                        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(ai, bv[j], s[i][j]);
                    }
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) store_cols<8>(sS + (ty + 16 * i) * MS + tx * 8, s[i]);
    }

    // 2) per head: M = where(t <= q, exp(cum[q] - cum[t]), 0) * S * dt[t];
    //    y = M x, row group g of 16 rows per warp, causal column bound
    const int w = tid / 32, lane = tid % 32;
    const int g = w < 4 ? w : 11 - w;          // schedulers s, s+4 get groups summing to 7
    const int r0 = 16 * g + 8 * (lane / 16), tx = lane % 16;
    const int t_end = r0 < p.Q ? min(r0 + 8, Qp) : 0;   // rows past Q: nothing to do
    float* sX = sR;
    for (int h = h0; h < h1; ++h) {
        __syncthreads();                       // S written / last head's reads done
        for (int t = tid; t < QM; t += NT) {
            const bool live = t < p.Q;
            sCum[t] = live ? at4(p.cum, p.cum_stride, b, c, t, h) : 0.f;
            sDt[t] = live ? at4(p.dt, p.dt_stride, b, c, t, h) : 0.f;
        }
        load_x<P>(sX, p, b, c, h);
        __syncthreads();
        for (int idx = tid; idx < QM * QM; idx += NT) {
            const int q = idx / QM, t = idx % QM;
            sM[q * MS + t] = t <= q ? expf(sCum[q] - sCum[t]) * sS[q * MS + t] * sDt[t] : 0.f;
        }
        __syncthreads();
        float acc[8][PC];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < PC; ++j) acc[i][j] = 0.f;
        for (int t = 0; t < t_end; t += 4) {
            float4 a[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
                a[i] = *reinterpret_cast<const float4*>(sM + (r0 + i) * MS + t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float bv[PC];
                load_cols<PC>(bv, sX + (t + e) * P + tx * PC);
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const float ai = lane4(a[i], e);
#pragma unroll
                    for (int j = 0; j < PC; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
                }
            }
        }
        float* ob = p.out + b * p.o_stride[0] + c * p.o_stride[1] + h * p.o_stride[3];
#pragma unroll
        for (int i = 0; i < 8; ++i)
            if (r0 + i < p.Q) store_cols<PC>(ob + (r0 + i) * p.o_stride[2] + tx * PC, acc[i]);
    }
}

// ---- ssd_chunk_state ---------------------------------------------------------

constexpr int ST_NT = 128;       // threads per block
constexpr int ST_TM = 16;        // state rows per thread
constexpr int ST_STAGE = 8192;   // x floats per ring stage (32 KB)
constexpr int ST_NS = 2;         // ring stages: one slab loads while one is used
constexpr int ST_WS = QM + 4;    // padded row of the (heads, Q) weight table

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

constexpr int ST_CH = ST_STAGE / 4 / ST_NT;    // 16-byte chunks each thread copies per slab

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
// slabs of exactly ST_STAGE floats, flattened over (round, slab), the
// next slab loading while this one is used.  N and P are compile-time,
// so every shared-memory offset of the product is an immediate.
template <int P, int N>
__global__ void __launch_bounds__(ST_NT, 2) ssd_state_kernel(const SsdParams p) {
    constexpr int TPH = (N / ST_TM) * (P / 8);  // threads per head
    constexpr int LG_R = log2_heads_per_round(TPH, P);
    constexpr int R = 1 << LG_R;               // heads per round
    constexpr int TQ = ST_STAGE / (R * P);     // x rows per slab
    extern __shared__ float4 smem4[];
    const int HG = p.heads_per_block;
    const int Q4 = (p.Q + 3) & ~3;             // rows the product walks; zero past Q
    const int n_slab = (p.Q + TQ - 1) / TQ;
    const int n_tiles = (HG + R - 1) / R * n_slab;
    float* sB = reinterpret_cast<float*>(smem4);   // (QM, N): B as it lies in HBM
    float* sW = sB + QM * N;                   // (HG, ST_WS): decay-to-end * dt
    float* ring = sW + HG * ST_WS;             // ST_NS x (TQ, R, P) slabs of x

    const int b = blockIdx.z, c = blockIdx.y, h0 = blockIdx.x * HG;
    const int hg = min(HG, p.H - h0);          // live heads of this group
    const int tid = threadIdx.x;

    // B once per block, rows up to Q4 (zero past Q), with the first slab
    const float* bb = p.Bm + b * p.b_stride[0] + c * p.b_stride[1];
    for (int idx = tid; idx < Q4 * (N / 4); idx += ST_NT) {
        const int t = idx / (N / 4), k = (idx % (N / 4)) * 4;
        const bool live = t < p.Q;
        cp_async16(sB + t * N + k, bb + (live ? t * p.b_stride[2] + k : 0), live);
    }
    // chunk tid + i * ST_NT of a slab is row t, head hr, columns k..k+3, and
    // lands at float (tid + i * ST_NT) * 4 of the slab
    const float* xb = p.x + b * p.x_stride[0] + c * p.x_stride[1] + h0 * p.x_stride[3];
    auto issue = [&](int tile) {
        const int hl0 = tile / n_slab * R, t0 = (tile % n_slab) * TQ;
        float* dst = ring + (tile % ST_NS) * ST_STAGE;
#pragma unroll
        for (int i = 0; i < ST_CH; ++i) {
            const int idx = tid + i * ST_NT, q1 = idx / (P / 4);
            const int t = q1 >> LG_R, hr = q1 & (R - 1), k = (idx % (P / 4)) * 4;
            const bool live = t0 + t < p.Q && hl0 + hr < hg;
            cp_async16(dst + idx * 4,
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
        const float* xs = ring + (tile % ST_NS) * ST_STAGE + hr * P + tx * 4;
        const float* bs = sB + t0 * N + ty * ST_TM;
        const float* ws = sW + hl * ST_WS + t0;
        for (int t = 0; t < tq; t += 4) {
            const float4 w4 = *reinterpret_cast<const float4*>(ws + t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float w = lane4(w4, e);
                const float4 x0 = *reinterpret_cast<const float4*>(xs + (t + e) * R * P);
                const float4 x1 = *reinterpret_cast<const float4*>(xs + (t + e) * R * P + P / 2);
                float a[ST_TM];
#pragma unroll
                for (int i = 0; i < ST_TM; i += 4) {
                    const float4 bq = *reinterpret_cast<const float4*>(bs + (t + e) * N + i);
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
            float* ob = p.out + b * p.o_stride[0] + c * p.o_stride[1] + (h0 + hl) * p.o_stride[2] +
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

template <typename K>
cudaError_t launch(K kernel, const SsdParams& p, int smem, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.H + p.heads_per_block - 1) / p.heads_per_block, p.nc, p.B);
    kernel<<<grid, NT, smem, stream>>>(p);
    return cudaGetLastError();
}

bool valid(const SsdParams& p) {
    return p.Q >= 1 && p.Q <= QM && p.N >= 16 && p.N <= 128 && p.N % 16 == 0 &&
           p.heads_per_block >= 1 && p.B >= 1 && p.nc >= 1 && p.H >= 1;
}

}  // namespace

extern "C" int ssd_chunk_intra_f32(const SsdParams* p, void* stream) {
    if (!valid(*p)) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int region = QM * (NK + 4) + NK * MS;
    auto smem = [&](int P) {
        return static_cast<int>(sizeof(float) * (2 * QM * MS + max(region, QM * P) + 2 * QM));
    };
    switch (p->P) {
        case 32: return launch(ssd_intra_kernel<32>, *p, smem(32), s);
        case 64: return launch(ssd_intra_kernel<64>, *p, smem(64), s);
        case 128: return launch(ssd_intra_kernel<128>, *p, smem(128), s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

extern "C" int ssd_chunk_state_f32(const SsdParams* p, void* stream) {
    if (!valid(*p)) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int smem = static_cast<int>(
        sizeof(float) * (QM * p->N + p->heads_per_block * ST_WS + ST_NS * ST_STAGE));
    if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    auto run = [&](auto kernel) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        const dim3 grid((p->H + p->heads_per_block - 1) / p->heads_per_block, p->nc, p->B);
        kernel<<<grid, ST_NT, smem, s>>>(*p);
        return static_cast<int>(cudaGetLastError());
    };
    auto by_n = [&](auto p_tag) {
        constexpr int P = decltype(p_tag)::value;
        switch (p->N) {
            case 16: return run(ssd_state_kernel<P, 16>);
            case 32: return run(ssd_state_kernel<P, 32>);
            case 48: return run(ssd_state_kernel<P, 48>);
            case 64: return run(ssd_state_kernel<P, 64>);
            case 80: return run(ssd_state_kernel<P, 80>);
            case 96: return run(ssd_state_kernel<P, 96>);
            case 112: return run(ssd_state_kernel<P, 112>);
            case 128: return run(ssd_state_kernel<P, 128>);
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

extern "C" int ssd_chunk_struct_size() { return static_cast<int>(sizeof(SsdParams)); }
