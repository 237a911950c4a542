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
// Design.  The TPU grid (B, nc, H) recomputes the (Q, Q) score tile C B^T
// for every head, although B and C are shared by all heads (one group).
// Here one block owns (b, c, a group of up to `heads_per_block` heads):
// it computes C B^T once into shared memory and reuses it for each head
// of the group, so the head-independent half of the intra-chunk work is
// done H / heads_per_block times less.  Per head it builds the masked
// decay matrix M[q, t] in shared memory — selecting t <= q BEFORE the
// exp, so exp never sees the positive cum[q] - cum[t] of a masked entry
// and no inf * 0 = NaN can arise — then y = M x with a causal bound: each
// warp owns 16 rows and stops at its last row's column (M is zero past
// it), and the row groups are spread so that the four schedulers of an
// SM get equal work.  The state kernel loads B^T once per block and, per
// head, x scaled by its decay-to-chunk-end weight, then one (N, Q) x
// (Q, P) product.
//
// What bounds it.  At the Zamba2 prefill shape (B = 2, L = 8192, H = 64,
// P = N = 64) the work the function needs (C B^T once per chunk, the
// causal half of M x) is ~9 GFLOP against ~0.55 GB of x in and y out, so
// at 67 TFLOP/s f32 and 3.35 TB/s it is bound by bytes; the state stage
// is ~8.6 GFLOP against ~0.54 GB, about even.  This first version does
// not overlap loads with compute (one block per SM for the intra kernel's
// ~200 KB of shared memory); a later version would double-buffer x and
// keep the score tile in registers.

#include <cuda_runtime.h>

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

// x rows [0, QM) of head h into sX (QM, P), scaled by w[t] if given;
// rows at or past Q are zero, so they add nothing to any product.
template <int P>
__device__ __forceinline__ void load_x(float* sX, const SsdParams& p, int b, int c, int h,
                                       const float* w) {
    const float* xb = p.x + b * p.x_stride[0] + c * p.x_stride[1] + h * p.x_stride[3];
    for (int idx = threadIdx.x; idx < QM * (P / 4); idx += NT) {
        const int t = idx / (P / 4), j = (idx % (P / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t < p.Q) {
            v = *reinterpret_cast<const float4*>(xb + t * p.x_stride[2] + j);
            if (w != nullptr) {
                const float s = w[t];
                v.x *= s; v.y *= s; v.z *= s; v.w *= s;
            }
        }
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
        load_x<P>(sX, p, b, c, h, nullptr);
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

template <int P>
__global__ void __launch_bounds__(NT) ssd_state_kernel(const SsdParams p) {
    constexpr int PC = P / 16;
    extern __shared__ float4 smem4[];
    float* sBT = reinterpret_cast<float*>(smem4);  // (N, MS)
    float* sX = sBT + p.N * MS;                // (QM, P): x * decay-to-end * dt
    float* sW = sX + QM * P;                   // (QM,)

    const int b = blockIdx.z, c = blockIdx.y;
    const int h0 = blockIdx.x * p.heads_per_block;
    const int h1 = min(p.H, h0 + p.heads_per_block);
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    const int nr = p.N / 16;                   // state rows per thread
    const int Qp = (p.Q + 3) & ~3;

    const float* bb = p.Bm + b * p.b_stride[0] + c * p.b_stride[1];
    for (int idx = tid; idx < QM * (p.N / 4); idx += NT) {
        const int t = idx / (p.N / 4), k = (idx % (p.N / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t < p.Q) v = *reinterpret_cast<const float4*>(bb + t * p.b_stride[2] + k);
        sBT[(k + 0) * MS + t] = v.x;
        sBT[(k + 1) * MS + t] = v.y;
        sBT[(k + 2) * MS + t] = v.z;
        sBT[(k + 3) * MS + t] = v.w;
    }
    for (int h = h0; h < h1; ++h) {
        __syncthreads();                       // B^T written / last head's reads done
        const float last = at4(p.cum, p.cum_stride, b, c, p.Q - 1, h);
        for (int t = tid; t < QM; t += NT)
            sW[t] = t < p.Q ? expf(last - at4(p.cum, p.cum_stride, b, c, t, h)) *
                                  at4(p.dt, p.dt_stride, b, c, t, h)
                            : 0.f;
        __syncthreads();
        load_x<P>(sX, p, b, c, h, sW);
        __syncthreads();
        float acc[8][PC];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < PC; ++j) acc[i][j] = 0.f;
        for (int t = 0; t < Qp; t += 4) {
            float4 a[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
                if (i < nr) a[i] = *reinterpret_cast<const float4*>(sBT + (ty + 16 * i) * MS + t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float bv[PC];
                load_cols<PC>(bv, sX + (t + e) * P + tx * PC);
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    if (i < nr) {
                        const float ai = lane4(a[i], e);
#pragma unroll
                        for (int j = 0; j < PC; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
                    }
                }
            }
        }
        float* ob = p.out + b * p.o_stride[0] + c * p.o_stride[1] + h * p.o_stride[2];
#pragma unroll
        for (int i = 0; i < 8; ++i)
            if (i < nr) store_cols<PC>(ob + (ty + 16 * i) * p.o_stride[3] + tx * PC, acc[i]);
    }
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
    auto smem = [&](int P) {
        return static_cast<int>(sizeof(float) * (p->N * MS + QM * P + QM));
    };
    switch (p->P) {
        case 32: return launch(ssd_state_kernel<32>, *p, smem(32), s);
        case 64: return launch(ssd_state_kernel<64>, *p, smem(64), s);
        case 128: return launch(ssd_state_kernel<128>, *p, smem(128), s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

extern "C" int ssd_chunk_struct_size() { return static_cast<int>(sizeof(SsdParams)); }
