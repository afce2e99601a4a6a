// Fused dense-layer "sandwich" for the encoder's dense blocks, backward.
//
//   forward:  y = conv3x3(r, w2),  r = relu(a),  a = z * scale + shift,
//             z = conv1x1(x, w1),  zero padding 1
//
// Given the layer input x [B, S, S, C_in] and the cotangent g = dL/dy
// [B, S, S, 48] (NHWC, compute dtype T: float or bf16), with P = B*S*S
// pixels and, per pixel p and channel k of z:
//   dr = conv2 transposed (g),  da = a > 0 ? dr : 0,
//   dscale = sum da * z,  dshift = sum da,  dz = da * scale (rounded to T),
//   dx = dz @ w1^T,  dw1 = sum_p dz^T x,  dw2[tap] = sum_q r[q + tap]^T g[q].
// z is summed in float32 from T operands; r and dz are rounded to T before
// their products; every sum is float32, as in the TPU kernels.
//
// Replaces the TPU kernels md_rdm_tpu/kernels/dense_sandwich.py::_bwd_kernel
// (per-layer NHWC I/O, pallas_call in _pallas_sandwich_bwd) and
// ::_bwd_kernel_flat (the same function on the flat-frame block layout,
// pallas_call in _pallas_sandwich_flat_bwd); the port's activations are
// channels-last already, so one set of kernels serves both.  It also
// computes the function of dense_sandwich_nhwc.py::_bwd_kernel.
//
// Bound on an H100: 2*P*C_mid*(3*C_in + 864) operations (z recompute, dx
// and dw1 over C_in each; dr and dw2 over the 9*48 taps each) against
// 20-150 MB of input and output per layer, so operations bound it: at
// B=16, S=57 (C_mid = 2736) 0.33-0.54 ms per layer on the bf16 tensor
// cores, 4.9-8.0 ms in float32 on the CUDA cores (38.5 / 2.6 ms over the six
// S=57 layers of a train step).
//
// The earlier design, one 8-warp block per (image, 8x8 tile) walking all
// C_mid chunks of 48, lost to autograd through cuDNN (170.65 / 48.03 ms f32
// / bf16 against 119.38 / 18.95 over the six layers, NVIDIA H100 80GB HBM3,
// 700 W) for three reasons.  Each of its 1024 blocks per layer reread x per
// chunk and every weight in full: ~108 GB (f32) / ~54 GB (bf16) of L2 reads
// per step.  Each block added its whole partial dw1 and dw2 into device
// memory with float32 atomics: 1024 * (1296 + 2592) * 2736 * 4 B = 43.6 GB
// of reductions per step.  And with one block per SM it met ~30-40
// barriers per chunk, most in front of a load it had to wait for.
//
// This design recomputes once per pixel tile, keeps dz and r in device
// memory, and computes the three products as GEMMs:
//   K1 bwd_recompute  [P, C_mid] tile = x @ w1t (z, K = C_in) and
//                     G @ w2m (dr, K = 432), where G [P, 432] is the im2col
//                     of g (column tap*48 + c: g at the pixel shifted by
//                     (1 - tap/3, 1 - tap%3), zero outside the image),
//                     gathered while loading; writes r and dz in T,
//                     reduces dscale / dshift in the block and adds them
//                     once per block and column;
//   K2 bwd_dx         dx [P, C_in] = dz @ w1m   (w1m = w1 as [C_mid, C_in]);
//   K3 bwd_dw1        dw1 [C_mid, C_in] = dz^T @ x, K = P split into slices;
//   K4 bwd_dw2        dw2m [C_mid, 432] = r^T @ G, K = P split the same way.
// K3 and K4 add each output element once per K slice with a float32
// atomic (a few slices, so that every SM has blocks): ~0.4 GB of atomics
// per step instead of 43.6 GB; their order changes from run to run
// (float32 rounding only).  Every kernel is one templated mainloop over
// 128 x 128 output tiles with one barrier per k tile: bf16 on the tensor
// cores (mma.sync m16n8k16, ldmatrix operands, k tiles of 48 in a
// three-stage cp.async ring, 8 warps of 64 x 32), float32 as FMA on the
// CUDA cores (8 x 8 outputs per thread, k tiles of 16, double-buffered;
// TF32 would break float32 parity).  K1 runs z and dr in two warp groups
// of one block, each with its own pipeline and named barrier, so that an
// SM holds 16 warps although each thread keeps only one accumulator; K2-K4
// run two 8-warp blocks per SM.  The tiles still read ~22 G elements from
// L2 per step (87 GB f32, 44 GB bf16; 64 multiply-adds per element
// loaded), about as much as before: the gain is in the atomics, the
// barriers and the latency each stage now hides.
//
// dz and r cross device memory: 2*P*C_mid elements written, dz read twice
// (K2, K3) and r once (K4), 1.42 GB per layer in bf16 and 2.85 GB in
// float32 at B=16, S=57; they are the backward's transient memory, 0.57 GB
// (bf16) / 1.14 GB (float32) per call.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int G = 48;             // growth: channels of y and g
constexpr int GK = 9 * G;         // im2col width of g
constexpr int BM = 128, BN = 128; // output tile
constexpr int NTHREAD = 256;

template <typename T> struct Cfg;
template <> struct Cfg<float> {
    // A and B in shared memory as [BK][BM + 4] and [BK][BN + 4] (A is
    // stored transposed when it is contiguous along k); double-buffered
    static constexpr int BK = 16, VE = 4, STAGES = 2;
    static constexpr int LDA = BM + 4, LDB = BN + 4;
    static constexpr int A_ELEMS = BK * LDA, B_ELEMS = BK * LDB;
};
template <> struct Cfg<bf16> {
    // A as [BM][BK + 8] when contiguous along k, else [BK][BM + 8]; B as
    // [BK][BN + 8] (rows of 7 and 17 16-byte units: ldmatrix of 8 rows is
    // conflict-free); a three-stage ring
    static constexpr int BK = 48, VE = 8, STAGES = 3;
    static constexpr int LDK = BK + 8, LDM = BM + 8, LDB = BN + 8;
    static constexpr int A_ELEMS = BM * LDK > BK * LDM ? BM * LDK : BK * LDM;
    static constexpr int B_ELEMS = BK * LDB;
};
template <typename T> __host__ __device__ constexpr int smem_bytes() {
    return Cfg<T>::STAGES * (Cfg<T>::A_ELEMS + Cfg<T>::B_ELEMS)
        * (int)sizeof(T);
}

__device__ __forceinline__ unsigned saddr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void ldsm4(unsigned a, unsigned (&r)[4]) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm4t(unsigned a, unsigned (&r)[4]) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
// d += a @ b on one m16n8k16 tile, bf16 in, f32 accumulate.  Lane l holds
// d[0], d[1] at (row l/4, cols 2(l%4), +1) and d[2], d[3] at row l/4 + 8.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(saddr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::);
}
// Barrier `id` among the NTHREAD threads of one warp group.
__device__ __forceinline__ void bar_sync(int id) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(NTHREAD) : "memory");
}

// ---- operands ------------------------------------------------------------
// Each operand gives the address of the 16-byte vector that starts at (row,
// col) of its matrix as stored (col the contiguous axis), and whether it
// lies inside; outside, the loaders fill zeros.  `slot` is the loading
// thread's vector index within the tile (used by GRows only).

// A row-major matrix [rows, ld], read up to (rows, cols).
template <typename T> struct Dense {
    const T* p;
    int ld, rows, cols;
    __device__ __forceinline__ const T* at(int, int r, int c, bool& ok) const {
        ok = r < rows && c < cols;
        return ok ? p + (size_t)r * ld + c : p;
    }
};

// The im2col matrix G [rows, 432] of g [B, S, S, 48]: column tap*48 + c of
// row q is g[c] at pixel q shifted by (1 - tap/3, 1 - tap%3), zero outside
// the image.  As K4's B operand: rows are pixels along k.
template <typename T> struct GCols {
    const T* g;
    int s, rows;
    __device__ __forceinline__ const T* at(int, int q, int j, bool& ok) const {
        const int tap = j / G, c = j - tap * G;
        const int b = q / (s * s), rem = q - b * s * s;
        const int y = rem / s + 1 - tap / 3, x = rem % s + 1 - tap % 3;
        ok = q < rows && j < GK && y >= 0 && y < s && x >= 0 && x < s;
        return ok ? g + (((size_t)b * s + y) * s + x) * G + c : g;
    }
};

// G as K1's A operand: each loading thread's rows (pixels) stay the same for
// every k tile, so they are decomposed once, into SLOTS slots.
template <typename T, int SLOTS> struct GRows {
    const T* g;
    int s;
    const T* base[SLOTS];
    int y[SLOTS], x[SLOTS];
    bool in[SLOTS];
    __device__ __forceinline__ void set(int i, int q, int rows) {
        const int b = q / (s * s), rem = q - b * s * s;
        base[i] = g + (size_t)b * s * s * G;
        y[i] = rem / s;
        x[i] = rem % s;
        in[i] = q < rows;
    }
    __device__ __forceinline__ const T* at(int i, int, int j, bool& ok) const {
        const int tap = j / G, c = j - tap * G;
        const int yy = y[i] + 1 - tap / 3, xx = x[i] + 1 - tap % 3;
        ok = in[i] && yy >= 0 && yy < s && xx >= 0 && xx < s;
        return ok ? base[i] + (yy * s + xx) * G + c : g;
    }
};

// ---- mainloops: acc += A[m0:+BM, k0:+nk*BK] @ B[k0:.., n0:+BN] -----------
// A is contiguous along k (AK) or along m; B is contiguous along n.  The
// accumulator is 64 floats per thread; acc_pos gives each one's place.  One
// warp group of NTHREAD threads (tid: the thread's index in it) runs the
// loop on its own shared memory, synchronised by barrier `bar`.

template <bool AK, class ASrc, class BSrc>
__device__ __forceinline__ void loop_f32(float (&acc)[64], const ASrc& A,
                                         const BSrc& B, int m0, int n0,
                                         int k0, int nk, float* smem,
                                         int tid, int bar) {
    using C = Cfg<float>;
    constexpr int BK = C::BK, LDA = C::LDA, LDB = C::LDB;
    float* As = smem;
    float* Bs = smem + C::STAGES * C::A_ELEMS;
    float4 ra[2];
    // tile t's loads: B (and A along m) by cp.async into buffer buf; A
    // along k into registers, stored transposed by stage_a
    auto issue = [&](int t, int buf) {
        const int k = k0 + t * BK;
        float* as = As + buf * C::A_ELEMS;
        float* bs = Bs + buf * C::B_ELEMS;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int v = tid + NTHREAD * i;
            bool ok;
            if constexpr (AK) {
                const int r = v / 4, c = (v % 4) * 4;
                const float* src = A.at(i, m0 + r, k + c, ok);
                ra[i] = ok ? __ldg(reinterpret_cast<const float4*>(src))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
            } else {
                const int r = v / 32, c = (v % 32) * 4;
                const float* src = A.at(i, k + r, m0 + c, ok);
                cp_async16(as + r * LDA + c, src, ok);
            }
            const int r = v / 32, c = (v % 32) * 4;
            const float* src = B.at(i, k + r, n0 + c, ok);
            cp_async16(bs + r * LDB + c, src, ok);
        }
        cp_async_commit();
    };
    auto stage_a = [&](int buf) {
        if constexpr (AK) {
            float* as = As + buf * C::A_ELEMS;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int v = tid + NTHREAD * i;
                const int r = v / 4, c = (v % 4) * 4;
                as[(c + 0) * LDA + r] = ra[i].x;
                as[(c + 1) * LDA + r] = ra[i].y;
                as[(c + 2) * LDA + r] = ra[i].z;
                as[(c + 3) * LDA + r] = ra[i].w;
            }
        }
    };
    const int ty = tid / 16, tx = tid % 16;
    issue(0, 0);
    stage_a(0);
    cp_async_wait_all();
    bar_sync(bar);
    for (int t = 0; t < nk; ++t) {
        const int buf = t & 1;
        if (t + 1 < nk) issue(t + 1, buf ^ 1);
        const float* as = As + buf * C::A_ELEMS;
        const float* bs = Bs + buf * C::B_ELEMS;
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            const float4 a0 = *reinterpret_cast<const float4*>(as + k * LDA + ty * 4);
            const float4 a1 = *reinterpret_cast<const float4*>(as + k * LDA + 64 + ty * 4);
            const float4 b0 = *reinterpret_cast<const float4*>(bs + k * LDB + tx * 4);
            const float4 b1 = *reinterpret_cast<const float4*>(bs + k * LDB + 64 + tx * 4);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    acc[i * 8 + j] = fmaf(av[i], bv[j], acc[i * 8 + j]);
        }
        if (t + 1 < nk) stage_a(buf ^ 1);
        cp_async_wait_all();
        bar_sync(bar);
    }
}

template <bool AK, class ASrc, class BSrc>
__device__ __forceinline__ void loop_bf16(float (&acc)[64], const ASrc& A,
                                          const BSrc& B, int m0, int n0,
                                          int k0, int nk, bf16* smem,
                                          int tid, int bar) {
    using C = Cfg<bf16>;
    constexpr int BK = C::BK, LDK = C::LDK, LDM = C::LDM, LDB = C::LDB;
    bf16* As = smem;
    bf16* Bs = smem + C::STAGES * C::A_ELEMS;
    auto issue = [&](int t, int st) {
        const int k = k0 + t * BK;
        bf16* as = As + st * C::A_ELEMS;
        bf16* bs = Bs + st * C::B_ELEMS;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            const int v = tid + NTHREAD * i;
            bool ok;
            if constexpr (AK) {
                const int r = v / 6, c = (v % 6) * 8;
                const bf16* src = A.at(i, m0 + r, k + c, ok);
                cp_async16(as + r * LDK + c, src, ok);
            } else {
                const int r = v / 16, c = (v % 16) * 8;
                const bf16* src = A.at(i, k + r, m0 + c, ok);
                cp_async16(as + r * LDM + c, src, ok);
            }
            const int r = v / 16, c = (v % 16) * 8;
            const bf16* src = B.at(i, k + r, n0 + c, ok);
            cp_async16(bs + r * LDB + c, src, ok);
        }
        cp_async_commit();
    };
    const int warp = tid / 32, lane = tid % 32;
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
    const int lr8 = lane & 7, h1 = (lane >> 3) & 1, h2 = lane >> 4;
    issue(0, 0);
    if (nk > 1) issue(1, 1); else cp_async_commit();
    for (int t = 0; t < nk; ++t) {
        cp_async_wait_one();
        bar_sync(bar);
        // the stage refilled here was read in step t - 1, before the barrier
        if (t + 2 < nk) issue(t + 2, (t + 2) % 3); else cp_async_commit();
        const int st = t % 3;
        const bf16* as = As + st * C::A_ELEMS;
        const bf16* bs = Bs + st * C::B_ELEMS;
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
            unsigned a[4][4], b[4][2];
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) {
                if constexpr (AK)
                    ldsm4(saddr(as + (wm + 16 * mi + lr8 + 8 * h1) * LDK
                                + 16 * ks + 8 * h2), a[mi]);
                else
                    ldsm4t(saddr(as + (16 * ks + lr8 + 8 * h2) * LDM + wm
                                 + 16 * mi + 8 * h1), a[mi]);
            }
#pragma unroll
            for (int np = 0; np < 2; ++np) {
                unsigned bw[4];
                ldsm4t(saddr(bs + (16 * ks + lr8 + 8 * h1) * LDB + wn
                             + 16 * np + 8 * h2), bw);
                b[2 * np][0] = bw[0];
                b[2 * np][1] = bw[1];
                b[2 * np + 1][0] = bw[2];
                b[2 * np + 1][1] = bw[3];
            }
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni)
                    mma_bf16(acc + (mi * 4 + ni) * 4, a[mi], b[ni][0],
                             b[ni][1]);
        }
    }
    cp_async_wait_all();
    bar_sync(bar);     // the caller may reuse the shared memory
}

template <typename T, bool AK, class ASrc, class BSrc>
__device__ __forceinline__ void mainloop(float (&acc)[64], const ASrc& A,
                                         const BSrc& B, int m0, int n0,
                                         int k0, int nk, void* smem,
                                         int tid, int bar) {
    if constexpr (std::is_same<T, float>::value)
        loop_f32<AK>(acc, A, B, m0, n0, k0, nk, static_cast<float*>(smem),
                     tid, bar);
    else
        loop_bf16<AK>(acc, A, B, m0, n0, k0, nk, static_cast<bf16*>(smem),
                      tid, bar);
}

// Tile row and column of accumulator element e.  Elements e and e + 1 (e
// even) are neighbouring columns of one row.
template <typename T>
__device__ __forceinline__ void acc_pos(int tid, int e, int& r, int& c) {
    if constexpr (std::is_same<T, float>::value) {
        const int i = e / 8, j = e % 8;
        r = (i & 3) + 4 * (tid / 16) + 64 * (i >> 2);
        c = (j & 3) + 4 * (tid % 16) + 64 * (j >> 2);
    } else {
        const int warp = tid / 32, lane = tid % 32;
        const int mi = e / 16, ni = (e / 4) % 4, h = e % 4;
        r = (warp >> 2) * 64 + 16 * mi + lane / 4 + 8 * (h >> 1);
        c = (warp & 3) * 32 + 8 * ni + 2 * (lane % 4) + (h & 1);
    }
}

template <typename T> struct Pair;
template <> struct Pair<float> {
    using type = float2;
    static __device__ __forceinline__ float2 make(float a, float b) {
        return make_float2(a, b);
    }
};
template <> struct Pair<bf16> {
    using type = __nv_bfloat162;
    static __device__ __forceinline__ __nv_bfloat162 make(float a, float b) {
        return __floats2bfloat162_rn(a, b);
    }
};
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a, float b) {
    *reinterpret_cast<typename Pair<T>::type*>(dst) = Pair<T>::make(a, b);
}

// ---- K1: r, dz, dscale, dshift ------------------------------------------
// Two warp groups per block: warps 0-7 sum z over C_in, warps 8-15 dr over
// the 432 columns of G, each with its own pipeline and barrier, so that
// the SM holds 16 warps although each thread keeps one accumulator.  Both
// tiles then meet in shared memory, and all 512 threads write r and dz
// row by row.
constexpr int LDE = BN + 4;   // float rows of the z and dr tiles
template <typename T> __host__ __device__ constexpr int k1_smem_bytes() {
    return 2 * smem_bytes<T>() > 2 * BM * LDE * 4 ? 2 * smem_bytes<T>()
                                                  : 2 * BM * LDE * 4;
}

template <typename T>
__global__ void __launch_bounds__(2 * NTHREAD, 1)
bwd_recompute(const T* __restrict__ x, const T* __restrict__ g,
              const T* __restrict__ w1t, const T* __restrict__ w2m,
              const float* __restrict__ scale,
              const float* __restrict__ shift, T* __restrict__ r,
              T* __restrict__ dz, float* __restrict__ dscale,
              float* __restrict__ dshift, int s, int p, int c_in,
              int c_mid) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    constexpr int BK = Cfg<T>::BK, VPR = BK / Cfg<T>::VE;
    constexpr int SLOTS = BM * VPR / NTHREAD;
    __shared__ float red[2 * BN];
    const int tid = threadIdx.x, group = tid / NTHREAD, lt = tid % NTHREAD;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    if (tid < 2 * BN) red[tid] = 0.f;

    float acc[64] = {};
    if (group == 0) {
        mainloop<T, true>(acc, Dense<T>{x, c_in, p, c_in},
                          Dense<T>{w1t, c_mid, c_in, c_mid}, m0, n0, 0,
                          c_in / BK, smem_raw, lt, 1);
    } else {
        GRows<T, SLOTS> gr;
        gr.g = g;
        gr.s = s;
#pragma unroll
        for (int i = 0; i < SLOTS; ++i)
            gr.set(i, m0 + (lt + NTHREAD * i) / VPR, p);
        mainloop<T, true>(acc, gr, Dense<T>{w2m, c_mid, GK, c_mid}, m0, n0,
                          0, GK / BK, smem_raw + smem_bytes<T>(), lt, 2);
    }
    __syncthreads();
    // the z (group 0) and dr (group 1) tiles, [BM][LDE] float32 each
    float* zt = reinterpret_cast<float*>(smem_raw);
    float* drt = zt + BM * LDE;
#pragma unroll
    for (int e = 0; e < 64; e += 2) {
        int row, col;
        acc_pos<T>(lt, e, row, col);
        *reinterpret_cast<float2*>((group ? drt : zt) + row * LDE + col) =
            make_float2(acc[e], acc[e + 1]);
    }
    __syncthreads();

    // each thread: columns c, c + 1 of rows tid / 64 + 8 i
    const int c = 2 * (tid % 64), k = n0 + c;
    if (k < c_mid) {   // c_mid is even: k + 1 < c_mid too
        const float sc0 = __ldg(scale + k), sc1 = __ldg(scale + k + 1);
        const float sh0 = __ldg(shift + k), sh1 = __ldg(shift + k + 1);
        float ds0 = 0.f, ds1 = 0.f, dh0 = 0.f, dh1 = 0.f;
#pragma unroll 4
        for (int i = 0; i < BM / 8; ++i) {
            const int row = tid / 64 + 8 * i, q = m0 + row;
            const float2 z =
                *reinterpret_cast<const float2*>(zt + row * LDE + c);
            const float2 d =
                *reinterpret_cast<const float2*>(drt + row * LDE + c);
            const float a0 = fmaf(z.x, sc0, sh0), a1 = fmaf(z.y, sc1, sh1);
            // rows past P have z = dr = 0 (zero-filled loads): da = 0 there
            const float da0 = a0 > 0.f ? d.x : 0.f;
            const float da1 = a1 > 0.f ? d.y : 0.f;
            ds0 = fmaf(da0, z.x, ds0);
            ds1 = fmaf(da1, z.y, ds1);
            dh0 += da0;
            dh1 += da1;
            if (q < p) {
                const size_t o = (size_t)q * c_mid + k;
                store_pair<T>(r + o, a0 > 0.f ? a0 : 0.f,
                              a1 > 0.f ? a1 : 0.f);
                store_pair<T>(dz + o, da0 * sc0, da1 * sc1);
            }
        }
        atomicAdd(red + c, ds0);
        atomicAdd(red + c + 1, ds1);
        atomicAdd(red + BN + c, dh0);
        atomicAdd(red + BN + c + 1, dh1);
    }
    __syncthreads();
    if (tid < BN && n0 + tid < c_mid) {
        atomicAdd(dscale + n0 + tid, red[tid]);
        atomicAdd(dshift + n0 + tid, red[BN + tid]);
    }
}

// ---- K2: dx = dz @ w1m ---------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NTHREAD, 2)
bwd_dx(const T* __restrict__ dz, const T* __restrict__ w1m,
       T* __restrict__ dx, int p, int c_in, int c_mid) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    float acc[64] = {};
    mainloop<T, true>(acc, Dense<T>{dz, c_mid, p, c_mid},
                      Dense<T>{w1m, c_in, c_mid, c_in}, m0, n0, 0,
                      c_mid / Cfg<T>::BK, smem_raw, threadIdx.x, 0);
#pragma unroll
    for (int e = 0; e < 64; e += 2) {
        int row, col;
        acc_pos<T>(threadIdx.x, e, row, col);
        const int q = m0 + row, c = n0 + col;
        if (q < p && c < c_in)
            store_pair<T>(dx + (size_t)q * c_in + c, acc[e], acc[e + 1]);
    }
}

// Adds the block's [BM, BN] partial product into out [rows, cols] (float32,
// row stride cols), one atomic per element.
template <typename T>
__device__ __forceinline__ void add_tile(const float (&acc)[64], float* out,
                                         int m0, int n0, int rows, int cols) {
#pragma unroll
    for (int e = 0; e < 64; ++e) {
        int row, col;
        acc_pos<T>(threadIdx.x, e, row, col);
        if (m0 + row < rows && n0 + col < cols)
            atomicAdd(out + (size_t)(m0 + row) * cols + n0 + col, acc[e]);
    }
}

// ---- K3: dw1 [C_mid, C_in] += dz^T @ x over one K slice of pixels -------
template <typename T>
__global__ void __launch_bounds__(NTHREAD, 2)
bwd_dw1(const T* __restrict__ x, const T* __restrict__ dz,
        float* __restrict__ dw1, int p, int c_in, int c_mid, int k_len) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    const int kb = blockIdx.z * k_len, ke = min(p, kb + k_len);
    constexpr int BK = Cfg<T>::BK;
    float acc[64] = {};
    mainloop<T, false>(acc, Dense<T>{dz, c_mid, ke, c_mid},
                       Dense<T>{x, c_in, ke, c_in}, m0, n0, kb,
                       (ke - kb + BK - 1) / BK, smem_raw, threadIdx.x, 0);
    add_tile<T>(acc, dw1, m0, n0, c_mid, c_in);
}

// ---- K4: dw2m [C_mid, 432] += r^T @ G over one K slice of pixels --------
template <typename T>
__global__ void __launch_bounds__(NTHREAD, 2)
bwd_dw2(const T* __restrict__ r, const T* __restrict__ g,
        float* __restrict__ dw2m, int s, int p, int c_mid, int k_len) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    const int kb = blockIdx.z * k_len, ke = min(p, kb + k_len);
    constexpr int BK = Cfg<T>::BK;
    float acc[64] = {};
    mainloop<T, false>(acc, Dense<T>{r, c_mid, ke, c_mid},
                       GCols<T>{g, s, ke}, m0, n0, kb,
                       (ke - kb + BK - 1) / BK, smem_raw, threadIdx.x, 0);
    add_tile<T>(acc, dw2m, m0, n0, c_mid, GK);
}

// ---- launches ------------------------------------------------------------
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool bad_shape(int batch, int s, int c_in, int c_mid) {
    const long long p = (long long)batch * s * s;
    return batch < 1 || s < 1 || c_in < G || c_in % G || c_mid < G ||
           c_mid % G || p * c_mid >= (1LL << 31) ||
           p * c_in >= (1LL << 31) || (p + BM - 1) / BM > 65535;
}

// K slices for a split-K product with `tiles` output tiles: enough blocks
// for four per SM, each slice a whole number of k tiles.
int slice_len(int p, int tiles, int bk) {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    int splits = (4 * sms + tiles - 1) / tiles;
    if (splits > 65535) splits = 65535;
    const int per = (p + splits - 1) / splits;
    return (per + bk - 1) / bk * bk;
}

template <typename T>
int launch_recompute(const void* x, const void* g, const void* w1t,
                     const void* w2m, const void* scale, const void* shift,
                     void* r, void* dz, void* dscale, void* dshift, int batch,
                     int s, int c_in, int c_mid, cudaStream_t st) {
    cudaError_t err = allow_smem(bwd_recompute<T>, k1_smem_bytes<T>());
    if (err != cudaSuccess) return (int)err;
    const int p = batch * s * s;
    const dim3 grid((c_mid + BN - 1) / BN, (p + BM - 1) / BM);
    bwd_recompute<T><<<grid, 2 * NTHREAD, k1_smem_bytes<T>(), st>>>(
        static_cast<const T*>(x), static_cast<const T*>(g),
        static_cast<const T*>(w1t), static_cast<const T*>(w2m),
        static_cast<const float*>(scale), static_cast<const float*>(shift),
        static_cast<T*>(r), static_cast<T*>(dz),
        static_cast<float*>(dscale), static_cast<float*>(dshift), s, p,
        c_in, c_mid);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_dx(const void* dz, const void* w1m, void* dx, int batch, int s,
              int c_in, int c_mid, cudaStream_t st) {
    cudaError_t err = allow_smem(bwd_dx<T>, smem_bytes<T>());
    if (err != cudaSuccess) return (int)err;
    const int p = batch * s * s;
    const dim3 grid((c_in + BN - 1) / BN, (p + BM - 1) / BM);
    bwd_dx<T><<<grid, NTHREAD, smem_bytes<T>(), st>>>(
        static_cast<const T*>(dz), static_cast<const T*>(w1m),
        static_cast<T*>(dx), p, c_in, c_mid);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_dw1(const void* x, const void* dz, void* dw1, int batch, int s,
               int c_in, int c_mid, cudaStream_t st) {
    cudaError_t err = allow_smem(bwd_dw1<T>, smem_bytes<T>());
    if (err != cudaSuccess) return (int)err;
    const int p = batch * s * s;
    const int gx = (c_in + BN - 1) / BN, gy = (c_mid + BM - 1) / BM;
    const int k_len = slice_len(p, gx * gy, Cfg<T>::BK);
    const dim3 grid(gx, gy, (p + k_len - 1) / k_len);
    bwd_dw1<T><<<grid, NTHREAD, smem_bytes<T>(), st>>>(
        static_cast<const T*>(x), static_cast<const T*>(dz),
        static_cast<float*>(dw1), p, c_in, c_mid, k_len);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_dw2(const void* r, const void* g, void* dw2m, int batch, int s,
               int c_mid, cudaStream_t st) {
    cudaError_t err = allow_smem(bwd_dw2<T>, smem_bytes<T>());
    if (err != cudaSuccess) return (int)err;
    const int p = batch * s * s;
    const int gx = (GK + BN - 1) / BN, gy = (c_mid + BM - 1) / BM;
    const int k_len = slice_len(p, gx * gy, Cfg<T>::BK);
    const dim3 grid(gx, gy, (p + k_len - 1) / k_len);
    bwd_dw2<T><<<grid, NTHREAD, smem_bytes<T>(), st>>>(
        static_cast<const T*>(r), static_cast<const T*>(g),
        static_cast<float*>(dw2m), s, p, c_mid, k_len);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns 0 on success, else a cudaError_t value (cudaErrorInvalidValue
// for shapes the kernels do not take: C_in and C_mid multiples of 48,
// P * C_mid below 2^31).  Pointers are 16-byte aligned and contiguous:
// x [P, C_in], g [P, 48], w1t [C_in, C_mid], w2m [432, C_mid] (row tap*48
// + c), w1m [C_mid, C_in], r and dz [P, C_mid], dx [P, C_in] in the compute
// dtype; scale, shift, dscale, dshift [C_mid], dw1 [C_mid, C_in] and dw2m
// [C_mid, 432] in float32.  dscale, dshift, dw1 and dw2m are added to: the
// caller zeroes them.

int sandwich_bwd_recompute(const void* x, const void* g, const void* w1t,
                           const void* w2m, const void* scale,
                           const void* shift, void* r, void* dz,
                           void* dscale, void* dshift, int batch, int s,
                           int c_in, int c_mid, int is_bf16, void* stream) {
    if (bad_shape(batch, s, c_in, c_mid)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16
        ? launch_recompute<bf16>(x, g, w1t, w2m, scale, shift, r, dz, dscale,
                                 dshift, batch, s, c_in, c_mid, st)
        : launch_recompute<float>(x, g, w1t, w2m, scale, shift, r, dz,
                                  dscale, dshift, batch, s, c_in, c_mid, st);
}

int sandwich_bwd_dx(const void* dz, const void* w1m, void* dx, int batch,
                    int s, int c_in, int c_mid, int is_bf16, void* stream) {
    if (bad_shape(batch, s, c_in, c_mid)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16 ? launch_dx<bf16>(dz, w1m, dx, batch, s, c_in, c_mid, st)
                   : launch_dx<float>(dz, w1m, dx, batch, s, c_in, c_mid, st);
}

int sandwich_bwd_dw1(const void* x, const void* dz, void* dw1, int batch,
                     int s, int c_in, int c_mid, int is_bf16, void* stream) {
    if (bad_shape(batch, s, c_in, c_mid)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16 ? launch_dw1<bf16>(x, dz, dw1, batch, s, c_in, c_mid, st)
                   : launch_dw1<float>(x, dz, dw1, batch, s, c_in, c_mid, st);
}

int sandwich_bwd_dw2(const void* r, const void* g, void* dw2m, int batch,
                     int s, int c_mid, int is_bf16, void* stream) {
    if (bad_shape(batch, s, G, c_mid)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16 ? launch_dw2<bf16>(r, g, dw2m, batch, s, c_mid, st)
                   : launch_dw2<float>(r, g, dw2m, batch, s, c_mid, st);
}

}  // extern "C"
