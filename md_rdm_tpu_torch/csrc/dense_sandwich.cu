// Dense-layer "sandwich" of the encoder's dense blocks, forward and
// backward, as seven GEMM-shaped kernels on one templated mainloop.
//
//   y = conv3x3(r, w2),  r = relu(a),  a = z * scale + shift,
//   z = conv1x1(x, w1),  zero padding 1 (on r, not on x)
//
// x [B, S, S, C_in] and y, g = dL/dy [B, S, S, 48] are NHWC in the compute
// dtype T (float or bf16); P = B*S*S pixels, C_mid = 48*S (2736 at S=57).
// z is summed in float32 from T operands, the affine and ReLU run in
// float32, r (and dz) are rounded to T once before their products, every
// other sum is float32 and y is rounded to T once, as in the TPU kernels.
//
// Forward: replaces md_rdm_tpu/kernels/dense_sandwich.py::_kernel
// (pallas_call in _pallas_sandwich) and ::_kernel_flat (the same function
// with block-native I/O); computes dense_sandwich_nhwc.py::_kernel too.
// The block's own layout here is one NHWC buffer [B, S, S, C_final] per
// dense block (models/densenet.py::_FlatBlock): F3 writes a layer's 48
// channels into their slot of it with row stride ldy = C_final, and K1 and
// K4 read the slot of the block's cotangent with row stride ldg, as
// _kernel_flat and _bwd_kernel_flat read and write the [B, C, ZT] stack.
// Three kernels:
//   F1 fwd_expand  r [P, C_mid] = relu((x @ w1t) * scale + shift), in T;
//   F2 fwd_taps    T9 [P, 432] = r @ w2n in float32, where column tap*48 + g
//                  of w2n [C_mid, 432] is w2[g, :, ky, kx], tap = 3*ky + kx:
//                  all nine taps as one product with a long K, as the TPU
//                  kernel runs them as one [9*48, kc] @ [kc, zl] pass;
//   F3 fwd_tapsum  y[b, i, j, g] = sum over the taps whose source pixel
//                  (i + ky - 1, j + kx - 1) lies in the image of
//                  T9[that pixel, tap*48 + g], in tap order, rounded to T.
// Bound on an H100: 2*P*C_mid*(C_in + 432) operations against 15-30 MB of
// input and output per layer, so operations bound the function: 16.5 ms
// (float32, CUDA cores) / 1.12 ms (bf16 tensor cores) over the six S=57
// layers at B=16.  The design adds the r and T9 round trip through device
// memory, 2*P*(C_mid*sizeof(T) + 432*4) bytes: 1.34 ms (bf16) / 2.36 ms
// (float32) over the six layers at 3.35 TB/s.  r and T9 are the forward's
// transient memory, 0.37 GB (bf16) / 0.66 GB (float32) per call at B=16,
// S=57.  Measured: 27.2 / 5.5 ms (float32 / bf16) over the six layers
// against the cuDNN sequence's 57.5 / 9.1 (NVIDIA H100 80GB HBM3, 700 W).
// The single-kernel design this replaces (one block per image and 8x16
// tile, z kept on chip one chunk of 48 channels at a time) recomputed z
// over a 1.5x halo, met four barriers per chunk around products of 48,
// and reread x once per chunk: 64.37 / 10.83 ms against the cuDNN
// sequence's 57.75 / 9.09 on the same card.
//
// Split of K in F1 and F2.  A block owns one 128 x 128 output tile and
// runs all of K, so where the tiles cannot fill the card (batch 1: at S=15
// F1 has 12 tiles and F2 8, against 264 blocks a wave) each tile's K runs
// as s slices on s blocks (grid z = s), the s blocks one thread-block
// cluster of 1 x 1 x s (cudaLaunchKernelEx).  Each block runs the same
// mainloop on its slice and stores its partial tile in its own shared
// memory; after a cluster barrier the block of rank j sums rows
// [128j/s, 128(j+1)/s) of every block's partial tile (distributed shared
// memory) in rank order and runs the kernel's own epilogue on them, and a
// second barrier keeps each block's shared memory until its peers have
// read it.  No workspace, no atomics, no extra launch: two calls and a
// graph replay give the same bits, and s = 1 is the unsplit kernel.  s (1
// to 8, the portable cluster size) comes from
// kernels/dense_sandwich.py::k_splits, a model of waves of clusters times
// the slice fitted on this card.  Measured, float32, F1 + F2 over every
// layer of the live encoder, device time of captured launches: batch 1
// 12.07 -> 4.48 ms against a bound of 1.69 (S=15 7.35 -> 1.36, S=29 2.30
// -> 0.93, S=57 2.42 -> 2.20); batch 16 47.70 -> 46.04 against 27.08 (S=15
// 11.17 -> 9.52, the others unchanged) (NVIDIA H100 80GB HBM3, 700 W).
//
// Backward: replaces ::_bwd_kernel (pallas_call in _pallas_sandwich_bwd)
// and ::_bwd_kernel_flat; computes dense_sandwich_nhwc.py::_bwd_kernel too.
// Per pixel p and channel k of z:
//   dr = conv2 transposed (g),  da = a > 0 ? dr : 0,
//   dscale = sum da * z,  dshift = sum da,  dz = da * scale (rounded to T),
//   dx = dz @ w1^T,  dw1 = sum_p dz^T x,  dw2[tap] = sum_q r[q + tap]^T g[q].
// Four kernels:
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
// Bound: 2*P*C_mid*(3*C_in + 864) operations against 20-150 MB per layer:
// 38.5 ms (float32) / 2.6 ms (bf16) over the six S=57 layers of a train
// step.  K3 and K4 add each output element once per K slice with a float32
// atomic (a few slices, so that every SM has blocks), ~0.4 GB of atomics
// per step; their order changes from run to run (float32 rounding only).
// dz and r are the backward's transient memory, 0.57 GB (bf16) / 1.14 GB
// (float32) per call.  The earlier one-kernel backward (one block per
// image and 8x8 tile) lost to autograd through cuDNN on 43.6 GB of
// float32 atomics and ~108 GB of L2 rereads per step.
//
// Every product is one mainloop over 128 x 128 output tiles with one
// barrier per k tile: bf16 on the tensor cores (mma.sync m16n8k16,
// ldmatrix operands, k tiles of 48 in a three-stage cp.async ring, 8 warps
// of 64 x 32), float32 as FMA on the CUDA cores (8 x 8 outputs per thread,
// k tiles of 16, double-buffered; TF32 would break float32 parity).
// Operands that lie outside their matrix load as zeros and the epilogues
// mask their stores, so ragged tiles need no padding (P = 406*128 + 16 at
// S=57; 2736 = 21*128 + 48; 432 = 3*128 + 48).  K1 runs z and dr in two
// warp groups of one block, each with its own pipeline and named barrier;
// the other kernels run two 8-warp blocks per SM.  F3 is a pass over
// memory, one thread per pixel and four channels.
#include <cooperative_groups.h>
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
// the image.  g's pixels lie ldg elements apart (48 when g is contiguous;
// the block's channel count when g is a 48-channel slot of the dense
// block's cotangent).  As K4's B operand: rows are pixels along k.
template <typename T> struct GCols {
    static constexpr int cols = GK;
    const T* g;
    int s, rows, ldg;
    __device__ __forceinline__ const T* at(int, int q, int j, bool& ok) const {
        const int tap = j / G, c = j - tap * G;
        const int b = q / (s * s), rem = q - b * s * s;
        const int y = rem / s + 1 - tap / 3, x = rem % s + 1 - tap % 3;
        ok = q < rows && j < GK && y >= 0 && y < s && x >= 0 && x < s;
        return ok ? g + (((size_t)b * s + y) * s + x) * ldg + c : g;
    }
};

// G as K1's A operand: each loading thread's rows (pixels) stay the same for
// every k tile, so they are decomposed once, into SLOTS slots.
template <typename T, int SLOTS> struct GRows {
    const T* g;
    int s, ldg;   // ldg: as GCols's
    const T* base[SLOTS];
    int y[SLOTS], x[SLOTS];
    bool in[SLOTS];
    __device__ __forceinline__ void set(int i, int q, int rows) {
        const int b = q / (s * s), rem = q - b * s * s;
        base[i] = g + (size_t)b * s * s * ldg;
        y[i] = rem / s;
        x[i] = rem % s;
        in[i] = q < rows;
    }
    __device__ __forceinline__ const T* at(int i, int, int j, bool& ok) const {
        const int tap = j / G, c = j - tap * G;
        const int yy = y[i] + 1 - tap / 3, xx = x[i] + 1 - tap % 3;
        ok = in[i] && yy >= 0 && yy < s && xx >= 0 && xx < s;
        return ok ? base[i] + (size_t)(yy * s + xx) * ldg + c : g;
    }
};

// ---- mainloops: acc += A[m0:+BM, k0:+nk*BK] @ B[k0:.., n0:+BN] -----------
// A is contiguous along k (AK) or along m; B is contiguous along n.  The
// accumulator is 64 floats per thread; acc_pos gives each one's place.  One
// warp group of NTHREAD threads (tid: the thread's index in it) runs the
// loop on its own shared memory, synchronised by barrier `bar`.  In
// float32, a tile with at most 64 columns left inside B (WIDE false: the
// last of N = 432 = 3*128 + 48, or of 2736 = 21*128 + 48) skips the right
// half's products, whose accumulators stay 0 and are never stored: 10%
// off F2 (NVIDIA H100 80GB HBM3, 700 W).  The same skip per warp fragment
// made the bf16 loop 2% slower and is not taken there.

template <bool AK, bool WIDE, class ASrc, class BSrc>
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
            const float4 b1 = WIDE
                ? *reinterpret_cast<const float4*>(bs + k * LDB + 64 + tx * 4)
                : make_float4(0.f, 0.f, 0.f, 0.f);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < (WIDE ? 8 : 4); ++j)
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
    if constexpr (std::is_same<T, float>::value) {
        if (B.cols - n0 > BN / 2)
            loop_f32<AK, true>(acc, A, B, m0, n0, k0, nk,
                               static_cast<float*>(smem), tid, bar);
        else
            loop_f32<AK, false>(acc, A, B, m0, n0, k0, nk,
                                static_cast<float*>(smem), tid, bar);
    } else
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
    static __device__ __forceinline__ float one(float a) { return a; }
};
template <> struct Pair<bf16> {
    using type = __nv_bfloat162;
    static __device__ __forceinline__ __nv_bfloat162 make(float a, float b) {
        return __floats2bfloat162_rn(a, b);
    }
    static __device__ __forceinline__ bf16 one(float a) {
        return __float2bfloat16_rn(a);
    }
};
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a, float b) {
    *reinterpret_cast<typename Pair<T>::type*>(dst) = Pair<T>::make(a, b);
}

// Writes the block's [BM, BN] tile (accumulator layout of T) into out
// [rows, cols] (row stride cols, cols even) in O.
template <typename T, typename O>
__device__ __forceinline__ void store_tile(const float (&acc)[64], O* out,
                                           int m0, int n0, int rows,
                                           int cols) {
#pragma unroll
    for (int e = 0; e < 64; e += 2) {
        int row, col;
        acc_pos<T>(threadIdx.x, e, row, col);
        const int q = m0 + row, c = n0 + col;
        if (q < rows && c < cols)   // c is even: c + 1 < cols too
            store_pair<O>(out + (size_t)q * cols + c, acc[e], acc[e + 1]);
    }
}

// ---- K split across a thread-block cluster (F1, F2) ----------------------
// Launched with gridDim.z = s > 1, the s blocks of one output tile form one
// cluster (dims 1 x 1 x s), and block z sums k tiles [kt*z/s, kt*(z+1)/s)
// of the kt; with s = 1 the block sums all of K, as without the split.
__device__ __forceinline__ void k_slice(int kt, int& k0, int& nk) {
    const int z = blockIdx.z, s = gridDim.z;
    k0 = kt * z / s;
    nk = kt * (z + 1) / s - k0;
}

// float32 rows of a partial tile in shared memory
constexpr int LDE = BN + 4;
constexpr int PARTIAL_BYTES = BM * LDE * 4;

// The cluster's partial tiles summed: each block stores its accumulator
// (T's layout) into its own shared memory as [BM][LDE] floats; after the
// cluster's barrier, the block of rank j owns rows [BM*j/s, BM*(j+1)/s) and
// reads them from every block's shared memory (distributed shared memory),
// summing in rank order 0..s-1, VE columns per thread at a time, which it
// hands to out(row, col, v).  The second barrier keeps each block's shared
// memory alive until every peer has read it.  The caller's mainloop ended
// on a barrier, so its shared memory is free; it holds PARTIAL_BYTES.
template <typename T, int VE, class Out>
__device__ __forceinline__ void cluster_sum(const float (&acc)[64],
                                            unsigned char* smem, Out out) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    float* part = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int e = 0; e < 64; e += 2) {
        int row, col;
        acc_pos<T>(threadIdx.x, e, row, col);
        *reinterpret_cast<float2*>(part + row * LDE + col) =
            make_float2(acc[e], acc[e + 1]);
    }
    cluster.sync();
    const int s = gridDim.z, j = (int)cluster.block_rank();
    const int r0 = BM * j / s, r1 = BM * (j + 1) / s;
    constexpr int VPR = BN / VE;
    for (int v = threadIdx.x; v < (r1 - r0) * VPR; v += NTHREAD) {
        const int row = r0 + v / VPR, col = (v % VPR) * VE;
        float sum[VE];
#pragma unroll
        for (int i = 0; i < VE; ++i) sum[i] = 0.f;
#pragma unroll 4
        for (int b = 0; b < s; ++b) {
            const float* src =
                cluster.map_shared_rank(part, b) + row * LDE + col;
#pragma unroll
            for (int i = 0; i < VE; i += 4) {
                const float4 f = *reinterpret_cast<const float4*>(src + i);
                sum[i] += f.x;
                sum[i + 1] += f.y;
                sum[i + 2] += f.z;
                sum[i + 3] += f.w;
            }
        }
        out(row, col, sum);
    }
    cluster.sync();
}

// ---- F1: r = relu((x @ w1t) * scale + shift) ------------------------------
// The tile of r meets in shared memory as [BM][LDR] T, so that it leaves
// row by row in 16-byte vectors: the accumulator layout alone would store
// 4-8 bytes per thread and row.
template <typename T> struct RTile {
    static constexpr int VE = 16 / sizeof(T), LD = BN + VE;
    static constexpr int BYTES = BM * LD * (int)sizeof(T);
};
template <typename T> __host__ __device__ constexpr int expand_smem_bytes() {
    return smem_bytes<T>() > RTile<T>::BYTES ? smem_bytes<T>()
                                             : RTile<T>::BYTES;
}

template <typename T>
__global__ void __launch_bounds__(NTHREAD, 2)
fwd_expand(const T* __restrict__ x, const T* __restrict__ w1t,
           const float* __restrict__ scale, const float* __restrict__ shift,
           T* __restrict__ r, int p, int c_in, int c_mid) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    using RT = RTile<T>;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    int k0, nk;
    k_slice(c_in / Cfg<T>::BK, k0, nk);
    float acc[64] = {};
    mainloop<T, true>(acc, Dense<T>{x, c_in, p, c_in},
                      Dense<T>{w1t, c_mid, c_in, c_mid}, m0, n0,
                      k0 * Cfg<T>::BK, nk, smem_raw, threadIdx.x, 0);
    // the mainloop ends on a barrier: its shared memory is free
    if (gridDim.z > 1) {
        cluster_sum<T, RT::VE>(acc, smem_raw, [&](int row, int col,
                                                  const float* v) {
            const int q = m0 + row, k = n0 + col;
            if (q >= p || k >= c_mid) return;   // whole vectors, as below
            alignas(16) T o[RT::VE];
#pragma unroll
            for (int i = 0; i < RT::VE; ++i) {
                const float a = fmaf(v[i], __ldg(scale + k + i),
                                     __ldg(shift + k + i));
                o[i] = Pair<T>::one(a > 0.f ? a : 0.f);
            }
            *reinterpret_cast<uint4*>(r + (size_t)q * c_mid + k) =
                *reinterpret_cast<const uint4*>(o);
        });
        return;
    }
    T* tile = reinterpret_cast<T*>(smem_raw);
#pragma unroll
    for (int e = 0; e < 64; e += 2) {
        int row, col;
        acc_pos<T>(threadIdx.x, e, row, col);
        const int k = n0 + col;
        float a0 = 0.f, a1 = 0.f;
        if (k < c_mid) {   // c_mid is even: k + 1 < c_mid too
            a0 = fmaf(acc[e], __ldg(scale + k), __ldg(shift + k));
            a1 = fmaf(acc[e + 1], __ldg(scale + k + 1), __ldg(shift + k + 1));
        }
        store_pair<T>(tile + row * RT::LD + col, a0 > 0.f ? a0 : 0.f,
                      a1 > 0.f ? a1 : 0.f);
    }
    __syncthreads();
    constexpr int VPR = BN / RT::VE;   // 16-byte vectors per tile row
#pragma unroll 4
    for (int v = threadIdx.x; v < BM * VPR; v += NTHREAD) {
        const int row = v / VPR, c = (v % VPR) * RT::VE;
        const int q = m0 + row, k = n0 + c;
        if (q < p && k < c_mid)   // c_mid is a multiple of 48: whole vectors
            *reinterpret_cast<uint4*>(r + (size_t)q * c_mid + k) =
                *reinterpret_cast<const uint4*>(tile + row * RT::LD + c);
    }
}

// ---- F2: T9 [P, 432] = r @ w2n, float32 -----------------------------------
template <typename T>
__global__ void __launch_bounds__(NTHREAD, 2)
fwd_taps(const T* __restrict__ r, const T* __restrict__ w2n,
         float* __restrict__ taps, int p, int c_mid) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    int k0, nk;
    k_slice(c_mid / Cfg<T>::BK, k0, nk);
    float acc[64] = {};
    mainloop<T, true>(acc, Dense<T>{r, c_mid, p, c_mid},
                      Dense<T>{w2n, GK, c_mid, GK}, m0, n0,
                      k0 * Cfg<T>::BK, nk, smem_raw, threadIdx.x, 0);
    if (gridDim.z > 1) {
        cluster_sum<T, 4>(acc, smem_raw, [&](int row, int col,
                                             const float* v) {
            const int q = m0 + row, c = n0 + col;
            if (q < p && c < GK)   // 432 is a multiple of 4: whole vectors
                *reinterpret_cast<float4*>(taps + (size_t)q * GK + c) =
                    make_float4(v[0], v[1], v[2], v[3]);
        });
        return;
    }
    store_tile<T>(acc, taps, m0, n0, p, GK);
}

// ---- F3: y = sum of the nine taps' shifted windows of T9 -------------------
// y's pixels lie ldy elements apart: 48 for a [P, 48] output, the block's
// channel count when F3 writes the layer's 48 channels into the dense
// block's buffer (the port of _kernel_flat's block-native output).
constexpr int TAPSUM_THREADS = 256;
template <typename T>
__global__ void __launch_bounds__(TAPSUM_THREADS)
fwd_tapsum(const float* __restrict__ taps, T* __restrict__ y, int s, int p,
           int ldy) {
    // one thread per pixel q and four channels c..c+3
    const int i = blockIdx.x * TAPSUM_THREADS + threadIdx.x;
    if (i >= p * (G / 4)) return;
    const int q = i / (G / 4), c = (i - q * (G / 4)) * 4;
    const int b = q / (s * s), rem = q - b * s * s;
    const int yy = rem / s, xx = rem - (rem / s) * s;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
        const int sy = yy + tap / 3 - 1, sx = xx + tap % 3 - 1;
        if (sy >= 0 && sy < s && sx >= 0 && sx < s) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(
                taps + (((size_t)b * s + sy) * s + sx) * GK + tap * G + c));
            acc.x += v.x;
            acc.y += v.y;
            acc.z += v.z;
            acc.w += v.w;
        }
    }
    T* out = y + (size_t)q * ldy + c;
    store_pair<T>(out, acc.x, acc.y);
    store_pair<T>(out + 2, acc.z, acc.w);
}

// ---- K1: r, dz, dscale, dshift ------------------------------------------
// Two warp groups per block: warps 0-7 sum z over C_in, warps 8-15 dr over
// the 432 columns of G, each with its own pipeline and barrier, so that
// the SM holds 16 warps although each thread keeps one accumulator.  Both
// tiles then meet in shared memory, and all 512 threads write r and dz
// row by row.
// The z and dr tiles are [BM][LDE] float32 each.
template <typename T> __host__ __device__ constexpr int k1_smem_bytes() {
    return 2 * smem_bytes<T>() > 2 * PARTIAL_BYTES ? 2 * smem_bytes<T>()
                                                   : 2 * PARTIAL_BYTES;
}

template <typename T>
__global__ void __launch_bounds__(2 * NTHREAD, 1)
bwd_recompute(const T* __restrict__ x, const T* __restrict__ g,
              const T* __restrict__ w1t, const T* __restrict__ w2m,
              const float* __restrict__ scale,
              const float* __restrict__ shift, T* __restrict__ r,
              T* __restrict__ dz, float* __restrict__ dscale,
              float* __restrict__ dshift, int s, int p, int c_in,
              int c_mid, int ldg) {
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
        gr.ldg = ldg;
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
    store_tile<T>(acc, dx, m0, n0, p, c_in);
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
        float* __restrict__ dw2m, int s, int p, int c_mid, int ldg,
        int k_len) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    const int kb = blockIdx.z * k_len, ke = min(p, kb + k_len);
    constexpr int BK = Cfg<T>::BK;
    float acc[64] = {};
    mainloop<T, false>(acc, Dense<T>{r, c_mid, ke, c_mid},
                       GCols<T>{g, s, ke, ldg}, m0, n0, kb,
                       (ke - kb + BK - 1) / BK, smem_raw, threadIdx.x, 0);
    add_tile<T>(acc, dw2m, m0, n0, c_mid, GK);
}

// ---- launches ------------------------------------------------------------
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Shapes the products take: C_in and C_mid multiples of 48, P * C_mid and
// P * C_in below 2^31, at most 65535 row tiles.
bool bad_rows(long long p, int c_in, int c_mid) {
    return p < 1 || c_in < G || c_in % G || c_mid < G || c_mid % G ||
           p * c_mid >= (1LL << 31) || p * c_in >= (1LL << 31) ||
           (p + BM - 1) / BM > 65535;
}

bool bad_shape(int batch, int s, int c_in, int c_mid) {
    return batch < 1 || s < 1 ||
           bad_rows((long long)batch * s * s, c_in, c_mid);
}

// Row strides of y (F3) and g (K1, K4): a multiple of 48 elements, so that
// every row starts 16-byte aligned (192 B in float32, 96 B in bf16) when
// the first does, over at most 2^31 elements.
bool bad_ld(int batch, int s, int ld) {
    return ld < G || ld % G || (long long)batch * s * s * ld >= (1LL << 31);
}

// F1's and F2's blocks a tile: 1 to MAX_SPLITS (the portable cluster
// size), at most one a k tile.
constexpr int MAX_SPLITS = 8;
bool bad_splits(int splits, int k, int is_bf16) {
    return splits < 1 || splits > MAX_SPLITS ||
           splits > k / (is_bf16 ? Cfg<bf16>::BK : Cfg<float>::BK);
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

// Dynamic shared memory of F1 and F2, split (s > 1: the partial tile too)
// or not; both stay two blocks per SM.  Each kernel's limit is set to the
// split size (a limit alone: a launch asks for its own), so that a
// captured launch of either size finds it set.
template <typename T> constexpr int fwd_smem_bytes(bool taps, bool split) {
    const int own = taps ? smem_bytes<T>() : expand_smem_bytes<T>();
    return split && PARTIAL_BYTES > own ? PARTIAL_BYTES : own;
}

// A launch of a forward kernel over grid (gx, gy) of output tiles: with
// splits = 1 a plain launch, else gridDim.z = splits with each tile's
// blocks as one cluster of 1 x 1 x splits.
cudaLaunchConfig_t fwd_config(int gx, int gy, int splits, int bytes,
                              cudaStream_t st, cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(gx, gy, splits);
    cfg.blockDim = dim3(NTHREAD);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = st;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = 1;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = splits;
    cfg.attrs = attr;
    cfg.numAttrs = splits > 1 ? 1 : 0;
    return cfg;
}

template <typename T>
int launch_expand(const void* x, const void* w1t, const void* scale,
                  const void* shift, void* r, int p, int c_in, int c_mid,
                  int splits, cudaStream_t st) {
    cudaError_t err =
        allow_smem(fwd_expand<T>, fwd_smem_bytes<T>(false, true));
    if (err != cudaSuccess) return (int)err;
    const int bytes = fwd_smem_bytes<T>(false, splits > 1);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = fwd_config(
        (c_mid + BN - 1) / BN, (p + BM - 1) / BM, splits, bytes, st, &attr);
    err = cudaLaunchKernelEx(&cfg, fwd_expand<T>, static_cast<const T*>(x),
                             static_cast<const T*>(w1t),
                             static_cast<const float*>(scale),
                             static_cast<const float*>(shift),
                             static_cast<T*>(r), p, c_in, c_mid);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int launch_taps(const void* r, const void* w2n, void* taps, int p, int c_mid,
                int splits, cudaStream_t st) {
    cudaError_t err = allow_smem(fwd_taps<T>, fwd_smem_bytes<T>(true, true));
    if (err != cudaSuccess) return (int)err;
    const int bytes = fwd_smem_bytes<T>(true, splits > 1);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = fwd_config(
        (GK + BN - 1) / BN, (p + BM - 1) / BM, splits, bytes, st, &attr);
    err = cudaLaunchKernelEx(&cfg, fwd_taps<T>, static_cast<const T*>(r),
                             static_cast<const T*>(w2n),
                             static_cast<float*>(taps), p, c_mid);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Clusters of `splits` blocks of F1 (taps 0) or F2 (taps 1) that the card
// holds at once (cudaOccupancyMaxActiveClusters), or -cudaError_t.
template <typename T>
int max_clusters(int taps, int splits) {
    cudaError_t err = taps
        ? allow_smem(fwd_taps<T>, fwd_smem_bytes<T>(true, true))
        : allow_smem(fwd_expand<T>, fwd_smem_bytes<T>(false, true));
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = fwd_config(
        1, 1, splits, fwd_smem_bytes<T>(taps, splits > 1), nullptr, &attr);
    cfg.numAttrs = 1;   // clusters of one block where splits = 1
    int n = 0;
    if (err == cudaSuccess)
        err = taps ? cudaOccupancyMaxActiveClusters(&n, fwd_taps<T>, &cfg)
                   : cudaOccupancyMaxActiveClusters(&n, fwd_expand<T>, &cfg);
    return err != cudaSuccess ? -(int)err : n;
}

template <typename T>
int launch_tapsum(const void* taps, void* y, int batch, int s, int ldy,
                  cudaStream_t st) {
    const int p = batch * s * s;
    const int blocks = (p * (G / 4) + TAPSUM_THREADS - 1) / TAPSUM_THREADS;
    fwd_tapsum<T><<<blocks, TAPSUM_THREADS, 0, st>>>(
        static_cast<const float*>(taps), static_cast<T*>(y), s, p, ldy);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_recompute(const void* x, const void* g, const void* w1t,
                     const void* w2m, const void* scale, const void* shift,
                     void* r, void* dz, void* dscale, void* dshift, int batch,
                     int s, int c_in, int c_mid, int ldg, cudaStream_t st) {
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
        c_in, c_mid, ldg);
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
               int c_mid, int ldg, cudaStream_t st) {
    cudaError_t err = allow_smem(bwd_dw2<T>, smem_bytes<T>());
    if (err != cudaSuccess) return (int)err;
    const int p = batch * s * s;
    const int gx = (GK + BN - 1) / BN, gy = (c_mid + BM - 1) / BM;
    const int k_len = slice_len(p, gx * gy, Cfg<T>::BK);
    const dim3 grid(gx, gy, (p + k_len - 1) / k_len);
    bwd_dw2<T><<<grid, NTHREAD, smem_bytes<T>(), st>>>(
        static_cast<const T*>(r), static_cast<const T*>(g),
        static_cast<float*>(dw2m), s, p, c_mid, ldg, k_len);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns 0 on success, else a cudaError_t value (cudaErrorInvalidValue
// for shapes the kernels do not take: C_in and C_mid multiples of 48,
// P * C_mid below 2^31, row strides ldy and ldg multiples of 48).
// Pointers are 16-byte aligned and contiguous, except that the rows of g
// and y lie ldg and ldy elements apart (48: contiguous):
// x [P, C_in], g and y [P, 48], w1t [C_in, C_mid], w2n [C_mid, 432]
// (column tap*48 + g), w2m [432, C_mid] (row tap*48 + c), w1m [C_mid,
// C_in], r and dz [P, C_mid], dx [P, C_in] in the compute dtype; scale,
// shift, dscale, dshift [C_mid], taps [P, 432], dw1 [C_mid, C_in] and dw2m
// [C_mid, 432] in float32.  dscale, dshift, dw1 and dw2m are added to: the
// caller zeroes them.

int sandwich_fwd_expand(const void* x, const void* w1t, const void* scale,
                        const void* shift, void* r, int p, int c_in,
                        int c_mid, int splits, int is_bf16, void* stream) {
    if (bad_rows(p, c_in, c_mid) || bad_splits(splits, c_in, is_bf16))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16
        ? launch_expand<bf16>(x, w1t, scale, shift, r, p, c_in, c_mid,
                              splits, st)
        : launch_expand<float>(x, w1t, scale, shift, r, p, c_in, c_mid,
                               splits, st);
}

int sandwich_fwd_taps(const void* r, const void* w2n, void* taps, int p,
                      int c_mid, int splits, int is_bf16, void* stream) {
    if (bad_rows(p, G, c_mid) || (long long)p * GK >= (1LL << 31) ||
        bad_splits(splits, c_mid, is_bf16))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16 ? launch_taps<bf16>(r, w2n, taps, p, c_mid, splits, st)
                   : launch_taps<float>(r, w2n, taps, p, c_mid, splits, st);
}

int sandwich_fwd_clusters(int taps, int splits, int is_bf16) {
    if (splits < 1 || splits > MAX_SPLITS) return -(int)cudaErrorInvalidValue;
    return is_bf16 ? max_clusters<bf16>(taps, splits)
                   : max_clusters<float>(taps, splits);
}

int sandwich_fwd_tapsum(const void* taps, void* y, int batch, int s,
                        int ldy, int is_bf16, void* stream) {
    if (batch < 1 || s < 1 || (long long)batch * s * s * GK >= (1LL << 31) ||
        bad_ld(batch, s, ldy))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16 ? launch_tapsum<bf16>(taps, y, batch, s, ldy, st)
                   : launch_tapsum<float>(taps, y, batch, s, ldy, st);
}

int sandwich_bwd_recompute(const void* x, const void* g, const void* w1t,
                           const void* w2m, const void* scale,
                           const void* shift, void* r, void* dz,
                           void* dscale, void* dshift, int batch, int s,
                           int c_in, int c_mid, int ldg, int is_bf16,
                           void* stream) {
    if (bad_shape(batch, s, c_in, c_mid) || bad_ld(batch, s, ldg))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16
        ? launch_recompute<bf16>(x, g, w1t, w2m, scale, shift, r, dz, dscale,
                                 dshift, batch, s, c_in, c_mid, ldg, st)
        : launch_recompute<float>(x, g, w1t, w2m, scale, shift, r, dz,
                                  dscale, dshift, batch, s, c_in, c_mid, ldg,
                                  st);
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
                     int s, int c_mid, int ldg, int is_bf16, void* stream) {
    if (bad_shape(batch, s, G, c_mid) || bad_ld(batch, s, ldg))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16 ? launch_dw2<bf16>(r, g, dw2m, batch, s, c_mid, ldg, st)
                   : launch_dw2<float>(r, g, dw2m, batch, s, c_mid, ldg, st);
}

}  // extern "C"
