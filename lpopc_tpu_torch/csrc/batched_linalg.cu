// batched_linalg.cu — batched small-matrix Cholesky and Cholesky-solve for Hopper.
//
// These kernels replace the Pallas kernels `_chol_kernel` and `_solve_kernel`
// of the JAX package (lpopc_tpu/ops/batched_linalg.py). The TPU versions keep
// the batch on the 128-wide lane axis, pad it to 128 and extract columns with
// mask-and-reduce because Mosaic has neither dynamic indexing nor a narrower
// vector unit. None of that carries over. Input and output stay in PyTorch's
// (B, n, n) / (B, n) layout, with no padding of the batch.
//
// Each kernel has two variants: a shared-memory variant when the matrix
// fits one block's 227 KB, and a global-memory variant with no size limit,
// which works through L2. The choice from n and the element size, and the
// shared variants' byte counts, live in batched_linalg_layout.h, which the
// launchers below and the Python wrapper (through batched_linalg_layout.cpp)
// both use.
//
// K1, lane_cholesky, replaces `_chol_kernel` (lpopc_tpu/ops/batched_linalg.py
// :38-67, called at :128). Blocked right-looking Cholesky in panels of 32
// columns: per panel, a panel step in registers (factor the diagonal tile,
// solve the rows below against it) and an update of the trailing lower
// triangle (f64 tensor cores; 4 x 4 register tiles in f32); see the K1
// section. Shared variant (n <= 239 in f64, 339 in f32): one block per
// matrix, the packed lower triangle in shared memory, 2 ceil(n/32) + 1
// block barriers per factorization (5 at n = 53, 15 at n = 197, where one
// column per step took 2n = 106 and 394). Global variant: the same panels
// in place on the output, 2 ceil(n/32) launches over many blocks per matrix
// (44 at n = 700), one barrier per block. Bound: K's lower triangle in and
// the full factor out at 3.35 TB/s, 17.4 MB = 5.2 us at (512, 53, f64) and
// 47 MB = 14 us at (8, 700), where n^3/3 flops per matrix on the f64 tensor
// cores (67 TFLOP/s) take 13.7 us. On an H100 80GB HBM3 at 700 W it takes
// ~17.3 us at (512, 53), set by one block's chain (53 pivot steps of ~180
// cycles, the copy in, the store out: one matrix alone takes nearly as long
// as 512), and ~0.43 ms at (8, 700), set by the 44 launches' latencies and
// the 22 passes over the trailing triangle.
//
// K2, lane_cho_solve, replaces `_solve_kernel` (lpopc_tpu/ops/batched_linalg.py
// :70-107, called at :193). Shared variant (n <= 240 in f64, 256 in f32):
// one WARP per (L, b) system, up to 4 systems per block.
// A lane owns rows i = lane (mod 32): its slice of the right-hand side w and
// of the reciprocal diagonal 1/L[i][i] sit in registers. Step j of the
// forward sweep broadcasts the owner's running value t_j = w[j] with one
// __shfl_sync; every lane applies w[i] -= (L[i][j] / L[j][j]) * t_j to its
// rows, the column entry scaled off the chain, so one step hands the next a
// shuffle and an FMA: no __syncthreads(), no division, no multiply on the
// chain (y_j = t_j / L[j][j] is stored beside it). The backward sweep on L^T
// is the same with row j of L. The shared variant stages L's lower
// triangle, packed (row i at offset i(i+1)/2), with cp.async copies issued
// in column panels of 32, one commit group per panel, so the forward steps
// of panel p run while panel p+1 is still arriving. Triangular numbers
// mod 2^k run through every residue, so a column walk of the packed
// triangle touches 16 (f64) or 32 (f32) distinct banks per phase: no bank
// conflicts in either sweep. Bound at (512, 53, f64): 6.3 MB at 3.35 TB/s =
// 1.9 us. What sets its time (~8 us on an H100 80GB HBM3 at 700 W, 2 of them
// the launch) is the
// latency of one warp's 2n dependent steps after the first panel lands: one
// system alone takes nearly as long as the full batch.
// Global variant (every larger n): a blocked substitution that spreads ONE
// system over many one-warp blocks, one per tile of 32 rows and direction,
// ordered by release/acquire counters in a scratch buffer (see the K2 global
// section). Bound at (1, 4099, f64): L's lower triangle read once, 67 MB at
// 3.35 TB/s = 0.020 ms. On an H100 80GB HBM3 at 700 W it takes ~0.52 ms
// there (torch.cholesky_solve ~0.76, the one-warp design it replaced 103),
// set by the chain of 2 ceil(n/32) = 258 links of ~2 us, each a hand-over
// between blocks through L2 and a 32-step diagonal solve; the bytes stream
// beside it. At (512, 300) ~0.22 ms against a bound of 0.056 (bytes).
//
// NaN contract (the interior-point solver's inertia logic depends on it): a
// negative or NaN pivot gives NaN through rsqrt in that column and, through
// the trailing update, in every later column. There is no early exit and no
// clamping. The solve multiplies by 1/L[j][j]: a zero or NaN diagonal gives
// Inf or NaN, which propagate, as the division of the plain version does.
//
// C ABI (ctypes): every function enqueues on the given stream, does not
// synchronize, allocates nothing, and returns cudaGetLastError() as an int.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o liblpopc_batched_linalg.so batched_linalg.cu

#include <cuda_runtime.h>

#include "batched_linalg_layout.h"

namespace {

using namespace lpopc_layout;

constexpr unsigned kFullMask = 0xffffffffu;

template <typename T>
__device__ inline T* shared_base() {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    return reinterpret_cast<T*>(smem_raw);
}

__device__ inline void cp_async(void* smem, const double* gmem) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" :: "r"(dst), "l"(gmem) : "memory");
}

__device__ inline void cp_async(void* smem, const float* gmem) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(gmem) : "memory");
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most `pending` of this thread's commit groups are still in
// flight (the count must be an immediate; past 7 it waits for 7, which is
// stricter and so still correct).
__device__ inline void cp_async_wait(int pending) {
    switch (pending) {
        case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
        case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
        case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
        case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
        case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
        case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
        case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
        default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
    }
}

// ---------------------------------------------------------------- K1 ------
// Blocked right-looking Cholesky in panels of kPanel = 32 columns. Panel p
// (columns c0 .. c0+nb-1, nb = min(32, n - c0), rows below it s0 = c0+nb
// .. n-1) takes two steps:
//   panel step: factor the nb x nb diagonal tile (POTRF) and solve the rows
//               below against it, L21 = A21 L11^-T (TRSM), in registers;
//   trailing update: A22 -= L21 L21^T on the lower triangle (SYRK), register
//               blocked, each entry of A22 read and written once per panel.
// Only the lower triangle is read or updated: later columns read nothing
// above the diagonal, so only K's lower triangle is loaded and L's upper
// triangle is written as zeros.

constexpr int kPanel = 32;

__device__ inline double rsqrt_of(double v) { return rsqrt(v); }
__device__ inline float rsqrt_of(float v) { return rsqrtf(v); }

// Offset of row i in a packed lower triangle.
__device__ inline int tri(int i) { return i * (i + 1) / 2; }

// Entry t of a lower triangle taken row by row: row r, column c <= r.
__device__ inline void tri_entry(int t, int& r, int& c) {
    r = (int)((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
    while (tri(r + 1) <= t) ++r;
    while (tri(r) > t) --r;
    c = t - tri(r);
}

// K1 shared: warps per block at the largest shared n (239 in f64, 339 in
// f32, by cholesky_warps), so that __launch_bounds__ keeps the registers
// within what such a block may use.
template <typename T>
constexpr int kMaxCholeskyWarps = sizeof(T) == 8 ? 8 : 11;

// 16 bytes of a column buffer (2 f64 or 4 f32 entries) in one broadcast load.
__device__ inline void load16(const double* p, double* out) {
    const double2 v = *reinterpret_cast<const double2*>(p);
    out[0] = v.x;
    out[1] = v.y;
}
__device__ inline void load16(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
}

// The panel step of one warp, in registers. Lane i holds row i of the
// diagonal tile in a[] (a[j] = A[c0+i][c0+j] for j <= i < nb, 0 elsewhere;
// a ragged tile, nb < 32, is padded with rows of the identity) and one row r
// below the tile in x[] (x[j] = A[r][c0+j] for j < nb, 0 elsewhere and on a
// lane with no row). The warp factors the tile, a[] becoming row i of L11,
// and solves x[] against it, x[] becoming row r of L21. Step k broadcasts
// the pivot with a shuffle and column k of L11 through the warp's 32-entry
// buffer `col` (16-byte aligned), read back in 16-byte broadcasts: 8 shared
// loads a step on average where shuffles would take 62 instructions, which
// other warps' copies and stores would queue behind. No block barrier. The
// pivot of step k+1 is formed off the broadcast (dn = a[k+1] - L[i][k]^2 on
// lane k+1), so the chain from step to step is shuffle -> rsqrt ->
// multiply -> FMA. The step count S (8, 16, 24 or 32, the least one >= nb)
// is a constant: a test of nb between steps would keep the compiler from
// issuing a step's loads ahead of their use. The padding leaves columns < nb
// as they would be and is never stored. A negative or NaN pivot gives NaN
// through rsqrt, in its column and, through the updates, in every later one.
template <typename T, int S>
__device__ inline void panel_rows(T (&a)[kPanel], T (&x)[kPanel], T* col) {
    constexpr int V = 16 / sizeof(T);
    const int lane = threadIdx.x & 31;
    T dn = a[0];
#pragma unroll
    for (int k = 0; k < S; ++k) {
        const T r = rsqrt_of(__shfl_sync(kFullMask, dn, k));
        const T lik = a[k] * r;                 // lane k: the pivot times its rsqrt
        a[k] = lik;
        const T xk = x[k] * r;
        x[k] = xk;
        if (k + 1 < S) {
            dn = a[k + 1] - lik * lik;
            col[lane] = lik;
            __syncwarp();
            T t[kPanel];                        // t[j] = L11[j][k], j > k
#pragma unroll
            for (int m = (k + 1) / V; m < S / V; ++m) load16(col + V * m, t + V * m);
            __syncwarp();
#pragma unroll
            for (int j = k + 1; j < S; ++j) {
                a[j] -= lik * t[j];
                x[j] -= xk * t[j];
            }
        }
    }
}

template <typename T>
__device__ inline void panel_rows(T (&a)[kPanel], T (&x)[kPanel], T* col, int nb) {
    if (nb > 24)      panel_rows<T, 32>(a, x, col);
    else if (nb > 16) panel_rows<T, 24>(a, x, col);
    else if (nb > 8)  panel_rows<T, 16>(a, x, col);
    else              panel_rows<T, 8>(a, x, col);
}

// Trailing update of the shared variant on the packed triangle A: the lower
// triangle of rows/columns s0 .. n-1 less L21 L21^T, L21 being columns
// c0 .. c0+31 of those rows. f32 (f64 has the overload below, on the tensor
// cores): each thread takes 4 x 4 tiles (row block tr,
// column block tc <= tr), holds them in registers over the 32 columns of the
// panel and writes them once. Rows past n read row n-1 and are not written.
template <typename T>
__device__ inline void syrk_packed(T* A, int c0, int s0, int n) {
    const int m = n - s0;
    const int mt = (m + 3) >> 2;
    const int ntiles = mt * (mt + 1) / 2;
    for (int t = threadIdx.x; t < ntiles; t += blockDim.x) {
        int tr, tc;
        tri_entry(t, tr, tc);
        int ro[4], co[4];
        T acc[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            ro[u] = tri(min(s0 + 4 * tr + u, n - 1)) + c0;
            co[u] = tri(min(s0 + 4 * tc + u, n - 1)) + c0;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int r = s0 + 4 * tr + u;
#pragma unroll
            for (int v = 0; v < 4; ++v) {
                const int q = s0 + 4 * tc + v;
                acc[u][v] = (r < n && q <= r) ? A[tri(r) + q] : T(0);
            }
        }
#pragma unroll 8
        for (int k = 0; k < kPanel; ++k) {
            T av[4], bv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                av[u] = A[ro[u] + k];
                bv[u] = A[co[u] + k];
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int v = 0; v < 4; ++v) acc[u][v] -= av[u] * bv[v];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int r = s0 + 4 * tr + u;
#pragma unroll
            for (int v = 0; v < 4; ++v) {
                const int q = s0 + 4 * tc + v;
                if (r < n && q <= r) A[tri(r) + q] = acc[u][v];
            }
        }
    }
}

// One 16 x 8 x 4 product on the f64 tensor cores, D = A B + D (mma.sync,
// sm_90): lane l, with g = l/4 and t = l%4, holds A[g][t] and A[g+8][t],
// B[t][g], and D[g][2t+i], D[g+8][2t+i] (i = 0, 1) in d[i], d[2+i]. The
// H100's f64 tensor-core rate (67 TFLOP/s on the SXM data sheet) is twice
// its f64 FMA rate.
__device__ inline void mma_16x8x4(double (&d)[4], double a0, double a1, double b) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
        "{%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a0), "d"(a1), "d"(b));
}

// The f64 trailing update of the shared variant, on the tensor cores: the
// triangle in blocks of 16 rows (I) by 8 columns (J, those that hold an
// entry on or below the diagonal); a warp takes a block row I and 4 of its
// blocks (J0 .. J0+3, those past the last one skipped), keeps -L21's
// 16 x 32 fragment of the row in registers (16 values a lane) and runs 8
// products per block, the blocks' entries of A22 in the accumulators: 4
// independent chains. Rows past n read row n-1 and are not written; blocks
// that cross the diagonal are computed whole and written below it.
__device__ inline void syrk_packed(double* A, int c0, int s0, int n) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int m = n - s0;
    int unit = 0;
    for (int I = 0; 16 * I < m; ++I) {
        const int r[2] = {s0 + 16 * I + g, s0 + 16 * I + g + 8};
        const int jmax = min(16 * I + 15, m - 1) >> 3;    // last block with a lower entry
        for (int J0 = 0; J0 <= jmax; J0 += 4, ++unit) {
            if (unit % nwarps != warp) continue;
            double af[2][kPanel / 4];
            int rd[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                rd[h] = tri(min(r[h], n - 1));
#pragma unroll
                for (int kk = 0; kk < kPanel / 4; ++kk) af[h][kk] = -A[rd[h] + c0 + 4 * kk + t];
            }
            int rb[4];
            double d[4][4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                const int J = J0 + jj;
                rb[jj] = tri(min(s0 + 8 * J + g, n - 1)) + c0;
                const int q0 = s0 + 8 * J + 2 * t;
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int i = 0; i < 2; ++i)
                        d[jj][2 * h + i] = (J <= jmax && r[h] < n && q0 + i <= r[h])
                                               ? A[rd[h] + q0 + i] : 0.0;
            }
#pragma unroll
            for (int kk = 0; kk < kPanel / 4; ++kk)
#pragma unroll
                for (int jj = 0; jj < 4; ++jj)
                    if (J0 + jj <= jmax)
                        mma_16x8x4(d[jj], af[0][kk], af[1][kk], A[rb[jj] + 4 * kk + t]);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                const int q0 = s0 + 8 * (J0 + jj) + 2 * t;
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int i = 0; i < 2; ++i)
                        if (J0 + jj <= jmax && r[h] < n && q0 + i <= r[h])
                            A[rd[h] + q0 + i] = d[jj][2 * h + i];
            }
        }
    }
}

// Shared variant: one block per matrix of cholesky_warps(n) warps, the
// packed lower triangle and the warps' column buffers in shared memory
// (cholesky_smem_bytes). In the panel step of panel p, warps 0 .. busy-1
// take the rows below the tile; the others copy the rest of K in (p = 0) or
// write the finished column block p-1 of L (p > 0), so neither waits in
// line. Block barriers: 1 after panel 0's columns land, then 2 per panel
// (after the panel step, after the trailing update): 2 * ceil(n/32) + 1.
// Warps with rows in the panel step of a panel whose rows below start at s0
// (warp 0 always, to factor the tile and write L11).
__device__ inline int busy_warps(int n, int s0) { return max(1, (n - s0 + kPanel - 1) / kPanel); }

template <typename T>
__device__ inline void copy_columns(T* A, const T* Kb, int n, int p, int w, int nw) {
    const int c = kPanel * p + (threadIdx.x & 31);
    for (int i = kPanel * p + w; i < n; i += nw)
        if (c <= i) cp_async(A + tri(i) + c, Kb + (size_t)i * n + c);
}

// Column block p of L (all n rows, zeros above the diagonal), warps w of nw,
// one coalesced 32-column row segment per instruction, 4 rows in flight.
template <typename T>
__device__ inline void store_columns(const T* A, T* Lb, int n, int p, int w, int nw) {
    const int c = kPanel * p + (threadIdx.x & 31);
    if (c >= n) return;
    for (int i0 = w; i0 < n; i0 += 4 * nw) {
        T v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * nw;
            v[u] = (i < n && c <= i) ? A[tri(i) + c] : T(0);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * nw;
            if (i < n) Lb[(size_t)i * n + c] = v[u];
        }
    }
}

// Clocks of the shared f64 kernel's phases, compiled only with
// -DLPOPC_K1_PROBE (scripts/torch_k1_phases.py): thread 0 of block b writes
// clock64() at probe point i to g_k1_probe[64 b + i]; the last point
// follows a block barrier of its own.
#ifdef LPOPC_K1_PROBE
__device__ long long* g_k1_probe;
#define K1_PROBE(i) \
    if (threadIdx.x == 0 && sizeof(T) == 8) g_k1_probe[blockIdx.x * 64 + (i)] = clock64()
#define K1_PROBE_LAST(i) __syncthreads(); K1_PROBE(i)
#else
#define K1_PROBE(i)
#define K1_PROBE_LAST(i)
#endif

template <typename T>
__global__ void __launch_bounds__(32 * kMaxCholeskyWarps<T>)
lane_cholesky_kernel(const T* __restrict__ K, T* __restrict__ L, int n, long long strideK) {
    K1_PROBE(0);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    T* col = shared_base<T>() + kPanel * warp;   // this warp's column buffer
    T* A = shared_base<T>() + kPanel * nwarps;   // the packed triangle
    const T* Kb = K + (long long)blockIdx.x * strideK;
    T* Lb = L + (long long)blockIdx.x * n * n;
    const int panels = (n + kPanel - 1) / kPanel;

    // 1. Panel 0's columns of K's lower triangle into shared memory; lane c
    //    copies column c of a row, so a warp reads one 32-column row
    //    segment per copy instruction (coalesced).
    copy_columns(A, Kb, n, 0, warp, nwarps);
    cp_async_commit();
    K1_PROBE(60);
    cp_async_wait(0);
    __syncthreads();
    K1_PROBE(1);
    // The rest of K: a copy instruction takes ~130 cycles to issue, so the
    // idle warps of the first panel step copy it while the step runs when it
    // is small; past 64 row segments per idle warp every warp issues its
    // share now (n = 197: 510 segments, ~9k cycles over 7 warps, 51k over 1).
    // At (512, 53, f64) the idle warp's copy takes 0.01722 ms where every
    // warp copying first takes 0.01782 (H100 80GB HBM3 at 700 W, 10
    // readings each in one call of scripts/torch_kernel_ab.py, spread
    // under 0.00002 ms).
    int rest = 0;                                // row segments past panel 0
    for (int q = 1; q < panels; ++q) rest += n - kPanel * q;
    const bool rest_now = rest > 64 * (nwarps - busy_warps(n, min(kPanel, n)));
    if (rest_now) {
        for (int q = 1; q < panels; ++q) copy_columns(A, Kb, n, q, warp, nwarps);
        cp_async_commit();
    }

    for (int p = 0; p < panels; ++p) {
        const int c0 = kPanel * p;
        const int nb = min(kPanel, n - c0);
        const int s0 = c0 + nb;
        const int busy = busy_warps(n, s0);      // < nwarps

        // 2. Panel step. Warp w < busy takes rows s0 + 32 w + lane and
        //    factors the tile itself (so no warp waits for another); warp 0
        //    always runs, to write L11. The idle warps copy the rest of K in
        //    (p = 0) or write the finished column block p-1 of L.
        T a[kPanel];
        if (warp < busy) {
            const int base = tri(c0 + min(lane, nb - 1)) + c0;
#pragma unroll
            for (int j = 0; j < kPanel; ++j)
                a[j] = lane < nb ? (j <= lane ? A[base + j] : T(0)) : T(j == lane);
            const int r = s0 + kPanel * warp + lane;
            const int rbase = tri(min(r, n - 1)) + c0;
            T x[kPanel];
#pragma unroll
            for (int j = 0; j < kPanel; ++j) x[j] = (r < n && j < nb) ? A[rbase + j] : T(0);
            K1_PROBE(40 + p);
            panel_rows(a, x, col, nb);
            if (r < n) {
#pragma unroll
                for (int j = 0; j < kPanel; ++j)
                    if (j < nb) A[rbase + j] = x[j];
            }
            K1_PROBE(2 + 3 * p);
        } else if (p == 0) {
            if (!rest_now) {
                for (int q = 1; q < panels; ++q) copy_columns(A, Kb, n, q, warp - busy, nwarps - busy);
                cp_async_commit();
            }
        } else {
            store_columns(A, Lb, n, p - 1, warp - busy, nwarps - busy);
        }
        if (p == 0) cp_async_wait(0);            // the rest of K (this thread's copies)
        __syncthreads();                         // L21 and K complete; the tile read
        K1_PROBE(3 + 3 * p);

        // 3. Warp 0 writes L11 over the tile; everyone updates the trailing
        //    triangle (disjoint from the tile and from L21).
        if (warp == 0 && lane < nb) {
            const int base = tri(c0 + lane) + c0;
#pragma unroll
            for (int j = 0; j < kPanel; ++j)
                if (j <= lane) A[base + j] = a[j];
        }
        if (s0 < n) syrk_packed(A, c0, s0, n);
        __syncthreads();
        K1_PROBE(4 + 3 * p);
    }

    // 4. The last column block.
    store_columns(A, Lb, n, panels - 1, warp, nwarps);
    K1_PROBE_LAST(63);
}

// Global variant: the same panels in place on the output L, each phase its
// own launch over many blocks per matrix, so a few large matrices still fill
// the card: a copy of K's lower triangle into L, then per panel one launch
// of the panel step (kGlobalPanelWarps warps of 32 rows per block) and one
// of the trailing update (one kSyrkTile x kSyrkTile tile per block). Kernel
// boundaries order the phases; no block waits for another.
constexpr int kGlobalPanelWarps = 4;
constexpr int kSyrkTile = 64;
constexpr int kSyrkThreads = 256;            // 16 x 16 threads, 4 x 4 entries each

template <typename T>
__global__ void cholesky_copy_lower_kernel(const T* __restrict__ K, T* __restrict__ L,
                                           int n, long long strideK) {
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (i >= n) return;
    const T* Kr = K + (long long)blockIdx.x * strideK + (size_t)i * n;
    T* Lr = L + (long long)blockIdx.x * n * n + (size_t)i * n;
    for (int c = lane; c < n; c += 32) Lr[c] = c <= i ? Kr[c] : T(0);
}

// Where warp 0 of row block 0 writes panel c0's L11. Every block of the
// panel-step launch reads the unfactored tile, and blocks are not ordered,
// so L11 goes over the tile only when fewer than kPanel rows lie below it
// (then the launch has one row block per matrix). Otherwise it goes, as
// rows c0 .. c0+31, to columns s0 .. s0+31: L's upper triangle, zero in
// the output and read by no launch; the trailing update's first block
// moves it over the tile (move_l11) and zeroes those entries again.
__device__ inline bool l11_stashed(int n, int c0) { return n - c0 - kPanel >= kPanel; }

// Panel step of panel c0 on L: the tile is staged in shared memory, every
// warp factors it and solves its 32 rows (row block blockIdx.y * warps +
// warp); warp 0 of row block 0 writes L11 (l11_stashed says where).
template <typename T>
__global__ void cholesky_panel_kernel(T* L, int n, int c0) {
    __shared__ T tile[kPanel][kPanel + 1];
    __shared__ __align__(16) T colbuf[kGlobalPanelWarps][kPanel];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    T* A = L + (long long)blockIdx.x * n * n;
    const int nb = min(kPanel, n - c0);
    const int s0 = c0 + nb;
    for (int i = warp; i < nb; i += kGlobalPanelWarps)
        tile[i][lane] = lane <= i ? A[(size_t)(c0 + i) * n + c0 + lane] : T(0);
    __syncthreads();

    const bool owner = blockIdx.y == 0 && warp == 0;
    const int r = s0 + kPanel * (blockIdx.y * kGlobalPanelWarps + warp) + lane;
    if (r - lane >= n && !owner) return;         // whole warps
    T a[kPanel], x[kPanel];
#pragma unroll
    for (int j = 0; j < kPanel; ++j) {
        a[j] = lane < nb ? tile[lane][j] : T(j == lane);
        x[j] = (r < n && j < nb) ? A[(size_t)r * n + c0 + j] : T(0);
    }
    panel_rows(a, x, colbuf[warp], nb);
    if (r < n) {
#pragma unroll
        for (int j = 0; j < kPanel; ++j)
            if (j < nb) A[(size_t)r * n + c0 + j] = x[j];
    }
    if (owner && lane < nb) {
        T* row = A + (size_t)(c0 + lane) * n + (l11_stashed(n, c0) ? s0 : c0);
#pragma unroll
        for (int j = 0; j < kPanel; ++j)
            if (j <= lane) row[j] = a[j];
    }
}

// In the trailing update of panel c0, block 0 of each matrix moves a
// stashed L11 over the tile (rows c0 .. c0+31, which no update block
// reads): all of a thread's loads, then its stores, so the move costs the
// block one round trip to L2, under that of its own tile's loads.
template <typename T>
__device__ inline void move_l11(T* A, int n, int c0) {
    if (blockIdx.y != 0 || !l11_stashed(n, c0)) return;
    constexpr int per = kPanel * kPanel / kSyrkThreads;
    T v[per];
#pragma unroll
    for (int u = 0; u < per; ++u) {
        const int e = threadIdx.x + kSyrkThreads * u, i = e / kPanel, j = e % kPanel;
        v[u] = j <= i ? A[(size_t)(c0 + i) * n + c0 + kPanel + j] : T(0);
    }
#pragma unroll
    for (int u = 0; u < per; ++u) {
        const int e = threadIdx.x + kSyrkThreads * u, i = e / kPanel, j = e % kPanel;
        if (j <= i) {
            A[(size_t)(c0 + i) * n + c0 + j] = v[u];
            A[(size_t)(c0 + i) * n + c0 + kPanel + j] = T(0);
        }
    }
}

// Trailing update of panel c0 on L, one 64 x 64 tile (row block tr, column
// block tc <= tr, from blockIdx.y) per block, f32 (f64 below): the tile's
// 64 rows of L21 and its 64 columns' rows of L21 come into shared memory
// with cp.async while the block reads its entries of A22; thread (ty, tx)
// holds rows ty + 16u and columns tx + 16v (coalesced in L, conflict-free in
// shared memory).
template <typename T>
__global__ void cholesky_syrk_kernel(T* L, int n, int c0) {
    __shared__ T Lr[kSyrkTile][kPanel + 1];
    __shared__ T Lc[kSyrkTile][kPanel + 1];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int tr, tc;
    tri_entry(blockIdx.y, tr, tc);
    T* A = L + (long long)blockIdx.x * n * n;
    const int s0 = c0 + kPanel;
    const int rb = s0 + kSyrkTile * tr;
    const int cb = s0 + kSyrkTile * tc;
    for (int i = warp; i < kSyrkTile; i += kSyrkThreads / 32) {
        if (rb + i < n) cp_async(&Lr[i][lane], A + (size_t)(rb + i) * n + c0 + lane);
        if (cb + i < n) cp_async(&Lc[i][lane], A + (size_t)(cb + i) * n + c0 + lane);
    }
    cp_async_commit();

    const int ty = threadIdx.x >> 4;
    const int tx = threadIdx.x & 15;
    T acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const int r = rb + ty + 16 * u;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
            const int q = cb + tx + 16 * v;
            acc[u][v] = (r < n && q <= r) ? A[(size_t)r * n + q] : T(0);
        }
    }
    move_l11(A, n, c0);
    cp_async_wait(0);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kPanel; ++k) {
        T av[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            av[u] = Lr[ty + 16 * u][k];
            bv[u] = Lc[tx + 16 * u][k];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] -= av[u] * bv[v];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const int r = rb + ty + 16 * u;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
            const int q = cb + tx + 16 * v;
            if (r < n && q <= r) A[(size_t)r * n + q] = acc[u][v];
        }
    }
}

// f64: the same tile on the tensor cores. Warp w takes 16-row block w/2 of
// the tile and 4 of its 8-column blocks ((w%2)*4 ..; in a diagonal tile,
// those that hold an entry on or below the diagonal), -L21's fragment of its
// rows in registers for each k4 step, the blocks' entries of A22 in 16
// accumulators a lane. Row stride 36 in shared memory: a fragment load then
// touches distinct banks.
template <>
__global__ void cholesky_syrk_kernel<double>(double* L, int n, int c0) {
    constexpr int ld = kPanel + 4;
    __shared__ double Lr[kSyrkTile][ld];
    __shared__ double Lc[kSyrkTile][ld];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int tr, tc;
    tri_entry(blockIdx.y, tr, tc);
    double* A = L + (long long)blockIdx.x * n * n;
    const int s0 = c0 + kPanel;
    const int rb = s0 + kSyrkTile * tr;
    const int cb = s0 + kSyrkTile * tc;
    for (int i = warp; i < kSyrkTile; i += kSyrkThreads / 32) {
        if (rb + i < n) cp_async(&Lr[i][lane], A + (size_t)(rb + i) * n + c0 + lane);
        if (cb + i < n) cp_async(&Lc[i][lane], A + (size_t)(cb + i) * n + c0 + lane);
    }
    cp_async_commit();

    const int g = lane >> 2, tq = lane & 3;
    const int I = warp >> 1;                     // 16-row block of the tile
    const int Jb = 4 * (warp & 1);               // its first 8-column block
    const int r[2] = {rb + 16 * I + g, rb + 16 * I + g + 8};
    const int jmax = tr == tc ? 2 * I + 1 : kSyrkTile / 8 - 1;
    double d[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
        const int q0 = cb + 8 * (Jb + jj) + 2 * tq;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 2; ++i)
                d[jj][2 * h + i] = (Jb + jj <= jmax && r[h] < n && q0 + i <= r[h])
                                       ? A[(size_t)r[h] * n + q0 + i] : 0.0;
    }
    move_l11(A, n, c0);
    cp_async_wait(0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kPanel / 4; ++kk) {
        const double a0 = -Lr[16 * I + g][4 * kk + tq];
        const double a1 = -Lr[16 * I + g + 8][4 * kk + tq];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
            if (Jb + jj <= jmax)
                mma_16x8x4(d[jj], a0, a1, Lc[8 * (Jb + jj) + g][4 * kk + tq]);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
        const int q0 = cb + 8 * (Jb + jj) + 2 * tq;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 2; ++i)
                if (Jb + jj <= jmax && r[h] < n && q0 + i <= r[h])
                    A[(size_t)r[h] * n + q0 + i] = d[jj][2 * h + i];
    }
}

// ---------------------------------------------------------------- K2 ------

// Shared variant: one warp per system, ROWS = ceil(n/32) <= kSolveMaxRows
// right-hand-side entries per lane. Shared: per warp, the packed lower triangle of L,
// n(n+1)/2 elements.
template <typename T, int ROWS>
__global__ void lane_cho_solve_kernel(const T* __restrict__ L, const T* __restrict__ b,
                                      T* __restrict__ x, int B, int n,
                                      long long strideL, long long strideB) {
    const int lane = threadIdx.x & 31;
    const int wib = threadIdx.x >> 5;
    const long long sys = (long long)blockIdx.x * (blockDim.x >> 5) + wib;
    if (sys >= B) return;                     // whole warps only; no block barrier below
    T* Ls = shared_base<T>() + (size_t)wib * ((size_t)n * (n + 1) / 2);
    const T* Lg = L + sys * strideL;
    const T* bg = b + sys * strideB;
    T* xg = x + sys * n;
    const int panels = (n + 31) / 32;

    // 1. L's lower triangle into shared memory, one commit group per panel
    //    of 32 columns; lane c copies column 32p + c of each row, so a warp
    //    reads one row segment (coalesced) per instruction.
    for (int p = 0; p < panels; ++p) {
        const int c = 32 * p + lane;
        size_t row = (size_t)(32 * p) * (32 * p + 1) / 2;   // offset of row 32p
        for (int i = 32 * p; i < n; ++i) {
            if (c <= i) cp_async(Ls + row + c, Lg + (size_t)i * n + c);
            row += i + 1;
        }
        cp_async_commit();
    }

    // 2. While it is in flight: the right-hand side and the reciprocal
    //    diagonal of this lane's rows, into registers. A row past n gets
    //    w = 0 and row offset 0, so it reads valid entries and its w, never
    //    used, needs no predicate in the sweeps.
    T w[ROWS], rinv[ROWS];
    int roff[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        const int i = 32 * k + lane;
        roff[k] = i < n ? i * (i + 1) / 2 : 0;
        w[k] = i < n ? bg[i] : T(0);
        rinv[k] = i < n ? T(1) / Lg[(size_t)i * n + i] : T(0);
    }

    // 3. Forward, L y = b, column by column; y_j stays in its owner's w.
    //    No lane-dependent branch: in row block jb a select keeps the rows
    //    at or above j (their read is clamped to their own diagonal, which
    //    has landed, and discarded); later blocks lie wholly below j.
#pragma unroll
    for (int jb = 0; jb < ROWS; ++jb) {
        if (32 * jb >= n) break;
        cp_async_wait(panels - 1 - jb);        // this lane's copies of panel jb landed
        __syncwarp();                          // ... and every other lane's
        const int jn = min(32, n - 32 * jb);
        // The chain from step to step is shuffle -> FMA -> shuffle: the owner
        // broadcasts its row's running value t (not yet scaled), the next
        // owner updates its own with L[i][j] * (1/L[j][j]) formed off the
        // chain, and the selects and y_j = t_j / L[j][j] stay beside it.
        T t = w[jb];
#pragma unroll 4
        for (int jj = 0; jj < jn; ++jj) {
            const int j = 32 * jb + jj;
            const T rj = __shfl_sync(kFullMask, rinv[jb], jj);
            const T tj = __shfl_sync(kFullMask, t, jj);
            const T yj = tj * rj;
            const T u = w[jb] - (Ls[roff[jb] + min(j, 32 * jb + lane)] * rj) * tj;
            t = u;
            w[jb] = lane > jj ? u : (lane == jj ? yj : w[jb]);
            // (a block wholly past n reads row offset 0 and is never used;
            // no exit test, so all of the step's loads issue before its FMAs)
#pragma unroll
            for (int k = jb + 1; k < ROWS; ++k) w[k] -= Ls[roff[k] + j] * yj;
        }
    }

    // 4. Backward, L^T x = y, with row j of L; x_j replaces y_j in w. Rows
    //    of earlier blocks lie wholly above j; in block jb a select keeps
    //    the rows at or below j (their read is clamped to entry j).
#pragma unroll
    for (int jb = ROWS - 1; jb >= 0; --jb) {
        if (32 * jb >= n) continue;
        const int jn = min(32, n - 32 * jb);
        T t = w[jb];
#pragma unroll 4
        for (int jj = jn - 1; jj >= 0; --jj) {
            const int j = 32 * jb + jj;
            const T rj = __shfl_sync(kFullMask, rinv[jb], jj);
            const T tj = __shfl_sync(kFullMask, t, jj);
            const T xj = tj * rj;
            const T* rowj = Ls + (size_t)j * (j + 1) / 2;
            const T u = w[jb] - (rowj[min(32 * jb + lane, j)] * rj) * tj;
            t = u;
            w[jb] = lane < jj ? u : (lane == jj ? xj : w[jb]);
#pragma unroll
            for (int k = 0; k < jb; ++k) w[k] -= rowj[32 * k + lane] * xj;
        }
    }

#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        const int i = 32 * k + lane;
        if (i < n) xg[i] = w[k];
    }
}

// Global variant: blocked substitution, ONE system spread over many blocks.
// The rows are cut into tiles of kSolveTile = 32, one row per lane, and
// each one-warp block takes one tile of one direction:
//   forward tile i:  y_i = L_ii^-1 (b_i - sum_{k<i} L_ik y_k),
//   backward tile i: x_i = L_ii^-T (y_i - sum_{k>i} L_ki^T x_k),
// y kept in x and replaced there by x. The sums are matrix-vector products
// with tiles that no tile of the chain waits for: lane c takes column c of
// each tile, so a copy instruction reads one 32-column row segment
// (coalesced), through a ring of kSolveRing tiles in shared memory that
// cp.async fills ahead of use while the block waits. Only the 32 x 32
// diagonal solves (the shared variant's shuffle-FMA chain) and one
// hand-over between blocks per tile lie on the dependent chain: 2 ceil(n/32)
// links per system, where the one-warp design had 2n steps.
//
// Order between blocks: the scratch holds a ticket counter and, per system,
// the count of forward tiles done and of backward tiles done. A block
// publishes its tile with st.release.gpu of the new count after its x
// stores; a block that needs tile k spins on ld.acquire.gpu until the count
// passes k, then reads x through L2 (ld.cg). Work goes by the ticket, not
// by blockIdx: forward items first, tile-major (tile 0 of every system,
// then tile 1, ...), then backward items from the last tile up. So every
// item a block waits on was taken by a block already running: no residency
// or occupancy assumption, no deadlock at any B. The launcher clears the
// scratch on the stream before the kernel. Every loop has a fixed trip
// count and every tile is published whatever its values, so a zero or NaN
// pivot gives non-finite x in its own system and never a hang.
//
// Each sum is taken in a fixed order, not in the order the tiles arrive: k
// increasing forward and decreasing backward, each lane over its own
// column, then a fixed butterfly across lanes. Repeated calls give bitwise
// identical x.
constexpr int kSolveTile = 32;
constexpr int kSolveRing = 4;   // tiles of L per block in shared memory (3 in flight)

// 8 or 4 bytes, zero-filled (nothing read) when !valid
__device__ inline void cp_async_zfill(void* smem, const double* gmem, bool valid) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(dst), "l"(gmem), "r"(valid ? 8 : 0) : "memory");
}

__device__ inline void cp_async_zfill(void* smem, const float* gmem, bool valid) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(gmem), "r"(valid ? 4 : 0) : "memory");
}

__device__ inline unsigned ld_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ inline void st_release(unsigned* p, unsigned v) {
    asm volatile("st.release.gpu.global.u32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}

// Spin until the count *p passes k (every lane reads the same word).
__device__ inline void wait_past(const unsigned* p, int k) {
    while (ld_acquire(p) <= (unsigned)k) {}
}

// The tile of L at rows row0 .. row0+31, columns col0 .. col0+31 into a
// ring slot, as one commit group; lane c copies column c, rows past n are
// zero-filled. A lane later reads only its own column, so no barrier
// orders the copies.
template <typename T>
__device__ inline void issue_tile(T (*slot)[kSolveTile], const T* Lg, int n, int row0, int col0) {
    const int lane = threadIdx.x & 31;
#pragma unroll 8
    for (int r = 0; r < kSolveTile; ++r) {
        const int row = row0 + r;
        cp_async_zfill(&slot[r][lane], Lg + (size_t)min(row, n - 1) * n + col0 + lane, row < n);
    }
    cp_async_commit();
}

// Ring step q of `count`: issue tile q + kSolveRing - 1 (an empty group
// past the last), then wait for tile q, which was group q.
template <typename T, typename Origin>
__device__ inline void ring_step(T (*ring)[kSolveTile][kSolveTile], const T* Lg, int n, int q,
                                 int count, Origin origin) {
    const int ahead = q + kSolveRing - 1;
    if (ahead < count) {
        int row0, col0;
        origin(ahead, row0, col0);
        issue_tile(ring[ahead % kSolveRing], Lg, n, row0, col0);
    } else {
        cp_async_commit();
    }
    cp_async_wait(kSolveRing - 1);
}

// The diagonal tile L_ii into D, zeros above the diagonal, rows past n
// padded with the identity; returns 1 / L_ii[lane][lane]. Off the diagonal
// each entry is scaled by the reciprocal of the pivot it multiplies in the
// chain (its column's forward, its row's backward), so that a chain step is
// one shuffle and one FMA. Row stride 33: a lane's walk along its own row
// (forward) and a warp's read of one row (backward) touch distinct banks.
template <typename T>
__device__ inline T load_diagonal(T (*D)[kSolveTile + 1], const T* Lg, int n, int i0,
                                  bool forward) {
    const int lane = threadIdx.x & 31;
    const int nb = min(kSolveTile, n - i0);
    T col[kSolveTile];
#pragma unroll
    for (int r = 0; r < kSolveTile; ++r)
        col[r] = (r < nb && lane <= r) ? Lg[(size_t)(i0 + r) * n + i0 + lane] : T(r == lane);
    T pivot = T(1);
#pragma unroll
    for (int r = 0; r < kSolveTile; ++r)
        if (r == lane) pivot = col[r];
    const T rinv = T(1) / pivot;
#pragma unroll
    for (int r = 0; r < kSolveTile; ++r)
        D[r][lane] = col[r] * (forward ? rinv : __shfl_sync(kFullMask, rinv, r));
    __syncwarp();
    return rinv;
}

// One level of lane_sums: lanes with bit S set keep the upper half of
// a[0 .. 2S-1] and take their partner's, the others the lower half.
template <int S, typename T>
__device__ inline void butterfly(T (&a)[kSolveTile], int lane) {
    const bool upper = lane & S;
#pragma unroll
    for (int q = 0; q < S; ++q) {
        const T send = upper ? a[q] : a[q + S];
        const T keep = upper ? a[q + S] : a[q];
        a[q] = keep + __shfl_xor_sync(kFullMask, send, S);
    }
}

// Lane l holds a[r], its part of row r's sum; returns on lane r the sum of
// every lane's part of row r. Five levels, 31 shuffles, in a fixed order.
template <typename T>
__device__ inline T lane_sums(T (&a)[kSolveTile]) {
    const int lane = threadIdx.x & 31;
    butterfly<16>(a, lane);
    butterfly<8>(a, lane);
    butterfly<4>(a, lane);
    butterfly<2>(a, lane);
    butterfly<1>(a, lane);
    return a[0];
}

// Publish tile i's 32 values of x (y forward) and the count `done_now`.
template <typename T>
__device__ inline void publish(T* xs, int n, int i0, T w, unsigned* count, unsigned done_now) {
    const int lane = threadIdx.x & 31;
    if (i0 + lane < n) __stcg(xs + i0 + lane, w);
    __syncwarp();
    if (lane == 0) st_release(count, done_now);
}

// Forward tile i: lane r ends with y[32i + r]. Lane c accumulates column c
// of each tile L_ik for all 32 rows; the butterfly gives lane r its row.
template <typename T>
__device__ void forward_tile(T (*ring)[kSolveTile][kSolveTile], T (*D)[kSolveTile + 1],
                             const T* Lg, const T* bg, T* xs, unsigned* fwd, int n, int i) {
    const int lane = threadIdx.x & 31;
    const int i0 = kSolveTile * i;
    auto origin = [i0](int k, int& row0, int& col0) { row0 = i0; col0 = kSolveTile * k; };
#pragma unroll
    for (int q = 0; q < kSolveRing - 1; ++q) {
        if (q < i) issue_tile(ring[q], Lg, n, i0, kSolveTile * q);
        else cp_async_commit();
    }
    const T rinv = load_diagonal(D, Lg, n, i0, true);
    const T bi = i0 + lane < n ? bg[i0 + lane] : T(0);
    T acc[kSolveTile];
#pragma unroll
    for (int r = 0; r < kSolveTile; ++r) acc[r] = T(0);
    for (int k = 0; k < i; ++k) {
        ring_step(ring, Lg, n, k, i, origin);
        wait_past(fwd, k);
        const T yk = __ldcg(xs + kSolveTile * k + lane);
        T (*tile)[kSolveTile] = ring[k % kSolveRing];
#pragma unroll
        for (int r = 0; r < kSolveTile; ++r) acc[r] += tile[r][lane] * yk;
    }
    // Rows past n: b = 0 and a zero-filled L give 0, and their identity rows
    // keep it 0. The chain as in the shared variant: shuffle -> FMA.
    T w = bi - lane_sums(acc);
#pragma unroll 4
    for (int j = 0; j < kSolveTile; ++j) {
        const T tj = __shfl_sync(kFullMask, w, j);
        const T u = w - D[lane][j] * tj;
        w = lane > j ? u : (lane == j ? w * rinv : w);
    }
    publish(xs, n, i0, w, fwd, (unsigned)i + 1);
}

// Backward tile i: lane c ends with x[32i + c]. The tiles below it,
// k = tiles-1 down to i+1, arrive in that order; lane c sums column c of
// each, L_ki^T x_k, row by row.
template <typename T>
__device__ void backward_tile(T (*ring)[kSolveTile][kSolveTile], T (*D)[kSolveTile + 1],
                              const T* Lg, T* xs, const unsigned* fwd, unsigned* bwd, int n,
                              int tiles, int i) {
    const int lane = threadIdx.x & 31;
    const int i0 = kSolveTile * i;
    const int count = tiles - 1 - i;
    auto origin = [i0, tiles](int q, int& row0, int& col0) {
        row0 = kSolveTile * (tiles - 1 - q);
        col0 = i0;
    };
#pragma unroll
    for (int q = 0; q < kSolveRing - 1; ++q) {
        if (q < count) issue_tile(ring[q], Lg, n, kSolveTile * (tiles - 1 - q), i0);
        else cp_async_commit();
    }
    const T rinv = load_diagonal(D, Lg, n, i0, false);
    wait_past(fwd, tiles - 1);                 // every forward tile: y complete
    T acc = T(0);
    for (int q = 0; q < count; ++q) {
        ring_step(ring, Lg, n, q, count, origin);
        wait_past(bwd, q);                     // tile tiles-1-q done
        const int k0 = kSolveTile * (tiles - 1 - q);
        const T xk = k0 + lane < n ? __ldcg(xs + k0 + lane) : T(0);
        T (*tile)[kSolveTile] = ring[q % kSolveRing];
#pragma unroll
        for (int r = 0; r < kSolveTile; ++r) acc += tile[r][lane] * __shfl_sync(kFullMask, xk, r);
    }
    T w = i0 + lane < n ? __ldcg(xs + i0 + lane) - acc : T(0);
#pragma unroll 4
    for (int j = kSolveTile - 1; j >= 0; --j) {
        const T tj = __shfl_sync(kFullMask, w, j);
        const T u = w - D[j][lane] * tj;
        w = lane < j ? u : (lane == j ? w * rinv : w);
    }
    publish(xs, n, i0, w, bwd, (unsigned)count + 1);
}

// One work item per block, 2 B ceil(n/32) in all; `sync` is the wrapper's
// scratch (cho_solve_global_scratch_bytes), cleared: [0] the ticket, then
// per system s [1 + 2s] forward tiles done, [2 + 2s] backward tiles done.
template <typename T>
__global__ void __launch_bounds__(32)
lane_cho_solve_global_kernel(const T* __restrict__ L, const T* __restrict__ b, T* x,
                             unsigned* sync, int B, int n, long long strideL, long long strideB) {
    __shared__ __align__(16) T ring[kSolveRing][kSolveTile][kSolveTile];
    __shared__ T D[kSolveTile][kSolveTile + 1];
    const int tiles = (n + kSolveTile - 1) / kSolveTile;
    unsigned ticket = 0;
    if (threadIdx.x == 0) ticket = atomicAdd(sync, 1u);
    ticket = __shfl_sync(kFullMask, ticket, 0);
    const unsigned half = (unsigned)B * (unsigned)tiles;
    const bool forward = ticket < half;
    const unsigned item = forward ? ticket : ticket - half;
    const int s = (int)(item % (unsigned)B);
    const int step = (int)(item / (unsigned)B);
    unsigned* fwd = sync + 1 + 2 * (size_t)s;
    const T* Lg = L + s * strideL;
    T* xs = x + (long long)s * n;
    if (forward)
        forward_tile(ring, D, Lg, b + s * strideB, xs, fwd, n, step);
    else
        backward_tile(ring, D, Lg, xs, fwd, fwd + 1, n, tiles, tiles - 1 - step);
}

// ----------------------------------------------------------- launches ------

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return (int)cudaSuccess;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
}

template <typename T>
int launch_cholesky(const void* K, void* L, int B, int n, long long strideK, void* stream) {
    if (B <= 0 || n <= 0) return (int)cudaGetLastError();
    const size_t bytes = cholesky_smem_bytes(n, sizeof(T));
    if (int e = allow_smem(lane_cholesky_kernel<T>, bytes)) return e;
    lane_cholesky_kernel<T><<<B, 32 * cholesky_warps(n), bytes, (cudaStream_t)stream>>>(
        (const T*)K, (T*)L, n, strideK);
    return (int)cudaGetLastError();
}

// K1 global: 2 * ceil(n/32) launches (the copy, then per panel the panel
// step and, but for the last panel, the trailing update).
template <typename T>
int launch_cholesky_global(const void* K, void* L, int B, int n, long long strideK,
                           void* stream) {
    if (B <= 0 || n <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    T* Lp = (T*)L;
    const long long mt0 = (n - 1) / kSyrkTile + 1;     // tile rows of the first update, at most
    if (mt0 * (mt0 + 1) / 2 > 65535) return (int)cudaErrorInvalidValue;   // grid.y
    cholesky_copy_lower_kernel<T><<<dim3(B, (n + 7) / 8), 256, 0, s>>>(
        (const T*)K, Lp, n, strideK);
    if (int e = (int)cudaGetLastError()) return e;
    const int rows_per_block = 32 * kGlobalPanelWarps;
    for (int c0 = 0; c0 < n; c0 += kPanel) {
        const int m = n - c0 > kPanel ? n - c0 - kPanel : 0;   // rows below the panel
        const int row_blocks = m > 0 ? (m + rows_per_block - 1) / rows_per_block : 1;
        cholesky_panel_kernel<T><<<dim3(B, row_blocks), rows_per_block, 0, s>>>(Lp, n, c0);
        if (int e = (int)cudaGetLastError()) return e;
        if (m > 0) {
            const int mt = (m + kSyrkTile - 1) / kSyrkTile;
            cholesky_syrk_kernel<T><<<dim3(B, mt * (mt + 1) / 2), kSyrkThreads, 0, s>>>(
                Lp, n, c0);
            if (int e = (int)cudaGetLastError()) return e;
        }
    }
    return (int)cudaGetLastError();
}

template <typename T, int ROWS>
int launch_cho_solve_rows(const T* L, const T* b, T* x, int B, int n,
                          long long strideL, long long strideB, cudaStream_t stream) {
    const size_t per_system = cho_solve_system_bytes(n, sizeof(T));
    size_t warps = kMaxBlockSmem / per_system;   // systems per block
    if (warps > kSolveMaxWarps) warps = kSolveMaxWarps;
    if (warps < 1) warps = 1;                    // too large: the attribute call refuses it
    const size_t bytes = warps * per_system;
    if (int e = allow_smem(lane_cho_solve_kernel<T, ROWS>, bytes)) return e;
    const int blocks = (int)((B + warps - 1) / warps);
    lane_cho_solve_kernel<T, ROWS><<<blocks, 32 * (int)warps, bytes, stream>>>(
        L, b, x, B, n, strideL, strideB);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_cho_solve(const void* L, const void* b, void* x, int B, int n,
                     long long strideL, long long strideB, void* stream) {
    if (B <= 0 || n <= 0) return (int)cudaGetLastError();
    const T* Lp = (const T*)L;
    const T* bp = (const T*)b;
    T* xp = (T*)x;
    cudaStream_t s = (cudaStream_t)stream;
    static_assert(kSolveMaxRows == 8, "instantiate one case per row count");
    switch (solve_rows(n)) {
        case 1: return launch_cho_solve_rows<T, 1>(Lp, bp, xp, B, n, strideL, strideB, s);
        case 2: return launch_cho_solve_rows<T, 2>(Lp, bp, xp, B, n, strideL, strideB, s);
        case 3: return launch_cho_solve_rows<T, 3>(Lp, bp, xp, B, n, strideL, strideB, s);
        case 4: return launch_cho_solve_rows<T, 4>(Lp, bp, xp, B, n, strideL, strideB, s);
        case 5: return launch_cho_solve_rows<T, 5>(Lp, bp, xp, B, n, strideL, strideB, s);
        case 6: return launch_cho_solve_rows<T, 6>(Lp, bp, xp, B, n, strideL, strideB, s);
        case 7: return launch_cho_solve_rows<T, 7>(Lp, bp, xp, B, n, strideL, strideB, s);
        case 8: return launch_cho_solve_rows<T, 8>(Lp, bp, xp, B, n, strideL, strideB, s);
        default: return (int)cudaErrorInvalidValue;   // cho_solve_variant: the global one
    }
}

template <typename T>
int launch_cho_solve_global(const void* L, const void* b, void* x, void* scratch, int B, int n,
                            long long strideL, long long strideB, void* stream) {
    if (B <= 0 || n <= 0) return (int)cudaGetLastError();
    const long long blocks = 2LL * B * ((n + kSolveTile - 1) / kSolveTile);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;   // grid.x, the ticket
    cudaStream_t s = (cudaStream_t)stream;
    if (int e = (int)cudaMemsetAsync(scratch, 0, cho_solve_global_scratch_bytes(B), s)) return e;
    lane_cho_solve_global_kernel<T><<<(int)blocks, 32, 0, s>>>(
        (const T*)L, (const T*)b, (T*)x, (unsigned*)scratch, B, n, strideL, strideB);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lpopc_lane_cholesky_f64(const void* K, void* L, int B, int n, long long strideK,
                            void* stream) {
    return launch_cholesky<double>(K, L, B, n, strideK, stream);
}

int lpopc_lane_cholesky_f32(const void* K, void* L, int B, int n, long long strideK,
                            void* stream) {
    return launch_cholesky<float>(K, L, B, n, strideK, stream);
}

int lpopc_lane_cholesky_global_f64(const void* K, void* L, int B, int n, long long strideK,
                                   void* stream) {
    return launch_cholesky_global<double>(K, L, B, n, strideK, stream);
}

int lpopc_lane_cholesky_global_f32(const void* K, void* L, int B, int n, long long strideK,
                                   void* stream) {
    return launch_cholesky_global<float>(K, L, B, n, strideK, stream);
}

int lpopc_lane_cho_solve_f64(const void* L, const void* b, void* x, int B, int n,
                             long long strideL, long long strideB, void* stream) {
    return launch_cho_solve<double>(L, b, x, B, n, strideL, strideB, stream);
}

int lpopc_lane_cho_solve_f32(const void* L, const void* b, void* x, int B, int n,
                             long long strideL, long long strideB, void* stream) {
    return launch_cho_solve<float>(L, b, x, B, n, strideL, strideB, stream);
}

int lpopc_lane_cho_solve_global_f64(const void* L, const void* b, void* x, void* scratch,
                                    int B, int n, long long strideL, long long strideB,
                                    void* stream) {
    return launch_cho_solve_global<double>(L, b, x, scratch, B, n, strideL, strideB, stream);
}

int lpopc_lane_cho_solve_global_f32(const void* L, const void* b, void* x, void* scratch,
                                    int B, int n, long long strideL, long long strideB,
                                    void* stream) {
    return launch_cho_solve_global<float>(L, b, x, scratch, B, n, strideL, strideB, stream);
}

#ifdef LPOPC_K1_PROBE
int lpopc_k1_probe_buffer(void* prof, void* stream) {
    return (int)cudaMemcpyToSymbolAsync(g_k1_probe, &prof, sizeof(prof), 0,
                                        cudaMemcpyHostToDevice, (cudaStream_t)stream);
}
#endif

}  // extern "C"
