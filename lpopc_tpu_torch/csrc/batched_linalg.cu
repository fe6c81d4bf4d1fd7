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
// which works through L1/L2. The choice from n and the element size, and the
// shared variants' byte counts, live in batched_linalg_layout.h, which the
// launchers below and the Python wrapper (through batched_linalg_layout.cpp)
// both use.
//
// K1, lane_cholesky. One thread block per matrix, right-looking, one column
// per step with a block-wide barrier per phase (2 per column). The shared
// variant holds the matrix in shared memory (n x (n|1)); the global variant
// runs the same loop in place on the output, with the scaled column in a
// scratch vector the wrapper allocates. At the sweep's shape (B = 512,
// n = 53, f64) the 2n barrier phases and the one block per matrix, not bytes,
// set its time (bound 5 us, ~92 us on an H100); the global variant pays
// n^3/3 read-modify-writes through L2 from one SM per matrix.
//
// K2, lane_cho_solve. One WARP per (L, b) system, up to 4 systems per block.
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
// 1.9 us. What sets its time (~8 us on an H100, 2 of them the launch) is the
// latency of one warp's 2n dependent steps after the first panel lands: one
// system alone takes nearly as long as the full batch. The global variant
// (n > 256, or a triangle past 227 KB) keeps w in the output x and the
// reciprocals in a scratch vector, and reads L through L2, columns strided,
// a few rows' loads in flight at once: correct at every n, not fast.
//
// NaN contract (the interior-point solver's inertia logic depends on it): a
// negative or NaN pivot gives NaN through sqrt in that column and, through
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

// ---------------------------------------------------------------- K1 ------
// Right-looking Cholesky, one column per step, on A (n x ld) with a column
// buffer col (n):
//   phase 1: col[i] = A[i][j] / sqrt(A[j][j]) for i >= j      (reads A only)
//   barrier
//   phase 2: A[i][j] = col[i];  A[r][c] -= col[r] * col[c] for r >= c > j
//   barrier
// Only the lower triangle of the trailing block is updated: later columns
// read nothing above the diagonal. So only the lower triangle of K is loaded
// (K is symmetric; n(n+1)/2 of its n*n entries are read), and the upper
// triangle is zero in the output. A and col are plain pointers: in the
// global variant they are written and read back by other threads of the
// block, so they must not take the read-only cache path.
template <typename T>
__device__ inline void cholesky_columns(T* A, T* col, int n, int ld) {
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = nt >> 5;
    for (int j = 0; j < n; ++j) {
        const T s = sqrt(A[(size_t)j * ld + j]);   // NaN for a negative pivot
        for (int i = j + tid; i < n; i += nt) col[i] = A[(size_t)i * ld + j] / s;
        __syncthreads();
        for (int i = j + tid; i < n; i += nt) A[(size_t)i * ld + j] = col[i];
        for (int r = j + 1 + warp; r < n; r += nwarps) {
            const T cr = col[r];
            for (int c = j + 1 + lane; c <= r; c += 32) A[(size_t)r * ld + c] -= cr * col[c];
        }
        __syncthreads();
    }
}

// Shared variant: the matrix in shared memory, (n * ld + n) elements.
template <typename T>
__global__ void lane_cholesky_kernel(const T* __restrict__ K, T* __restrict__ L,
                                     int n, long long strideK) {
    T* A = shared_base<T>();
    const int ld = lead_dim(n);
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const T* Kb = K + (long long)blockIdx.x * strideK;
    T* Lb = L + (long long)blockIdx.x * n * n;

    for (int idx = tid; idx < n * n; idx += nt) {
        const int r = idx / n, c = idx - r * n;
        if (c <= r) A[r * ld + c] = Kb[idx];
    }
    __syncthreads();
    cholesky_columns(A, A + (size_t)n * ld, n, ld);
    for (int idx = tid; idx < n * n; idx += nt) {
        const int r = idx / n, c = idx - r * n;
        Lb[idx] = (c <= r) ? A[r * ld + c] : T(0);
    }
}

// Global variant: the same loop in place on the output L (ld = n), the
// column buffer in the wrapper's scratch (B, n). No shared memory, any n.
template <typename T>
__global__ void lane_cholesky_global_kernel(const T* __restrict__ K, T* L, T* col,
                                            int n, long long strideK) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const T* Kb = K + (long long)blockIdx.x * strideK;
    T* A = L + (long long)blockIdx.x * n * n;

    for (int r = warp; r < n; r += nwarps)
        for (int c = lane; c < n; c += 32)
            A[(size_t)r * n + c] = (c <= r) ? Kb[(size_t)r * n + c] : T(0);
    __syncthreads();
    cholesky_columns(A, col + (long long)blockIdx.x * n, n, n);
}

// ---------------------------------------------------------------- K2 ------

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

// Global variant: one warp per system, one warp per block, L read through
// L1/L2 (lane i owns rows i mod 32). The running right-hand side w lives in
// the output x and the reciprocal diagonal in the wrapper's scratch (B, n):
// any n. __syncwarp orders each step's writes before the next step's reads.
constexpr int kChunk = 8;   // row blocks whose loads the global variant keeps in flight

template <typename T>
__global__ void lane_cho_solve_global_kernel(const T* __restrict__ L, const T* __restrict__ b,
                                             T* x, T* scratch, int n, long long strideL,
                                             long long strideB) {
    const int lane = threadIdx.x & 31;
    const T* Lg = L + (long long)blockIdx.x * strideL;
    const T* bg = b + (long long)blockIdx.x * strideB;
    T* w = x + (long long)blockIdx.x * n;
    T* rinv = scratch + (long long)blockIdx.x * n;

    for (int i = lane; i < n; i += 32) {
        w[i] = bg[i];
        rinv[i] = T(1) / Lg[(size_t)i * n + i];
    }
    __syncwarp();
    for (int j = 0; j < n; ++j) {
        const T yj = w[j] * rinv[j];
        // rows below j, from the first 32-row block that holds one; the
        // column's entries of kChunk blocks are loaded before any is used,
        // so their L2 round trips overlap
        for (int i0 = 32 * ((j + 1) >> 5) + lane; i0 < n; i0 += 32 * kChunk) {
            T l[kChunk];
#pragma unroll
            for (int u = 0; u < kChunk; ++u) {
                const int i = i0 + 32 * u;
                l[u] = (i > j && i < n) ? Lg[(size_t)i * n + j] : T(0);
            }
#pragma unroll
            for (int u = 0; u < kChunk; ++u) {
                const int i = i0 + 32 * u;
                if (i > j && i < n) w[i] -= l[u] * yj;
            }
        }
        __syncwarp();
        if (lane == (j & 31)) w[j] = yj;
    }
    __syncwarp();
    for (int j = n - 1; j >= 0; --j) {
        const T xj = w[j] * rinv[j];
        const T* rowj = Lg + (size_t)j * n;
        for (int i0 = lane; i0 < j; i0 += 32 * kChunk) {
            T l[kChunk];
#pragma unroll
            for (int u = 0; u < kChunk; ++u) {
                const int i = i0 + 32 * u;
                l[u] = i < j ? rowj[i] : T(0);
            }
#pragma unroll
            for (int u = 0; u < kChunk; ++u) {
                const int i = i0 + 32 * u;
                if (i < j) w[i] -= l[u] * xj;
            }
        }
        __syncwarp();
        if (lane == (j & 31)) w[j] = xj;
    }
}

// ----------------------------------------------------------- launches ------

inline int block_threads(int n, int cap) {
    int t = ((n + 31) / 32) * 32;
    if (t < 64) t = 64;
    if (t > cap) t = cap;
    return t;
}

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
    lane_cholesky_kernel<T><<<B, block_threads(n, 256), bytes, (cudaStream_t)stream>>>(
        (const T*)K, (T*)L, n, strideK);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_cholesky_global(const void* K, void* L, void* col, int B, int n,
                           long long strideK, void* stream) {
    if (B <= 0 || n <= 0) return (int)cudaGetLastError();
    lane_cholesky_global_kernel<T><<<B, block_threads(n, 256), 0, (cudaStream_t)stream>>>(
        (const T*)K, (T*)L, (T*)col, n, strideK);
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
    lane_cho_solve_global_kernel<T><<<B, 32, 0, (cudaStream_t)stream>>>(
        (const T*)L, (const T*)b, (T*)x, (T*)scratch, n, strideL, strideB);
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

int lpopc_lane_cholesky_global_f64(const void* K, void* L, void* col, int B, int n,
                                   long long strideK, void* stream) {
    return launch_cholesky_global<double>(K, L, col, B, n, strideK, stream);
}

int lpopc_lane_cholesky_global_f32(const void* K, void* L, void* col, int B, int n,
                                   long long strideK, void* stream) {
    return launch_cholesky_global<float>(K, L, col, B, n, strideK, stream);
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

}  // extern "C"
