// batched_linalg.cu — batched small-matrix Cholesky and Cholesky-solve for Hopper.
//
// These two kernels replace the Pallas kernels `_chol_kernel` and
// `_solve_kernel` of the JAX package (lpopc_tpu/ops/batched_linalg.py). The
// TPU versions keep the batch on the 128-wide lane axis, pad it to 128 and
// extract columns with mask-and-reduce because Mosaic has neither dynamic
// indexing nor a narrower vector unit. None of that carries over. Here:
//
//   * one thread block owns one matrix (or one (L, b) pair), held in shared
//     memory in its native row-major (n, n) layout; no padding of the batch;
//   * the column loop of the recurrence runs inside the block with a
//     block-wide barrier per phase;
//   * input and output stay in PyTorch's (B, n, n) / (B, n) layout, read and
//     written once, coalesced.
//
// Bound on an H100 (3.35 TB/s): both kernels move a few megabytes and do a
// few MFLOP at the sweep's shape (B = 512, n = 53, f64) — the memory bound is
// single-digit microseconds, so launch latency and the n sequential barrier
// phases dominate, not bandwidth. The design therefore keeps the barrier
// count per column minimal (2 for the factorization, 1 per substitution
// step) and the per-block footprint small enough (n*n*sizeof(T) + O(n)) that
// the whole batch is resident in one wave.
//
// NaN contract (the interior-point solver's inertia logic depends on it): a
// negative or NaN pivot gives NaN through sqrt in that column and, through
// the trailing update, in every later column. There is no early exit and no
// clamping. The solve divides by the diagonal exactly as the recurrence
// says, so NaN/Inf propagate.
//
// C ABI (ctypes): every function enqueues on the given stream, does not
// synchronize, allocates nothing, and returns cudaGetLastError() as an int.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o liblpopc_batched_linalg.so batched_linalg.cu

#include <cuda_runtime.h>

namespace {

// Odd leading dimension: a column walk (stride ld) then touches distinct
// shared-memory banks for 4- and 8-byte elements alike.
__host__ __device__ inline int lead_dim(int n) { return n | 1; }

template <typename T>
__device__ inline T* shared_base() {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    return reinterpret_cast<T*>(smem_raw);
}

// ---------------------------------------------------------------- K1 ------
// Right-looking Cholesky, one column per step. Shared: A (n x ld), col (n).
//   phase 1: col[i] = A[i][j] / sqrt(A[j][j]) for i >= j      (reads A only)
//   barrier
//   phase 2: A[i][j] = col[i];  A[r][c] -= col[r] * col[c] for r >= c > j
//   barrier
// Only the lower triangle of the trailing block is updated: later columns
// read nothing above the diagonal. So only the lower triangle of K is loaded
// (K is symmetric; n(n+1)/2 of its n*n entries are read), and the upper
// triangle is zeroed on store.
template <typename T>
__global__ void lane_cholesky_kernel(const T* __restrict__ K, T* __restrict__ L,
                                     int n, long long strideK) {
    T* A = shared_base<T>();
    const int ld = lead_dim(n);
    T* col = A + (size_t)n * ld;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const T* Kb = K + (long long)blockIdx.x * strideK;
    T* Lb = L + (long long)blockIdx.x * n * n;

    for (int idx = tid; idx < n * n; idx += nt) {
        const int r = idx / n, c = idx - r * n;
        if (c <= r) A[r * ld + c] = Kb[idx];
    }
    __syncthreads();

    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = nt >> 5;

    for (int j = 0; j < n; ++j) {
        const T s = sqrt(A[j * ld + j]);   // NaN for a negative pivot
        for (int i = j + tid; i < n; i += nt) col[i] = A[i * ld + j] / s;
        __syncthreads();
        for (int i = j + tid; i < n; i += nt) A[i * ld + j] = col[i];
        for (int r = j + 1 + warp; r < n; r += nwarps) {
            const T cr = col[r];
            for (int c = j + 1 + lane; c <= r; c += 32) A[r * ld + c] -= cr * col[c];
        }
        __syncthreads();
    }

    for (int idx = tid; idx < n * n; idx += nt) {
        const int r = idx / n, c = idx - r * n;
        Lb[idx] = (c <= r) ? A[r * ld + c] : T(0);
    }
}

// ---------------------------------------------------------------- K2 ------
// Solve L L^T x = b. Shared: Ls (n x ld, lower triangle), y (n), x (n).
// Forward, column-oriented:  y_j = y[j] / L[j][j];  y[i] -= L[i][j] * y_j, i > j
// Backward on L^T:           x_j = x[j] / L[j][j];  x[i] -= L[j][i] * x_j, i < j
// Entry j is final when step j reads it (only entries beyond j are updated
// in a step), so one barrier per step suffices; the finished values go to a
// separate vector so no thread overwrites what another still reads.
template <typename T>
__global__ void lane_cho_solve_kernel(const T* __restrict__ L, const T* __restrict__ b,
                                      T* __restrict__ x, int n,
                                      long long strideL, long long strideB) {
    T* Ls = shared_base<T>();
    const int ld = lead_dim(n);
    T* work = Ls + (size_t)n * ld;   // running right-hand side
    T* done = work + n;              // finished entries
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const T* Lb = L + (long long)blockIdx.x * strideL;
    const T* bb = b + (long long)blockIdx.x * strideB;
    T* xb = x + (long long)blockIdx.x * n;

    for (int idx = tid; idx < n * n; idx += nt) {
        const int r = idx / n, c = idx - r * n;
        if (c <= r) Ls[r * ld + c] = Lb[idx];
    }
    for (int i = tid; i < n; i += nt) work[i] = bb[i];
    __syncthreads();

    for (int j = 0; j < n; ++j) {
        const T yj = work[j] / Ls[j * ld + j];
        if (tid == 0) done[j] = yj;
        for (int i = j + 1 + tid; i < n; i += nt) work[i] -= Ls[i * ld + j] * yj;
        __syncthreads();
    }
    for (int i = tid; i < n; i += nt) work[i] = done[i];
    __syncthreads();
    for (int j = n - 1; j >= 0; --j) {
        const T xj = work[j] / Ls[j * ld + j];
        if (tid == 0) done[j] = xj;
        for (int i = tid; i < j; i += nt) work[i] -= Ls[j * ld + i] * xj;
        __syncthreads();
    }
    for (int i = tid; i < n; i += nt) xb[i] = done[i];
}

template <typename T>
size_t chol_smem_bytes(int n) { return ((size_t)n * lead_dim(n) + n) * sizeof(T); }

template <typename T>
size_t solve_smem_bytes(int n) { return ((size_t)n * lead_dim(n) + 2 * (size_t)n) * sizeof(T); }

inline int block_threads(int n, int cap) {
    int t = ((n + 31) / 32) * 32;
    if (t < 64) t = 64;
    if (t > cap) t = cap;
    return t;
}

template <typename T>
int launch_cholesky(const void* K, void* L, int B, int n, long long strideK, void* stream) {
    if (B <= 0 || n <= 0) return (int)cudaGetLastError();
    const size_t bytes = chol_smem_bytes<T>(n);
    if (bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(lane_cholesky_kernel<T>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)bytes);
        if (e != cudaSuccess) return (int)e;
    }
    lane_cholesky_kernel<T><<<B, block_threads(n, 256), bytes, (cudaStream_t)stream>>>(
        (const T*)K, (T*)L, n, strideK);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_cho_solve(const void* L, const void* b, void* x, int B, int n,
                     long long strideL, long long strideB, void* stream) {
    if (B <= 0 || n <= 0) return (int)cudaGetLastError();
    const size_t bytes = solve_smem_bytes<T>(n);
    if (bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(lane_cho_solve_kernel<T>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)bytes);
        if (e != cudaSuccess) return (int)e;
    }
    lane_cho_solve_kernel<T><<<B, block_threads(n, 128), bytes, (cudaStream_t)stream>>>(
        (const T*)L, (const T*)b, (T*)x, n, strideL, strideB);
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

int lpopc_lane_cho_solve_f64(const void* L, const void* b, void* x, int B, int n,
                             long long strideL, long long strideB, void* stream) {
    return launch_cho_solve<double>(L, b, x, B, n, strideL, strideB, stream);
}

int lpopc_lane_cho_solve_f32(const void* L, const void* b, void* x, int B, int n,
                             long long strideL, long long strideB, void* stream) {
    return launch_cho_solve<float>(L, b, x, B, n, strideL, strideB, stream);
}

// Shared-memory bytes a block needs; the Python wrapper refuses sizes past
// the 227 KB a Hopper block may use before it launches.
long long lpopc_lane_cholesky_smem_bytes(int n, int elem_size) {
    return elem_size == 4 ? (long long)chol_smem_bytes<float>(n)
                          : (long long)chol_smem_bytes<double>(n);
}

long long lpopc_lane_cho_solve_smem_bytes(int n, int elem_size) {
    return elem_size == 4 ? (long long)solve_smem_bytes<float>(n)
                          : (long long)solve_smem_bytes<double>(n);
}

}  // extern "C"
