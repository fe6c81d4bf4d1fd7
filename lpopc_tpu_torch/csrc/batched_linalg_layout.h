// batched_linalg_layout.h — which variant of each kernel of batched_linalg.cu
// runs an n x n system, and how much shared memory its shared variant takes.
//
// Plain C++, so the choice has one owner: batched_linalg.cu includes it for
// its launchers, and batched_linalg_layout.cpp exports the same choice to the
// Python wrapper (ops/batched_linalg.py::variant), built for the host with
// g++, so it is known and testable without a GPU.

#pragma once

#include <stddef.h>

#ifdef __CUDACC__
#define LPOPC_HOST_DEVICE __host__ __device__
#else
#define LPOPC_HOST_DEVICE
#endif

namespace lpopc_layout {

// shared memory one block may use on Hopper (227 KB)
constexpr size_t kMaxBlockSmem = 232448;
// K2's shared variant keeps ceil(n/32) right-hand-side entries per lane in
// registers; its launcher instantiates 1..kSolveMaxRows of them
constexpr int kSolveMaxRows = 8;
// K2's shared variant: systems (warps) per block, at most
constexpr int kSolveMaxWarps = 4;

enum Variant { kShared = 0, kGlobal = 1 };

// Odd leading dimension: a column walk (stride ld) then touches distinct
// shared-memory banks for 4- and 8-byte elements alike.
LPOPC_HOST_DEVICE inline int lead_dim(int n) { return n | 1; }

// K1 shared: the matrix (n x lead_dim(n)) and one column.
inline size_t cholesky_smem_bytes(int n, int elem_size) {
    return ((size_t)n * lead_dim(n) + n) * elem_size;
}

// K2 shared: per system, the packed lower triangle (row i at offset i(i+1)/2).
inline size_t cho_solve_system_bytes(int n, int elem_size) {
    return (size_t)n * (n + 1) / 2 * elem_size;
}

inline int solve_rows(int n) { return (n + 31) / 32; }

inline Variant cholesky_variant(int n, int elem_size) {
    return cholesky_smem_bytes(n, elem_size) <= kMaxBlockSmem ? kShared : kGlobal;
}

inline Variant cho_solve_variant(int n, int elem_size) {
    return solve_rows(n) <= kSolveMaxRows && cho_solve_system_bytes(n, elem_size) <= kMaxBlockSmem
               ? kShared
               : kGlobal;
}

}  // namespace lpopc_layout
