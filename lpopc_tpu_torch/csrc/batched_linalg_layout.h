// batched_linalg_layout.h — which variant of each kernel of batched_linalg.cu
// runs an n x n system, how much shared memory its shared variant takes, and
// how much scratch K2's global variant needs.
//
// Plain C++, so the choice has one owner: batched_linalg.cu includes it for
// its launchers, and batched_linalg_layout.cpp exports the same choice to the
// Python wrapper (ops/batched_linalg.py::variant), built for the host with
// g++, so it is known and testable without a GPU.

#pragma once

#include <stddef.h>

namespace lpopc_layout {

// shared memory one block may use on Hopper (227 KB)
constexpr size_t kMaxBlockSmem = 232448;
// K2's shared variant keeps ceil(n/32) right-hand-side entries per lane in
// registers; its launcher instantiates 1..kSolveMaxRows of them
constexpr int kSolveMaxRows = 8;
// K2's shared variant: systems (warps) per block, at most
constexpr int kSolveMaxWarps = 4;

enum Variant { kShared = 0, kGlobal = 1 };

// K1 shared: warps per block. The panel step gives a warp each 32 rows below
// the first panel, and one warp more copies K in and L out meanwhile.
inline int cholesky_warps(int n) {
    const int row_warps = n > 32 ? (n - 32 + 31) / 32 : 1;
    return row_warps + 1;
}

// K1 shared: a 32-entry column buffer per warp and the packed lower
// triangle (row i at offset i(i+1)/2): n <= 239 in f64, n <= 339 in f32.
inline size_t cholesky_smem_bytes(int n, int elem_size) {
    return ((size_t)32 * cholesky_warps(n) + (size_t)n * (n + 1) / 2) * elem_size;
}

// K2 shared: per system, the packed lower triangle (row i at offset i(i+1)/2).
inline size_t cho_solve_system_bytes(int n, int elem_size) {
    return (size_t)n * (n + 1) / 2 * elem_size;
}

inline int solve_rows(int n) { return (n + 31) / 32; }

// K2 global: the scratch the wrapper passes, in bytes: a ticket counter
// and, per system, the counts of forward and of backward tiles done (32-bit
// words each). It does not depend on n.
inline size_t cho_solve_global_scratch_bytes(int B) { return 4 * (1 + 2 * (size_t)B); }

inline Variant cholesky_variant(int n, int elem_size) {
    return cholesky_smem_bytes(n, elem_size) <= kMaxBlockSmem ? kShared : kGlobal;
}

inline Variant cho_solve_variant(int n, int elem_size) {
    return solve_rows(n) <= kSolveMaxRows && cho_solve_system_bytes(n, elem_size) <= kMaxBlockSmem
               ? kShared
               : kGlobal;
}

}  // namespace lpopc_layout
