// batched_linalg_layout.cpp — the kernels' variant choice for the host
// (ctypes): 0 for the shared-memory variant, 1 for the global-memory one;
// and the bytes of scratch K2's global variant takes.
//
// Build: g++ -std=c++17 -O2 -shared -fPIC -o liblpopc_batched_linalg_layout.so
//        batched_linalg_layout.cpp

#include "batched_linalg_layout.h"

extern "C" {

int lpopc_lane_cholesky_variant(int n, int elem_size) {
    return lpopc_layout::cholesky_variant(n, elem_size);
}

int lpopc_lane_cho_solve_variant(int n, int elem_size) {
    return lpopc_layout::cho_solve_variant(n, elem_size);
}

long long lpopc_lane_cho_solve_global_scratch_bytes(int B) {
    return (long long)lpopc_layout::cho_solve_global_scratch_bytes(B);
}

}  // extern "C"
