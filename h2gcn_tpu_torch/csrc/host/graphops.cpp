// graphops: native host-side graph kernels of h2gcn_tpu_torch (CPU, OpenMP).
//
// The port's own copy of the JAX package's csrc/graphops.cpp, with the same
// code in every function it keeps, so both packages compute the same
// exact-hop split and the same node order. h2gcn_tpu_torch/native.py
// compiles it with g++ at first use (without -fopenmp where the compiler
// has no OpenMP runtime: the pragmas are then ignored, the results the
// same) and binds it with ctypes:
//
//   * bool_spgemm      — Gustavson sparse×sparse boolean product over CSR
//                        index arrays (values implicitly 1), OpenMP
//                        row-parallel, two-phase (count, fill).
//   * bool_subtract    — A \ B on sorted CSR index arrays (exact-hop
//                        difference 1[(A+I)^k>0] − 1[(A+I)^{k-1}>0]).
//   * rcm_order        — reverse Cuthill-McKee order (cluster reordering).
//   * build_ell        — CSR → padded ELL neighbor table (GraphSAGE).
//
// The JAX package's BSR builder and the team-uncapped spgemm entry points
// are left out: the port does not call them.
//
// Plain C ABI for ctypes; all index arrays are int64 (scipy default) or
// int32 as noted. This is host code, not a device kernel.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// CSR → padded ELL table [n, dmax] with validity flags.
void build_ell(int64_t n_rows, const int64_t* indptr, const int32_t* indices,
               int64_t dmax, int32_t* table, uint8_t* valid) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_rows; ++i) {
        const int64_t deg = indptr[i + 1] - indptr[i];
        for (int64_t d = 0; d < dmax; ++d) {
            if (d < deg) {
                table[i * dmax + d] = indices[indptr[i] + d];
                valid[i * dmax + d] = 1;
            } else {
                table[i * dmax + d] = 0;
                valid[i * dmax + d] = 0;
            }
        }
    }
}

// Phase 1: count nnz per row of C = A(boolean) * B(boolean).
// indptr arrays are int64[n+1]; indices int32[nnz].
// The _nt variants cap the OpenMP team size (nt <= 0 = runtime default).
void bool_spgemm_count_nt(int64_t n_rows, int64_t n_cols,
                          const int64_t* a_indptr, const int32_t* a_indices,
                          const int64_t* b_indptr, const int32_t* b_indices,
                          int64_t* c_row_counts, int64_t nt) {
#ifdef _OPENMP
    if (nt <= 0) nt = omp_get_max_threads();
#else
    (void)nt;
#endif
#pragma omp parallel num_threads(nt)
    {
        std::vector<int64_t> stamp(n_cols, -1);
#pragma omp for schedule(dynamic, 64)
        for (int64_t i = 0; i < n_rows; ++i) {
            int64_t count = 0;
            for (int64_t jj = a_indptr[i]; jj < a_indptr[i + 1]; ++jj) {
                const int32_t j = a_indices[jj];
                for (int64_t kk = b_indptr[j]; kk < b_indptr[j + 1]; ++kk) {
                    const int32_t k = b_indices[kk];
                    if (stamp[k] != i) {
                        stamp[k] = i;
                        ++count;
                    }
                }
            }
            c_row_counts[i] = count;
        }
    }
}

// Phase 2: fill C's column indices (sorted per row).
void bool_spgemm_fill_nt(int64_t n_rows, int64_t n_cols,
                         const int64_t* a_indptr, const int32_t* a_indices,
                         const int64_t* b_indptr, const int32_t* b_indices,
                         const int64_t* c_indptr, int32_t* c_indices,
                         int64_t nt) {
#ifdef _OPENMP
    if (nt <= 0) nt = omp_get_max_threads();
#else
    (void)nt;
#endif
#pragma omp parallel num_threads(nt)
    {
        std::vector<int64_t> stamp(n_cols, -1);
#pragma omp for schedule(dynamic, 64)
        for (int64_t i = 0; i < n_rows; ++i) {
            int64_t out = c_indptr[i];
            const int64_t start = out;
            for (int64_t jj = a_indptr[i]; jj < a_indptr[i + 1]; ++jj) {
                const int32_t j = a_indices[jj];
                for (int64_t kk = b_indptr[j]; kk < b_indptr[j + 1]; ++kk) {
                    const int32_t k = b_indices[kk];
                    if (stamp[k] != i) {
                        stamp[k] = i;
                        c_indices[out++] = k;
                    }
                }
            }
            std::sort(c_indices + start, c_indices + out);
        }
    }
}

// C = A \ B on sorted CSR index sets; phase 1 counts.
void bool_subtract_count(int64_t n_rows,
                         const int64_t* a_indptr, const int32_t* a_indices,
                         const int64_t* b_indptr, const int32_t* b_indices,
                         int64_t* c_row_counts) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_rows; ++i) {
        int64_t aj = a_indptr[i], bj = b_indptr[i];
        const int64_t ae = a_indptr[i + 1], be = b_indptr[i + 1];
        int64_t count = 0;
        while (aj < ae) {
            while (bj < be && b_indices[bj] < a_indices[aj]) ++bj;
            if (bj >= be || b_indices[bj] != a_indices[aj]) ++count;
            ++aj;
        }
        c_row_counts[i] = count;
    }
}

void bool_subtract_fill(int64_t n_rows,
                        const int64_t* a_indptr, const int32_t* a_indices,
                        const int64_t* b_indptr, const int32_t* b_indices,
                        const int64_t* c_indptr, int32_t* c_indices) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_rows; ++i) {
        int64_t aj = a_indptr[i], bj = b_indptr[i];
        const int64_t ae = a_indptr[i + 1], be = b_indptr[i + 1];
        int64_t out = c_indptr[i];
        while (aj < ae) {
            while (bj < be && b_indices[bj] < a_indices[aj]) ++bj;
            if (bj >= be || b_indices[bj] != a_indices[aj])
                c_indices[out++] = a_indices[aj];
            ++aj;
        }
    }
}

// Reverse Cuthill-McKee ordering on a symmetric CSR pattern. Writes a
// permutation `perm` (int32[n]) such that A[perm][:, perm] has reduced
// bandwidth — used to cluster edges into dense tiles so the BSR/COO-tile
// SpMM backends touch fewer blocks at large scale. BFS per connected
// component from a minimum-degree seed, neighbors visited in degree order,
// whole order reversed at the end (the classic RCM recipe; greenfield —
// the reference has no analogue, its scipy path densifies instead).
void rcm_order(int64_t n, const int64_t* indptr, const int32_t* indices,
               int32_t* perm) {
    std::vector<int32_t> degree(n);
    for (int64_t i = 0; i < n; ++i)
        degree[i] = static_cast<int32_t>(indptr[i + 1] - indptr[i]);

    // global degree-ascending node order: component seeds are scanned from
    // here so each component starts at (one of) its min-degree nodes.
    std::vector<int32_t> by_degree(n);
    for (int64_t i = 0; i < n; ++i) by_degree[i] = static_cast<int32_t>(i);
    std::sort(by_degree.begin(), by_degree.end(),
              [&](int32_t a, int32_t b) {
                  return degree[a] != degree[b] ? degree[a] < degree[b]
                                                : a < b;
              });

    std::vector<uint8_t> visited(n, 0);
    std::vector<int32_t> order;
    order.reserve(n);
    std::vector<int32_t> nbrs;
    int64_t seed_scan = 0;
    while (static_cast<int64_t>(order.size()) < n) {
        while (visited[by_degree[seed_scan]]) ++seed_scan;
        const int32_t seed = by_degree[seed_scan];
        visited[seed] = 1;
        order.push_back(seed);
        // BFS over order[] itself as the queue
        for (size_t head = order.size() - 1; head < order.size(); ++head) {
            const int32_t u = order[head];
            nbrs.clear();
            for (int64_t jj = indptr[u]; jj < indptr[u + 1]; ++jj) {
                const int32_t v = indices[jj];
                if (!visited[v]) {
                    visited[v] = 1;
                    nbrs.push_back(v);
                }
            }
            std::sort(nbrs.begin(), nbrs.end(),
                      [&](int32_t a, int32_t b) {
                          return degree[a] != degree[b]
                                     ? degree[a] < degree[b]
                                     : a < b;
                      });
            order.insert(order.end(), nbrs.begin(), nbrs.end());
        }
    }
    for (int64_t i = 0; i < n; ++i) perm[i] = order[n - 1 - i];
}

int graphops_version() { return 3; }

// Threads the OpenMP loops run on; 1 when built without OpenMP (serial).
int graphops_openmp_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
