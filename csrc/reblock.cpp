// Native on-the-fly reblocking cascade.
//
// The reference implements this streaming doubling cascade as a
// numba-jitted kernel (reference: stats/reblock.py:524-604).  In this
// framework it is a host-side (CPU) computation feeding the block
// statistics; this C++ implementation replaces numba for large series.
//
// Semantics: for order k, block means are the means of the first
// floor(n / 2^k) complete blocks of 2^k consecutive samples; the table
// accumulates per-order sums of block means, sums of squared block
// means, and block counts.  The cascade keeps one running partial sum
// per order, promoting a completed block's mean upward - a single
// streaming pass, cache-friendly and allocation-free.
//
// Build: see csrc/Makefile (produces phd_qmclib_tpu/_native/libreblock.so).

#include <cstdint>

extern "C" {

// data:           (n, num_cols) row-major samples
// means_sum:      (num_cols, max_order + 1) output, zero-initialized
// means_sqr_sum:  (num_cols, max_order + 1) output, zero-initialized
// num_blocks:     (num_cols, max_order + 1) output, zero-initialized
void otf_reblock_f64(const double* data, int64_t n, int64_t num_cols,
                     int64_t max_order, double* means_sum,
                     double* means_sqr_sum, int64_t* num_blocks) {
    const int64_t orders = max_order + 1;
    // Per-column running partial block sums, one per order.
    // Allocated on the heap once; orders <= 63 for any realistic n.
    double* partial = new double[num_cols * orders]();

    for (int64_t idx = 0; idx < n; ++idx) {
        const double* row = data + idx * num_cols;
        for (int64_t c = 0; c < num_cols; ++c) {
            double v = row[c];
            double* part_c = partial + c * orders;
            double* ms_c = means_sum + c * orders;
            double* msq_c = means_sqr_sum + c * orders;
            int64_t* nb_c = num_blocks + c * orders;

            // Order 0: every sample is a block.
            ms_c[0] += v;
            msq_c[0] += v * v;
            nb_c[0] += 1;

            // Promote completed blocks upward.  Block b at order k
            // completes when (idx + 1) is a multiple of 2^k.
            double mean = v;
            int64_t index1 = idx + 1;
            for (int64_t k = 1; k <= max_order; ++k) {
                part_c[k] += mean;  // accumulate half-block mean
                if (index1 % (int64_t(1) << k) != 0) break;
                mean = part_c[k] * 0.5;
                part_c[k] = 0.0;
                ms_c[k] += mean;
                msq_c[k] += mean * mean;
                nb_c[k] += 1;
            }
        }
    }
    delete[] partial;
}

}  // extern "C"
