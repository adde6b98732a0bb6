// Kernel 1 (the lane-batched rbf pass A, rbf_row_wss.cuh) for float64,
// and the library's shared entries.  The float32 entries are in
// rbf_row_wss_f32.cu, so nvcc builds the two in parallel.
#include "rbf_row_wss.cuh"

extern "C" {

int repro_block_l() { return repro::kBlockL; }

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int rbf_row_wss_batched_f64(const double* XT, const double* sqn,
                            const double* G, const double* alpha,
                            const double* L, const double* U,
                            const double* XQ, const double* sqq,
                            const double* a_i, const double* L_i,
                            const double* U_i, const double* g_i,
                            const int* i_idx, const bool* use_exact,
                            const double* gammas, const bool* act,
                            double* bmax, int* barg, int B, int H, int l,
                            int d, int device, void* stream) {
  return repro::row_wss<double>(XT, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i,
                                U_i, g_i, i_idx, use_exact, gammas, act,
                                bmax, barg, B, H, l, d, device, stream);
}

// Resources of the variant a launch with these arguments takes: out =
// {registers a thread, local bytes a thread (spills included), static
// shared bytes, dynamic shared bytes}.
int rbf_row_wss_batched_attrs_f64(int B, int H, int masked, int* out) {
  return repro::row_wss_attrs<double>(B, H, masked != 0, out);
}

}  // extern "C"
