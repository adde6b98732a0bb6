// Kernel 1 (the lane-batched rbf pass A, rbf_row_wss.cuh) for float32.
#include "rbf_row_wss.cuh"

extern "C" {

int rbf_row_wss_batched_f32(const float* XT, const float* sqn,
                            const float* G, const float* alpha,
                            const float* L, const float* U, const float* XQ,
                            const float* sqq, const float* a_i,
                            const float* L_i, const float* U_i,
                            const float* g_i, const int* i_idx,
                            const bool* use_exact, const float* gammas,
                            const bool* act, float* bmax, int* barg, int B,
                            int H, int l, int d, int device, void* stream) {
  return repro::row_wss<float>(XT, sqn, G, alpha, L, U, XQ, sqq, a_i, L_i,
                               U_i, g_i, i_idx, use_exact, gammas, act, bmax,
                               barg, B, H, l, d, device, stream);
}

// As rbf_row_wss_batched_attrs_f64 (rbf_row_wss.cu).
int rbf_row_wss_batched_attrs_f32(int B, int H, int masked, int* out) {
  return repro::row_wss_attrs<float>(B, H, masked != 0, out);
}

}  // extern "C"
