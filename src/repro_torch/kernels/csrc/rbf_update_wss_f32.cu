// Kernel 2 (the lane-batched rbf pass B, rbf_update_wss.cuh) for float32.
#include "rbf_update_wss.cuh"

extern "C" {

int rbf_update_wss_batched_f32(const float* XT, const float* sqn,
                               const float* G, const float* alpha,
                               const float* L, const float* U,
                               const float* XQi, const float* sqqi,
                               const float* XQj, const float* sqqj,
                               const float* mu, const float* gammas,
                               const bool* act, const float* dirv,
                               const float* mu2, float* G_out, float* bmax,
                               int* barg, float* bmin, float* r_out, int B,
                               int H, int l, int d, int device,
                               void* stream) {
  return repro::update_wss<float>(XT, sqn, G, alpha, L, U, XQi, sqqi, XQj,
                                  sqqj, mu, gammas, act, dirv, mu2, G_out,
                                  bmax, barg, bmin, r_out, B, H, l, d, device,
                                  stream);
}

// As rbf_update_wss_batched_attrs_f64 (rbf_update_wss.cu).
int rbf_update_wss_batched_attrs_f32(int B, int H, int masked, int conj,
                                     int* out) {
  return repro::update_wss_attrs<float>(B, H, masked != 0, conj != 0, out);
}

}  // extern "C"
