// Kernel 2 (the lane-batched rbf pass B, rbf_update_wss.cuh) for float64.
// The float32 entries are in rbf_update_wss_f32.cu, so nvcc builds the two
// in parallel.
#include "rbf_update_wss.cuh"

extern "C" {

int rbf_update_wss_batched_f64(const double* XT, const double* sqn,
                               const double* G, const double* alpha,
                               const double* L, const double* U,
                               const double* XQi, const double* sqqi,
                               const double* XQj, const double* sqqj,
                               const double* mu, const double* gammas,
                               const bool* act, const double* dirv,
                               const double* mu2, double* G_out,
                               double* bmax, int* barg, double* bmin,
                               double* r_out, int B, int H, int l, int d,
                               int device, void* stream) {
  return repro::update_wss<double>(XT, sqn, G, alpha, L, U, XQi, sqqi, XQj,
                                   sqqj, mu, gammas, act, dirv, mu2, G_out,
                                   bmax, barg, bmin, r_out, B, H, l, d, device,
                                   stream);
}

// Resources of the variant a launch with these arguments takes: out =
// {registers a thread, local bytes a thread (spills included), static
// shared bytes, dynamic shared bytes}.
int rbf_update_wss_batched_attrs_f64(int B, int H, int masked, int conj,
                                     int* out) {
  return repro::update_wss_attrs<double>(B, H, masked != 0, conj != 0, out);
}

}  // extern "C"
