// K5's float taps instantiation (3xTF32 `wgmma`, `taps_wg_kernel`), a source of its own so
// that nvcc builds it beside mlp_dwbn.cu and mlp_dwbn_fc1_f32.cu; see mlp_dwbn.cuh.
#include "mlp_dwbn.cuh"

namespace rss {
template int taps_run<float>(const TapsArgs<float>&, int, int, int, cudaStream_t, int*);
}  // namespace rss
