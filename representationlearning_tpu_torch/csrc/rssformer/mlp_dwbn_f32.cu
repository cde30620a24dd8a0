// K5's float (3xTF32) fc1 instantiation, built beside mlp_dwbn.cu; see mlp_dwbn.cuh.
#include "mlp_dwbn.cuh"

namespace rss {
template int fc1_run<float>(const Fc1Args<float>&, int, int, cudaStream_t, int*);
}  // namespace rss
