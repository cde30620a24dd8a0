// K5's C entry points and its bf16 instantiations; the kernels and the notes on their
// design are in mlp_dwbn.cuh, the float instantiations in mlp_dwbn_f32.cu and
// mlp_dwbn_taps_f32.cu.
#include "mlp_dwbn.cuh"

namespace rss {
// built in mlp_dwbn_f32.cu (fc1) and mlp_dwbn_taps_f32.cu (taps)
extern template int fc1_run<float>(const Fc1Args<float>&, int, int, cudaStream_t, int*);
extern template int taps_run<float>(const TapsArgs<float>&, int, int, int, cudaStream_t, int*);
template int fc1_run<bf16>(const Fc1Args<bf16>&, int, int, cudaStream_t, int*);
template int taps_run<bf16>(const TapsArgs<bf16>&, int, int, int, cudaStream_t, int*);

template <typename T>
int fc1_call(const void* x, const void* w1, const void* b1, const void* s1, const void* t1,
             void* h, int M, int cin, int cinp, int hp, int warps, int per, cudaStream_t st,
             int* held) {
  const Fc1Args<T> p{(const float*)x, (const T*)w1, (const float*)b1, (const float*)s1,
                     (const float*)t1, (T*)h, M, cin, cinp, per};
  return fc1_run<T>(p, hp, warps, st, held);
}

template <typename T>
int taps_call(const void* h, const void* taps, const void* dwb, const void* s2, const void* t2,
              const void* w2, const void* b2, const void* s3, const void* t3, void* out, int B,
              int H, int W, int cout, int coutp, int hp, int tile, int blocks, cudaStream_t st,
              int* held) {
  const int N = H * W, M = B * N;
  const TapsArgs<T> p{(const T*)h,  (const T*)taps, (const float*)dwb, (const float*)s2,
                      (const float*)t2, (const T*)w2, (const float*)b2, (const float*)s3,
                      (const float*)t3, (float*)out,  M, N, H, W, cout, coutp,
                      (M + tile - 1) / tile};
  return taps_run<T>(p, hp, tile, blocks, st, held);
}
}  // namespace rss

// h (M, hp) from x (M, cin) f32 and w1 (hp, cinp), h and w1 bf16, or f32 where `f32` is
// set; cinp is cin rounded up to 16 and hp a padded hidden width (96, 128, 160, 192),
// w1's padding zeros. x 4-byte aligned (16 where cin % 4 == 0), the rest 16-byte.
// `warps` and `per` (steps a block walks) come from the wrapper's plan.
extern "C" int k5_mlp_fc1(const void* x, const void* w1, const void* b1, const void* s1,
                          const void* t1, void* h, int M, int cin, int cinp, int hp, int f32,
                          int warps, int per, void* stream) {
  using namespace rss;
  if (M < 1 || per < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return f32 ? fc1_call<float>(x, w1, b1, s1, t1, h, M, cin, cinp, hp, warps, per, st, nullptr)
             : fc1_call<bf16>(x, w1, b1, s1, t1, h, M, cin, cinp, hp, warps, per, st, nullptr);
}

// Blocks of fc1 with that many warps one SM holds at once, as the card reports it;
// -1 for a width or warp count the kernel does not take.
extern "C" int k5_fc1_blocks_per_sm(int cin, int cinp, int hp, int f32, int warps) {
  using namespace rss;
  int n = -1;
  const int rc = f32 ? fc1_call<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1,
                                       cin, cinp, hp, warps, 1, nullptr, &n)
                     : fc1_call<bf16>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1,
                                      cin, cinp, hp, warps, 1, nullptr, &n);
  return rc == 0 ? n : -1;
}

// out (B * H * W, cout) f32 from h (B * H * W, hp), taps (19, hp, hp) and w2 (coutp, hp),
// bf16, or f32 where `f32` is set; the six vectors f32 (dw_bias, bn2: hp; b2, bn3:
// coutp), padding zeros; coutp is cout rounded up to 16. out 4-byte aligned (16 where
// cout % 4 == 0), the rest 16-byte. `tile` and `blocks` come from the wrapper's plan.
extern "C" int k5_mlp_taps(const void* h, const void* taps, const void* dwb, const void* s2,
                           const void* t2, const void* w2, const void* b2, const void* s3,
                           const void* t3, void* out, int B, int H, int W, int cout, int coutp,
                           int hp, int f32, int tile, int blocks, void* stream) {
  using namespace rss;
  if (B < 1 || H < 1 || W < 1 || cout < 1 || coutp < cout || coutp >= cout + 16 ||
      coutp % 16 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return f32 ? taps_call<float>(h, taps, dwb, s2, t2, w2, b2, s3, t3, out, B, H, W, cout, coutp,
                                hp, tile, blocks, st, nullptr)
             : taps_call<bf16>(h, taps, dwb, s2, t2, w2, b2, s3, t3, out, B, H, W, cout, coutp,
                               hp, tile, blocks, st, nullptr);
}

// Blocks of the taps kernel at (hp, operand type, tile) one SM holds at once, as the
// card reports it; -1 for an instantiation the kernel does not have.
extern "C" int k5_taps_blocks_per_sm(int hp, int f32, int tile) {
  using namespace rss;
  int n = -1;
  const int rc =
      f32 ? taps_call<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, nullptr, 1, 1, 1, 16, 16, hp, tile, 1, nullptr, &n)
          : taps_call<bf16>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, nullptr, nullptr, 1, 1, 1, 16, 16, hp, tile, 1, nullptr, &n);
  return rc == 0 ? n : -1;
}
