// K5's C entry points and its bf16 instantiations; the kernels and the notes on their
// design are in mlp_dwbn.cuh, the f32 instantiations in mlp_dwbn_fc1_f32.cu (fc1) and
// mlp_dwbn_taps_f32.cu (taps).
#include "mlp_dwbn.cuh"

namespace rss {
// built in mlp_dwbn_taps_f32.cu
extern template int taps_run<float>(const TapsArgs<float>&, int, int, int, cudaStream_t, int*);
template int taps_run<bf16>(const TapsArgs<bf16>&, int, int, int, cudaStream_t, int*);

// bf16: `a` warps a block walking `b` steps; f32: the tile of `a` hidden features, `b`
// blocks a tile
inline int fc1_call(const void* x, const void* w1, const void* b1, const void* s1,
                    const void* t1, void* h, int M, int cin, int cinp, int hp, int f32, int a,
                    int b, cudaStream_t st, int* held) {
  if (f32) {
    const Fc1F32Args p{(const float*)x, (const float*)w1, (const float*)b1, (const float*)s1,
                       (const float*)t1, (float*)h, M, cin, cinp, hp};
    return fc1_f32_run(p, a, b, st, held);
  }
  const Fc1Args p{(const float*)x, (const bf16*)w1, (const float*)b1, (const float*)s1,
                  (const float*)t1, (bf16*)h, M, cin, cinp, b};
  return fc1_run(p, hp, a, st, held);
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
// `a` and `b` are the wrapper's plan: bf16 (warps, steps a block), f32 (tile, blocks).
extern "C" int k5_mlp_fc1(const void* x, const void* w1, const void* b1, const void* s1,
                          const void* t1, void* h, int M, int cin, int cinp, int hp, int f32,
                          int a, int b, void* stream) {
  if (M < 1 || b < 1) return (int)cudaErrorInvalidValue;
  return rss::fc1_call(x, w1, b1, s1, t1, h, M, cin, cinp, hp, f32, a, b, (cudaStream_t)stream,
                       nullptr);
}

// Blocks of fc1 with that many warps (bf16) or that tile (f32) one SM holds at once, as
// the card reports it; -1 for a width, warp count or tile the kernel does not take.
extern "C" int k5_fc1_blocks_per_sm(int cin, int cinp, int hp, int f32, int a) {
  int n = -1;
  const int rc = rss::fc1_call(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, cin, cinp,
                               hp, f32, a, 1, nullptr, &n);
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
