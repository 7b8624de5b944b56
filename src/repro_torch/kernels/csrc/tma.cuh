// Host side of the port's TMA loads: tensor maps over strided bf16
// [B, heads, T, hd] views, built per call and handed to a kernel as a
// __grid_constant__ parameter. Shared by flash_attention.cu and
// flash_attention_bwd.cu.
#pragma once

#include <cuda.h>   // CUtensorMap and the tensor-map enums (no libcuda link)
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime's
// entry-point table (no libcuda link).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over the strided bf16 view [B, heads, T, hd] (dims innermost
// first: hd, T, heads, B), boxes of 64 columns x `rows` rows, 128-byte
// swizzle, out-of-range elements read as zero (so hd 32 and 112 arrive
// zero-padded to 64 and 128 columns). A dim of extent 1 never moves, so its
// stride is replaced by a valid one.
bool make_map(CUtensorMap* map, const void* base, int hd, int T, int heads,
              int B, Strides s, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t fallback = (cuuint64_t)hd * 2;
  cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)T, (cuuint64_t)heads,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {T > 1 ? (cuuint64_t)s.t * 2 : fallback,
                           heads > 1 ? (cuuint64_t)s.h * 2 : fallback,
                           B > 1 ? (cuuint64_t)s.b * 2 : fallback};
  cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
