// zstd_decls.h -- the part of libzstd's stable API that precompiles.cpp
// calls, declared here so that the library builds where the machine has
// libzstd.so.1 but neither zstd.h nor the libzstd.so link name (the
// runtime package without its development files).  The build links
// -l:libzstd.so.1.  Every name below is in zstd.h's stable section since
// v1.3.0, with these exact signatures and values.
#pragma once
#include <stddef.h>

extern "C" {
typedef struct ZSTD_CCtx_s ZSTD_CCtx;
typedef struct ZSTD_DCtx_s ZSTD_DCtx;

ZSTD_CCtx* ZSTD_createCCtx(void);
size_t ZSTD_freeCCtx(ZSTD_CCtx* cctx);
size_t ZSTD_compressCCtx(ZSTD_CCtx* cctx, void* dst, size_t dstCapacity,
                         const void* src, size_t srcSize,
                         int compressionLevel);
ZSTD_DCtx* ZSTD_createDCtx(void);
size_t ZSTD_freeDCtx(ZSTD_DCtx* dctx);
size_t ZSTD_decompressDCtx(ZSTD_DCtx* dctx, void* dst, size_t dstCapacity,
                           const void* src, size_t srcSize);
size_t ZSTD_compressBound(size_t srcSize);
unsigned long long ZSTD_getFrameContentSize(const void* src, size_t srcSize);
unsigned ZSTD_isError(size_t code);
}

#define ZSTD_CONTENTSIZE_UNKNOWN (0ULL - 1)
#define ZSTD_CONTENTSIZE_ERROR (0ULL - 2)
